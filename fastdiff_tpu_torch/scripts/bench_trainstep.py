"""The vocoder train step at the reference recipe, per training route (the
twin of ``scripts/bench_trainstep.py``): batch 20 x 25,600 samples, bf16,
``FastDiffTask.train_step`` (the eps loss, backward, clip and AdamW) on the
card, the routes raced in turns with CUDA events.

    python -m fastdiff_tpu_torch.scripts.bench_trainstep [--reps 3]
        [--batch 20] [--frames 100] [--hparams 'k=v,...']

The routes, in JAX's order: ``plain`` (JAX's ``xla``: the plain PyTorch
block), ``ncl_sr`` (K3 and the saved-residual K4), ``ncl_vjp`` (K3 and
K1 / K2 with a recomputing backward) and ``nwc_vjp`` (K7 and K6,
``use_pallas_block: true``). Each route's task starts from the same seed-0
weights and steps on one batch drawn on the device from a generator seeded
2 (wavs N(0, 0.3^2), mels N(-4, 1)), with its t and z drawn there too, the
same for every route. For each route it prints ms per step (the mean of
the turns, and each turn's mean over ``--reps`` steps), the achieved
TFLOP/s and share of the bf16 peak from 3 x 2.369e5 FLOP per sample per
forward, the peak memory of one step, the loss and gradient norm, and the
relative L2 of its gradients of the first step against the plain route's;
then the fastest route and the hours of a million updates. ``setup``,
``gradient_errors``, ``warm`` and ``race`` are its parts
(``chip_smoke.py`` phase 10 runs them; ``tests/test_torch_script_twins.py``
runs them at a small width on the CPU, where nothing is timed).
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from fastdiff_tpu_torch.models.fastdiff import checked_device
from fastdiff_tpu_torch.training.task import FastDiffTask
from fastdiff_tpu_torch.utils.hparams import apply_overrides
from fastdiff_tpu_torch.utils.timing import cuda_ms

ROUTES = ("plain", "ncl_sr", "ncl_vjp", "nwc_vjp")
# the use_pallas_block value of each route
FLAGS = {"plain": False, "ncl_sr": "ncl_sr", "ncl_vjp": "ncl_vjp",
         "nwc_vjp": True}
BATCH, FRAMES = 20, 100
FLOP_PER_SAMPLE = 3 * 2.369e5          # forward, and backward as two
H100_BF16_PEAK = 989e12


@dataclasses.dataclass
class Race:
    """The tasks and states of each route and the one batch and draws they
    share."""
    routes: tuple
    tasks: dict
    states: dict
    batch: dict
    ts: torch.Tensor
    z: torch.Tensor

    @property
    def samples(self) -> int:
        return int(self.z.shape[0] * self.z.shape[1])

    def step(self, route: str) -> dict:
        """One update of ``route``'s state on the batch."""
        return self.tasks[route].train_step(self.states[route], self.batch,
                                            ts=self.ts, z=self.z)


def setup(device, routes=ROUTES, batch: int = BATCH, frames: int = FRAMES,
          hparams: dict | None = None) -> Race:
    """The tasks of ``routes`` on ``device`` (each checked to resolve to
    its route) with seed-0 states, and the batch and draws from a generator
    on ``device`` seeded 2."""
    device = checked_device(device)
    hp = dict(hparams or {})
    tasks = {r: FastDiffTask(dict(hp, use_pallas_block=FLAGS[r]),
                             device=device) for r in routes}
    for r, task in tasks.items():
        if task.route != r:
            raise ValueError(f"use_pallas_block {FLAGS[r]!r} resolved to "
                             f"{task.route}, not {r}")
    cfg = tasks[routes[0]].model_cfg
    length = frames * cfg.total_hop
    gen = torch.Generator(device=device).manual_seed(2)
    data = {"wavs": torch.randn((batch, length, 1), generator=gen,
                                device=device).mul_(0.3).cpu().numpy(),
            "mels": torch.randn((batch, frames, cfg.cond_channels),
                                generator=gen, device=device).sub_(4.0)
            .cpu().numpy()}
    ts = torch.randint(0, 1000, (batch, 1, 1), generator=gen, device=device)
    z = torch.randn((batch, length, 1), generator=gen, device=device)
    states = {r: tasks[r].build_state(seed=0) for r in routes}
    return Race(tuple(routes), tasks, states, data, ts, z)


def gradient_errors(race: Race, reference: str = "plain") -> dict:
    """{route: (relative L2 of all its gradients against ``reference``'s,
    (the worst tensor's relative L2, its name))} for the first step of the
    identical initial weights on the same draws."""
    grads = {}
    for r in race.routes:
        model = race.states[r].model
        names, params = zip(*model.named_parameters())
        loss = race.tasks[r].loss(model, race.batch, ts=race.ts, z=race.z)
        grads[r] = dict(zip(names, torch.autograd.grad(loss, params)))
    ref = grads[reference]
    ref_norm = torch.sqrt(sum(g.float().square().sum() for g in ref.values()))
    out = {}
    for r in race.routes:
        if r == reference:
            continue
        diff = torch.sqrt(sum((grads[r][k].float() - g.float()).square().sum()
                              for k, g in ref.items()))
        worst = max(((float((grads[r][k].float() - g.float()).norm()
                            / g.float().norm()), k)
                     for k, g in ref.items() if float(g.float().norm()) > 0),
                    key=lambda t: t[0])
        out[r] = (float(diff / ref_norm), worst)
    return out


def warm(race: Race) -> tuple:
    """A warm-up step per route, then one more with the peak memory reset:
    ({route: {metric: float}} of that step, {route: peak bytes or None on
    the CPU})."""
    metrics, peak = {}, {}
    cuda = race.z.is_cuda
    for r in race.routes:
        race.step(r)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(race.z.device)
        metrics[r] = {k: float(v) for k, v in race.step(r).items()}
        if cuda:
            torch.cuda.synchronize()
        peak[r] = (torch.cuda.max_memory_allocated(race.z.device) if cuda
                   else None)
    return metrics, peak


def race(race_: Race, reps: int = 3) -> dict:
    """{route: [ms per step of each turn]}: the routes in turns, forwards
    then backwards (each turn ``reps`` steps between CUDA events after a
    warm-up step). The card only."""
    if not race_.z.is_cuda:
        raise RuntimeError("the race times the card with CUDA events; the "
                           "batch is not on a CUDA device")
    times = {r: [] for r in race_.routes}
    for r in race_.routes + race_.routes[::-1]:
        times[r].append(cuda_ms(lambda: race_.step(r), reps))
    return times


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--batch", type=int, default=BATCH)
    parser.add_argument("--frames", type=int, default=FRAMES)
    parser.add_argument("--hparams", default="")
    args = parser.parse_args(argv)
    hp = {}
    if args.hparams:
        apply_overrides(hp, args.hparams)
    state = setup(checked_device("cuda"), ROUTES, args.batch, args.frames, hp)
    errors = gradient_errors(state)
    metrics, peak = warm(state)
    times = race(state, args.reps)
    flop = FLOP_PER_SAMPLE * state.samples
    results = {}
    for r in ROUTES:
        ms = sum(times[r]) / len(times[r])
        results[r] = ms
        m = metrics[r]
        line = (f"| {r}: {ms:.2f} ms/step = {1e3 / ms:.1f} steps/s (turns "
                + ", ".join(f"{t:.2f}" for t in times[r])
                + f"), {flop / (ms / 1e3) / 1e12:.1f} TFLOP/s = "
                f"{100 * flop / (ms / 1e3) / H100_BF16_PEAK:.2f} % of the "
                f"bf16 peak, peak memory {peak[r] / 2 ** 30:.2f} GiB, loss "
                f"{m['loss']:.4f}, grad_norm {m['grad_norm']:.4f}")
        if r in errors:
            line += f", gradients vs plain rel_l2 {errors[r][0]:.3e}"
        print(line, flush=True)
    best = min(results, key=results.get)
    print(f"| best: {best} ({results[best]:.2f} ms); 1M updates in "
          f"{results[best] * 1e6 / 3.6e6:.1f} h on one "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
