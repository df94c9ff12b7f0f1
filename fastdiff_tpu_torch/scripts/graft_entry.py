"""Driver entry points of the port (the twin of the root
``__graft_entry__.py``): a one-card forward and a data-parallel dry run.

    python -m fastdiff_tpu_torch.scripts.graft_entry [--ranks N]
        [--device cuda]

``entry()`` returns ``(fn, example_args)``: the full-width ``FastDiff``
denoiser forward (``ModelConfig()``, seed-0 weights, the route
``use_pallas_block: auto`` takes) at 25 frames, batch 2, on the card.

``dryrun_multichip(n)`` runs JAX's four checks data parallel over ``n``
ranks, one process each (NCCL on cards, one card a rank, by default;
gloo on the CPU when the caller asks for it), each rank keeping its rows
of the global batch under ``DistributedDataParallel``: (1) one train
step of a tiny model (C = 8, one LVC layer, f32, the plain route) at 8
frames, one crop a rank; (2) one step on the ``ncl_vjp`` route at 16
frames (at the tiny widths on the CPU, where the route's plain versions
run; at the full widths in bf16 on cards, the widths its kernels are
built for); (3) rank 0 vocodes 16 frames a rank with
``DistributedChunkedVocoder`` over the ranks' devices, N = 4, from the
tiny model's trained weights; (4) one train step of the full-size model
(15.3M parameters, f32, the plain route) at 16 frames. Every loss and
waveform must be finite; a rank that fails raises in the caller with its
output.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from fastdiff_tpu_torch.config import ModelConfig
from fastdiff_tpu_torch.models.fastdiff import (FastDiff, checked_device,
                                                resolve_infer_route)

TINY = {
    "audio_channels": 1, "inner_channels": 8, "cond_channels": 80,
    "upsample_ratios": [8, 8, 4], "lvc_layers_each_block": 1,
    "lvc_kernel_size": 3, "kpnet_hidden_channels": 8, "kpnet_conv_size": 3,
    "dropout": 0.0, "diffusion_step_embed_dim_in": 16,
    "diffusion_step_embed_dim_mid": 32, "diffusion_step_embed_dim_out": 32,
    "use_weight_norm": True, "compute_dtype": "float32",
    "T": 50, "beta_0": 1e-4, "beta_T": 0.05,
    "lr": 1e-4, "weight_decay": 0, "scheduler": "none",
    "optimizer_adam_beta1": 0.9, "optimizer_adam_beta2": 0.98,
    "clip_grad_norm": 1, "accumulate_grad_batches": 1,
    "seed": 0, "hop_size": 256, "max_samples": 2048,
    "binary_data_dir": "", "load_ckpt": "", "multihost": True,
    # f32 on the plain route, as JAX's dry run (the kernels are bf16)
    "use_pallas_block": False,
}
FULL = {"inner_channels": 32, "lvc_layers_each_block": 4,
        "kpnet_hidden_channels": 64, "diffusion_step_embed_dim_in": 128,
        "diffusion_step_embed_dim_mid": 512,
        "diffusion_step_embed_dim_out": 512, "T": 1000, "beta_0": 1e-6,
        "beta_T": 0.01}


def entry(device="cuda", cfg: ModelConfig | None = None,
          state_dict: dict | None = None) -> tuple:
    """(fn, (audio (2, 6400, 1), mel (2, 25, 80), t (2, 1))): the
    denoiser forward on ``device`` of seed-0 weights (or ``state_dict``)
    and zero inputs, t ones, as JAX's entry; ``fn(audio, mel, t) ->
    eps``."""
    cfg = cfg or ModelConfig()
    device = checked_device(device)
    model = FastDiff(cfg, seed=0, infer_route=resolve_infer_route({}))
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model = model.to(device).eval()

    def fn(audio, mel, t):
        with torch.inference_mode():
            return model(audio, mel, t)

    frames, batch = 25, 2
    audio = torch.zeros((batch, frames * cfg.total_hop, 1), device=device)
    mel = torch.zeros((batch, frames, cfg.cond_channels), device=device)
    t = torch.ones((batch, 1), device=device)
    return fn, (audio, mel, t)


def _batch(n: int, frames: int, seeds: tuple) -> dict:
    return {"mels": np.random.default_rng(seeds[0]).standard_normal(
                (n, frames, 80)).astype(np.float32),
            "wavs": (np.random.default_rng(seeds[1]).standard_normal(
                (n, frames * 256, 1)) * 0.1).astype(np.float32)}


def _step(hp: dict, device, batch: dict, seed: int) -> tuple:
    from fastdiff_tpu_torch.training.task import FastDiffTask
    task = FastDiffTask(hp, device=device)
    state = task.build_state()
    gen = torch.Generator(device=task.device).manual_seed(seed)
    loss = float(task.train_step(state, batch, gen)["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss} on route {task.route}")
    return task, state, loss


def _rank_main(n: int, device) -> dict:
    """One rank of ``dryrun_multichip``: its four checks, under the process
    group the launcher's environment describes."""
    from fastdiff_tpu_torch.parallel import mesh as meshlib
    device = checked_device(device)
    if not meshlib.maybe_initialize_distributed({"multihost": True},
                                                device):
        raise RuntimeError("no process group")
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    rank = torch.distributed.get_rank()
    out = {"rank": rank, "world": torch.distributed.get_world_size(),
           "backend": torch.distributed.get_backend()}
    hp = dict(TINY, max_sentences=n)
    task, state, out["toy_loss"] = _step(hp, device, _batch(n, 8, (0, 1)), 0)
    if state.ddp is None or task.mesh.world_size != n:
        raise RuntimeError("the toy step did not run data parallel")
    ncl = dict(hp, use_pallas_block="ncl_vjp")
    if device.type == "cuda":
        ncl.update(FULL, compute_dtype="bfloat16")
    ncl_task, _, out["ncl_vjp_loss"] = _step(ncl, device,
                                             _batch(n, 16, (5, 6)), 0)
    if ncl_task.route != "ncl_vjp":
        raise RuntimeError(f"ncl_vjp resolved to {ncl_task.route}")
    if rank == 0:
        out["chunked_samples"] = _chunked(task, state, n, device)
    _, _, out["full_loss"] = _step(dict(hp, **FULL), device,
                                   _batch(n, 16, (3, 4)), 1)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return out


def _chunked(task, state, n: int, device) -> int:
    """16 x n frames through ``DistributedChunkedVocoder`` over the ranks'
    devices (the CPU n times, or cards 0..n-1), N = 4, chunks of 16 frames
    with a halo of 4."""
    from fastdiff_tpu_torch.diffusion import schedules
    from fastdiff_tpu_torch.diffusion.sampler import (inference_generator,
                                                      make_sampler)
    from fastdiff_tpu_torch.serving.chunked_vocoder import \
        DistributedChunkedVocoder
    devices = ([torch.device("cuda", i) for i in range(n)]
               if device.type == "cuda" else [torch.device("cpu")] * n)
    weights = task.inference_state_dict(state.model.state_dict())
    const = schedules.sampler_constants_for_schedule(
        schedules.noise_schedule_for_steps(4),
        schedules.compute_hyperparams_given_schedule(
            schedules.linear_beta_schedule(task.diff_cfg)))
    samplers = []
    for dev in devices:
        model = task.inference_model(weights).to(dev)
        samplers.append(make_sampler(model, const))
    voc = DistributedChunkedVocoder(samplers, hop_size=256, devices=devices,
                                    chunk_frames=16, halo_frames=4)
    mel = np.random.default_rng(2).standard_normal(
        (16 * n, 80)).astype(np.float32)
    wav = voc.vocode(mel, generator=inference_generator(0, device))
    if wav.shape != (mel.shape[0] * 256,) or not np.isfinite(wav).all():
        raise RuntimeError(f"chunked vocoding gave {wav.shape}, finite "
                           f"{bool(np.isfinite(wav).all())}")
    return int(wav.shape[0])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout: float = 900) -> list:
    """JAX's dry run over ``n_devices`` ranks (module docstring), one
    process each: NCCL ranks on cards when ``device`` is CUDA (the
    default; no card raises), gloo ranks on the CPU when the caller asks
    for it; each rank's results ({rank, world, backend, losses, chunked
    samples}), rank order."""
    device = checked_device(device)
    if device.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise ValueError(f"need {n_devices} cards, have "
                         f"{torch.cuda.device_count()}")
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = []
    for rank in range(n_devices):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(n_devices), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [root] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "fastdiff_tpu_torch.scripts.graft_entry",
             "--rank-of", str(n_devices), "--device", device.type],
            env=env, cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for p, log in zip(procs, logs):
        lines = [ln for ln in log.splitlines() if ln.startswith("DRYRUN ")]
        if p.returncode != 0 or not lines:
            raise RuntimeError(f"a dry-run rank exited {p.returncode}:\n"
                               + log[-4000:])
        results.append(json.loads(lines[-1][len("DRYRUN "):]))
    for r in results:
        print(f"| dryrun_multichip({n_devices}) rank {r['rank']}/"
              f"{r['world']} ({r['backend']}): dp train step ok, loss="
              f"{r['toy_loss']:.4f}; ncl_vjp loss={r['ncl_vjp_loss']:.4f}; "
              f"FULL-SIZE (15.3M) loss={r['full_loss']:.4f}"
              + (f"; sp chunked inference ok ({r['chunked_samples']} "
                 "samples)" if "chunked_samples" in r else ""), flush=True)
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ranks", type=int, default=0,
                        help="ranks of the dry run (default: every card, "
                             "or 2 on the CPU)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--rank-of", type=int, default=0,
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank_of:
        torch.set_num_threads(1)
        print("DRYRUN " + json.dumps(_rank_main(args.rank_of, args.device)),
              flush=True)
        return 0
    device = checked_device(args.device)
    n = args.ranks or (torch.cuda.device_count() if device.type == "cuda"
                       else 2)
    dryrun_multichip(n, device)
    fn, example = entry(device)
    out = fn(*example)
    print(f"entry ok: {tuple(out.shape)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
