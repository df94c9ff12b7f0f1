"""Correctness drive of the saved-residual training route on the card (the
twin of ``scripts/drive_ncl_sr.py``): one train step at the reference
recipe (20 x 25,600 samples, bf16) on ``use_pallas_block: ncl_sr`` (K3 and
K4) beside the same step on the plain route (JAX's ``xla``).

    python -m fastdiff_tpu_torch.scripts.drive_ncl_sr [--batch 20]
        [--frames 100] [--hparams 'k=v,...']

Both routes start from the seed-0 weights and take the batch of JAX's
drive (numpy seed 0: mels N(0, 1), wavs N(0, 0.3^2)) with one set of t
and z drawn from a generator on the device seeded 1. For each route it
prints the loss, the global gradient norm and whether the loss and every
gradient leaf are finite, then runs ``FastDiffTask.train_step`` (clip and
AdamW) once; it prints ``DRIVE OK`` and exits 0 when every value is
finite, the update was taken, the losses agree within 5e-2 relative and
the gradient norms within 1e-1 (JAX's bf16 bounds), else ``DRIVE
MISMATCH`` and exits 1. ``drive`` is the check
(``tests/test_torch_script_twins.py`` runs it at a small width on the
CPU).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fastdiff_tpu_torch.models.fastdiff import checked_device
from fastdiff_tpu_torch.training.optim import global_norm
from fastdiff_tpu_torch.training.task import FastDiffTask
from fastdiff_tpu_torch.utils.hparams import apply_overrides

BATCH, FRAMES = 20, 100
LOSS_REL, GNORM_REL = 5e-2, 1e-1


def drive(device="cuda", batch: int = BATCH, frames: int = FRAMES,
          hparams: dict | None = None) -> dict:
    """{route: (loss, grad norm, all finite, update taken)} for "plain" and
    "ncl_sr", and "ok"."""
    device = checked_device(device)
    hp = dict(hparams or {})
    tasks = {r: FastDiffTask(dict(hp, use_pallas_block=flag), device=device)
             for r, flag in (("plain", False), ("ncl_sr", "ncl_sr"))}
    if tasks["ncl_sr"].route != "ncl_sr":
        raise ValueError(f"ncl_sr resolved to {tasks['ncl_sr'].route}")
    cfg = tasks["plain"].model_cfg
    rng = np.random.default_rng(0)
    data = {"mels": rng.standard_normal(
                (batch, frames, cfg.cond_channels)).astype(np.float32),
            "wavs": (rng.standard_normal((batch, frames * cfg.total_hop, 1))
                     * 0.3).astype(np.float32)}
    gen = torch.Generator(device=device).manual_seed(1)
    ts = torch.randint(0, 1000, (batch, 1, 1), generator=gen, device=device)
    z = torch.randn((batch, frames * cfg.total_hop, 1), generator=gen,
                    device=device)
    results = {}
    for r, task in tasks.items():
        state = task.build_state(seed=0)
        model = state.model
        loss = task.loss(model, data, ts=ts, z=z)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        finite = bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in grads)
        step = task.train_step(state, data, ts=ts, z=z)
        results[r] = (float(loss.detach()), float(global_norm(grads)),
                      finite, not bool(step["nonfinite"]))
        print(f"| {r}: loss {results[r][0]:.6f} gnorm {results[r][1]:.4f} "
              f"finite={finite} update taken={results[r][3]}", flush=True)
    (lx, gx, *_), (ls, gs, *_) = results["plain"], results["ncl_sr"]
    loss_rel = abs(lx - ls) / max(abs(lx), 1e-9)
    gnorm_rel = abs(gx - gs) / max(abs(gx), 1e-9)
    print(f"| loss rel diff {loss_rel:.2e}; gnorm rel diff {gnorm_rel:.2e}",
          flush=True)
    results["ok"] = (all(all(r[2:]) for r in results.values())
                     and loss_rel < LOSS_REL and gnorm_rel < GNORM_REL)
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=BATCH)
    parser.add_argument("--frames", type=int, default=FRAMES)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--hparams", default="")
    args = parser.parse_args(argv)
    hp = {}
    if args.hparams:
        apply_overrides(hp, args.hparams)
    ok = drive(args.device, args.batch, args.frames, hp)["ok"]
    print("DRIVE", "OK" if ok else "MISMATCH", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
