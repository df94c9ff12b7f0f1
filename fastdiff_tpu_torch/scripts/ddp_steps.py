"""A few data-parallel train steps of ``FastDiffTask`` under ``torchrun``,
written out for comparison with the same steps in one process:

    torchrun --standalone --nproc_per_node 1 \\
        -m fastdiff_tpu_torch.scripts.ddp_steps --out steps.npz [--steps 3]
        [--batch 20] [--frames 100] [--device cuda] [--hparams 'k=v,...']
        [--compare other.npz]

Every rank starts the process group (``parallel/mesh.py:
maybe_initialize_distributed``; NCCL on the card, at any world size, so one
process runs the DDP path too), builds the task from ``--hparams`` (the
recipe's widths and ``use_pallas_block: auto`` by default), draws the same
global batch from a numpy seed and runs ``--steps`` updates with a
generator seeded alike; rank 0 writes each step's loss and the parameters
after the last to ``--out``, and with ``--compare`` the largest relative
differences of the losses and parameters from another run's file (one
world size against another). Each step is timed on the host clock around
synchronized steps. cuDNN runs deterministic (``benchmark`` off) and TF32
is off. ``run_steps`` is the same loop for the one-process side
(``chip_smoke.py`` phase 30).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from fastdiff_tpu_torch.models.fastdiff import checked_device
from fastdiff_tpu_torch.parallel import mesh as meshlib
from fastdiff_tpu_torch.training.task import FastDiffTask
from fastdiff_tpu_torch.utils.hparams import apply_overrides


def deterministic() -> dict:
    """cuDNN deterministic, no benchmark, TF32 off; the flags as set."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"cudnn.deterministic": torch.backends.cudnn.deterministic,
            "cudnn.benchmark": torch.backends.cudnn.benchmark,
            "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}


def run_steps(task: FastDiffTask, steps: int, batch: int, frames: int,
              seed: int = 0, times: list | None = None) -> tuple:
    """``steps`` updates of a seed-0 state on one numpy-seeded batch of
    ``batch`` x ``frames`` frames, drawing from a generator seeded with
    ``seed``: (losses, {name: parameter} after the last, whether the
    state ran under DDP). Each step's seconds go to ``times`` when given
    (the device synchronized around it)."""
    rng = np.random.default_rng(seed)
    hop = int(task.hparams.get("hop_size", 256))
    data = {"wavs": (0.3 * rng.standard_normal((batch, frames * hop, 1)))
            .astype(np.float32),
            "mels": (rng.standard_normal(
                (batch, frames, task.model_cfg.cond_channels)) - 4.0)
            .astype(np.float32)}
    state = task.build_state(seed=0)
    gen = torch.Generator(device=task.device).manual_seed(seed + 1)
    losses = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(task.train_step(state, data, gen)["loss"]))
        if times is not None:
            times.append(time.perf_counter() - t0)
    return losses, {k: p.detach().float().cpu().numpy()
                    for k, p in state.model.named_parameters()}, \
        state.ddp is not None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", required=True)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--batch", type=int, default=20)
    parser.add_argument("--frames", type=int, default=100)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--hparams", default="")
    parser.add_argument("--compare", default="")
    args = parser.parse_args(argv)
    device = checked_device(args.device)
    flags = deterministic()
    meshlib.maybe_initialize_distributed({"multihost": True}, device)
    hp = {"use_pallas_block": "auto"}
    if args.hparams:
        apply_overrides(hp, args.hparams)
    task = FastDiffTask(hp, device=device)
    times = []
    losses, params, ddp = run_steps(task, args.steps, args.batch,
                                    args.frames, times=times)
    mesh = task.mesh
    print(f"| rank {mesh.rank}/{mesh.world_size} "
          f"({torch.distributed.get_backend()}) route {task.route} ddp {ddp} "
          f"flags {flags} losses " + ", ".join(f"{v:.6f}" for v in losses)
          + "; ms per step " + ", ".join(f"{t * 1e3:.2f}" for t in times),
          flush=True)
    if mesh.rank == 0:
        np.savez(args.out, losses=np.asarray(losses), ddp=ddp,
                 world_size=mesh.world_size,
                 **{"p:" + k: v for k, v in params.items()})
        if args.compare:
            other = np.load(args.compare)
            loss_rel = np.abs(np.asarray(losses) - other["losses"]) / np.abs(
                other["losses"])
            param_rel = max(
                float(np.linalg.norm(v - other["p:" + k])
                      / max(np.linalg.norm(other["p:" + k]), 1e-30))
                for k, v in params.items())
            print(f"| against {args.compare} (world size "
                  f"{int(other['world_size'])}): loss rel per step "
                  + ", ".join(f"{v:.2e}" for v in loss_rel)
                  + f"; max parameter rel_l2 {param_rel:.2e}", flush=True)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
