"""Checkpoint files of the trainer (``fastdiff_tpu/training/checkpoint.py``).

- ``model_ckpt_steps_<N>.ckpt`` per save, only the newest ``num_keep``
  kept;
- ``model_ckpt_best.pt`` beside them for the best validation score;
- every file written to ``<name>.part`` and renamed into place, so a
  reader never sees half a file;
- ``get_last_checkpoint`` finds the newest step (or a pinned one).

A file is ``torch.save`` of a dict of tensors and numbers (the JAX package
writes msgpack through flax): params, optimizer state, step, best_val and
the EMA when one is kept.
"""

from __future__ import annotations

import glob
import os
import re
import shutil
from typing import Optional, Tuple

import torch


def _replace(write, path: str) -> None:
    tmp = path + ".part"
    write(tmp)
    os.replace(tmp, path)


def save_checkpoint(work_dir: str, step: int, state: dict,
                    num_keep: int = 3, is_best: bool = False) -> str:
    """Write ``state`` atomically as step ``step``; prune old ones."""
    os.makedirs(work_dir, exist_ok=True)
    path = os.path.join(work_dir, f"model_ckpt_steps_{step}.ckpt")
    _replace(lambda tmp: torch.save(state, tmp), path)
    if is_best:
        _replace(lambda tmp: shutil.copyfile(path, tmp),
                 os.path.join(work_dir, "model_ckpt_best.pt"))
    for old in sorted(glob.glob(os.path.join(work_dir,
                                             "model_ckpt_steps_*.ckpt")),
                      key=_ckpt_step)[:-num_keep]:
        os.remove(old)
        print(f"| Deleted old checkpoint: {os.path.basename(old)}")
    return path


def _ckpt_step(path: str) -> int:
    m = re.search(r"model_ckpt_steps_(\d+)\.ckpt", path)
    return int(m.group(1)) if m else -1


def get_last_checkpoint(work_dir: str, steps: Optional[int] = None
                        ) -> Tuple[Optional[str], int]:
    """Newest (or pinned-step) checkpoint path and its step."""
    if steps:
        path = os.path.join(work_dir, f"model_ckpt_steps_{steps}.ckpt")
        return (path, steps) if os.path.exists(path) else (None, 0)
    paths = sorted(glob.glob(os.path.join(work_dir,
                                          "model_ckpt_steps_*.ckpt")),
                   key=_ckpt_step)
    if not paths:
        return None, 0
    return paths[-1], _ckpt_step(paths[-1])


def load_checkpoint(path: str, map_location=None) -> dict:
    return torch.load(path, map_location=map_location, weights_only=True)
