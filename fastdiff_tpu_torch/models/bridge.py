"""JAX parameter tree -> ``FastDiff`` state_dict (``fastdiff_tpu`` weights in
the port).

Takes the tree of ``fastdiff_tpu.models.fastdiff.init_fastdiff`` (or a
loaded checkpoint of it) with numpy leaves, and returns the port's
``state_dict``:

- weight norm is fused with the JAX formulas (``fuse_weight_norm``,
  ``ops/nn.py:conv_weight``): a conv's norm runs over (K, I) for each output
  channel, a transposed conv's over (K, O) for each input channel, both with
  ``+ 1e-12`` under the square root. An already fused tree (``'w'``
  leaves) is taken as it is;
- conv (K, I, O) -> (O, I, K);
- transposed conv: JAX stores the kernel flipped as (K, I, O); PyTorch's
  (I, O, K) is ``w[::-1].transpose(1, 2, 0)`` (the inverse of
  ``fastdiff_tpu/utils/ckpt_import.py:_conv_transpose_from_torch``);
- dense (I, O) -> (O, I);
- ``kernel_conv`` keeps its (layers, K, Cin, Cout) output-channel order.
"""

from __future__ import annotations

import numpy as np
import torch

from fastdiff_tpu.config import ModelConfig


def _fused(p: dict, transpose: bool) -> np.ndarray:
    if "w" in p:
        return np.asarray(p["w"], np.float32)
    v = np.asarray(p["v"], np.float32)
    g = np.asarray(p["g"], np.float32)
    axes = (0, 2) if transpose else (0, 1)
    norm = np.sqrt(np.sum(v ** 2, axis=axes, keepdims=True) + 1e-12)
    scale = g[None, :, None] if transpose else g[None, None, :]
    return (scale * v / norm).astype(np.float32)


def _conv(p: dict) -> tuple:
    return _fused(p, False).transpose(2, 1, 0), p["b"]


def _conv_transpose(p: dict) -> tuple:
    return _fused(p, True)[::-1].transpose(1, 2, 0), p["b"]


def _dense(p: dict) -> tuple:
    return np.asarray(p["w"], np.float32).T, p["b"]


def params_from_jax(tree: dict, cfg: ModelConfig) -> dict:
    """JAX FastDiff tree (numpy leaves) -> ``FastDiff(cfg)`` state_dict."""
    pairs = {
        "first_audio_conv": _conv(tree["first_audio_conv"]),
        "final_conv": _conv(tree["final_conv"]),
        "fc_t1": _dense(tree["fc_t1"]),
        "fc_t2": _dense(tree["fc_t2"]),
    }
    for n in range(len(cfg.upsample_ratios)):
        down = tree["downsample"][n]
        pairs[f"downsample.{n}.residual_dense"] = _conv(down["residual_dense"])
        for i, conv in enumerate(down["convs"]):
            pairs[f"downsample.{n}.convs.{i}"] = _conv(conv)
        blk = tree["lvc_blocks"][n]
        pre = f"lvc_blocks.{n}"
        pairs[f"{pre}.upsample"] = _conv_transpose(blk["upsample"])
        pairs[f"{pre}.fc_t"] = _dense(blk["fc_t"])
        for i, conv in enumerate(blk["convs"]):
            pairs[f"{pre}.convs.{i}"] = _conv(conv)
        kp = blk["kernel_predictor"]
        kpre = f"{pre}.kernel_predictor"
        pairs[f"{kpre}.input_conv"] = _conv(kp["input_conv"])
        for i, conv in enumerate(kp["residual_convs"]):
            pairs[f"{kpre}.residual_convs.{i}"] = _conv(conv)
        pairs[f"{kpre}.kernel_conv"] = _conv(kp["kernel_conv"])
        pairs[f"{kpre}.bias_conv"] = _conv(kp["bias_conv"])
    state = {}
    for name, (w, b) in pairs.items():
        state[f"{name}.weight"] = torch.tensor(
            np.ascontiguousarray(w, np.float32))
        state[f"{name}.bias"] = torch.tensor(np.asarray(b, np.float32))
    return state
