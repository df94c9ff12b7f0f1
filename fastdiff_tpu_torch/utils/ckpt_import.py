"""Import of released FastDiff checkpoints (``fastdiff_tpu/utils/ckpt_import.py``).

The released checkpoints store a torch ``state_dict`` under
``ckpt['state_dict']['model']`` (or flat with ``model.`` prefixes, or bare)
with weight norm as ``weight_g`` / ``weight_v`` pairs on every conv
(reference: modules/FastDiff/module/FastDiff_model.py:115-122,
utils/trainer.py:424-437 for the envelope).

``convert_torch_state_dict`` is JAX's conversion, copied in numpy: it
builds the JAX parameter tree (conv (O, I, K) -> (K, I, O); transposed conv
(I, O, K) flipped -> (K, I, O); dense transposed; the KernelPredictor's
residual convs at ``_RESIDUAL_CONV_IDX``; the kernel conv's output channels
permuted to (layers, K, Cin, Cout)), with (v, g) pairs or, with ``fuse``,
fused weights. The port's state_dicts come from that tree through
``models/bridge.py`` (``params_from_jax`` for the inference ``FastDiff``,
``trainable_params_from_jax`` for the trainable one), so the layout rules
live in one tested place. Files are read with ``torch.load(...,
weights_only=True)``: tensors, numbers and containers only.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from fastdiff_tpu_torch.config import ModelConfig
from fastdiff_tpu_torch.models import bridge

# Sequential indices of the 6 convs inside the reference KernelPredictor's
# residual_conv (Dropout/LeakyReLU interleaving, modules.py:297-313).
_RESIDUAL_CONV_IDX = (1, 3, 6, 8, 11, 13)


def _np(tensor) -> np.ndarray:
    if hasattr(tensor, "detach"):
        return tensor.detach().cpu().numpy()
    return np.asarray(tensor)


def _conv_from_torch(sd: Dict, prefix: str, fuse: bool) -> dict:
    """Convert one torch Conv1d (weight-normed or plain) to our param dict."""
    bias = _np(sd[f"{prefix}.bias"]).astype(np.float32)
    if f"{prefix}.weight_v" in sd:
        v = _np(sd[f"{prefix}.weight_v"]).astype(np.float32)     # (O, I, K)
        g = _np(sd[f"{prefix}.weight_g"]).astype(np.float32).reshape(-1)
        v = v.transpose(2, 1, 0)                                  # (K, I, O)
        if fuse:
            norm = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))
            return {"w": (g[None, None, :] * v / norm).astype(np.float32),
                    "b": bias}
        return {"v": v, "g": g, "b": bias}
    w = _np(sd[f"{prefix}.weight"]).astype(np.float32).transpose(2, 1, 0)
    return {"w": w, "b": bias}


def _conv_transpose_from_torch(sd: Dict, prefix: str, fuse: bool) -> dict:
    bias = _np(sd[f"{prefix}.bias"]).astype(np.float32)
    if f"{prefix}.weight_v" in sd:
        v = _np(sd[f"{prefix}.weight_v"]).astype(np.float32)      # (I, O, K)
        g = _np(sd[f"{prefix}.weight_g"]).astype(np.float32).reshape(-1)
        v = v[:, :, ::-1].transpose(2, 0, 1).copy()               # (K, I, O)
        if fuse:
            norm = np.sqrt((v ** 2).sum(axis=(0, 2), keepdims=True))
            return {"w": (g[None, :, None] * v / norm).astype(np.float32),
                    "b": bias}
        return {"v": v, "g": g, "b": bias}
    w = _np(sd[f"{prefix}.weight"]).astype(np.float32)
    return {"w": w[:, :, ::-1].transpose(2, 0, 1).copy(), "b": bias}


def _dense_from_torch(sd: Dict, prefix: str) -> dict:
    return {"w": _np(sd[f"{prefix}.weight"]).astype(np.float32).T.copy(),
            "b": _np(sd[f"{prefix}.bias"]).astype(np.float32)}


def convert_torch_state_dict(sd: Dict, cfg: ModelConfig,
                             fuse: bool = False) -> dict:
    """Torch FastDiff state_dict -> our parameter pytree (numpy leaves)."""
    n_blocks = len(cfg.upsample_ratios)
    params = {
        "first_audio_conv": _conv_from_torch(sd, "first_audio_conv", fuse),
        "final_conv": _conv_from_torch(sd, "final_conv.0", fuse),
        "fc_t1": _dense_from_torch(sd, "fc_t1"),
        "fc_t2": _dense_from_torch(sd, "fc_t2"),
        "downsample": [],
        "lvc_blocks": [],
    }
    # kernel_conv output-channel permutation: the reference predicts kernels
    # in C-order (layers, Cin, Cout, K) (modules.py:333-338); our model
    # stores them in (layers, K, Cin, Cout) order so the per-frame reshape
    # is layout-free (models/fastdiff.py _kernel_predictor_apply).
    layers = cfg.lvc_layers_each_block
    cin = cfg.inner_channels
    cout = 2 * cfg.inner_channels
    ksz = cfg.lvc_kernel_size
    old = np.arange(layers * cin * cout * ksz).reshape(layers, cin, cout, ksz)
    kernel_perm = old.transpose(0, 3, 1, 2).reshape(-1)  # new_idx -> old_idx

    def permute_out_channels(p: dict, perm: np.ndarray) -> dict:
        out = dict(p)
        for key in ("w", "v"):
            if key in out:
                out[key] = np.ascontiguousarray(out[key][..., perm])
        for key in ("g", "b"):
            if key in out:
                out[key] = np.ascontiguousarray(out[key][perm])
        return out

    for n in range(n_blocks):
        params["downsample"].append({
            "residual_dense": _conv_from_torch(
                sd, f"downsample.{n}.residual_dense", fuse),
            "convs": [
                _conv_from_torch(sd, f"downsample.{n}.conv.{i}", fuse)
                for i in range(3)
            ],
        })
        kp = f"lvc_blocks.{n}.kernel_predictor"
        params["lvc_blocks"].append({
            "upsample": _conv_transpose_from_torch(
                sd, f"lvc_blocks.{n}.upsample", fuse),
            "fc_t": _dense_from_torch(sd, f"lvc_blocks.{n}.fc_t"),
            "convs": [
                _conv_from_torch(sd, f"lvc_blocks.{n}.convs.{i}", fuse)
                for i in range(cfg.lvc_layers_each_block)
            ],
            "kernel_predictor": {
                "input_conv": _conv_from_torch(sd, f"{kp}.input_conv.0", fuse),
                "residual_convs": [
                    _conv_from_torch(sd, f"{kp}.residual_conv.{i}", fuse)
                    for i in _RESIDUAL_CONV_IDX
                ],
                "kernel_conv": permute_out_channels(
                    _conv_from_torch(sd, f"{kp}.kernel_conv", fuse),
                    kernel_perm),
                "bias_conv": _conv_from_torch(sd, f"{kp}.bias_conv", fuse),
            },
        })
    return params


def released_state_dict(saved: dict):
    """The model ``state_dict`` in a loaded released checkpoint (the
    trainer envelope ``{'state_dict': {'model': ...}}``, flat ``model.``
    keys, or bare; reference: utils/ckpt_utils.py:36-61 tolerates all
    three), or None when ``saved`` is not one (the port's own checkpoints
    name the final conv ``final_conv``, the reference ``final_conv.0``)."""
    sd = saved.get("state_dict", saved)
    if "model" in sd and not any(k.startswith("first_audio_conv")
                                 for k in sd):
        sd = sd["model"]
    sd = {k[len("model."):] if k.startswith("model.") else k: v
          for k, v in sd.items()}
    return sd if "final_conv.0.bias" in sd else None


def load_torch_checkpoint(path: str, cfg: ModelConfig,
                          fuse: bool = False) -> dict:
    """A released ``.ckpt`` file -> the JAX parameter tree (numpy leaves),
    as JAX's ``load_torch_checkpoint``; raises for a file of another
    kind."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    sd = released_state_dict(saved)
    if sd is None:
        raise ValueError(f"{path} is not a released FastDiff checkpoint")
    return convert_torch_state_dict(sd, cfg, fuse=fuse)


def inference_state_dict(sd: Dict, cfg: ModelConfig,
                         fuse: bool = False) -> dict:
    """A released model ``state_dict`` -> the inference ``FastDiff``
    state_dict: weight norm fused by ``params_from_jax`` (JAX's
    ``fuse_weight_norm``), or with ``fuse`` by the conversion itself
    (JAX's ``fuse=True``)."""
    return bridge.params_from_jax(convert_torch_state_dict(sd, cfg, fuse),
                                  cfg)


def trainable_state_dict(sd: Dict, cfg: ModelConfig) -> dict:
    """A released model ``state_dict`` -> the trainable ``FastDiff``
    state_dict (weight norm kept as v / g)."""
    return bridge.trainable_params_from_jax(convert_torch_state_dict(sd, cfg),
                                            cfg)
