"""JAX parameter tree <-> ``FastDiff`` state_dict (``fastdiff_tpu`` weights in
the port).

Takes the tree of ``fastdiff_tpu.models.fastdiff.init_fastdiff`` (or a
loaded checkpoint of it) with numpy leaves. Layouts:

- conv (K, I, O) -> (O, I, K);
- transposed conv: JAX stores the kernel flipped as (K, I, O); PyTorch's
  (I, O, K) is ``w[::-1].transpose(1, 2, 0)`` (the inverse of
  ``fastdiff_tpu/utils/ckpt_import.py:_conv_transpose_from_torch``);
- dense (I, O) -> (O, I);
- ``kernel_conv`` keeps its (layers, K, Cin, Cout) output-channel order.

Three directions:

- ``params_from_jax``: the inference model's state_dict. Weight norm is
  fused with the JAX formulas (``ops/nn.py:conv_weight``): a conv's norm
  runs over (K, I) for each output channel, a transposed conv's over (K, O)
  for each input channel, both with ``+ 1e-12`` under the square root. An
  already fused tree (``'w'`` leaves) is taken as it is;
- ``trainable_params_from_jax``: the trainable model's state_dict
  (``FastDiff(cfg, train_route=...)``), weight norm kept: ``v`` in the
  layouts above, ``g`` as it is (one entry per output channel of a conv,
  per input channel of a transposed conv);
- ``params_to_jax``: a trainable state_dict (or anything keyed like it,
  such as its gradients) back to the JAX tree, numpy leaves in JAX's
  layouts. It inverts ``trainable_params_from_jax`` exactly: every step is
  a transpose or a flip.

FastSpeech 2 (``fs2_params_from_jax`` / ``fs2_params_to_jax``) and the BDDM
noise predictor (``phi_params_from_jax`` / ``phi_params_to_jax``) convert
both ways in the same layouts.
"""

from __future__ import annotations

import numpy as np
import torch

from fastdiff_tpu_torch.config import ModelConfig


def _entries(cfg: ModelConfig) -> list:
    """(state_dict prefix, JAX tree path, kind) of every layer; kind is
    'conv', 'conv_t' or 'dense'."""
    out = [("first_audio_conv", ("first_audio_conv",), "conv"),
           ("final_conv", ("final_conv",), "conv"),
           ("fc_t1", ("fc_t1",), "dense"),
           ("fc_t2", ("fc_t2",), "dense")]
    for n in range(len(cfg.upsample_ratios)):
        down = ("downsample", n)
        out.append((f"downsample.{n}.residual_dense",
                    down + ("residual_dense",), "conv"))
        out += [(f"downsample.{n}.convs.{i}", down + ("convs", i), "conv")
                for i in range(3)]
        pre, blk = f"lvc_blocks.{n}", ("lvc_blocks", n)
        out.append((f"{pre}.upsample", blk + ("upsample",), "conv_t"))
        out.append((f"{pre}.fc_t", blk + ("fc_t",), "dense"))
        out += [(f"{pre}.convs.{i}", blk + ("convs", i), "conv")
                for i in range(cfg.lvc_layers_each_block)]
        kpre, kp = f"{pre}.kernel_predictor", blk + ("kernel_predictor",)
        out.append((f"{kpre}.input_conv", kp + ("input_conv",), "conv"))
        out += [(f"{kpre}.residual_convs.{i}", kp + ("residual_convs", i),
                 "conv") for i in range(6)]
        out.append((f"{kpre}.kernel_conv", kp + ("kernel_conv",), "conv"))
        out.append((f"{kpre}.bias_conv", kp + ("bias_conv",), "conv"))
    return out


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _set(tree, path, value) -> None:
    """Set ``tree[path]``, making dicts and lists (for int keys) on the way."""
    for key, nxt in zip(path, path[1:] + (None,)):
        if isinstance(tree, list):
            tree.extend([None] * (key + 1 - len(tree)))
        if nxt is None:
            tree[key] = value
            return
        if isinstance(tree, dict):
            tree = tree.setdefault(key, [] if isinstance(nxt, int) else {})
            continue
        if tree[key] is None:
            tree[key] = [] if isinstance(nxt, int) else {}
        tree = tree[key]


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _fused(p: dict, transpose: bool) -> np.ndarray:
    if "w" in p:
        return _f32(p["w"])
    v = _f32(p["v"])
    g = _f32(p["g"])
    axes = (0, 2) if transpose else (0, 1)
    norm = np.sqrt(np.sum(v ** 2, axis=axes, keepdims=True) + 1e-12)
    scale = g[None, :, None] if transpose else g[None, None, :]
    return (scale * v / norm).astype(np.float32)


def _to_torch(w: np.ndarray, kind: str) -> np.ndarray:
    """A JAX kernel in the PyTorch layout of ``kind``."""
    if kind == "conv":
        return w.transpose(2, 1, 0)
    if kind == "conv_t":
        return w[::-1].transpose(1, 2, 0)
    return w.T


def _from_torch(w: np.ndarray, kind: str) -> np.ndarray:
    """Inverse of ``_to_torch``."""
    if kind == "conv":
        return w.transpose(2, 1, 0)
    if kind == "conv_t":
        return w.transpose(2, 0, 1)[::-1]
    return w.T


def _tensor(a) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a, np.float32))


def params_from_jax(tree: dict, cfg: ModelConfig) -> dict:
    """JAX FastDiff tree (numpy leaves) -> ``FastDiff(cfg)`` state_dict."""
    state = {}
    for name, path, kind in _entries(cfg):
        p = _get(tree, path)
        w = _f32(p["w"]) if kind == "dense" else _fused(p, kind == "conv_t")
        state[f"{name}.weight"] = _tensor(_to_torch(w, kind))
        state[f"{name}.bias"] = _tensor(p["b"])
    return state


def trainable_params_from_jax(tree: dict, cfg: ModelConfig) -> dict:
    """JAX FastDiff tree with (v, g) leaves -> the state_dict of
    ``FastDiff(cfg, train_route=...)``, weight norm kept."""
    state = {}
    for name, path, kind in _entries(cfg):
        p = _get(tree, path)
        if "v" in p:
            state[f"{name}.v"] = _tensor(_to_torch(_f32(p["v"]), kind))
            state[f"{name}.g"] = _tensor(p["g"])
        else:
            state[f"{name}.weight"] = _tensor(_to_torch(_f32(p["w"]), kind))
        state[f"{name}.bias"] = _tensor(p["b"])
    return state


def params_to_jax(state: dict, cfg: ModelConfig) -> dict:
    """A trainable state_dict (or tensors keyed like one) -> the JAX tree,
    numpy float32 leaves in JAX's layouts."""
    tree: dict = {}
    for name, path, kind in _entries(cfg):
        def get(key):
            return state[f"{name}.{key}"].detach().cpu().float().numpy()
        if f"{name}.v" in state:
            p = {"v": np.ascontiguousarray(_from_torch(get("v"), kind)),
                 "g": get("g")}
        else:
            p = {"w": np.ascontiguousarray(_from_torch(get("weight"), kind))}
        p["b"] = get("bias")
        _set(tree, path, p)
    return tree


def _fs2_leaves(tree, path=()):
    """(path, kind, leaf) of every layer of a JAX FastSpeech 2 tree; kind
    is 'ln', 'conv', 'dense' or 'embed'."""
    if isinstance(tree, dict):
        if "scale" in tree:
            yield path, "ln", tree
        elif "w" in tree:
            yield path, "conv" if np.ndim(tree["w"]) == 3 else "dense", tree
        else:
            for key, sub in tree.items():
                yield from _fs2_leaves(sub, path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _fs2_leaves(sub, path + (i,))
    else:
        yield path, "embed", tree


def _check_fs2_depth(n_enc: int, n_dec: int, cfg) -> None:
    if (n_enc, n_dec) != (cfg.enc_layers, cfg.dec_layers):
        raise ValueError(f"the tree has {n_enc} + {n_dec} layers, the config "
                         f"{cfg.enc_layers} + {cfg.dec_layers}")


def fs2_params_from_jax(tree: dict, cfg) -> dict:
    """JAX FastSpeech 2 tree (numpy leaves) -> ``FastSpeech2(cfg)``
    state_dict."""
    _check_fs2_depth(len(tree["encoder"]), len(tree["decoder"]), cfg)
    state = {}
    for path, kind, p in _fs2_leaves(tree):
        name = ".".join(map(str, path))
        if kind == "embed":
            state[f"{name}.weight"] = _tensor(p)
            continue
        w = p["scale"] if kind == "ln" else _to_torch(_f32(p["w"]), kind)
        state[f"{name}.weight"] = _tensor(w)
        state[f"{name}.bias"] = _tensor(p["bias" if kind == "ln" else "b"])
    return state


def fs2_params_to_jax(state: dict, cfg) -> dict:
    """A ``FastSpeech2(cfg)`` state_dict -> the JAX tree, numpy float32
    leaves in JAX's layouts."""
    tree: dict = {}
    for key in state:
        name, leaf = key.rsplit(".", 1)
        if leaf != "weight":
            continue
        w = state[key].detach().cpu().float().numpy()
        path = tuple(int(k) if k.isdigit() else k for k in name.split("."))
        if f"{name}.bias" not in state:
            _set(tree, path, w)
            continue
        b = state[f"{name}.bias"].detach().cpu().float().numpy()
        if w.ndim == 1:
            _set(tree, path, {"scale": w, "bias": b})
        else:
            kind = "conv" if w.ndim == 3 else "dense"
            _set(tree, path, {"w": np.ascontiguousarray(_from_torch(w, kind)),
                              "b": b})
    _check_fs2_depth(len(tree["encoder"]), len(tree["decoder"]), cfg)
    return tree


def phi_params_from_jax(tree: dict) -> dict:
    """JAX noise-predictor tree (``init_noise_predictor``: ``convs``, a list
    of (K, I, O) convs, and dense ``fc1``, ``fc2``) -> ``NoisePredictor``
    state_dict: conv weights (O, I, K), dense (O, I)."""
    layers = [(f"convs.{i}", p, "conv") for i, p in enumerate(tree["convs"])]
    layers += [(name, tree[name], "dense") for name in ("fc1", "fc2")]
    state = {}
    for name, p, kind in layers:
        state[f"{name}.weight"] = _tensor(_to_torch(_f32(p["w"]), kind))
        state[f"{name}.bias"] = _tensor(p["b"])
    return state


def phi_params_to_jax(state: dict) -> dict:
    """A ``NoisePredictor`` state_dict (or anything keyed like it, such as
    its gradients) -> JAX's tree, numpy float32 leaves in JAX's layouts;
    the inverse of ``phi_params_from_jax``."""
    def layer(name: str, kind: str) -> dict:
        w = state[f"{name}.weight"].detach().cpu().float().numpy()
        return {"w": np.ascontiguousarray(_from_torch(w, kind)),
                "b": state[f"{name}.bias"].detach().cpu().float().numpy()}

    n_convs = len({k.split(".")[1] for k in state if k.startswith("convs.")})
    return {"convs": [layer(f"convs.{i}", "conv") for i in range(n_convs)],
            "fc1": layer("fc1", "dense"), "fc2": layer("fc2", "dense")}


# ---------------------------------------------------------------------------
# The other model families: speaker encoder, WaveNet, PWG, diffusion PWG and
# MoL WaveNet. Their port modules carry the JAX trees' names (a dotted path
# per layer), so one walk converts each: "w" -> "weight" (in PyTorch's
# layout), "b" -> "bias", "v" and "g" kept (weight norm). By shape and
# name: a 2-D "w" is a dense layer (transposed), but under
# ``embed_speakers`` a lookup table (as it is); 3-D a conv; 4-D (KH, KW, I,
# O) a Conv2d, (O, I, KH, KW), except under ``upsamplers`` (the WaveNet
# mel upsamplers), where JAX stores a ConvTranspose2d kernel flipped in both
# spatial axes: PyTorch's (I, O, KH, KW) is ``v[::-1, ::-1]`` transposed.
# ---------------------------------------------------------------------------

def _zoo_layers(tree, path=()):
    """(dotted path, layer dict) of every layer of a JAX tree."""
    if isinstance(tree, dict) and any(k in tree for k in ("w", "v")):
        yield ".".join(map(str, path)), tree
    elif isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _zoo_layers(sub, path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _zoo_layers(sub, path + (i,))


def _zoo_to_torch(name: str, a: np.ndarray) -> np.ndarray:
    if a.ndim == 2 and "embed_speakers" not in name:
        return a.T
    if a.ndim == 3:
        return a.transpose(2, 1, 0)
    if a.ndim == 4 and "upsamplers" in name:
        return a[::-1, ::-1].transpose(2, 3, 0, 1)
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    return a


def _zoo_from_torch(name: str, a: np.ndarray) -> np.ndarray:
    """Inverse of ``_zoo_to_torch``."""
    if a.ndim == 2 and "embed_speakers" not in name:
        return a.T
    if a.ndim == 3:
        return a.transpose(2, 1, 0)
    if a.ndim == 4 and "upsamplers" in name:
        return a.transpose(2, 3, 0, 1)[::-1, ::-1]
    if a.ndim == 4:
        return a.transpose(2, 3, 1, 0)
    return a


_ZOO_LEAVES = (("w", "weight"), ("b", "bias"), ("v", "v"), ("g", "g"))


def zoo_params_from_jax(tree: dict) -> dict:
    """A JAX tree of the speaker encoder (``init_spk_encoder``), WaveNet
    (``init_wavenet``, weight norm kept), PWG (``init_pwg``), diffusion PWG
    (``init_pwg_diffusion``) or MoL WaveNet (``init_wavenet_mol``), numpy
    leaves -> the state_dict of the port's ``SpeakerEncoder``,
    ``WaveNet``, ``PWG``, ``PWGDiffusion`` or ``MoLWaveNet``."""
    state = {}
    for name, layer in _zoo_layers(tree):
        for jax_key, key in _ZOO_LEAVES:
            if jax_key in layer:
                a = _f32(layer[jax_key])
                if jax_key in ("w", "v"):
                    a = _zoo_to_torch(name, a)
                # np.array copies into a contiguous array and, unlike
                # np.ascontiguousarray, keeps a 0-d g (the upsamplers') 0-d
                state[f"{name}.{key}"] = torch.from_numpy(np.array(a))
    return state


def zoo_params_to_jax(state: dict) -> dict:
    """A state_dict of one of those modules (or tensors keyed like it, such
    as its gradients) -> the JAX tree, numpy float32 leaves; the inverse of
    ``zoo_params_from_jax``."""
    tree: dict = {}
    for full, value in state.items():
        name, key = full.rsplit(".", 1)
        jax_key = {k: j for j, k in _ZOO_LEAVES}[key]
        a = value.detach().cpu().float().numpy()
        if jax_key in ("w", "v"):
            a = _zoo_from_torch(name, a)
        path = tuple(int(k) if k.isdigit() else k for k in name.split("."))
        _set(tree, path + (jax_key,), np.array(a))
    return tree
