"""NCL conv, transposed conv, dense and activations (``fastdiff_tpu/ops/nn.py``),
with NWC (B, L, C) twins of the convs and the downsample for the NWC route.

Weights are in PyTorch's layouts: ``Conv1d`` (O, I, K), ``ConvTranspose1d``
(I, O, K), ``Linear`` (O, I). Inference takes weights with weight norm
already fused (``models/bridge.py``); training resolves each (v, g) pair on
every call with ``conv_weight`` / ``conv_transpose_weight``, the JAX
formulas, differentiably.

Cast points follow the JAX ops: under a ``compute_dtype`` the input and the
weight are rounded to it, the products accumulate in float32, the bias is
added in float32, and the result is rounded back to ``compute_dtype``. The
convolutions run on float32 copies of the rounded operands, which gives
exactly that (a bf16 value is exact in float32, and in TF32 too).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _cast(x, w, compute_dtype):
    if compute_dtype is None:
        return x, w, torch.float32
    return x.to(compute_dtype), w.to(compute_dtype), compute_dtype


def conv_weight(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight-normed conv kernel: v (O, I, K), g (O,) -> g * v / ||v|| with
    the norm over (I, K) for each output channel, ``+ 1e-12`` under the
    square root (``fastdiff_tpu/ops/nn.py:conv_weight``)."""
    norm = torch.sqrt(torch.sum(v ** 2, dim=(1, 2), keepdim=True) + 1e-12)
    return g[:, None, None] * v / norm


def conv_transpose_weight(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight-normed transposed-conv kernel: v (I, O, K), g (I,) -> the norm
    over (O, K) for each input channel (``conv_transpose_weight`` in JAX).
    In PyTorch's layouts both norms keep dim 0, so the formula is
    ``conv_weight``'s."""
    return conv_weight(v, g)


def conv1d_ncl(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor, *,
               dilation: int = 1, compute_dtype=None) -> torch.Tensor:
    """'Same'-padded stride-1 conv: x (B, I, L), w (O, I, K) -> (B, O, L)."""
    x, w, out_dtype = _cast(x, w, compute_dtype)
    pad = dilation * ((w.shape[-1] - 1) // 2)
    y = F.conv1d(x.float(), w.float(), b.float(), padding=pad,
                 dilation=dilation)
    return y.to(out_dtype)


def conv_transpose1d_ncl(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                         *, stride: int, torch_padding: int,
                         output_padding: int = 0,
                         compute_dtype=None) -> torch.Tensor:
    """Transposed conv: x (B, I, L), w (I, O, K) -> (B, O, L') with
    L' = (L - 1) * stride - 2 * torch_padding + K + output_padding."""
    x, w, out_dtype = _cast(x, w, compute_dtype)
    y = F.conv_transpose1d(x.float(), w.float(), b.float(), stride=stride,
                           padding=torch_padding,
                           output_padding=output_padding)
    return y.to(out_dtype)


def conv1d_nwc(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor, *,
               dilation: int = 1, compute_dtype=None) -> torch.Tensor:
    """``conv1d_ncl`` for NWC activations (``conv1d_dot`` in JAX):
    x (B, L, I), w (O, I, K) -> (B, L, O), the same cast points."""
    return conv1d_ncl(w, b, x.transpose(1, 2), dilation=dilation,
                      compute_dtype=compute_dtype).transpose(1, 2)


def conv_transpose1d_nwc(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                         *, stride: int, torch_padding: int,
                         output_padding: int = 0,
                         compute_dtype=None) -> torch.Tensor:
    """``conv_transpose1d_ncl`` for NWC activations
    (``conv_transpose1d_dot`` in JAX): x (B, L, I) -> (B, L', O)."""
    return conv_transpose1d_ncl(
        w, b, x.transpose(1, 2), stride=stride, torch_padding=torch_padding,
        output_padding=output_padding,
        compute_dtype=compute_dtype).transpose(1, 2)


def dense(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
          compute_dtype=None) -> torch.Tensor:
    """x (..., I) @ w (O, I).T + b -> float32 (the JAX ``dense`` keeps the
    float32 accumulator and never casts back)."""
    x, w, _ = _cast(x, w, compute_dtype)
    return F.linear(x.float(), w.float()) + b.float()


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def nearest_downsample_ncl(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour ``interpolate(size=L // factor)`` == strided slice."""
    return x[..., ::factor]


def nearest_downsample_nwc(x: torch.Tensor, factor: int) -> torch.Tensor:
    """``nearest_downsample`` for NWC (B, L, C): the phase-0 strided pick."""
    return x[:, ::factor]


def diffusion_step_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding of fractional steps: t (B, 1) -> (B, dim) f32."""
    half = dim // 2
    freqs = torch.exp(math.log(10000.0) / (half - 1) * -torch.arange(
        half, dtype=torch.float32, device=t.device))
    args = t.float() * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


@torch.no_grad()
def uniform_init_(module: torch.nn.Module, generator: torch.Generator):
    """PyTorch's default initialization of every ``Conv1d`` / ``Conv2d`` /
    ``Linear`` in ``module``, drawn from ``generator``: weight and bias
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in = weight[0].numel() (the
    JAX package's ``conv1d_init`` / ``dense_init``)."""
    for sub in module.modules():
        if isinstance(sub, (torch.nn.Conv1d, torch.nn.Conv2d,
                            torch.nn.Linear)):
            bound = sub.weight[0].numel() ** -0.5
            sub.weight.uniform_(-bound, bound, generator=generator)
            if sub.bias is not None:
                sub.bias.uniform_(-bound, bound, generator=generator)
