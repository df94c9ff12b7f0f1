"""Operations the references share: convolutions in float32 with TF32 off,
the sinusoidal step embedding, and the rounding of the control.

``quant`` is applied to every operand of a product (activations and
weights) and to its result: the identity for the reference itself, and
``fp8_round`` for the control, the next precision below the bfloat16 the
configurations state (the program rounds the same operands and results to
bfloat16).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0                     # the largest finite float8 e4m3 value


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` scaled by its absolute maximum onto float8 e4m3's range, rounded
    to float8 e4m3 and scaled back: per-tensor scaled fp8, as fp8 inference
    rounds its operands."""
    t = t.float()
    amax = t.detach().abs().amax()
    scale = FP8_MAX / amax if float(amax) > 0 else 1.0
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


QUANT = {"float32": identity, "fp8": fp8_round}


@contextlib.contextmanager
def exact_float32():
    """Matrix products and cuDNN convolutions in float32, TF32 off."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def conv1d(x, w, b, quant=identity, dilation: int = 1):
    """Stride-1 convolution padded to keep the length: x (B, I, L),
    w (O, I, K)."""
    pad = dilation * (w.shape[-1] - 1) // 2
    return quant(F.conv1d(quant(x), quant(w), b.float(), padding=pad,
                          dilation=dilation))


def linear(x, w, b, quant=identity):
    return quant(F.linear(quant(x), quant(w), b.float()))


def leaky(x, slope: float):
    return F.leaky_relu(x, slope)


def swish(x):
    return x * torch.sigmoid(x)


def step_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """FastDiff's and DiffWave's sinusoidal embedding of the (fractional)
    diffusion step: t (B,) -> (B, dim), sines then cosines of t times
    10000^(-i / (dim/2 - 1))."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float64,
                                   device=t.device)
                      * (-math.log(10000.0) / (half - 1)))
    args = t.double()[:, None] * freqs[None]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=1).float()


def weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """g * v / ||v||: the norm over every axis but the first for a vector
    g, over the whole tensor for a scalar g (1e-12 under the root)."""
    if g.dim() == 0:
        return g * v / torch.sqrt(torch.sum(v * v) + 1e-12)
    dims = tuple(range(1, v.dim()))
    norm = torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True) + 1e-12)
    return g.reshape((-1,) + (1,) * (v.dim() - 1)) * v / norm
