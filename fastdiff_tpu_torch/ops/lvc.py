"""Location-variable convolution, NCL (``fastdiff_tpu/ops/lvc.py``).

The waveform is cut into frames of ``hop`` samples and each frame is
convolved with its own kernel, predicted from its mel frame:

    out[b, o, f*hop + t] = bias[b, f, o]
        + sum_{k, i} x_pad[b, i, f*hop + t + k] * kernel[b, f, k, i, o]

with ``x_pad`` zero-padded by (K-1)//2 on both sides. Plain PyTorch: this is
the oracle that the LVC block's plain version (``ops/lvc_block_ncl.py``) is
written against. The ``_nwc`` entries take (B, L, C) activations, the JAX
functions' own layout; the NWC route's plain block
(``ops/lvc_block_pallas.py``) and its hop-8 block run them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def location_variable_convolution(x: torch.Tensor, kernel: torch.Tensor,
                                  bias: torch.Tensor,
                                  hop: int) -> torch.Tensor:
    """x (B, Cin, L), kernel (B, F, K, Cin, Cout), bias (B, F, Cout)
    -> (B, Cout, L) float32, accumulated in float32."""
    b, cin, length = x.shape
    _, frames, k, _, cout = kernel.shape
    if length != frames * hop:
        raise ValueError(f"length {length} != frames {frames} * hop {hop}")
    pad = (k - 1) // 2
    xp = F.pad(x.float(), (pad, pad))
    # win[b, k*Cin + i, f, t] = x_pad[b, i, f*hop + t + k]
    win = torch.stack([xp[:, :, j:j + length] for j in range(k)], dim=1)
    win = win.reshape(b, k * cin, frames, hop)
    kflat = kernel.reshape(b, frames, k * cin, cout).float()
    out = torch.einsum("brfh,bfro->bofh", win, kflat)
    out = out + bias.float().permute(0, 2, 1)[..., None]
    return out.reshape(b, cout, length)


def lvc_gated_residual(x: torch.Tensor, y_in: torch.Tensor,
                       kernel: torch.Tensor, bias: torch.Tensor,
                       hop: int) -> torch.Tensor:
    """x + sigmoid(z[:, :C]) * tanh(z[:, C:]) with z = LVC(y_in); the gate
    is rounded to x's dtype before the residual add, as in JAX."""
    c = x.shape[1]
    z = location_variable_convolution(y_in, kernel, bias, hop)
    gate = torch.sigmoid(z[:, :c]) * torch.tanh(z[:, c:])
    return x + gate.to(x.dtype)


def location_variable_convolution_nwc(x: torch.Tensor, kernel: torch.Tensor,
                                      bias: torch.Tensor,
                                      hop: int) -> torch.Tensor:
    """The LVC for NWC activations, the JAX function's own layout:
    x (B, L, Cin), kernel (B, F, K, Cin, Cout), bias (B, F, Cout)
    -> (B, L, Cout) float32."""
    b, length, cin = x.shape
    _, frames, k, _, cout = kernel.shape
    if length != frames * hop:
        raise ValueError(f"length {length} != frames {frames} * hop {hop}")
    pad = (k - 1) // 2
    xp = F.pad(x.float(), (0, 0, pad, pad))
    # win[b, f, t, k*Cin + i] = x_pad[b, f*hop + t + k, i]
    win = torch.stack([xp[:, j:j + length] for j in range(k)], dim=2)
    win = win.reshape(b, frames, hop, k * cin)
    kflat = kernel.reshape(b, frames, k * cin, cout).float()
    out = torch.einsum("bfhr,bfro->bfho", win, kflat)
    out = out + bias.float()[:, :, None, :]
    return out.reshape(b, length, cout)


def lvc_gated_residual_nwc(x: torch.Tensor, y_in: torch.Tensor,
                           kernel: torch.Tensor, bias: torch.Tensor,
                           hop: int) -> torch.Tensor:
    """``lvc_gated_residual`` for NWC activations x, y_in (B, L, C)."""
    c = x.shape[-1]
    z = location_variable_convolution_nwc(y_in, kernel, bias, hop)
    gate = torch.sigmoid(z[..., :c]) * torch.tanh(z[..., c:])
    return x + gate.to(x.dtype)
