"""Training loss of the epsilon-prediction vocoder
(``fastdiff_tpu/diffusion/losses.py``).

Draw an integer timestep t in [0, T) per example and z ~ N(0, 1), form
x_t = alpha_t * x0 + sqrt(1 - alpha_t^2) * z, and regress the model's
epsilon estimate onto z with the mean squared error. The draws come from an
explicit ``torch.Generator``, or are injected (``ts``, ``z``) so that a test
can replay another implementation's draws.
"""

from __future__ import annotations

from typing import Callable

import torch


def theta_timestep_loss(denoise_fn: Callable, mel: torch.Tensor,
                        audio: torch.Tensor, alpha: torch.Tensor, *,
                        generator: torch.Generator | None = None,
                        ts: torch.Tensor | None = None,
                        z: torch.Tensor | None = None) -> torch.Tensor:
    """Epsilon-MSE diffusion loss.

    ``denoise_fn(x_t, mel, t (B, 1) float) -> eps_hat``; mel (B, T', n_mels);
    audio (B, T, 1); alpha (T_diff,) the training alpha table (square root
    of the cumulative product), on audio's device. ``ts`` (B, 1, 1) int and
    ``z`` (like audio) replace the generator's draws when given."""
    b = audio.shape[0]
    if ts is None:
        ts = torch.randint(0, alpha.shape[0], (b, 1, 1), generator=generator,
                           device=audio.device)
    if z is None:
        z = torch.randn(audio.shape, generator=generator, device=audio.device,
                        dtype=audio.dtype)
    ts = ts.to(audio.device)
    alpha_t = alpha[ts]                                       # (B, 1, 1)
    delta = torch.sqrt(1.0 - alpha_t ** 2)
    x_t = alpha_t * audio + delta * z
    eps = denoise_fn(x_t, mel, ts.reshape(b, 1).float())
    return torch.mean((eps - z) ** 2)
