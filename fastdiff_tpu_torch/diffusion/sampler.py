"""Reverse-diffusion sampling (``fastdiff_tpu/diffusion/sampler.py``).

A Python loop over the N steps of the inference schedule; the per-step
constants come from ``diffusion/schedules.py``. DDPM update:

    x <- (x - beta_n / sqrt(1 - alpha_n^2) * eps(x, mel, t_n)) / sqrt(1 - beta_n)
    x <- x + sigma_n * z            (no noise after the final step)

and the DDIM variant. Noise is drawn from a ``torch.Generator`` on the
model's device, or injected as ``noise=(x_T, [z_0, ..., z_{N-1}])`` so that a
test can replay another sampler's draws.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from fastdiff_tpu_torch.config import DiffusionConfig
from fastdiff_tpu_torch.diffusion import schedules
from fastdiff_tpu_torch.diffusion.schedules import SamplerConstants


def constants_for_hparams(hp: dict) -> SamplerConstants:
    """Sampler constants for the hparams' ``noise_schedule`` / ``N`` over
    the training schedule (``T``, ``beta_0``, ``beta_T``)."""
    hyper = schedules.compute_hyperparams_given_schedule(
        schedules.linear_beta_schedule(DiffusionConfig.from_hparams(hp)))
    return schedules.sampler_constants_for_schedule(
        schedules.resolve_noise_schedule(hp), hyper)


def _f32(v) -> np.float32:
    return np.float32(v)


def sample(denoise_fn: Callable, mel: torch.Tensor,
           constants: SamplerConstants, audio_length: int, *,
           ddim: bool = False, generator: torch.Generator | None = None,
           noise: tuple | None = None) -> torch.Tensor:
    """mel (B, T', n_mels) -> waveform (B, audio_length, 1) float32.

    ``denoise_fn(x (B, L, 1), mel, t (B, 1)) -> eps``. Either ``generator``
    (on mel's device) draws x_T and the per-step noise, or ``noise`` gives
    them: ``(x_T (B, L, 1), [z_i (B, L, 1) for each of the N steps])``.
    The step constants are combined in float32, as in the JAX scan body."""
    batch = mel.shape[0]
    device = mel.device
    shape = (batch, audio_length, 1)
    n_steps = constants.n_steps
    zs = None
    if noise is not None:
        x, zs = noise
        if len(zs) != n_steps:
            raise ValueError(f"noise has {len(zs)} step draws, the schedule "
                             f"has {n_steps} steps")
        x = x.to(device, torch.float32)
    else:
        x = torch.randn(shape, generator=generator, device=device)
    if tuple(x.shape) != shape:
        raise ValueError(f"x_T shape {tuple(x.shape)} != {shape}")
    one = _f32(1.0)
    for i in range(n_steps):
        b_n, a_n = _f32(constants.beta[i]), _f32(constants.alpha[i])
        t_vec = torch.full((batch, 1), float(constants.steps[i]),
                           dtype=torch.float32, device=device)
        eps = denoise_fn(x, mel, t_vec)
        if ddim:
            a_next = a_n / np.sqrt(one - b_n)
            c1 = a_next / a_n
            c2 = -np.sqrt(one - a_n * a_n) * c1
            c3 = np.sqrt(one - a_next * a_next)
            x = float(c1) * x + float(c2 + c3) * eps
            continue
        x = x - float(b_n / np.sqrt(one - a_n * a_n)) * eps
        x = x / float(np.sqrt(one - b_n))
        if i < n_steps - 1:
            z = (zs[i].to(device, torch.float32) if zs is not None
                 else torch.randn(shape, generator=generator, device=device))
            x = x + float(constants.sigma[i]) * z
    return x
