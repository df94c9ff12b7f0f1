"""The reverse process (DDPM) of FastDiff and DiffWave, in float64 scalars
and float32 tensors.

Training schedule: beta linear from ``beta_0`` to ``beta_T`` over ``T``
steps, alpha_t = sqrt(prod_{s <= t} (1 - beta_s)). An N-step inference
schedule (the table published with FastDiff, ``FastDiff.py:76-93``) has its
own alpha_n and sigma_n^2 = beta_n (1 - alpha_{n-1}^2) / (1 - alpha_n^2);
each alpha_n is mapped to a fractional training step by linear
interpolation in alpha, which the step embedding takes. Executed from the
noisiest step down, each step is

    x <- (x - beta_n / sqrt(1 - alpha_n^2) * eps(x, mel, t_n))
         / sqrt(1 - beta_n) + sigma_n * z_n

with no noise after the last. Draws come in DDPM's order: x_T, then one
z per step but the last.
"""

from __future__ import annotations

import numpy as np
import torch

NOISE_SCHEDULES = {
    4: [3.2176e-04, 2.5743e-03, 2.5376e-02, 7.0414e-01],
    6: [1.7838445955931093e-06, 2.7984189728158526e-05,
        0.00043231004383414984, 0.006634317338466644, 0.09357017278671265,
        0.6000000238418579],
}


def steps(cfg: dict) -> list:
    """[(t_n, c_eps, c_x, sigma_n)] in the order executed: eps's
    coefficient beta / sqrt(1 - alpha^2), x's 1 / sqrt(1 - beta)."""
    train_beta = np.linspace(float(cfg["beta_0"]), float(cfg["beta_T"]),
                             int(cfg["T"]))
    train_alpha = np.sqrt(np.cumprod(1.0 - train_beta))
    beta = np.asarray(NOISE_SCHEDULES[int(cfg["N"])], np.float64)
    alpha_sq = np.cumprod(1.0 - beta)
    sigma_sq = beta.copy()
    sigma_sq[1:] = beta[1:] * (1.0 - alpha_sq[:-1]) / (1.0 - alpha_sq[1:])
    out = []
    for n in range(len(beta))[::-1]:
        a = np.sqrt(alpha_sq[n])
        if a < train_alpha[-1]:
            t = float(len(train_alpha) - 1)
        elif a > train_alpha[0]:
            t = 0.0
        else:
            i = int(np.nonzero(train_alpha >= a)[0][-1])
            i = min(i, len(train_alpha) - 2)
            t = i + (train_alpha[i] - a) / (train_alpha[i] - train_alpha[i + 1])
        out.append((t, beta[n] / np.sqrt(1.0 - alpha_sq[n]),
                    1.0 / np.sqrt(1.0 - beta[n]), np.sqrt(sigma_sq[n])))
    return out


def draws(seed: int, batch: int, length: int, n_steps: int,
          device) -> tuple:
    """x_T and the step draws (B, L) in DDPM's order from a generator on
    ``device`` seeded with ``seed``: the noise of one vocoder call."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    shape = (batch, length, 1)
    x_t = torch.empty(shape, device=device).normal_(generator=gen)
    zs = [torch.empty(shape, device=device).normal_(generator=gen)
          for _ in range(n_steps - 1)]
    return x_t[..., 0], [z[..., 0] for z in zs]


def reverse(forward, weights: dict, cfg: dict, mel: torch.Tensor,
            x_t: torch.Tensor, zs: list, quant) -> torch.Tensor:
    """The N reverse steps from x_T (B, L) given mel (B, F, n_mels)."""
    x = x_t.float()
    schedule = steps(cfg)
    for n, (t, c_eps, c_x, sigma) in enumerate(schedule):
        t_vec = torch.full((x.shape[0],), t, dtype=torch.float64,
                           device=x.device)
        eps = forward(weights, cfg, x, mel, t_vec, quant)
        x = (x - c_eps * eps) * c_x
        if n < len(schedule) - 1:
            x = x + sigma * zs[n]
    return x
