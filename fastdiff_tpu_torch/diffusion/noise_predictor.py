"""BDDM noise predictor: learned noise-schedule search
(``fastdiff_tpu/diffusion/noise_predictor.py``).

The reference ships the BDDM training and search call sites but no model
(``net.noise_pred`` is defined nowhere, reference: modules/FastDiff/module/
util.py:284,356); its N = 8/6/4/3 schedules were produced elsewhere. The
JAX package supplies the missing piece, and this module is its twin:

- ``NoisePredictor``: ``n_convs`` strided convs (k 5, stride 4, padding 2,
  each followed by leaky ReLU 0.2) over x_t, averaged over time, then an
  MLP over ``[pooled, log(beta_next + 1e-12), log(delta^2 + 1e-12)]``
  (tanh, then a sigmoid) giving a ratio in (0, 1);
  ``beta_est = ratio * min(delta^2, beta_next)`` (BDDM's parameterization,
  Lam et al. 2022). Plain PyTorch: the JAX predictor reaches no Pallas
  kernel.
- ``phi_loss``: BDDM's step-size ELBO (util.py:328-362), term for term as
  JAX computes it. The score network runs under ``torch.no_grad``: the
  loss's gradient with respect to phi never reaches its epsilon, so this
  gives JAX's values without a backward pass through the LVC blocks.
- ``search_noise_schedule``: the reverse search of util.py:237-288, driven
  from the host (it ends on the data and reads one predicted beta a step):
  from (alpha_N, beta_N) it denoises with the score network and asks the
  predictor for the next beta until ``rho``, alpha > 1 or ``max_steps``,
  and returns the schedule ascending, ready for
  ``schedules.sampler_constants_for_schedule``.

The draws (``phi_loss``'s t and z, the search's initial x) come from a
``torch.Generator`` or are injected, so that a test can replay JAX's.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fastdiff_tpu_torch.diffusion.schedules import (
    DiffusionHyperparams, map_noise_scale_to_time_step)


class NoisePredictor(nn.Module):
    """phi: ``forward(x_t (B, T, 1), beta_next (B, 1), delta_sq (B, 1)) ->
    beta_est (B, 1)`` (JAX's ``noise_predictor_apply``; its
    ``init_noise_predictor`` distributions, U(+-1/sqrt(fan_in)) for every
    weight and bias, drawn from a CPU generator seeded ``seed``)."""

    def __init__(self, hidden: int = 32, n_convs: int = 5,
                 seed: int | None = 0, device=None):
        super().__init__()
        self.convs = nn.ModuleList(
            [nn.Conv1d(1 if i == 0 else hidden, hidden, 5, stride=4,
                       padding=2) for i in range(n_convs)])
        self.fc1 = nn.Linear(hidden + 2, hidden)
        self.fc2 = nn.Linear(hidden, 1)
        if seed is not None:
            generator = torch.Generator().manual_seed(seed)
            with torch.no_grad():
                for module in self.modules():
                    if isinstance(module, (nn.Conv1d, nn.Linear)):
                        bound = module.weight[0].numel() ** -0.5
                        module.weight.uniform_(-bound, bound,
                                               generator=generator)
                        module.bias.uniform_(-bound, bound,
                                             generator=generator)
        if device is not None:
            self.to(device)

    def forward(self, x_t: torch.Tensor, beta_next: torch.Tensor,
                delta_sq: torch.Tensor) -> torch.Tensor:
        h = x_t.transpose(1, 2)                          # (B, 1, T)
        for conv in self.convs:
            h = F.leaky_relu(conv(h), 0.2)
        pooled = h.mean(dim=2)                           # (B, hidden)
        feat = torch.cat([pooled, torch.log(beta_next + 1e-12),
                          torch.log(delta_sq + 1e-12)], dim=-1)
        ratio = torch.sigmoid(self.fc2(torch.tanh(self.fc1(feat))))
        return ratio * torch.minimum(delta_sq, beta_next)


def phi_loss(model: NoisePredictor, denoise_fn: Callable, mel: torch.Tensor,
             audio: torch.Tensor, alpha: torch.Tensor, tau: int = 200, *,
             generator: torch.Generator | None = None,
             ts: torch.Tensor | None = None,
             z: torch.Tensor | None = None) -> torch.Tensor:
    """BDDM step-size ELBO. t is drawn in [tau, T - tau) per example (or
    ``ts`` (B,) int is given), z ~ N(0, 1) like ``audio`` (or ``z`` is
    given); beta_next is the tau-step jump ratio. ``denoise_fn(x_t, mel,
    t (B, 1) float32) -> eps``; ``alpha`` (T,) on audio's device."""
    b = audio.shape[0]
    t_total = alpha.shape[0]
    device = audio.device
    if ts is None:
        ts = torch.randint(tau, t_total - tau, (b,), generator=generator,
                           device=device)
    ts = ts.to(device, torch.long)
    alpha_cur = alpha[ts][:, None, None]
    alpha_nxt = alpha[ts + tau][:, None, None]
    beta_nxt = 1.0 - (alpha_nxt / alpha_cur) ** 2
    delta = torch.sqrt(1.0 - alpha_cur ** 2)
    if z is None:
        z = torch.randn(audio.shape, generator=generator, device=device)
    z = z.to(device, torch.float32)
    x_t = alpha_cur * audio + delta * z
    with torch.no_grad():
        eps = denoise_fn(x_t, mel, ts[:, None].float()).float()

    beta_est = model(x_t, beta_nxt[:, :, 0], (delta ** 2)[:, :, 0])
    beta_est = beta_est[:, :, None]                      # (B, 1, 1)

    delta_sq = delta ** 2
    term = (1.0 / (2.0 * (delta_sq - beta_est))
            * (delta * z - beta_est / delta * eps) ** 2)
    term = term + torch.log(1e-8 + delta_sq / (beta_est + 1e-8)) / 4.0
    return (term.mean(dim=1, keepdim=True)
            + beta_est / delta_sq / 2.0).mean()


def phi_train_step(model: NoisePredictor, optimizer: torch.optim.Optimizer,
                   denoise_fn: Callable, mel: torch.Tensor,
                   audio: torch.Tensor, alpha: torch.Tensor, tau: int = 200,
                   **draws) -> torch.Tensor:
    """One update of phi (``scripts/bddm_search.py``'s ``phi_step``):
    ``phi_loss``, its gradient and ``optimizer.step``; returns the loss,
    detached. ``draws`` are ``phi_loss``'s ``generator``, ``ts``, ``z``."""
    optimizer.zero_grad(set_to_none=True)
    loss = phi_loss(model, denoise_fn, mel, audio, alpha, tau, **draws)
    loss.backward()
    optimizer.step()
    return loss.detach()


@torch.no_grad()
def search_noise_schedule(model: NoisePredictor, denoise_fn: Callable,
                          mel: torch.Tensor,
                          hyperparams: DiffusionHyperparams,
                          audio_length: int, max_steps: int = 8,
                          beta_start: float = 0.5, alpha_start: float = 0.3,
                          rho: float = 1e-9, *,
                          generator: torch.Generator | None = None,
                          x: torch.Tensor | None = None) -> np.ndarray:
    """Reverse schedule search; returns an ascending float32 beta schedule
    of length <= ``max_steps``. x starts as ``x`` (B, audio_length, 1) or
    a draw of ``generator`` on mel's device. Precision as JAX's: beta and
    alpha enter the step and the predictor as float32, the next alpha is
    computed on the host in float64, the predicted beta comes back as a
    Python float. The reverse step adds no noise."""
    alpha_table = hyperparams.alpha
    batch = mel.shape[0]
    device = mel.device
    shape = (batch, audio_length, 1)
    if x is None:
        x = torch.randn(shape, generator=generator, device=device)
    if tuple(x.shape) != shape:
        raise ValueError(f"x shape {tuple(x.shape)} != {shape}")
    x = x.to(device, torch.float32)
    one = np.float32(1.0)

    def column(v) -> torch.Tensor:
        return torch.full((batch, 1), float(v), dtype=torch.float32,
                          device=device)

    beta_cur, alpha_cur = float(beta_start), float(alpha_start)
    betas: List[float] = []
    for _ in range(max_steps):
        step = map_noise_scale_to_time_step(alpha_cur, alpha_table)
        if step >= 0:
            betas.append(beta_cur)
        b32, a32 = np.float32(beta_cur), np.float32(alpha_cur)
        eps = denoise_fn(x, mel, column(np.float32(max(step, 0.0)))).float()
        x = x - float(b32 / np.sqrt(one - a32 * a32)) * eps
        x = x / float(np.sqrt(one - b32))
        alpha_nxt = alpha_cur / np.sqrt(max(1.0 - beta_cur, 1e-12))
        if alpha_nxt > 1.0:
            break
        alpha_cur = float(alpha_nxt)
        a32 = np.float32(alpha_cur)
        delta_sq = max(one - a32 * a32, np.float32(1e-12))
        beta_cur = float(model(x, column(np.float32(beta_cur)),
                               column(delta_sq))[0, 0])
        if beta_cur < rho:
            break
    return np.asarray(betas[::-1], dtype=np.float32)
