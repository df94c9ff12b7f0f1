"""Diffusion schedule math (host-side numpy), a copy of
``fastdiff_tpu/diffusion/schedules.py``.

Re-derivation of the reference's DDPM hyperparameter pipeline
(reference: modules/FastDiff/module/util.py:365-404 and
modules/FastDiff/task/FastDiff.py:33-96):

- training: beta linear in [beta_0, beta_T] over T steps; alpha_t =
  sqrt(prod(1-beta_s)); sigma_t = sqrt(beta_t * (1-alpha_{t-1}^2)/(1-alpha_t^2)).
- inference: an arbitrary (usually tiny, N=4..8) noise schedule is converted
  to its own (alpha_infer, sigma_infer) and each inference noise level is
  mapped to a *fractional* training timestep by linear interpolation in alpha
  (util.py:394-404) — these fractional steps feed the sinusoidal embedding.
- the derived N-step schedules published with the reference
  (FastDiff.py:76-93) are reproduced verbatim as data.

Everything here is host precompute; the sampler reads the stacked
per-step constants once per step.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from fastdiff_tpu_torch.config import DiffusionConfig


@dataclasses.dataclass(frozen=True)
class DiffusionHyperparams:
    """Training-process constants: all shape (T,) float32."""
    T: int
    beta: np.ndarray
    alpha: np.ndarray   # cumulative sqrt(prod(1-beta))
    sigma: np.ndarray


def linear_beta_schedule(cfg: DiffusionConfig) -> np.ndarray:
    return np.linspace(cfg.beta_0, cfg.beta_T, cfg.T, dtype=np.float32)


def compute_hyperparams_given_schedule(beta: np.ndarray) -> DiffusionHyperparams:
    """beta (T,) -> (alpha, sigma) tables; semantics of util.py:365-390.

    alpha here is sqrt(cumprod(1-beta)) (the reference stores the sqrt),
    sigma_t^2 = beta_t * (1 - alpha_{t-1}^2) / (1 - alpha_t^2).
    """
    beta = np.asarray(beta, dtype=np.float64)  # f64: 1-cumprod cancels in f32
    t_max = len(beta)
    alpha_sq = np.cumprod(1.0 - beta)
    sigma_sq = beta.copy()
    # sigma_t^2 scales by the ratio of cumulative variances (t >= 1).
    sigma_sq[1:] = beta[1:] * (1.0 - alpha_sq[:-1]) / (1.0 - alpha_sq[1:])
    return DiffusionHyperparams(
        T=t_max,
        beta=beta.astype(np.float32),
        alpha=np.sqrt(alpha_sq).astype(np.float32),
        sigma=np.sqrt(sigma_sq).astype(np.float32),
    )


def map_noise_scale_to_time_step(alpha_infer: float, alpha: np.ndarray) -> float:
    """Linear-in-alpha fractional timestep lookup (util.py:394-404).

    Returns -1.0 only if alpha is non-monotone around alpha_infer (never for
    the linear schedule); callers drop negative steps like the reference does.
    """
    if alpha_infer < alpha[-1]:
        return float(len(alpha) - 1)
    if alpha_infer > alpha[0]:
        return 0.0
    for t in range(len(alpha) - 1):
        if alpha[t + 1] <= alpha_infer <= alpha[t]:
            frac = (alpha[t] - alpha_infer) / (alpha[t] - alpha[t + 1])
            return float(t) + float(frac)
    return -1.0


@dataclasses.dataclass(frozen=True)
class SamplerConstants:
    """Per-reverse-step constants, stacked, index 0 = first
    (most-noisy) step executed. All shape (N,) float32."""
    beta: np.ndarray
    alpha: np.ndarray
    sigma: np.ndarray
    steps: np.ndarray   # fractional training timesteps for the embedding

    @property
    def n_steps(self) -> int:
        return len(self.beta)


def sampler_constants_for_schedule(
        inference_noise_schedule: Sequence[float],
        hyperparams: DiffusionHyperparams) -> SamplerConstants:
    """Build reverse-process constants for an arbitrary inference schedule.

    Mirrors the precompute section of util.py:158-207: derive
    (alpha_infer, sigma_infer) from the inference betas, map each to a
    fractional training step, drop unmappable entries, and *reverse* the
    order so index 0 is the first reverse step (n = N-1 in the
    reference's countdown loop).
    """
    beta_infer = np.asarray(inference_noise_schedule, dtype=np.float64)
    n = len(beta_infer)
    alpha_sq = np.cumprod(1.0 - beta_infer)
    sigma_sq = beta_infer.copy()
    sigma_sq[1:] = beta_infer[1:] * (1.0 - alpha_sq[:-1]) / (1.0 - alpha_sq[1:])
    alpha_infer = np.sqrt(alpha_sq).astype(np.float32)
    sigma_infer = np.sqrt(sigma_sq).astype(np.float32)
    beta_infer = beta_infer.astype(np.float32)

    steps, keep = [], []
    for i in range(n):
        step = map_noise_scale_to_time_step(float(alpha_infer[i]),
                                            hyperparams.alpha)
        if step >= 0:
            steps.append(step)
            keep.append(i)
    keep = np.asarray(keep, dtype=np.int64)
    order = keep[::-1]  # countdown: most-noisy step first
    return SamplerConstants(
        beta=beta_infer[order],
        alpha=alpha_infer[order],
        sigma=sigma_infer[order],
        steps=np.asarray(steps, dtype=np.float32)[::-1].copy(),
    )


# ---------------------------------------------------------------------------
# Published derived schedules (reference: FastDiff.py:76-93)
# ---------------------------------------------------------------------------

_DERIVED_SCHEDULES = {
    8: [6.689325005027058e-07, 1.0033881153503899e-05, 0.00015496854030061513,
        0.002387222135439515, 0.035597629845142365, 0.3681158423423767,
        0.4735414385795593, 0.5],
    6: [1.7838445955931093e-06, 2.7984189728158526e-05, 0.00043231004383414984,
        0.006634317338466644, 0.09357017278671265, 0.6000000238418579],
    4: [3.2176e-04, 2.5743e-03, 2.5376e-02, 7.0414e-01],
    3: [9.0000e-05, 9.0000e-03, 6.0000e-01],
}


def noise_schedule_for_steps(n_steps: int) -> np.ndarray:
    """The reference's per-N noise-schedule table (FastDiff.py:76-93)."""
    if n_steps == 1000:
        return np.linspace(1e-6, 0.01, 1000, dtype=np.float32)
    if n_steps == 200:
        return np.linspace(1e-4, 0.02, 200, dtype=np.float32)
    if n_steps in _DERIVED_SCHEDULES:
        return np.asarray(_DERIVED_SCHEDULES[n_steps], dtype=np.float32)
    raise NotImplementedError(
        f"no derived noise schedule for N={n_steps}; provide noise_schedule= "
        f"explicitly (supported N: 1000, 200, 8, 6, 4, 3)")


def resolve_noise_schedule(hp: dict) -> np.ndarray:
    """Resolve hparams['noise_schedule'] / hparams['N'] exactly as the
    reference test path does (FastDiff.py:65-96): an explicit list wins;
    otherwise N selects from the table, falling back to N=4 when unset."""
    sched = hp.get("noise_schedule", "")
    if isinstance(sched, (list, tuple)) and len(sched):
        return np.asarray(sched, dtype=np.float32)
    try:
        n_steps = int(hp.get("N"))
    except (TypeError, ValueError):
        print("| N not specified; denoising with 4 iterations.")
        n_steps = 4
    return noise_schedule_for_steps(n_steps)
