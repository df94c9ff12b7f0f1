"""Mixture-density output heads: discretized mix-of-logistics and
mix-of-Gaussians (``fastdiff_tpu/ops/mixture.py``), and mu-law companding.

Parameters are channel-last ``(..., 3 * nr_mix)`` laid out as
[logit_probs | means | log_scales]; targets are ``(...,)`` scalars in
[-1, 1].

The samplers take their draws as an optional argument, so that a test can
inject another implementation's: ``draws=(u, u2)`` for the logistic one
(u ~ U(1e-5, 1 - 1e-5) of the mixture pick's shape, u2 of the output's),
``draws=(u, z)`` for the Gaussian one (z ~ N(0, 1); u is unused for a
single Gaussian). Without ``draws`` they draw from ``generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _log_sum_exp(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    m = x.max(dim=dim, keepdim=True).values
    return m.squeeze(dim) + torch.log(torch.sum(torch.exp(x - m), dim=dim))


def _split_params(y_hat: torch.Tensor, log_scale_min: float,
                  clamp: bool = True):
    nr_mix = y_hat.shape[-1] // 3
    logit_probs = y_hat[..., :nr_mix]
    means = y_hat[..., nr_mix:2 * nr_mix]
    log_scales = y_hat[..., 2 * nr_mix:3 * nr_mix]
    if clamp:
        log_scales = torch.clamp(log_scales, min=log_scale_min)
    return logit_probs, means, log_scales


def discretized_mix_logistic_loss(y_hat: torch.Tensor, y: torch.Tensor,
                                  num_classes: int = 256,
                                  log_scale_min: float = -7.0,
                                  reduce: bool = True) -> torch.Tensor:
    """Discretized MoL negative log-likelihood; y_hat (..., 3 * nr_mix),
    y (...,) in [-1, 1]; ``reduce`` sums over all elements.

    The log of ``cdf_delta`` takes ``max(cdf_delta, 1e-12)`` inside the
    ``where``: the branch not taken then has a finite gradient, so no
    inf * 0 reaches the gradient at y = +-1."""
    assert y_hat.shape[-1] % 3 == 0
    logit_probs, means, log_scales = _split_params(y_hat, log_scale_min)
    y = y[..., None]
    centered = y - means
    inv_stdv = torch.exp(-log_scales)
    half_bin = 1.0 / (num_classes - 1)
    plus_in = inv_stdv * (centered + half_bin)
    min_in = inv_stdv * (centered - half_bin)
    cdf_plus = torch.sigmoid(plus_in)
    cdf_min = torch.sigmoid(min_in)
    log_cdf_plus = plus_in - F.softplus(plus_in)        # log sigmoid
    log_one_minus_cdf_min = -F.softplus(min_in)
    cdf_delta = cdf_plus - cdf_min
    mid_in = inv_stdv * centered
    log_pdf_mid = mid_in - log_scales - 2.0 * F.softplus(mid_in)

    inner_inner = torch.where(
        cdf_delta > 1e-5, torch.log(torch.clamp(cdf_delta, min=1e-12)),
        log_pdf_mid - math.log((num_classes - 1) / 2.0))
    inner = torch.where(y > 0.999, log_one_minus_cdf_min, inner_inner)
    log_probs = torch.where(y < -0.999, log_cdf_plus, inner)

    log_probs = log_probs + F.log_softmax(logit_probs, dim=-1)
    nll = -_log_sum_exp(log_probs)
    return nll.sum() if reduce else nll


def _uniform(shape, like: torch.Tensor, generator) -> torch.Tensor:
    """U(1e-5, 1 - 1e-5), as the reference draws its uniforms."""
    u = torch.rand(shape, generator=generator, device=like.device)
    return u * (1.0 - 2e-5) + 1e-5


def _pick(logit_probs, means_all, log_scales_all, u):
    """Gumbel-max mixture pick with uniforms u; the picked (means,
    log_scales) (JAX sums a one-hot product, which selects the same
    values)."""
    idx = torch.argmax(logit_probs - torch.log(-torch.log(u)), dim=-1,
                       keepdim=True)
    return (torch.gather(means_all, -1, idx)[..., 0],
            torch.gather(log_scales_all, -1, idx)[..., 0])


def sample_from_discretized_mix_logistic(y: torch.Tensor,
                                         log_scale_min: float = -7.0,
                                         clamp_log_scale: bool = False, *,
                                         generator=None, draws=None
                                         ) -> torch.Tensor:
    """Gumbel-max mixture pick, then a logistic draw by the inverse CDF,
    clipped to [-1, 1]: y (..., 3 * nr_mix) -> (...,)."""
    assert y.shape[-1] % 3 == 0
    logit_probs, means_all, log_scales_all = _split_params(
        y, log_scale_min, clamp=clamp_log_scale)
    if draws is None:
        draws = (_uniform(logit_probs.shape, y, generator),
                 _uniform(logit_probs.shape[:-1], y, generator))
    u, u2 = draws
    means, log_scales = _pick(logit_probs, means_all, log_scales_all, u)
    x = means + torch.exp(log_scales) * (torch.log(u2) - torch.log(1.0 - u2))
    return torch.clamp(x, -1.0, 1.0)


def mix_logistic_mode(y: torch.Tensor,
                      log_scale_min: float = -7.0) -> torch.Tensor:
    """The temperature -> 0 limit of the logistic sampler: the argmax
    component's mean, clipped to [-1, 1] (deterministic)."""
    assert y.shape[-1] % 3 == 0
    logit_probs, means_all, _ = _split_params(y, log_scale_min, clamp=False)
    idx = torch.argmax(logit_probs, dim=-1, keepdim=True)
    return torch.clamp(torch.gather(means_all, -1, idx)[..., 0], -1.0, 1.0)


def mix_gaussian_mode(y: torch.Tensor,
                      log_scale_min: float = -7.0) -> torch.Tensor:
    """The temperature -> 0 limit of ``sample_from_mix_gaussian``."""
    if y.shape[-1] == 2:
        return torch.clamp(y[..., 0], -1.0, 1.0)
    return mix_logistic_mode(y, log_scale_min)


def mix_gaussian_loss(y_hat: torch.Tensor, y: torch.Tensor,
                      log_scale_min: float = -7.0,
                      reduce: bool = True) -> torch.Tensor:
    """Continuous mixture-of-Gaussians NLL, with the C == 2 single-Gaussian
    case."""
    c = y_hat.shape[-1]
    y = y[..., None]
    if c == 2:
        means = y_hat[..., 0:1]
        log_scales = torch.clamp(y_hat[..., 1:2], min=log_scale_min)
        logit_probs = None
    else:
        assert c % 3 == 0
        logit_probs, means, log_scales = _split_params(y_hat, log_scale_min)
    centered = y - means
    log_probs = (-0.5 * (centered * torch.exp(-log_scales)) ** 2
                 - log_scales - 0.5 * math.log(2.0 * math.pi))
    if logit_probs is not None:
        log_probs = log_probs + F.log_softmax(logit_probs, dim=-1)
        nll = -_log_sum_exp(log_probs)
    else:
        nll = -log_probs[..., 0]
    return nll.sum() if reduce else nll


def sample_from_mix_gaussian(y: torch.Tensor, log_scale_min: float = -7.0,
                             *, generator=None, draws=None) -> torch.Tensor:
    """y (..., C) -> (...,) in [-1, 1]."""
    c = y.shape[-1]
    if draws is None:
        u = (_uniform(y.shape[:-1] + (c // 3,), y, generator) if c != 2
             else None)
        z = torch.randn(y.shape[:-1], generator=generator, device=y.device)
        draws = (u, z)
    u, z = draws
    if c == 2:
        means, log_scales = y[..., 0], y[..., 1]
    else:
        assert c % 3 == 0
        logit_probs, means_all, log_scales_all = _split_params(
            y, log_scale_min, clamp=False)
        means, log_scales = _pick(logit_probs, means_all, log_scales_all, u)
    return torch.clamp(means + torch.exp(log_scales) * z, -1.0, 1.0)


# ---------------------------------------------------------------------------
# mu-law companding (ITU G.711)
# ---------------------------------------------------------------------------

def mulaw(x: torch.Tensor, mu: int = 255) -> torch.Tensor:
    """[-1, 1] -> [-1, 1] mu-law companded."""
    return torch.sign(x) * torch.log1p(mu * torch.abs(x)) / math.log1p(mu)


def inv_mulaw(y: torch.Tensor, mu: int = 255) -> torch.Tensor:
    return torch.sign(y) * ((1.0 + mu) ** torch.abs(y) - 1.0) / mu


def mulaw_quantize(x: torch.Tensor, mu: int = 255) -> torch.Tensor:
    """[-1, 1] -> integer class ids [0, mu], truncating (nnmnkwii's
    ``mulaw_quantize``; ``mulaw_quantize(0) == 127``)."""
    y = mulaw(x, mu)
    return torch.clamp(((y + 1.0) / 2.0 * mu).to(torch.int32), 0, mu)


def inv_mulaw_quantize(ids: torch.Tensor, mu: int = 255) -> torch.Tensor:
    return inv_mulaw(2.0 * ids.float() / mu - 1.0, mu)
