"""Mel-spectrogram reconstruction losses of acoustic-model training
(``fastdiff_tpu/ops/mel_losses.py``).

``mel_loss`` parses the ``"l1:0.5|ssim:0.5|gdl:0.1"`` option into
loss -> lambda (``parse_mel_losses``) and applies each loss weighted by
``weights_nonzero_speech``: frames whose target mel is all zero (padding)
contribute nothing.

- SSIM (Wang et al. 2004): an 11 x 11 Gaussian window (sigma 1.5), C1 =
  0.01^2, C2 = 0.03^2, on mels shifted by +6 (log10 mels span about
  [-6, 2]). The blur is one ``F.conv2d`` of the window's outer product over
  (B, 1, T, M) with 'same' zero padding, as JAX's two separable passes.
- GDL (Mathieu et al. 2016): L1 between the absolute finite differences of
  prediction and target along time and along the mel axis.

All functions take NWC mels ``(B, T, n_mels)`` and return 0-dim tensors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def parse_mel_losses(spec: str) -> dict:
    """``"l1:0.5|ssim:0.5"`` -> {"l1": 0.5, "ssim": 0.5} (tts_base.py:57-67)."""
    out = {}
    for part in str(spec).split("|"):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            name, lbd = part.split(":")
            out[name] = float(lbd)
        else:
            out[part] = 1.0
    return out


def weights_nonzero_speech(target: torch.Tensor) -> torch.Tensor:
    """(B, T, M) -> (B, T, 1) mask of frames with any nonzero mel energy."""
    return (target.abs().sum(-1, keepdim=True) > 0).float()


def _masked_mean(err: torch.Tensor, w: torch.Tensor, n_bins: int
                 ) -> torch.Tensor:
    return (err * w).sum() / torch.clamp(w.sum() * n_bins, min=1.0)


def l1_mel_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return _masked_mean((pred - target).abs(),
                        weights_nonzero_speech(target), target.shape[-1])


def mse_mel_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return _masked_mean((pred - target) ** 2,
                        weights_nonzero_speech(target), target.shape[-1])


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur2d(img: torch.Tensor, win: np.ndarray) -> torch.Tensor:
    """Gaussian blur of (B, T, M) with 'same' zero padding."""
    kernel = torch.from_numpy(np.outer(win, win)).to(img)[None, None]
    pad = win.shape[0] // 2
    return F.conv2d(img[:, None], kernel, padding=pad)[:, 0]


def ssim(pred: torch.Tensor, target: torch.Tensor,
         c1: float = 0.01 ** 2, c2: float = 0.03 ** 2) -> torch.Tensor:
    """Per-pixel SSIM map of two (B, T, M) images (Wang et al. 2004)."""
    win = _gaussian_window()
    mu_p = _blur2d(pred, win)
    mu_t = _blur2d(target, win)
    mu_pt = mu_p * mu_t
    var_p = _blur2d(pred * pred, win) - mu_p ** 2
    var_t = _blur2d(target * target, win) - mu_t ** 2
    cov = _blur2d(pred * target, win) - mu_pt
    num = (2.0 * mu_pt + c1) * (2.0 * cov + c2)
    den = (mu_p ** 2 + mu_t ** 2 + c1) * (var_p + var_t + c2)
    return num / den


def ssim_mel_loss(pred: torch.Tensor, target: torch.Tensor,
                  bias: float = 6.0) -> torch.Tensor:
    """1 - SSIM on bias-shifted mels, masked to speech frames."""
    s = ssim(pred + bias, target + bias)
    return _masked_mean(1.0 - s, weights_nonzero_speech(target),
                        target.shape[-1])


def gdl_mel_loss(pred: torch.Tensor, target: torch.Tensor,
                 alpha: float = 1.0) -> torch.Tensor:
    """Gradient difference loss over the time and mel axes, masked to
    speech frames."""
    w = weights_nonzero_speech(target)
    dt_p = (pred[:, 1:] - pred[:, :-1]).abs()
    dt_t = (target[:, 1:] - target[:, :-1]).abs()
    wt = w[:, 1:] * w[:, :-1]
    lt = _masked_mean((dt_p - dt_t).abs() ** alpha, wt, target.shape[-1])
    df_p = (pred[:, :, 1:] - pred[:, :, :-1]).abs()
    df_t = (target[:, :, 1:] - target[:, :, :-1]).abs()
    lf = _masked_mean((df_p - df_t).abs() ** alpha, w, target.shape[-1] - 1)
    return lt + lf


MEL_LOSS_FNS = {
    "l1": l1_mel_loss,
    "mse": mse_mel_loss,
    "ssim": ssim_mel_loss,
    "gdl": gdl_mel_loss,
}


def mel_loss(pred: torch.Tensor, target: torch.Tensor,
             loss_and_lambda: dict) -> dict:
    """Every configured mel loss: {"l1": l1 * lambda, ...}."""
    return {name: MEL_LOSS_FNS[name](pred, target) * lbd
            for name, lbd in loss_and_lambda.items()}
