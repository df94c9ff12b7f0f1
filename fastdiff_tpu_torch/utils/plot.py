"""Matplotlib figures for training logs, a copy of
``fastdiff_tpu/utils/plot.py`` (reference: utils/plot.py:11-64, the
spectrogram / f0 figures of validation).

Matplotlib is imported on first use, on the Agg backend, so headless runs
work and a machine without it fails only where a figure is drawn; the
``Trainer`` logs the figures as PNGs (``ScalarLogger.log_figure``).
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def spec_to_figure(spec: np.ndarray, vmin: float = None, vmax: float = None,
                   title: str = ""):
    """Mel / linear spectrogram (T, bins) -> matplotlib figure."""
    plt = _plt()
    spec = np.asarray(spec)
    fig = plt.figure(figsize=(12, 6))
    plt.pcolor(spec.T, vmin=vmin, vmax=vmax)
    plt.colorbar()
    if title:
        plt.title(title)
    plt.tight_layout()
    return fig


def f0_to_figure(f0_gt: np.ndarray, f0_pred: np.ndarray = None):
    """Ground-truth (and optionally predicted) f0 contours."""
    plt = _plt()
    fig = plt.figure()
    plt.plot(np.asarray(f0_gt), color="r", label="gt")
    if f0_pred is not None:
        plt.plot(np.asarray(f0_pred), color="b", label="pred")
    plt.legend()
    plt.tight_layout()
    return fig


def wav_to_figure(wav: np.ndarray, sample_rate: int = 22050):
    plt = _plt()
    fig = plt.figure(figsize=(12, 3))
    t = np.arange(len(wav)) / sample_rate
    plt.plot(t, np.asarray(wav), linewidth=0.4)
    plt.xlabel("seconds")
    plt.tight_layout()
    return fig


def save_figure(fig, path: str) -> None:
    fig.savefig(path)
    import matplotlib.pyplot as plt
    plt.close(fig)
