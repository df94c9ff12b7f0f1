"""Training observability: scalar logging and meters, a copy of
``fastdiff_tpu/utils/logging_utils.py`` (``ScalarLogger``, ``MeterBank``).

Scalars go to TensorBoard when ``torch.utils.tensorboard`` is importable
and always to a ``metrics.jsonl`` file, so runs are inspectable without TB;
figures (``log_figure``) to PNGs under ``<log_dir>/figures/``.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict


class ScalarLogger:
    def __init__(self, log_dir: str, enabled: bool = True):
        self.enabled = enabled
        self.log_dir = log_dir
        self._tb = None
        self._jsonl = None
        if enabled:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir=log_dir)
            except Exception:
                self._tb = None

    def log(self, metrics: Dict[str, float], step: int, prefix: str = "") -> None:
        if not self.enabled:
            return
        flat = {f"{prefix}{k}": float(v) for k, v in metrics.items()}
        self._jsonl.write(json.dumps({"step": step, **flat}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in flat.items():
                self._tb.add_scalar(k, v, step)

    def log_figure(self, tag: str, fig, step: int) -> None:
        """Log a matplotlib figure: TB ``add_figure`` when available, and
        always a PNG under ``<log_dir>/figures/`` (the reference logs
        validation spectrograms this way, tasks/tts/tts_base.py:224-245)."""
        if not self.enabled:
            return
        fig_dir = os.path.join(self.log_dir, "figures")
        os.makedirs(fig_dir, exist_ok=True)
        safe = tag.replace("/", "_")
        fig.savefig(os.path.join(fig_dir, f"{safe}_{step}.png"))
        if self._tb is not None:
            try:
                self._tb.add_figure(tag, fig, step)
            except Exception:
                pass
        import matplotlib.pyplot as plt
        plt.close(fig)

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()


class AvgMeter:
    """Weighted running average (reference AvgrageMeter semantics)."""

    def __init__(self):
        self.sum = 0.0
        self.cnt = 0

    def update(self, val: float, n: int = 1) -> None:
        self.sum += float(val) * n
        self.cnt += n

    @property
    def avg(self) -> float:
        return self.sum / max(1, self.cnt)


class MeterBank:
    def __init__(self):
        self.meters = defaultdict(AvgMeter)

    def update(self, metrics: Dict[str, float], n: int = 1) -> None:
        for k, v in metrics.items():
            self.meters[k].update(float(v), n)

    def averages(self) -> Dict[str, float]:
        return {k: m.avg for k, m in self.meters.items()}

    def reset(self) -> None:
        self.meters.clear()
