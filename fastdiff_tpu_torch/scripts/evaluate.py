"""Objective evaluation: compare generated wavs against ground truth
(``scripts/evaluate.py`` on the port's metrics, ``utils/metrics.py``).

    python -m fastdiff_tpu_torch.scripts.evaluate <gen_dir>
        # uses *_pred.wav / *_gt.wav pairs
    python -m fastdiff_tpu_torch.scripts.evaluate <pred_dir> <gt_dir>
        # matched file names

Reports MCD, log-mel spectral distance, multi-resolution STFT distance and
PESQ MOS-LQO per pair, then each one's mean and standard deviation. The
metrics are numpy on the host: no device is used.
"""

import glob
import os
import sys

import numpy as np

from fastdiff_tpu_torch.config import AudioConfig
from fastdiff_tpu_torch.utils import audio_io, metrics


def pairs_from_gen_dir(gen_dir):
    for pred in sorted(glob.glob(os.path.join(gen_dir, "*_pred.wav"))):
        gt = pred.replace("_pred.wav", "_gt.wav")
        if os.path.exists(gt):
            yield pred, gt


def pairs_from_two_dirs(pred_dir, gt_dir):
    for pred in sorted(glob.glob(os.path.join(pred_dir, "*.wav"))):
        gt = os.path.join(gt_dir, os.path.basename(pred))
        if os.path.exists(gt):
            yield pred, gt


def evaluate_pairs(pairs) -> list:
    """One row of metrics per (pred, gt) path pair, printed as it goes."""
    cfg = AudioConfig()
    rows = []
    for pred_fn, gt_fn in pairs:
        pred, _ = audio_io.load_wav(pred_fn)
        gt, _ = audio_io.load_wav(gt_fn)
        rows.append({
            "item": os.path.basename(pred_fn),
            "mcd": metrics.mcd(pred, gt, cfg),
            "msd": metrics.mel_spectral_distance(pred, gt, cfg),
            "mrstft": metrics.multi_resolution_stft_distance(pred, gt),
            "pesq": metrics.pesq_mos(gt, pred, cfg.sample_rate),
        })
        r = rows[-1]
        print(f"{r['item']:40s} mcd={r['mcd']:6.2f} msd={r['msd']:6.2f} "
              f"mrstft={r['mrstft']:6.3f} pesq={r['pesq']:5.2f}")
    return rows


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    if len(args) == 1:
        pairs = list(pairs_from_gen_dir(args[0]))
    elif len(args) == 2:
        pairs = list(pairs_from_two_dirs(args[0], args[1]))
    else:
        print(__doc__)
        return 1
    if not pairs:
        print("no (pred, gt) pairs found")
        return 1
    rows = evaluate_pairs(pairs)
    print("-" * 70)
    for key in ("mcd", "msd", "mrstft", "pesq"):
        vals = [r[key] for r in rows]
        print(f"mean {key}: {np.mean(vals):.3f} (+/- {np.std(vals):.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
