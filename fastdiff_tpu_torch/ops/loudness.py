"""ITU-R BS.1770-4 loudness metering and normalization, a copy of
``fastdiff_tpu/ops/loudness.py`` (numpy and scipy).

K-weighting (a high shelf and a high pass, with coefficients derived for
any sample rate), 400 ms gating blocks with 75 % overlap, the -70 LUFS
absolute and -10 LU relative gates; ``normalize_loudness`` gains a signal to
a target loudness, ``trim_long_silences`` shortens long silent stretches
with an energy VAD at 30 ms granularity. A full-scale 997 Hz sine reads
~-3.0 LUFS.
"""

from __future__ import annotations

import numpy as np


def _k_weighting_coeffs(fs: float):
    """Stage-1 shelf + stage-2 high-pass biquads for sample rate fs
    (BS.1770-4 Table 1/2 are given for 48 kHz; these parametric forms
    reproduce them exactly at 48 kHz and generalize to other rates)."""
    # stage 1: spherical-head high shelf
    g_db = 3.999843853973347
    fc = 1681.974450955533
    q = 0.7071752369554196
    k = np.tan(np.pi * fc / fs)
    vh = 10.0 ** (g_db / 20.0)
    vb = vh ** 0.4996667741545416
    a0 = 1.0 + k / q + k * k
    shelf_b = np.array([(vh + vb * k / q + k * k) / a0,
                        2.0 * (k * k - vh) / a0,
                        (vh - vb * k / q + k * k) / a0])
    shelf_a = np.array([1.0, 2.0 * (k * k - 1.0) / a0,
                        (1.0 - k / q + k * k) / a0])
    # stage 2: high pass (RLB weighting)
    fc = 38.13547087602444
    q = 0.5003270373238773
    k = np.tan(np.pi * fc / fs)
    a0 = 1.0 + k / q + k * k
    hp_b = np.array([1.0, -2.0, 1.0])
    hp_a = np.array([1.0, 2.0 * (k * k - 1.0) / a0,
                     (1.0 - k / q + k * k) / a0])
    return (shelf_b, shelf_a), (hp_b, hp_a)


def _biquad(b, a, x):
    from scipy.signal import lfilter
    return lfilter(b, a, x)


def integrated_loudness(wav: np.ndarray, sr: int) -> float:
    """Gated integrated loudness in LUFS (mono). Returns -inf for silence
    or signals shorter than one 400 ms gating block."""
    wav = np.asarray(wav, np.float64)
    (sb, sa), (hb, ha) = _k_weighting_coeffs(sr)
    y = _biquad(hb, ha, _biquad(sb, sa, wav))

    block = int(round(0.400 * sr))
    step = int(round(0.100 * sr))                 # 75% overlap
    if y.shape[0] < block:
        return float("-inf")
    n_blocks = (y.shape[0] - block) // step + 1
    idx = np.arange(block)[None, :] + step * np.arange(n_blocks)[:, None]
    z = np.mean(y[idx] ** 2, axis=1)              # per-block mean square
    with np.errstate(divide="ignore"):
        lk = -0.691 + 10.0 * np.log10(np.maximum(z, 1e-30))

    above_abs = lk > -70.0
    if not above_abs.any():
        return float("-inf")
    rel_threshold = (-0.691 + 10.0 * np.log10(np.mean(z[above_abs]))) - 10.0
    gated = z[above_abs & (lk > rel_threshold)]
    if gated.size == 0:
        return float("-inf")
    return float(-0.691 + 10.0 * np.log10(np.mean(gated)))


def normalize_loudness(wav: np.ndarray, sr: int,
                       target_lufs: float = -22.0,
                       peak_limit: bool = True) -> np.ndarray:
    """Gain the signal to the target integrated loudness (the reference's
    pyln.normalize.loudness + its peak-renormalization guard,
    data_gen_utils.py:116-120)."""
    loudness = integrated_loudness(wav, sr)
    if not np.isfinite(loudness):
        return np.asarray(wav, np.float32)
    gain = 10.0 ** ((target_lufs - loudness) / 20.0)
    out = np.asarray(wav, np.float32) * np.float32(gain)
    if peak_limit and np.abs(out).max() > 1.0:
        out = out / np.abs(out).max()
    return out


def trim_long_silences(wav: np.ndarray, sr: int,
                       max_silence_frames: int = 12,
                       window_ms: int = 30,
                       moving_average_width: int = 8,
                       threshold_db: float = -40.0) -> np.ndarray:
    """Clip silent stretches to at most ``max_silence_frames`` VAD frames
    (reference behavior: data_gen_utils.py:27-90, which uses webrtcvad on a
    16 kHz resample; here an energy VAD at the same 30 ms granularity —
    same contract: voiced audio is untouched, long silences shrink)."""
    wav = np.asarray(wav, np.float32)
    spw = max(1, (window_ms * sr) // 1000)
    n_frames = len(wav) // spw
    if n_frames == 0:
        return wav
    frames = wav[: n_frames * spw].reshape(n_frames, spw)
    rms = np.sqrt(np.mean(frames ** 2, axis=1) + 1e-12)
    ref = np.max(rms) + 1e-12
    voiced = 20.0 * np.log10(rms / ref) > threshold_db
    # moving-average smoothing (reference width 8), then binary dilation
    kernel = np.ones(moving_average_width) / moving_average_width
    voiced = np.convolve(voiced.astype(np.float32), kernel, "same") > 0.5
    # keep silences up to max_silence_frames, split across BOTH ends of the
    # run (the reference dilates the voiced mask symmetrically,
    # data_gen_utils.py:27-90, so silence adjoining a voiced onset survives;
    # keeping only the leading frames would clip pre-onset silence and shift
    # alignment relative to reference preprocessing)
    keep = voiced.copy()
    run_start = None
    for i in range(n_frames + 1):
        v = voiced[i] if i < n_frames else True
        if not v and run_start is None:
            run_start = i
        elif v and run_start is not None:
            if i - run_start <= max_silence_frames:
                keep[run_start:i] = True
            else:
                head = max_silence_frames - max_silence_frames // 2
                tail = max_silence_frames // 2
                keep[run_start:run_start + head] = True
                keep[i - tail:i] = True
            run_start = None
    mask = np.repeat(keep, spw)
    tail = wav[n_frames * spw:]
    return np.concatenate([wav[: n_frames * spw][mask], tail])
