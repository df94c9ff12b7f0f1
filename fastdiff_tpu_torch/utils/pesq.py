"""PESQ (ITU-T P.862 / P.862.2) — perceptual speech-quality MOS estimator.

The port's copy of ``fastdiff_tpu/utils/pesq.py`` (numpy and scipy, no
JAX), line for line: the same tables, constants and arithmetic, so the
two give the same score on the same inputs.

Fresh numpy implementation of the published P.862 algorithm structure
(BASELINE.md names PESQ as half of the quality-parity metric pair; the
reference repo has no metric code at all — utils/metrics.py is a 5-line
laplace helper).

Pipeline (per the standard):

1.  resample ref/deg to the model rate (16 kHz wideband by default),
2.  level alignment to a fixed target power in the speech band,
3.  input filtering (P.862.2 wideband: 100 Hz IIR high-pass),
4.  envelope-based crude delay + cross-correlation fine delay compensation,
5.  perceptual model: 32 ms Hann frames (50% overlap) -> power spectra ->
    Bark-band integration -> absolute-hearing-threshold gating ->
    per-band frequency compensation (ref toward deg) -> short-term gain
    compensation (deg toward ref) -> Zwicker loudness transform,
6.  disturbance: masked loudness difference (symmetric) + asymmetry-
    weighted disturbance (degraded-additive distortions weigh more),
    L2-over-bands, L6-over-split-second windows, L2-over-time,
7.  MOS = 4.5 - 0.1 * d_sym - 0.0309 * d_asym, mapped to MOS-LQO with the
    P.862.2 logistic.

Honesty note (validation): the ITU reference implementation and its exact
lookup tables are not redistributable and are not present in this
zero-egress environment, so band tables and hearing thresholds here are
*derived from the published psychoacoustic formulas* (Zwicker Bark scale,
Terhardt absolute-threshold approximation) rather than copied. Scores are
calibrated to the standard [1.02, 4.64] scale and behave correctly under
metamorphic tests (identity ~4.6, monotone in SNR, delay/gain invariant —
tests/test_pesq.py), but third-party decimal agreement is unverified. Treat
cross-framework comparisons as approximate; within-framework comparisons
(the BASELINE parity protocol) are exact.
"""

from __future__ import annotations

import numpy as np
from scipy import signal as sps

_TARGET_POWER = 1e7          # level-alignment target (P.862 uses ~10^7)
_FRAME_MS = 32.0
_N_BARK = 49                 # wideband band count (42 narrowband)
_SPLIT_SECOND = 20           # frames per L6 aggregation window (~0.32 s)


# ---------------------------------------------------------------------------
# Psychoacoustic tables (formula-derived; see module docstring)
# ---------------------------------------------------------------------------

def _bark(f_hz: np.ndarray) -> np.ndarray:
    """Zwicker & Terhardt critical-band rate (Bark)."""
    f = np.asarray(f_hz, np.float64)
    return 13.0 * np.arctan(0.00076 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


def _abs_threshold_db(f_hz: np.ndarray) -> np.ndarray:
    """Terhardt's absolute hearing threshold approximation (dB SPL)."""
    f = np.maximum(np.asarray(f_hz, np.float64), 20.0) / 1000.0
    return (3.64 * f ** -0.8
            - 6.5 * np.exp(-0.6 * (f - 3.3) ** 2)
            + 1e-3 * f ** 4)


class _BarkModel:
    """FFT-bin -> Bark-band integration for one (fs, nfft) geometry."""

    def __init__(self, fs: int, nfft: int, n_bands: int, fmax: float):
        freqs = np.fft.rfftfreq(nfft, 1.0 / fs)
        z_edges = np.linspace(_bark(np.array([20.0]))[0],
                              _bark(np.array([fmax]))[0], n_bands + 1)
        z_bins = _bark(freqs)
        self.band_of_bin = np.clip(
            np.searchsorted(z_edges, z_bins, side="right") - 1, -1, n_bands)
        self.band_of_bin[(z_bins < z_edges[0]) | (z_bins > z_edges[-1])] = -1
        self.n_bands = n_bands
        counts = np.array([(self.band_of_bin == b).sum()
                           for b in range(n_bands)], np.float64)
        self.counts = np.maximum(counts, 1.0)
        centers_hz = []
        for b in range(n_bands):
            sel = freqs[self.band_of_bin == b]
            centers_hz.append(sel.mean() if len(sel) else
                              0.5 * (fs / nfft))
        self.centers_hz = np.asarray(centers_hz)
        self.width_bark = np.diff(z_edges)
        # absolute threshold as band power on the same scale as the frame
        # power spectra (calibrated so conversational speech at the target
        # level sits ~70 dB above threshold, as in the standard's intent)
        thr_db = _abs_threshold_db(self.centers_hz)
        self.abs_thresh = 10.0 ** ((thr_db - 30.0) / 10.0)

    def integrate(self, power_spec: np.ndarray) -> np.ndarray:
        """(frames, bins) power -> (frames, n_bands) mean band power."""
        frames = power_spec.shape[0]
        out = np.zeros((frames, self.n_bands))
        for b in range(self.n_bands):
            sel = self.band_of_bin == b
            if sel.any():
                out[:, b] = power_spec[:, sel].sum(axis=1) / self.counts[b]
        return out


# ---------------------------------------------------------------------------
# Pre-processing
# ---------------------------------------------------------------------------

def _resample(wav: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    if sr == target_sr:
        return np.asarray(wav, np.float64)
    g = np.gcd(sr, target_sr)
    return sps.resample_poly(np.asarray(wav, np.float64),
                             target_sr // g, sr // g)


def _level_align(wav: np.ndarray, fs: int) -> np.ndarray:
    """Scale to fixed power in the 350-3250 Hz speech band."""
    sos = sps.butter(4, [350.0, 3250.0], btype="band", fs=fs, output="sos")
    band = sps.sosfilt(sos, wav)
    p = np.mean(band ** 2) + 1e-20
    return wav * np.sqrt(_TARGET_POWER / p)


def _input_filter(wav: np.ndarray, fs: int) -> np.ndarray:
    """P.862.2 wideband input filter: IIR high-pass at 100 Hz."""
    sos = sps.butter(4, 100.0, btype="high", fs=fs, output="sos")
    return sps.sosfilt(sos, wav)


def _estimate_delay(ref: np.ndarray, deg: np.ndarray, fs: int) -> int:
    """Crude (4 ms envelope) + fine (sample) delay of deg relative to ref."""
    hop = max(1, int(fs * 0.004))
    n = min(len(ref), len(deg)) // hop

    def env(x):
        e = x[: n * hop].reshape(n, hop)
        return np.log1p(np.sqrt(np.mean(e ** 2, axis=1)))

    er, ed = env(ref), env(deg)
    er = er - er.mean()
    ed = ed - ed.mean()
    xc = sps.correlate(ed, er, mode="full")
    crude = (np.argmax(np.abs(xc)) - (n - 1)) * hop

    # fine: sample-level cross-correlation in a +-hop window around crude
    win = 2 * hop
    lo = max(0, -crude) + win
    hi = min(len(ref), len(deg) - crude) - win
    if hi - lo < fs // 4:
        return int(crude)
    r = ref[lo:hi]
    d = deg[lo + crude - win: hi + crude + win]
    xc = sps.correlate(d, r, mode="valid")
    fine = np.argmax(np.abs(xc)) - win
    return int(crude + fine)


# ---------------------------------------------------------------------------
# Perceptual model
# ---------------------------------------------------------------------------

def _frames_power(wav: np.ndarray, fs: int, nfft: int) -> np.ndarray:
    hop = nfft // 2
    n = (len(wav) - nfft) // hop + 1
    if n < 4:
        raise ValueError("signal too short for PESQ (need >= ~0.1 s)")
    idx = np.arange(nfft)[None, :] + hop * np.arange(n)[:, None]
    frames = wav[idx] * np.hanning(nfft)[None, :]
    spec = np.fft.rfft(frames, axis=1)
    return (spec.real ** 2 + spec.imag ** 2) / nfft


def _loudness(bark_pow: np.ndarray, model: _BarkModel) -> np.ndarray:
    """Zwicker loudness density per band (sone-like)."""
    tq = model.abs_thresh[None, :]
    ratio = np.maximum(bark_pow / tq, 0.0)
    s = ((tq / 0.5) ** 0.23) * ((0.5 + 0.5 * ratio) ** 0.23 - 1.0)
    return np.where(bark_pow > tq, s, 0.0)


def _lp(x: np.ndarray, p: float, axis=-1, weights=None) -> np.ndarray:
    if weights is None:
        return (np.mean(np.abs(x) ** p, axis=axis)) ** (1.0 / p)
    w = weights / weights.sum()
    return (np.sum(w * np.abs(x) ** p, axis=axis)) ** (1.0 / p)


def pesq(ref, deg, sr: int, mode: str = "wb") -> float:
    """PESQ MOS-LQO of ``deg`` against clean ``ref`` (higher is better).

    mode 'wb' (P.862.2, 16 kHz model) or 'nb' (P.862, 8 kHz model).
    """
    fs = 16000 if mode == "wb" else 8000
    n_bands = _N_BARK if mode == "wb" else 42
    nfft = int(fs * _FRAME_MS / 1000)     # 512 wb / 256 nb
    fmax = min(fs / 2.0, 8000.0) - 1.0

    ref = _resample(np.asarray(ref, np.float64), sr, fs)
    deg = _resample(np.asarray(deg, np.float64), sr, fs)
    ref = _level_align(ref - ref.mean(), fs)
    deg = _level_align(deg - deg.mean(), fs)
    if mode == "wb":
        ref = _input_filter(ref, fs)
        deg = _input_filter(deg, fs)

    # time alignment
    delay = _estimate_delay(ref, deg, fs)
    if delay > 0:
        deg = deg[delay:]
    elif delay < 0:
        ref = ref[-delay:]
    n = min(len(ref), len(deg))
    ref, deg = ref[:n], deg[:n]

    model = _BarkModel(fs, nfft, n_bands, fmax)
    pr = model.integrate(_frames_power(ref, fs, nfft))
    pd = model.integrate(_frames_power(deg, fs, nfft))

    # speech-active frames: above a fraction of the ref median energy
    frame_pow = pr.sum(axis=1)
    active = frame_pow > 1e-2 * np.median(frame_pow[frame_pow > 0] + 1e-20)
    if active.sum() < 4:
        active = np.ones_like(active)

    # frequency compensation: scale ref bands toward deg (linear-distortion
    # forgiveness), clipped to [-20, +20] dB
    num = (pd[active] * (pr[active] > model.abs_thresh)).sum(axis=0) + 1e3
    den = (pr[active] * (pr[active] > model.abs_thresh)).sum(axis=0) + 1e3
    band_factor = np.clip(num / den, 0.01, 100.0)
    pr_eq = pr * band_factor[None, :]

    # short-term gain compensation: scale deg frames toward ref, clipped,
    # smoothed with a 1st-order recursion
    audible_r = np.sum(np.maximum(pr_eq - model.abs_thresh, 0), axis=1) + 1e4
    audible_d = np.sum(np.maximum(pd - model.abs_thresh, 0), axis=1) + 1e4
    g = np.clip(audible_r / audible_d, 3e-4, 5.0)
    g_s = np.empty_like(g)
    acc = 1.0
    for i, gi in enumerate(g):           # short loop over frames
        acc = 0.8 * acc + 0.2 * gi
        g_s[i] = acc
    pd_eq = pd * g_s[:, None]

    lr = _loudness(pr_eq, model)
    ld = _loudness(pd_eq, model)

    # masked disturbance
    d = ld - lr
    m = 0.25 * np.minimum(ld, lr)
    d = np.sign(d) * np.maximum(np.abs(d) - m, 0.0)

    # asymmetry factor: additive (deg > ref) distortion weighs more
    af = ((pd_eq + 50.0) / (pr_eq + 50.0)) ** 1.2
    af = np.where(af < 3.0, 0.0, np.minimum(af, 12.0))

    w = model.width_bark[None, :]
    d_frame = _lp(d * w, 2.0, axis=1) / np.mean(w)
    da_frame = np.sum(np.abs(d) * af * w, axis=1) / np.sum(w)

    # weight frames by audible power (quiet frames matter less); the scalar
    # calibrates the formula-derived tables to the standard severity curve
    # (white noise at 20 dB SNR ~ 2.5 LQO; tests/test_pesq.py)
    cal = 2.0
    fw = ((audible_r + 1e5) / 1e7) ** 0.04
    d_frame = np.minimum(cal * d_frame / fw, 45.0)
    da_frame = np.minimum(cal * da_frame / fw, 45.0)

    def aggregate(x):
        k = _SPLIT_SECOND
        pad = (-len(x)) % k
        xx = np.pad(x, (0, pad))
        windows = _lp(xx.reshape(-1, k), 6.0, axis=1)
        return _lp(windows, 2.0)

    d_sym = aggregate(d_frame[active])
    d_asym = aggregate(da_frame[active])

    raw = 4.5 - 0.1 * d_sym - 0.0309 * d_asym
    raw = float(np.clip(raw, -0.5, 4.5))

    # P.862.2 logistic raw->LQO mapping
    if mode == "wb":
        return float(0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224)))
    return float(0.999 + 4.0 / (1.0 + np.exp(-1.4945 * raw + 4.6607)))
