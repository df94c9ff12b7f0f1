"""The port's objective metrics (``utils/metrics.py``, ``utils/pesq.py``),
``vocoders/denoise.py`` and the ``evaluate`` / ``demo_vocoder`` scripts
against the JAX package's.

Every metric takes the same numpy inputs as JAX's and returns the same
value (rel 1e-6: both are the same numpy arithmetic). ``denoise`` runs its
inverse STFT in torch where JAX runs ``istft_jax``: 1e-5 of the largest
sample. PESQ's properties (``tests/test_pesq.py``) run on the port as one
parametrised test; wavs are at most 1 s so PESQ and DTW stay quick.
"""

import contextlib
import importlib.util
import io
import os

import numpy as np
import pytest
import torch

from fastdiff_tpu.utils import metrics as jax_metrics
from fastdiff_tpu.utils.pesq import pesq as jax_pesq
from fastdiff_tpu.vocoders.denoise import denoise as jax_denoise
from fastdiff_tpu_torch.config import AudioConfig
from fastdiff_tpu_torch.scripts import demo_vocoder, evaluate
from fastdiff_tpu_torch.utils import audio_io, metrics
from fastdiff_tpu_torch.utils.pesq import pesq
from fastdiff_tpu_torch.vocoders.denoise import denoise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 22050


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch intra-op thread: the suite runs several workers on the
    machine's cores, and torch's CPU kernels oversubscribe them (a 60-step
    training test took 135 s under five busy neighbours, 0.8 s with one
    thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _voice(seconds=0.8, f0=140.0, seed=0, sr=SR):
    """A harmonic series with vibrato, an amplitude envelope and a noise
    floor (speech-like enough for YIN and PESQ; the repo holds no audio)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    f = f0 + 20 * np.sin(2 * np.pi * 3.0 * t)
    ph = 2 * np.pi * np.cumsum(f) / sr
    wav = sum(np.sin(k * ph) / k for k in range(1, 8))
    env = 0.5 * (1 + np.sin(2 * np.pi * 2.5 * t + rng.uniform(0, 6)))
    wav = 0.3 * wav * env + 0.003 * rng.standard_normal(len(t))
    return wav.astype(np.float32)


REF = _voice(seed=0)
DEG = (REF + 0.02 * np.random.default_rng(5).standard_normal(len(REF))
       ).astype(np.float32)
OTHER = _voice(seconds=0.7, f0=190.0, seed=1)

CASES = {
    "log_mel": lambda m: m.log_mel(REF, _cfg(m)),
    "mel_spectral_distance": lambda m: m.mel_spectral_distance(REF, DEG),
    "mcd": lambda m: m.mcd(REF, OTHER, _cfg(m)),
    "multi_resolution_stft_distance":
        lambda m: m.multi_resolution_stft_distance(REF, DEG),
    "pesq_mos_wb": lambda m: m.pesq_mos(REF, DEG, SR),
    "pesq_mos_nb": lambda m: m.pesq_mos(REF, OTHER, SR, mode="nb"),
    "laplace_var": lambda m: m.laplace_var(m.log_mel(REF, _cfg(m))),
    "compute_rtf": lambda m: m.compute_rtf(0.0123, 22050 * 3, SR),
    "dtw_distance": lambda m: m.dtw_distance(REF[:300:3], OTHER[:400:4]),
    "pitch_alignment_distance":
        lambda m: m.pitch_alignment_distance(REF, OTHER),
}


def _cfg(module):
    """Each side's own AudioConfig (the same defaults)."""
    if module is metrics:
        return AudioConfig()
    from fastdiff_tpu.config import AudioConfig as JaxAudioConfig
    return JaxAudioConfig()


@pytest.mark.parametrize("name", sorted(CASES))
def test_metric_matches_jax(name):
    """Each function of utils/metrics.py against JAX's on the same numpy
    inputs, rel 1e-6."""
    got = np.asarray(CASES[name](metrics), np.float64)
    want = np.asarray(CASES[name](jax_metrics), np.float64)
    assert got.shape == want.shape
    assert np.all(np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("sr,mode", [(16000, "wb"), (8000, "nb"),
                                     (22050, "wb")])
def test_pesq_matches_jax(sr, mode):
    ref = _voice(seconds=0.9, sr=sr, seed=2)
    deg = np.concatenate([np.zeros(sr // 50), 0.5 * ref])[: len(ref)]
    deg = deg + 0.01 * np.random.default_rng(3).standard_normal(len(ref))
    assert pesq(ref, deg, sr, mode) == pytest.approx(
        jax_pesq(ref, deg, sr, mode), rel=1e-6)


def _with_snr(wav, snr_db, seed=1):
    rng = np.random.default_rng(seed)
    noise = rng.normal(size=wav.shape)
    noise *= np.sqrt((wav ** 2).mean() / (noise ** 2).mean())
    return wav + noise * 10 ** (-snr_db / 20)


@pytest.mark.parametrize("prop", ["identity", "monotone_snr", "delay",
                                  "gain"])
def test_pesq_properties(prop):
    """tests/test_pesq.py's properties on the port's PESQ (16 kHz, 1 s):
    the identity ceiling, monotone in SNR, delay and gain invariance."""
    sr = 16000
    clean = _voice(seconds=1.0, sr=sr).astype(np.float64)
    clean = clean / np.abs(clean).max()
    ceiling = pesq(clean, clean, sr)
    if prop == "identity":
        assert ceiling > 4.5
        assert pesq(clean, clean, sr, mode="nb") > 4.4
        assert ceiling <= 4.65
    elif prop == "monotone_snr":
        scores = [pesq(clean, _with_snr(clean, snr), sr)
                  for snr in (40, 30, 20, 10, 0)]
        assert all(a > b for a, b in zip(scores, scores[1:])), scores
        assert scores[0] > 4.0
        assert scores[-1] < 2.0
    elif prop == "delay":
        delayed = np.concatenate([np.zeros(sr // 20), clean])  # +50 ms
        assert abs(pesq(clean, delayed, sr) - ceiling) < 0.15
    else:
        assert abs(pesq(clean, 0.25 * clean, sr) - ceiling) < 0.1


@pytest.mark.parametrize("c,noise_frames", [(0.1, 5), (0.5, 3)])
def test_denoise_matches_jax(c, noise_frames):
    """vocoders/denoise.py on the CPU against JAX's (its istft_jax), 1e-5
    of the largest sample."""
    wav = DEG[:12000]
    got = denoise(wav, c=c, noise_frames=noise_frames, device="cpu")
    want = np.asarray(jax_denoise(wav, c=c, noise_frames=noise_frames))
    assert got.shape == want.shape == wav.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_denoise_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        denoise(DEG[:4096])


def _jax_evaluate():
    spec = importlib.util.spec_from_file_location(
        "jax_evaluate_script", os.path.join(REPO, "scripts", "evaluate.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("form", ["gen_dir", "two_dirs"])
def test_evaluate_matches_jax_script(form, tmp_path, monkeypatch):
    """The port's evaluate on the same directories as JAX's
    scripts/evaluate.py: the same rows and means, printed the same, and
    the means equal to the metrics' own means (rel 1e-6)."""
    pred_dir, gt_dir = tmp_path / "pred", tmp_path / "gt"
    pred_dir.mkdir()
    gt_dir.mkdir()
    pairs = []
    items = [(REF, DEG), (OTHER, _with_snr(OTHER, 15))]
    for i, (gt, pred) in enumerate(items):
        if form == "gen_dir":
            p, g = pred_dir / f"u{i}_pred.wav", pred_dir / f"u{i}_gt.wav"
        else:
            p, g = pred_dir / f"u{i}.wav", gt_dir / f"u{i}.wav"
        audio_io.save_wav(np.asarray(pred, np.float32), str(p), SR)
        audio_io.save_wav(gt, str(g), SR)
        pairs.append((str(p), str(g)))
    args = [str(pred_dir)] if form == "gen_dir" else [str(pred_dir),
                                                      str(gt_dir)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert evaluate.main(args) == 0
    port_text = out.getvalue()
    jax_script = _jax_evaluate()
    monkeypatch.setattr("sys.argv", ["evaluate.py", *args])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jax_script.main() == 0
    assert port_text == out.getvalue()
    with contextlib.redirect_stdout(io.StringIO()):
        rows = evaluate.evaluate_pairs(pairs)
    for key, fn in (("mcd", jax_metrics.mcd),
                    ("mrstft", jax_metrics.multi_resolution_stft_distance)):
        want = np.mean([fn(audio_io.load_wav(p)[0], audio_io.load_wav(g)[0])
                        for p, g in pairs])
        assert np.mean([r[key] for r in rows]) == pytest.approx(want,
                                                                rel=1e-6)


def test_evaluate_without_pairs(tmp_path, capsys):
    assert evaluate.main([str(tmp_path)]) == 1
    assert evaluate.main([]) == 1


def test_demo_vocoder_on_cpu(tmp_path, capsys):
    """demo_vocoder at full width (seed weights, N = 4) on a 0.3 s wav with
    --device cpu: both wavs written, the prediction frames * 256 finite
    samples; the JAX script's output lines."""
    wav_path = tmp_path / "in.wav"
    audio_io.save_wav(_voice(seconds=0.3), str(wav_path), SR)
    out = tmp_path / "out"
    assert demo_vocoder.main(["--wav", str(wav_path), "--N", "4", "--out",
                              str(out), "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "no --ckpt: using random weights" in text
    assert "fractional steps" in text and "RTF" in text
    pred, sr = audio_io.load_wav(str(out / "in_pred.wav"))
    gt, _ = audio_io.load_wav(str(out / "in_gt.wav"))
    assert sr == SR
    assert len(pred) == len(gt) and len(pred) % 256 == 0
    assert np.isfinite(pred).all() and np.abs(pred).max() > 0.5
