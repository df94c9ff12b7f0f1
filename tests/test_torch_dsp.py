"""The port's DSP front end against the JAX package's
(``fastdiff_tpu_torch/ops/{dsp,loudness}.py``, ``utils/audio_io.py``).

- The numpy halves are copies: ``wav2mel_np``, ``stft_magnitude_np``,
  ``mel_filterbank``, ``mel_to_linear_np`` and the loudness functions give
  arrays equal to JAX's (``assert_array_equal``).
- The torch halves against the ``*_jax`` functions on the same inputs:
  ``mel_spectrogram`` within 1e-4 abs on log-mel, ``stft_magnitude`` within
  1e-4, ``istft`` within 1e-5; ``griffin_lim`` from JAX's own initial phase
  (``PRNGKey(0)``) within 1e-4 over 3 iterations, and over 60 iterations
  its spectral convergence ||(|STFT(y)| - M)|| / ||M|| within 5 % of JAX's
  (the phase passes through ``angle()`` every iteration, so float32 FFT
  differences grow and the waveforms themselves drift apart).
- ``load_wav`` / ``save_wav`` round-trip, with resampling, as JAX's do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdiff_tpu.config import AudioConfig as JaxAudioConfig
from fastdiff_tpu.ops import dsp as jdsp
from fastdiff_tpu.ops import loudness as jloud
from fastdiff_tpu.utils import audio_io as jaudio
from fastdiff_tpu_torch.config import AudioConfig
from fastdiff_tpu_torch.ops import dsp
from fastdiff_tpu_torch.ops import loudness
from fastdiff_tpu_torch.utils import audio_io

SR = 22050


def _speechlike(seconds, seed=0, sr=SR):
    """A swept sine with harmonics and noise, silent for its last quarter."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f = 140 + 90 * t / max(seconds, 1e-9)
    phase = 2 * np.pi * np.cumsum(f) / sr
    wav = 0.4 * np.sin(phase) + 0.15 * np.sin(3 * phase)
    wav += 0.02 * rng.standard_normal(len(t))
    wav[int(0.75 * len(t)):] *= 0.001
    return wav.astype(np.float32)


def _cfgs(compression):
    kw = {} if compression == "log10" else dict(
        fmin=0.0, fmax=8000.0, mel_eps=1e-5, mel_compression="ln")
    return AudioConfig(**kw), JaxAudioConfig(**kw)


@pytest.mark.parametrize("compression", ["log10", "ln"])
def test_numpy_front_end_is_jax_s(compression):
    cfg, jcfg = _cfgs(compression)
    wav = _speechlike(1.3)
    got = dsp.wav2mel_np(wav, cfg, return_linear=True)
    want = jdsp.wav2mel_np(wav, jcfg, return_linear=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    pad = "constant" if compression == "log10" else "reflect"
    np.testing.assert_array_equal(
        dsp.stft_magnitude_np(wav, 1024, 256, 1024, pad),
        jdsp.stft_magnitude_np(wav, 1024, 256, 1024, pad))
    np.testing.assert_array_equal(
        dsp.mel_filterbank(SR, 1024, 80, cfg.fmin, cfg.fmax),
        jdsp.mel_filterbank(SR, 1024, 80, jcfg.fmin, jcfg.fmax))
    np.testing.assert_array_equal(dsp.mel_to_linear_np(got[1], cfg),
                                  jdsp.mel_to_linear_np(want[1], jcfg))


def test_loudness_is_jax_s():
    wav = _speechlike(2.0, seed=1)
    assert loudness.integrated_loudness(wav, SR) == \
        jloud.integrated_loudness(wav, SR)
    np.testing.assert_array_equal(loudness.normalize_loudness(wav, SR, -22.0),
                                  jloud.normalize_loudness(wav, SR, -22.0))
    np.testing.assert_array_equal(loudness.trim_long_silences(wav, SR),
                                  jloud.trim_long_silences(wav, SR))
    assert len(loudness.trim_long_silences(wav, SR)) < len(wav)


@pytest.mark.parametrize("compression", ["log10", "ln"])
def test_mel_spectrogram_matches_jax(compression):
    cfg, jcfg = _cfgs(compression)
    wav = np.stack([_speechlike(0.8, seed=s) for s in (2, 3)])
    got = dsp.mel_spectrogram(torch.from_numpy(wav), cfg).numpy()
    want = np.asarray(jdsp.mel_spectrogram_jax(jnp.asarray(wav), jcfg))
    assert got.shape == want.shape == (2, 80, 1 + wav.shape[1] // 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    pad = "constant" if compression == "log10" else "reflect"
    np.testing.assert_allclose(
        dsp.stft_magnitude(torch.from_numpy(wav), 1024, 256, 1024,
                           pad).numpy(),
        np.asarray(jdsp.stft_magnitude_jax(jnp.asarray(wav), 1024, 256, 1024,
                                           pad)), rtol=0, atol=1e-4)
    # the numpy front end on one utterance, within the same bound
    host = dsp.wav2mel_np(wav[0], cfg)[1]
    np.testing.assert_allclose(got[0], host[:, :got.shape[2]], rtol=0,
                               atol=1e-4)


def test_istft_matches_jax():
    rng = np.random.default_rng(4)
    mag = np.abs(rng.standard_normal((2, 513, 24))).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, (2, 513, 24)).astype(np.float32)
    got = dsp.istft(torch.from_numpy(mag), torch.from_numpy(phase), 1024, 256,
                    1024, 24 * 256).numpy()
    want = np.asarray(jdsp.istft_jax(jnp.asarray(mag), jnp.asarray(phase),
                                     1024, 256, 1024, 24 * 256))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _target(seconds=0.6):
    wav = _speechlike(seconds, seed=5)[None]
    return jdsp.stft_magnitude_np(wav[0], 1024, 256, 1024)[None]


def _convergence(wav, mag) -> float:
    rec = jdsp.stft_magnitude_np(np.asarray(wav)[0], 1024, 256, 1024)
    n = min(rec.shape[1], mag.shape[2])
    return float(np.linalg.norm(rec[:, :n] - mag[0, :, :n])
                 / np.linalg.norm(mag[0, :, :n]))


def test_griffin_lim_matches_jax():
    cfg, jcfg = AudioConfig(), JaxAudioConfig()
    mag = _target()
    phase0 = np.array(jax.random.uniform(jax.random.PRNGKey(0), mag.shape,
                                           minval=-np.pi, maxval=np.pi))
    got = dsp.griffin_lim(torch.from_numpy(mag), cfg, n_iters=3,
                          phase=torch.from_numpy(phase0)).numpy()
    want = np.asarray(jdsp.griffin_lim_jax(jnp.asarray(mag), jcfg, n_iters=3))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)

    got = dsp.griffin_lim(torch.from_numpy(mag), cfg,
                          phase=torch.from_numpy(phase0)).numpy()
    want = np.asarray(jdsp.griffin_lim_jax(jnp.asarray(mag), jcfg))
    sc_port, sc_jax = _convergence(got, mag), _convergence(want, mag)
    assert sc_port <= 1.05 * sc_jax, (sc_port, sc_jax)
    assert sc_port < 0.5


def test_griffin_lim_default_phase_is_device_independent():
    """The default initial phase comes from a CPU generator seeded 0, so a
    generator of that seed gives the same waveform."""
    cfg = AudioConfig()
    mag = torch.from_numpy(_target(0.3))
    a = dsp.griffin_lim(mag, cfg, n_iters=2)
    b = dsp.griffin_lim(mag, cfg, n_iters=2,
                        generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)


@pytest.mark.parametrize("sr_file", [22050, 16000])
def test_wav_io_round_trip(tmp_path, sr_file):
    wav = _speechlike(0.5, seed=6, sr=sr_file)
    path = str(tmp_path / "a.wav")
    audio_io.save_wav(wav, path, sr_file)
    got, sr = audio_io.load_wav(path, target_sr=SR)
    want, jsr = jaudio.load_wav(path, target_sr=SR)
    assert sr == jsr == SR
    np.testing.assert_array_equal(got, want)
    if sr_file == SR:
        # x * 32767 truncated, read back / 32768: within two steps
        np.testing.assert_allclose(got, wav, rtol=0, atol=2.0 / 32767)
    else:
        assert abs(len(got) - len(wav) * SR / sr_file) <= 1
    # save_wav casts x * 32767 without a clip, as JAX's does
    jpath = str(tmp_path / "b.wav")
    audio_io.save_wav(1.5 * wav, path, sr_file)
    jaudio.save_wav(1.5 * wav, jpath, sr_file)
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("flags", [{}, {"loud_norm": True},
                                   {"trim_long_sil": True}])
def test_wav2spec_is_jax_s(tmp_path, flags):
    """``BaseVocoder.wav2spec`` honours ``trim_long_sil`` / ``loud_norm``
    as JAX's does: the same (wav, mel) arrays."""
    from fastdiff_tpu.vocoders.base import BaseVocoder as JaxBase
    from fastdiff_tpu_torch.vocoders.base import BaseVocoder
    path = str(tmp_path / "a.wav")
    wav = np.concatenate([_speechlike(1.0, seed=7), np.zeros(SR, np.float32)])
    audio_io.save_wav(wav, path, SR)                # 1 s of silence at the end
    got = BaseVocoder.wav2spec(path, dict(flags))
    want = JaxBase.wav2spec(path, dict(flags))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    if flags.get("trim_long_sil"):
        assert len(got[0]) < len(BaseVocoder.wav2spec(path, {})[0])
