"""The port's StreamingVocoder: the mirror of tests/test_streaming_vocoder.py,
the port against JAX's module on one key-free numpy sampler (1e-6: the
crossfade, overlap-add and finalization arithmetic must match), and the
port on the graph sampler of a small FastDiff against ChunkedVocoder with
per-chunk generators (bit for bit)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdiff_tpu.serving.streaming_vocoder import \
    StreamingVocoder as JaxStreamingVocoder
from fastdiff_tpu.serving.streaming_vocoder import \
    crossfade_window as jax_crossfade_window
from fastdiff_tpu_torch.config import ModelConfig
from fastdiff_tpu_torch.diffusion.sampler import (constants_for_hparams,
                                                  make_sampler)
from fastdiff_tpu_torch.models.fastdiff import FastDiff
from fastdiff_tpu_torch.serving.chunked_vocoder import ChunkedVocoder
from fastdiff_tpu_torch.serving.streaming_vocoder import (StreamingVocoder,
                                                          crossfade_window)

HOP = 4
CHUNK, HALO = 32, 8
CORE = CHUNK - 2 * HALO


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


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _noisy_sampler(generator, mel, audio_length):
    """Generator-dependent local 'vocoder': mel-mean upsample + noise drawn
    from the generator, so RNG handling differences between paths show."""
    hop = audio_length // mel.shape[1]
    cond = torch.repeat_interleave(mel.mean(-1), hop, dim=1)
    noise = torch.randn(cond.shape, generator=generator) * 0.1
    return (cond + noise)[..., None]


def _stream(voc, mel, sizes):
    out, i = [], 0
    for n in sizes:
        out.append(voc.feed(mel[i: i + n]))
        i += n
    assert i == len(mel)
    out.append(voc.finish())
    return np.concatenate(out)


def test_feed_granularity_invariance():
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((150, 6)).astype(np.float32)

    def fresh():
        return StreamingVocoder(_noisy_sampler, HOP, CHUNK, HALO,
                                generator=_gen(3))

    one_shot = _stream(fresh(), mel, [150])
    frame_by_frame = _stream(fresh(), mel, [1] * 150)
    bursts = _stream(fresh(), mel, [7, 50, 3, 80, 10])

    assert one_shot.shape == (150 * HOP,)
    np.testing.assert_array_equal(one_shot, frame_by_frame)
    np.testing.assert_array_equal(one_shot, bursts)


def test_matches_batch_chunked_path():
    """Identical to ChunkedVocoder with per-chunk generators."""
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((200, 6)).astype(np.float32)

    batch = ChunkedVocoder(_noisy_sampler, HOP, CHUNK, HALO,
                           per_chunk_keys=True).vocode(mel,
                                                       generator=_gen(5))
    streamed = _stream(StreamingVocoder(_noisy_sampler, HOP, CHUNK, HALO,
                                        generator=_gen(5)),
                       mel, [13] * 15 + [5])
    assert streamed.shape == batch.shape
    np.testing.assert_allclose(streamed, batch, rtol=1e-6, atol=1e-6)


def test_incremental_latency_bound():
    """Samples become final within (core + halo) frames of input."""
    rng = np.random.default_rng(2)
    mel = rng.standard_normal((120, 6)).astype(np.float32)
    voc = StreamingVocoder(_noisy_sampler, HOP, CHUNK, HALO,
                           generator=_gen(0))
    emitted = 0
    for i in range(len(mel)):
        emitted += len(voc.feed(mel[i: i + 1]))
        fed = i + 1
        lag_frames = fed - emitted // HOP
        assert lag_frames <= CORE + HALO + CHUNK, lag_frames
    emitted += len(voc.finish())
    assert emitted == 120 * HOP


def test_short_stream():
    """Streams shorter than one chunk still produce frames * hop samples."""
    mel = np.random.default_rng(3).standard_normal((10, 6)).astype(np.float32)
    voc = StreamingVocoder(_noisy_sampler, HOP, CHUNK, HALO,
                           generator=_gen(0))
    out = np.concatenate([voc.feed(mel), voc.finish()])
    assert out.shape == (10 * HOP,)
    assert np.all(np.isfinite(out))


def test_low_latency_preset_invariants():
    """The <500 ms preset keeps the granularity-invariance guarantee and
    reports its latency bound correctly."""
    rng = np.random.default_rng(2)
    mel = rng.standard_normal((150, 6)).astype(np.float32)

    def fresh():
        return StreamingVocoder(_noisy_sampler, HOP, chunk_frames=48,
                                halo_frames=8, generator=_gen(9))

    voc = fresh()
    assert voc.latency_frames == 40          # core 32 + halo 8
    prod = StreamingVocoder.low_latency(_noisy_sampler, 256,
                                        generator=_gen(9))
    assert (prod.chunk, prod.halo) == (48, 8)
    assert prod.latency_seconds(22050) < 0.5

    one_shot = _stream(fresh(), mel, [150])
    frame_by_frame = _stream(fresh(), mel, [1] * 150)
    assert one_shot.shape == (150 * HOP,)
    np.testing.assert_array_equal(one_shot, frame_by_frame)


def test_feed_after_finish_raises():
    voc = StreamingVocoder(_noisy_sampler, HOP, CHUNK, HALO,
                           generator=_gen(0))
    voc.feed(np.zeros((5, 6), np.float32))
    voc.finish()
    with pytest.raises(RuntimeError, match="after finish"):
        voc.feed(np.zeros((1, 6), np.float32))
    with pytest.raises(RuntimeError, match="twice"):
        voc.finish()


def _linear(mel: np.ndarray, audio_length: int) -> np.ndarray:
    hop = audio_length // mel.shape[1]
    return np.repeat(mel.mean(-1), hop, axis=1)[..., None]


def test_crossfade_window_matches_jax():
    for core_s, halo_s in ((64, 32), (128, 2048), (8192, 4096)):
        np.testing.assert_array_equal(crossfade_window(core_s, halo_s),
                                      jax_crossfade_window(core_s, halo_s))


@pytest.mark.parametrize("chunk,halo,frames,sizes", [
    (32, 8, 150, [150]), (32, 8, 150, [7, 50, 3, 80, 10]),
    (48, 8, 97, [1] * 97), (32, 4, 10, [4, 6]), (24, 4, 45, [9] * 5)])
def test_matches_jax_module(chunk, halo, frames, sizes):
    """One key-free numpy sampler behind both modules, fed the same way:
    equal within 1e-6 after every feed and at the finish."""
    mel = np.random.default_rng(frames).standard_normal(
        (frames, 6)).astype(np.float32)
    port = StreamingVocoder(
        lambda g, m, n: torch.from_numpy(_linear(m.numpy(), n)), HOP, chunk,
        halo, generator=_gen(0))
    ref = JaxStreamingVocoder(
        lambda k, m, n: jnp.asarray(_linear(np.asarray(m), n)), HOP, chunk,
        halo)
    i = 0
    for n in sizes:
        got, want = port.feed(mel[i: i + n]), ref.feed(mel[i: i + n])
        i += n
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    got, want = port.finish(), ref.finish()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_graph_sampler_stream_matches_chunked():
    """On a small FastDiff's graph sampler: the stream equals ChunkedVocoder
    with per-chunk generators, bit for bit, through one entry. At 40
    frames the cores of the chunked path's 3 chunks end within a halo of
    the stream's end; at 45 the stream, as JAX's, runs a fourth chunk that
    changes the last frame's samples (a case of the JAX-equality test
    above)."""
    cfg = ModelConfig(inner_channels=8, cond_channels=16,
                      upsample_ratios=(4, 2, 2), kpnet_hidden_channels=8,
                      diffusion_step_embed_dim_in=16,
                      diffusion_step_embed_dim_mid=32,
                      diffusion_step_embed_dim_out=32,
                      compute_dtype="float32")
    run = make_sampler(FastDiff(cfg, seed=0).eval(),
                       constants_for_hparams({"N": 4}))
    mel = np.random.default_rng(4).normal(size=(40, 16)).astype(np.float32)
    streamed = _stream(StreamingVocoder(run, cfg.total_hop, 24, 4,
                                        generator=_gen(2)), mel, [8] * 5)
    batch = ChunkedVocoder(run, cfg.total_hop, 24, 4,
                           per_chunk_keys=True).vocode(mel,
                                                       generator=_gen(2))
    assert streamed.shape == (40 * cfg.total_hop,)
    np.testing.assert_array_equal(streamed, batch)
    assert run.graphs_cached == 1
