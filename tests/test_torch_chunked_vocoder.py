"""The port's ChunkedVocoder: the mirror of tests/test_chunked_vocoder.py
(all but the mesh test), the port against JAX's module on one key-free
numpy sampler (1e-6: the crossfade and overlap-add arithmetic must match),
and the port on the graph sampler of a small FastDiff (bit for bit against
the eager sampler's chunks crossfaded by JAX's module)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdiff_tpu.serving.chunked_vocoder import \
    ChunkedVocoder as JaxChunkedVocoder
from fastdiff_tpu_torch.config import ModelConfig
from fastdiff_tpu_torch.diffusion.sampler import (constants_for_hparams,
                                                  fold_in, make_sampler,
                                                  sample, split)
from fastdiff_tpu_torch.models.fastdiff import FastDiff
from fastdiff_tpu_torch.serving.chunked_vocoder import ChunkedVocoder

CPU = torch.Generator()


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


def _linear(mel: np.ndarray, audio_length: int) -> np.ndarray:
    """Deterministic, local 'vocoder': the mel mean upsampled by hop (no
    noise), so chunked and unchunked outputs agree away from the edges."""
    hop = audio_length // mel.shape[1]
    return np.repeat(mel.mean(-1), hop, axis=1)[..., None]


def _linear_sampler(generator, mel, audio_length):
    return torch.from_numpy(_linear(mel.numpy(), audio_length))


def _jax_linear_sampler(key, mel, audio_length):
    return jnp.asarray(_linear(np.asarray(mel), audio_length))


def test_short_input_single_call():
    voc = ChunkedVocoder(_linear_sampler, hop_size=4, chunk_frames=64,
                         halo_frames=8)
    mel = np.random.default_rng(0).standard_normal((50, 6)).astype(np.float32)
    wav = voc.vocode(mel, generator=CPU)
    assert wav.shape == (200,)


def test_chunked_matches_unchunked_for_local_sampler():
    hop = 4
    voc = ChunkedVocoder(_linear_sampler, hop_size=hop, chunk_frames=32,
                         halo_frames=8)
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((150, 6)).astype(np.float32)   # forces chunking
    wav = voc.vocode(mel, generator=CPU)
    want = _linear(mel[None], 150 * hop)[0, :, 0]
    assert wav.shape == want.shape
    np.testing.assert_allclose(wav, want, rtol=1e-4, atol=1e-5)


def test_odd_lengths():
    voc = ChunkedVocoder(_linear_sampler, hop_size=4, chunk_frames=32,
                         halo_frames=4)
    for frames in (33, 57, 100, 129):
        mel = np.ones((frames, 6), np.float32)
        wav = voc.vocode(mel, generator=CPU)
        assert wav.shape == (frames * 4,)
        assert np.isfinite(wav).all()


@pytest.mark.parametrize("frames,chunk,halo,per_chunk", [
    (50, 64, 8, False), (150, 32, 8, False), (129, 32, 4, False),
    (200, 48, 8, True), (33, 32, 4, True)])
def test_matches_jax_module(frames, chunk, halo, per_chunk):
    """One key-free numpy sampler behind both modules: equal within 1e-6."""
    mel = np.random.default_rng(frames).standard_normal(
        (frames, 6)).astype(np.float32)
    kw = dict(hop_size=4, chunk_frames=chunk, halo_frames=halo,
              per_chunk_keys=per_chunk)
    want = JaxChunkedVocoder(_jax_linear_sampler, **kw).vocode(mel)
    got = ChunkedVocoder(_linear_sampler, **kw).vocode(mel, generator=CPU)
    assert got.shape == want.shape == (frames * 4,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_chunk_must_exceed_two_halos():
    with pytest.raises(ValueError, match="twice halo_frames"):
        ChunkedVocoder(_linear_sampler, hop_size=4, chunk_frames=32,
                       halo_frames=16)


SMALL = ModelConfig(inner_channels=8, cond_channels=16,
                    upsample_ratios=(4, 2, 2), kpnet_hidden_channels=8,
                    diffusion_step_embed_dim_in=16,
                    diffusion_step_embed_dim_mid=32,
                    diffusion_step_embed_dim_out=32, compute_dtype="float32")


@pytest.mark.parametrize("per_chunk", [False, True])
def test_graph_sampler_one_shape_for_any_length(per_chunk):
    """On a small FastDiff's graph sampler, with per-chunk generators every
    call is one chunk: one shape (one entry) for any length. The batched
    call's batch is the chunk count, so each chunk count is a shape of its
    own: two lengths of 5 and 3 chunks, each vocoded twice, capture two
    graphs. The output equals the eager sampler's chunks (one batched
    call, or each chunk with fold_in(split(generator), i)) crossfaded by
    JAX's module, bit for bit, and a replay equals the first call."""
    hop, chunk, halo, frames = SMALL.total_hop, 24, 4, 70
    model = FastDiff(SMALL, seed=0).eval()
    const = constants_for_hparams({"N": 4})
    run = make_sampler(model, const)
    mel = np.random.default_rng(2).normal(size=(frames, 16)).astype(
        np.float32)
    voc = ChunkedVocoder(run, hop, chunk_frames=chunk, halo_frames=halo,
                         per_chunk_keys=per_chunk)
    wav = voc.vocode(mel, generator=torch.Generator().manual_seed(9))
    assert wav.shape == (frames * hop,) and np.isfinite(wav).all()
    np.testing.assert_array_equal(
        voc.vocode(mel, generator=torch.Generator().manual_seed(9)), wav)
    for _ in range(2):
        voc.vocode(mel[:40], generator=torch.Generator().manual_seed(9))
    shapes = 1 if per_chunk else 2
    assert run.graphs_cached == shapes and run.captures == shapes
    assert run.warmups == shapes

    core = chunk - 2 * halo
    n_chunks = -(-frames // core)
    mel_pad = np.pad(mel, ((halo, n_chunks * core + halo - frames), (0, 0)),
                     mode="edge")
    chunks = torch.from_numpy(np.stack([mel_pad[i * core: i * core + chunk]
                                        for i in range(n_chunks)]))
    gen = torch.Generator().manual_seed(9)
    with torch.no_grad():
        if per_chunk:
            stream = split(gen)
            wavs = [sample(model, chunks[i:i + 1], const, chunk * hop,
                           generator=fold_in(stream, i)).numpy()
                    for i in range(n_chunks)]
        else:
            wavs = [sample(model, chunks, const, chunk * hop,
                           generator=gen).numpy()]
    want = JaxChunkedVocoder(lambda key, m, length: wavs.pop(0), hop,
                             chunk_frames=chunk, halo_frames=halo,
                             per_chunk_keys=per_chunk).vocode(mel)
    np.testing.assert_array_equal(wav, want)
