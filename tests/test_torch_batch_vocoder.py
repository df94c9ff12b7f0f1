"""The port's BatchedVocoder on one card (``fastdiff_tpu/serving/
batch_vocoder.py`` without the mesh): the mirror of
tests/test_batch_vocoder.py's shapes test, the bucketing and trims seen by
a recording sampler, and a small FastDiff through the graph sampler
against per-utterance eager calls (bit for bit: the same generator drawn
in the same order)."""

import numpy as np
import pytest
import torch

from fastdiff_tpu_torch.config import DiffusionConfig, ModelConfig
from fastdiff_tpu_torch.diffusion import schedules
from fastdiff_tpu_torch.diffusion.sampler import constants_for_hparams, sample
from fastdiff_tpu_torch.models.fastdiff import FastDiff
from fastdiff_tpu_torch.serving.batch_vocoder import BatchedVocoder

FRAMES = (5, 8, 13, 16, 7, 21, 3, 9, 10)


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


def _constants(n=4):
    hp = schedules.compute_hyperparams_given_schedule(
        schedules.linear_beta_schedule(DiffusionConfig(T=50, beta_0=1e-4,
                                                       beta_T=0.05)))
    return schedules.sampler_constants_for_schedule(
        np.linspace(1e-4, 0.05, n), hp)


class _FakeDenoise(torch.nn.Module):
    """The JAX test's mel-conditioned toy denoiser."""

    def __init__(self, hop):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.tensor(0.1))
        self.hop = hop

    def forward(self, x, mel, t):
        cond = torch.repeat_interleave(mel.mean(-1, keepdim=True), self.hop,
                                       dim=1)
        return self.scale * x + 0.01 * cond


def _mels(n_mels=6):
    rng = np.random.default_rng(0)
    return [rng.standard_normal((f, n_mels)).astype(np.float32)
            for f in FRAMES]


def test_batched_vocoder_shapes():
    hop = 4
    voc = BatchedVocoder(_FakeDenoise(hop), _constants(), hop_size=hop,
                         frame_bucket=8, max_batch=16)
    mels = _mels()
    wavs = voc.vocode(mels, generator=torch.Generator().manual_seed(0))
    assert len(wavs) == len(mels)
    for mel, wav in zip(mels, wavs):
        assert wav.shape == (mel.shape[0] * hop,)
        assert np.isfinite(wav).all()
    # buckets 8, 16, 24 -> one entry each, one call each: no capture
    assert voc.sampler.warmups == 3 and voc.sampler.captures == 0


def test_max_batch_defaults_to_one():
    voc = BatchedVocoder(_FakeDenoise(4), _constants(), hop_size=4)
    assert voc.max_batch == 1 and voc.frame_bucket == 128
    assert BatchedVocoder.from_sampler(None, 4).max_batch == 1


@pytest.mark.parametrize("max_batch", [1, 2, 16])
def test_buckets_rounds_and_trims(max_batch):
    """from_sampler with a recording sampler: every call is a padded bucket
    of at most max_batch rows, buckets in increasing length, rows in input
    order zero-padded past their frames, outputs trimmed to frames * hop."""
    hop, calls = 4, []

    def sampler(generator, mel, audio_length):
        calls.append(mel.clone())
        assert audio_length == mel.shape[1] * hop
        frames = torch.arange(audio_length, dtype=torch.float32)
        return (frames[None, :, None] + 1000 * mel[:, :1, :1].round()
                ).expand(mel.shape[0], audio_length, 1)

    mels = _mels()
    for i, mel in enumerate(mels):
        mel[0, 0] = i                     # row tag read back by the sampler
    wavs = BatchedVocoder.from_sampler(sampler, hop, frame_bucket=8,
                                       max_batch=max_batch).vocode(
        mels, generator=torch.Generator())
    order = [i for bucket in (8, 16, 24) for i, f in enumerate(FRAMES)
             if -(-f // 8) * 8 == bucket]
    rows = [int(m[r, 0, 0]) for m in calls for r in range(m.shape[0])]
    assert rows == order
    for m in calls:
        assert m.shape[0] <= max_batch and m.shape[1] in (8, 16, 24)
        for r in range(m.shape[0]):
            frames = FRAMES[int(m[r, 0, 0])]
            assert torch.equal(m[r, :frames], torch.from_numpy(
                mels[int(m[r, 0, 0])]))
            assert not m[r, frames:].any()
    for i, wav in enumerate(wavs):
        np.testing.assert_array_equal(
            wav, np.arange(FRAMES[i] * hop, dtype=np.float32) + 1000 * i)


def test_small_fastdiff_against_per_utterance_calls():
    """max_batch 1 on a small FastDiff: each utterance equals the eager
    sampler on its zero-padded bucket, drawn from one generator in the
    vocoder's order, trimmed to frames * hop; one entry per bucket."""
    cfg = ModelConfig(inner_channels=8, cond_channels=16,
                      upsample_ratios=(4, 2, 2), kpnet_hidden_channels=8,
                      diffusion_step_embed_dim_in=16,
                      diffusion_step_embed_dim_mid=32,
                      diffusion_step_embed_dim_out=32,
                      compute_dtype="float32")
    hop = cfg.total_hop
    model = FastDiff(cfg, seed=0).eval()
    const = constants_for_hparams({"N": 4})
    frames = (5, 12, 8, 3)
    rng = np.random.default_rng(1)
    mels = [rng.normal(size=(f, 16)).astype(np.float32) for f in frames]
    voc = BatchedVocoder(model, const, hop, frame_bucket=8)
    wavs = voc.vocode(mels, generator=torch.Generator().manual_seed(3))
    # bucket 8 (three calls) warmed and captured, bucket 16 warmed
    assert voc.sampler.warmups == 2 and voc.sampler.captures == 1
    assert voc.sampler.graphs_cached == 1
    gen = torch.Generator().manual_seed(3)
    for i in sorted(range(len(frames)), key=lambda i: -(-frames[i] // 8)):
        bucket = -(-frames[i] // 8) * 8
        padded = np.zeros((1, bucket, 16), np.float32)
        padded[0, :frames[i]] = mels[i]
        with torch.no_grad():
            want = sample(model, torch.from_numpy(padded), const,
                          bucket * hop, generator=gen)
        assert wavs[i].shape == (frames[i] * hop,)
        np.testing.assert_array_equal(wavs[i],
                                      want[0, :frames[i] * hop, 0].numpy())
