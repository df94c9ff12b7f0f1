"""The vocoder's checkpoint loading and hparams against the JAX vocoder.

- A checkpoint of the port's ``Trainer`` (``{"params": v / g / bias, ...}``)
  loads with weight norm fused, as ``fastdiff_tpu/vocoders/
  fastdiff_vocoder.py`` loads its trainer's files: at f32 the vocoder's
  denoiser matches the trainable model's forward (1e-5 relative) and JAX's
  ``fastdiff_apply`` on the same weights fused by ``fuse_weight_norm``
  (3e-4, the port's per-call tolerance).
- A ``vocoder_ckpt`` path that does not exist warns and runs the seed-0
  random weights, as JAX does.
- A non-zero ``chunked_infer_frames`` (cast with ``int``) vocodes through
  ``ChunkedVocoder`` around the vocoder's sampler and generator, as JAX's
  vocoder chunks; a chunk of no more than two 16-frame halos is refused,
  as JAX's ``ChunkedVocoder`` refuses it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdiff_tpu.config import ModelConfig as JaxModelConfig
from fastdiff_tpu.models.fastdiff import fastdiff_apply, fuse_weight_norm
from fastdiff_tpu_torch.data.indexed_dataset import IndexedDatasetBuilder
from fastdiff_tpu_torch.models.bridge import params_to_jax
from fastdiff_tpu_torch.serving.chunked_vocoder import (DEFAULT_HALO_FRAMES,
                                                        ChunkedVocoder)
from fastdiff_tpu_torch.training import checkpoint as ckpt
from fastdiff_tpu_torch.training.task import FastDiffTask
from fastdiff_tpu_torch.training.trainer import Trainer
from fastdiff_tpu_torch.vocoders.fastdiff_vocoder import FastDiffVocoder

N_MELS, HOP, FRAMES = 80, 256, 6
ARCH = {"inner_channels": 8, "cond_channels": N_MELS,
        "upsample_ratios": [8, 8, 4], "lvc_layers_each_block": 2,
        "kpnet_hidden_channels": 8, "diffusion_step_embed_dim_in": 16,
        "diffusion_step_embed_dim_mid": 32,
        "diffusion_step_embed_dim_out": 32, "compute_dtype": "float32"}


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


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _write_split(binary_dir, prefix, n_items, rng):
    builder = IndexedDatasetBuilder(os.path.join(binary_dir, prefix))
    lengths = []
    for i in range(n_items):
        frames = int(rng.integers(20, 30))
        wav = (0.3 * rng.standard_normal(frames * HOP)).astype(np.float32)
        mel = (rng.normal(size=(frames, N_MELS)) - 4.0).astype(np.float32)
        builder.add_item({"item_name": f"{prefix}{i}", "mel": mel, "wav": wav,
                          "len": frames})
        lengths.append(frames)
    builder.finalize()
    np.save(os.path.join(binary_dir, f"{prefix}_lengths.npy"), lengths)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Three updates of ``Trainer.fit`` on a tiny binarized dataset; the
    checkpoint it wrote and the trained (trainable) model."""
    root = tmp_path_factory.mktemp("vocoder_ckpt")
    binary = root / "binary"
    binary.mkdir()
    rng = np.random.default_rng(0)
    _write_split(str(binary), "train", 6, rng)
    _write_split(str(binary), "valid", 2, rng)
    hp = dict(ARCH, binary_data_dir=str(binary), hop_size=HOP,
              audio_num_mel_bins=N_MELS, use_pallas_block="ncl_sr", T=50,
              beta_0=1e-4, beta_T=0.05, max_updates=3, max_samples=4096,
              max_sentences=4, max_valid_sentences=2, val_check_interval=3,
              num_sanity_val_steps=0, tb_log_interval=3, lr=1e-3,
              num_ckpt_keep=1, seed=1234, eval_max_batches=1)
    work = str(root / "work")
    result = Trainer(FastDiffTask(hp, device="cpu"), work).fit()
    path, step = ckpt.get_last_checkpoint(work)
    assert step == 3
    return path, result["state"].model.eval()


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    audio = rng.normal(size=(1, FRAMES * HOP, 1)).astype(np.float32)
    mel = (rng.normal(size=(1, FRAMES, N_MELS)) - 4.0).astype(np.float32)
    t = np.array([[321.0]], np.float32)
    return audio, mel, t


def _forward(model, audio, mel, t):
    with torch.no_grad():
        return model(*(torch.from_numpy(a) for a in (audio, mel, t))).numpy()


def test_trainer_checkpoint_matches_trainable_model(trained):
    path, trainable = trained
    voc = FastDiffVocoder(dict(ARCH, vocoder_ckpt=path), device="cpu")
    assert voc.model.train_route is None
    audio, mel, t = _inputs()
    got = _forward(voc.model, audio, mel, t)
    ref = _forward(trainable, audio, mel, t)
    assert got.shape == (1, FRAMES * HOP, 1)
    assert _rel(got, ref) <= 1e-5
    wav = voc.spec2wav(mel[0])
    assert wav.shape == (FRAMES * HOP,) and np.isfinite(wav).all()


def test_trainer_checkpoint_matches_jax_denoiser(trained):
    path, _ = trained
    voc = FastDiffVocoder(dict(ARCH, vocoder_ckpt=path), device="cpu")
    saved = ckpt.load_checkpoint(path)
    jcfg = JaxModelConfig(**dict(ARCH, upsample_ratios=(8, 8, 4)))
    params = jax.tree_util.tree_map(
        jnp.asarray, fuse_weight_norm(params_to_jax(saved["params"], jcfg)))
    for seed in (0, 1):
        audio, mel, t = _inputs(seed)
        ref = np.asarray(fastdiff_apply(params, jnp.asarray(audio),
                                        jnp.asarray(mel), jnp.asarray(t),
                                        jcfg))
        got = _forward(voc.model, audio, mel, t)
        np.testing.assert_allclose(got, ref, rtol=3e-4, atol=3e-4)


def test_bare_state_dict_still_loads(trained, tmp_path):
    path, _ = trained
    fused = FastDiffVocoder(dict(ARCH, vocoder_ckpt=path), device="cpu")
    bare = tmp_path / "bare.pt"
    torch.save(fused.model.state_dict(), bare)
    again = FastDiffVocoder(dict(ARCH, vocoder_ckpt=str(bare)), device="cpu")
    for name, value in again.model.state_dict().items():
        torch.testing.assert_close(value, fused.model.state_dict()[name],
                                   rtol=0, atol=0)


def test_missing_checkpoint_warns_and_runs_seeded_weights(tmp_path, capsys):
    missing = str(tmp_path / "no_such.ckpt")
    voc = FastDiffVocoder(dict(ARCH, vocoder_ckpt=missing), device="cpu")
    assert "WARNING: no vocoder_ckpt given" in capsys.readouterr().out
    seeded = FastDiffVocoder(dict(ARCH), device="cpu")
    for name, value in voc.model.state_dict().items():
        torch.testing.assert_close(value, seeded.model.state_dict()[name],
                                   rtol=0, atol=0)


@pytest.mark.parametrize("frames", [64, "32"])
def test_chunked_infer_frames_runs_the_chunked_vocoder(frames):
    """The vocoder with ``chunked_infer_frames`` equals ChunkedVocoder
    (default halo) around the same sampler and a generator of the same
    seed, bit for bit, through one sampler entry (warmed on the first
    call, captured on the second); 32 frames are not more
    than two halos, which ChunkedVocoder refuses (JAX's asserts)."""
    chunk = int(frames)
    hp = dict(ARCH, seed=7, chunked_infer_frames=frames)
    if chunk <= 2 * DEFAULT_HALO_FRAMES:
        with pytest.raises(ValueError, match="twice halo_frames"):
            ChunkedVocoder(None, HOP, chunk_frames=chunk)
        with pytest.raises(ValueError, match="twice halo_frames"):
            FastDiffVocoder(hp, device="cpu")
        return
    mel = (np.random.default_rng(3).normal(size=(100, N_MELS)) - 4.0
           ).astype(np.float32)
    voc = FastDiffVocoder(hp, device="cpu")
    got = voc.spec2wav(mel)
    plain = FastDiffVocoder(dict(ARCH, seed=7), device="cpu")
    assert plain.chunked is None
    want = ChunkedVocoder(plain.sample, HOP, chunk_frames=chunk).vocode(
        mel, generator=torch.Generator().manual_seed(7))
    assert got.shape == (100 * HOP,)
    np.testing.assert_array_equal(got, want)
    assert voc.sampler.warmups == 1 and voc.sampler.graphs_cached == 0
    assert np.isfinite(voc.spec2wav(mel)).all()
    assert voc.sampler.warmups == 1 and voc.sampler.graphs_cached == 1
