"""The port's last script twins (``fastdiff_tpu_torch/scripts/``) on the CPU,
at small widths: ``bench_n1000``, ``bench_trainstep``, ``drive_ncl_sr``,
``streaming_latency_curve`` and ``graft_entry`` (the twin of the root
``__graft_entry__.py``).

- the ``bench_n1000`` twin's timed call gives a finite (1, L, 1) waveform
  at N = 200 and N = 1000, its second call (the capture on the card) equal
  to its first;
- ``bench_trainstep``'s four routes step at a tiny batch: every route
  resolves to itself, losses and gradient norms finite, gradients within
  5e-2 of the plain route's; its race refuses the CPU;
- ``drive_ncl_sr`` passes at a tiny batch and exits 0;
- the streaming curve on a checkpoint the port's ``Trainer`` wrote: JAX's
  five (chunk, halo) settings (read from its script's source), JAX's
  latency column exactly, and each metric equal to ``utils/metrics.py`` on
  the row's arrays;
- ``graft_entry.entry()``'s forward against JAX's ``__graft_entry__.
  entry()`` fn, both at the full width in f32 with JAX's seed weights
  carried across (``models/bridge.py:params_from_jax``), within 3e-4, on
  the example inputs and on random ones;
- ``dryrun_multichip(2)`` under gloo: two ranks, each step data parallel,
  every loss finite and equal across the ranks, rank 0's chunked
  vocoding of 32 frames.
"""

import ast
import os

import jax
import numpy as np
import pytest
import torch

from fastdiff_tpu_torch.config import AudioConfig
from fastdiff_tpu_torch.config import ModelConfig as PortModelConfig
from fastdiff_tpu_torch.data.indexed_dataset import IndexedDatasetBuilder
from fastdiff_tpu_torch.models.bridge import params_from_jax
from fastdiff_tpu_torch.scripts import (bench_n1000, bench_trainstep,
                                        drive_ncl_sr, graft_entry,
                                        streaming_latency_curve)
from fastdiff_tpu_torch.training.task import FastDiffTask
from fastdiff_tpu_torch.training.trainer import Trainer
from fastdiff_tpu_torch.utils import metrics
from fastdiff_tpu_torch.utils.hparams import dump_yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = dict(inner_channels=8, cond_channels=16, upsample_ratios=(4, 2, 2),
            kpnet_hidden_channels=8, diffusion_step_embed_dim_in=16,
            diffusion_step_embed_dim_mid=32, diffusion_step_embed_dim_out=32,
            compute_dtype="float32")
SMALL_HP = dict(ARCH, upsample_ratios=[4, 2, 2], hop_size=16)


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


@pytest.mark.parametrize("n_steps", [200, 1000])
def test_bench_n1000_timed_call(n_steps):
    sampler, mel, length = bench_n1000.build(
        n_steps, frames=16, device="cpu", cfg=PortModelConfig(**ARCH))
    assert sampler.constants.n_steps == n_steps
    first = bench_n1000.sample_once(sampler, mel, length, 1)
    assert first.shape == (1, length, 1) and length == 16 * 16
    assert torch.isfinite(first).all()
    assert torch.equal(bench_n1000.sample_once(sampler, mel, length, 1),
                       first)
    assert bench_n1000.buffer_bytes(sampler) > 0


def test_bench_trainstep_routes_at_a_tiny_batch():
    race = bench_trainstep.setup("cpu", bench_trainstep.ROUTES, batch=2,
                                 frames=16, hparams=SMALL_HP)
    assert race.routes == ("plain", "ncl_sr", "ncl_vjp", "nwc_vjp")
    assert {r: t.route for r, t in race.tasks.items()} == {
        r: r for r in race.routes}
    errors = bench_trainstep.gradient_errors(race)
    assert set(errors) == {"ncl_sr", "ncl_vjp", "nwc_vjp"}
    assert all(rel <= 5e-2 for rel, _ in errors.values()), errors
    done, peak = bench_trainstep.warm(race)
    for r in race.routes:
        assert np.isfinite(done[r]["loss"]) and np.isfinite(
            done[r]["grad_norm"]) and done[r]["nonfinite"] == 0.0
        assert peak[r] is None
    with pytest.raises(RuntimeError, match="CUDA events"):
        bench_trainstep.race(race)


def test_drive_ncl_sr_at_a_tiny_batch(capsys):
    result = drive_ncl_sr.drive("cpu", batch=2, frames=16, hparams=SMALL_HP)
    assert result["ok"]
    for route in ("plain", "ncl_sr"):
        loss, gnorm, finite, taken = result[route]
        assert finite and taken and np.isfinite(gnorm)
    hp = ",".join(f"{k}={v}" for k, v in ARCH.items()
                  if k != "upsample_ratios")
    assert drive_ncl_sr.main(["--device", "cpu", "--batch", "2",
                              "--frames", "16", "--hparams", hp]) == 0
    assert "DRIVE OK" in capsys.readouterr().out


def _jax_settings() -> list:
    """``SETTINGS`` of the JAX script, read from its source (importing it
    would set JAX's compilation cache)."""
    path = os.path.join(REPO, "scripts", "streaming_latency_curve.py")
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "SETTINGS":
            return ast.literal_eval(node.value)
    raise AssertionError("no SETTINGS in the JAX script")


def _checkpoint_dir(root) -> str:
    """A ``Trainer`` checkpoint of a small model beside its config.yaml
    and a binarized valid split of two utterances (30 and 50 frames)."""
    binary = os.path.join(root, "binary")
    hp = dict(SMALL_HP, upsample_ratios=[8, 8, 4], hop_size=256,
              inner_channels=4, lvc_layers_each_block=2, cond_channels=80,
              binary_data_dir=binary, work_dir=os.path.join(root, "work"))
    rng = np.random.default_rng(0)
    os.makedirs(binary)
    builder = IndexedDatasetBuilder(os.path.join(binary, "valid"))
    for i, frames in enumerate((30, 50)):
        builder.add_item({"item_name": f"valid{i}", "len": frames,
                          "mel": (rng.normal(size=(frames, 80)) - 4.0)
                          .astype(np.float32),
                          "wav": (0.3 * rng.normal(size=frames * 256))
                          .astype(np.float32)})
    builder.finalize()
    task = FastDiffTask(hp, device="cpu")
    Trainer(task, hp["work_dir"])._maybe_save(task.build_state(seed=3), 7, {})
    with open(os.path.join(hp["work_dir"], "config.yaml"), "w") as f:
        f.write(dump_yaml(hp))
    return hp["work_dir"]


def test_streaming_latency_curve_rows(tmp_path):
    ckpt_dir = _checkpoint_dir(tmp_path)
    hp, sampler, mels, step = streaming_latency_curve.load(ckpt_dir, "cpu")
    assert step == 7 and [m.shape[0] for m in mels] == [30, 50]
    audio_cfg = AudioConfig.from_hparams(hp)
    rows = streaming_latency_curve.curve(sampler, mels, 256, audio_cfg,
                                         "cpu")
    assert [(r["chunk"], r["halo"]) for r in rows] == _jax_settings()
    assert streaming_latency_curve.SETTINGS == _jax_settings()
    for row in rows:
        assert row["latency_ms"] == ((row["chunk"] - row["halo"]) * 256
                                     / audio_cfg.sample_rate * 1e3)
        assert [len(o) for o, _ in row["pairs"]] == [30 * 256, 50 * 256]
        assert row["mcd"] == np.mean([metrics.mcd(o, r, audio_cfg)
                                      for o, r in row["pairs"]])
        assert row["mel_l2"] == np.mean(
            [metrics.mel_spectral_distance(o, r, audio_cfg)
             for o, r in row["pairs"]])
        assert row["mr_stft"] == np.mean(
            [metrics.multi_resolution_stft_distance(o, r)
             for o, r in row["pairs"]])
        assert all(np.isfinite(row[k]) for k in ("mcd", "mel_l2", "mr_stft"))
    # one chunk covers both utterances at (256, 16), with the reference's
    # generator: the streamed waveform is a different draw, not a copy
    assert rows[0]["mr_stft"] > 0


def test_graft_entry_forward_matches_jax(monkeypatch):
    import __graft_entry__ as jax_entry
    from fastdiff_tpu import config as jax_config
    f32 = dict(compute_dtype="float32")
    real = jax_config.ModelConfig
    monkeypatch.setattr(jax_config, "ModelConfig",
                        lambda **kw: real(**dict(f32, **kw)))
    jax_fn, (params, audio, mel, t) = jax_entry.entry()
    cfg = PortModelConfig(**f32)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg)
    fn, example = graft_entry.entry("cpu", cfg=cfg, state_dict=state)
    assert [tuple(a.shape) for a in example] == [
        tuple(audio.shape), tuple(mel.shape), tuple(t.shape)] == [
        (2, 6400, 1), (2, 25, 80), (2, 1)]
    rng = np.random.default_rng(0)
    inputs = [tuple(np.asarray(a) for a in (audio, mel, t)),
              (rng.standard_normal((2, 6400, 1)).astype(np.float32),
               rng.standard_normal((2, 25, 80)).astype(np.float32) - 4.0,
               np.array([[17.0], [803.0]], np.float32))]
    for args in inputs:
        want = np.asarray(jax.jit(jax_fn)(params, *args))
        got = fn(*(torch.from_numpy(np.array(a)) for a in args)).numpy()
        np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)
    # the default: seed-0 weights of the full-width bf16 model
    fn, example = graft_entry.entry("cpu")
    out = fn(*example)
    assert out.shape == (2, 6400, 1) and torch.isfinite(out).all()


def test_dryrun_multichip_two_gloo_ranks():
    results = graft_entry.dryrun_multichip(2, "cpu", timeout=600)
    assert [(r["rank"], r["world"], r["backend"]) for r in results] == [
        (0, 2, "gloo"), (1, 2, "gloo")]
    for key in ("toy_loss", "ncl_vjp_loss", "full_loss"):
        assert np.isfinite(results[0][key])
        assert results[0][key] == results[1][key]
    assert results[0]["chunked_samples"] == 32 * 256
    assert "chunked_samples" not in results[1]
