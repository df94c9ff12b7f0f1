"""The port's training slice against the JAX package.

Small config (C=8, ratios 4/2/2 -> hops 4/8/16, 16 frames), f32. JAX's
``ncl_sr`` route runs its saved-residual Pallas kernel in interpret mode on
the hop-8 and hop-16 blocks and XLA on the hop-4 block; its ``False`` route
is XLA throughout. The port runs every block through the route it is given.

- the weight bridge round trip (JAX (v, g) tree -> trainable state_dict ->
  ``params_to_jax``) is exact;
- the loss and every gradient match ``jax.value_and_grad`` of
  ``theta_timestep_loss`` with the JAX draws of t and z injected: loss to
  rel 1e-5, each gradient leaf (mapped through the bridge) to rel L2 1e-4;
- the optimizer matches ``optax.chain(clip_by_global_norm, adamw)`` (and
  ``MultiSteps``) to rel 1e-6;
- the task's NaN skip, EMA, and the trainer's fit, checkpoints, resume and
  best checkpoint, on a tiny binarized dataset.
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fastdiff_tpu.config import DiffusionConfig, ModelConfig, TrainConfig
from fastdiff_tpu.data.indexed_dataset import IndexedDatasetBuilder
from fastdiff_tpu.diffusion import schedules
from fastdiff_tpu.diffusion.losses import theta_timestep_loss as jax_loss
from fastdiff_tpu.models.fastdiff import fastdiff_apply, init_fastdiff
from fastdiff_tpu.training.optim import make_optimizer
from fastdiff_tpu_torch.diffusion.losses import theta_timestep_loss
from fastdiff_tpu_torch.models.bridge import (params_to_jax,
                                              trainable_params_from_jax)
from fastdiff_tpu_torch.models.fastdiff import FastDiff, resolve_train_route
from fastdiff_tpu_torch.training import checkpoint as ckpt
from fastdiff_tpu_torch.training.optim import AdamW
from fastdiff_tpu_torch.training.task import FastDiffTask
from fastdiff_tpu_torch.training.trainer import Trainer

SMALL = ModelConfig(inner_channels=8, cond_channels=16,
                    upsample_ratios=(4, 2, 2), kpnet_hidden_channels=8,
                    diffusion_step_embed_dim_in=16,
                    diffusion_step_embed_dim_mid=32,
                    diffusion_step_embed_dim_out=32, compute_dtype="float32")
FRAMES = 16


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


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_model(params, route):
    model = FastDiff(SMALL, seed=None, train_route=route)
    model.load_state_dict(trainable_params_from_jax(_np_tree(params), SMALL))
    return model


def test_bridge_round_trip_is_exact():
    params = _np_tree(init_fastdiff(jax.random.PRNGKey(1), SMALL))
    model = _port_model(params, "plain")
    back = params_to_jax(model.state_dict(), SMALL)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_trainable_state_dict_names():
    names = set(FastDiff(SMALL, seed=None, train_route="plain").state_dict())
    assert {"first_audio_conv.v", "first_audio_conv.g", "first_audio_conv.bias",
            "lvc_blocks.0.upsample.v", "lvc_blocks.0.upsample.g",
            "fc_t1.weight", "fc_t1.bias"} <= names
    assert not any(n.endswith(".weight") and "fc_t" not in n for n in names)


@pytest.fixture(scope="module")
def jax_reference():
    """JAX loss and gradients for both reference routes, with the draws of
    t and z recomputed from the loss's key."""
    params = init_fastdiff(jax.random.PRNGKey(0), SMALL)
    rng = np.random.default_rng(0)
    b = 2
    audio = rng.normal(size=(b, FRAMES * SMALL.total_hop, 1)).astype(np.float32)
    mel = rng.normal(size=(b, FRAMES, SMALL.cond_channels)).astype(np.float32)
    alpha = schedules.compute_hyperparams_given_schedule(
        schedules.linear_beta_schedule(DiffusionConfig())).alpha
    key = jax.random.PRNGKey(3)
    k_t, k_z = jax.random.split(key)
    ts = np.asarray(jax.random.randint(k_t, (b, 1, 1), 0, alpha.shape[0]))
    z = np.asarray(jax.random.normal(k_z, audio.shape, jnp.float32))
    out = {}
    for route in ("ncl_sr", False):
        cfg = dataclasses.replace(SMALL, use_pallas_block=route)

        def loss(p, cfg=cfg):
            return jax_loss(lambda x, m, t: fastdiff_apply(p, x, m, t, cfg),
                            key, jnp.asarray(mel), jnp.asarray(audio),
                            jnp.asarray(alpha))
        value, grads = jax.jit(jax.value_and_grad(loss))(params)
        out[route] = (float(value), _np_tree(grads))
    return dict(params=_np_tree(params), audio=audio, mel=mel,
                alpha=np.array(alpha),
                ts=np.array(ts), z=np.array(z), ref=out)


@pytest.mark.parametrize("jax_route", ["ncl_sr", False])
@pytest.mark.parametrize("route", ["ncl_sr", "ncl_vjp", "plain"])
def test_loss_and_gradients_match_jax(jax_reference, route, jax_route):
    r = jax_reference
    model = _port_model(r["params"], route)
    loss = theta_timestep_loss(
        model, torch.from_numpy(r["mel"]), torch.from_numpy(r["audio"]),
        torch.from_numpy(r["alpha"]), ts=torch.from_numpy(r["ts"]),
        z=torch.from_numpy(r["z"]))
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    ref_loss, ref_grads = r["ref"][jax_route]
    assert abs(float(loss.detach()) - ref_loss) <= 1e-5 * abs(ref_loss)
    got = params_to_jax(dict(zip(names, grads)), SMALL)
    paths = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    flat_got = jax.tree_util.tree_leaves(got)
    assert len(flat_got) == len(paths)
    for (path, ref), g in zip(paths, flat_got):
        assert _rel(g, ref) <= 1e-4, (jax.tree_util.keystr(path), _rel(g, ref))


def test_loss_draws_from_generator():
    model = FastDiff(SMALL, seed=0, train_route="plain")
    rng = np.random.default_rng(1)
    audio = torch.from_numpy(
        rng.normal(size=(2, FRAMES * SMALL.total_hop, 1)).astype(np.float32))
    mel = torch.from_numpy(
        rng.normal(size=(2, FRAMES, SMALL.cond_channels)).astype(np.float32))
    alpha = torch.from_numpy(schedules.compute_hyperparams_given_schedule(
        schedules.linear_beta_schedule(DiffusionConfig())).alpha)
    with torch.no_grad():
        a, b = (theta_timestep_loss(model, mel, audio, alpha,
                                    generator=torch.Generator().manual_seed(4))
                for _ in range(2))
        c = theta_timestep_loss(model, mel, audio, alpha,
                                generator=torch.Generator().manual_seed(5))
    assert torch.isfinite(a) and float(a) == float(b) != float(c)


def test_route_resolver():
    assert resolve_train_route({}, "cpu") == "plain"
    assert resolve_train_route({"use_pallas_block": "auto"}, "cuda") == "ncl_sr"
    assert resolve_train_route({"use_pallas_block": ""}, "cpu") == "plain"
    assert resolve_train_route({"use_pallas_block": "ncl_vjp"}, "cpu") == \
        "ncl_vjp"
    assert resolve_train_route({"use_pallas_block": "ncl_sr"}, "cpu") == \
        "ncl_sr"
    assert resolve_train_route({"use_pallas_block": False}, "cuda") == "plain"
    for raw in (True, "true", "1", "on"):
        assert resolve_train_route({"use_pallas_block": raw}, "cuda") == \
            "nwc_vjp"


# -- optimizer ----------------------------------------------------------------

@pytest.mark.parametrize("overrides,steps", [
    ({}, 3),
    ({"scheduler": "rsqrt"}, 3),
    ({"accumulate_grad_batches": 2}, 6),
    ({"weight_decay": 0.01, "clip_grad_norm": 0.0}, 3),
])
def test_optimizer_matches_optax(overrides, steps):
    """Identical gradients through both; the second gradient is scaled so
    that clipping bites on that step (norm > 1) and not on the others."""
    cfg = dataclasses.replace(TrainConfig(lr=1e-2), **overrides)
    rng = np.random.default_rng(7)
    shapes = [(4, 3, 5), (7,), (2, 9)]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grad_seq = [[(rng.normal(size=s) * (3.0 if k % 3 == 1 else 0.05)
                  ).astype(np.float32) for s in shapes] for k in range(steps)]
    tx = make_optimizer(cfg, warmup_updates=4, hidden_size=16)
    jp = [jnp.asarray(a) for a in init]
    opt_state = tx.init(jp)
    params = [torch.from_numpy(a.copy()) for a in init]
    opt = AdamW(params, cfg, warmup_updates=4, hidden_size=16)
    for grads in grad_seq:
        updates, opt_state = tx.update([jnp.asarray(g) for g in grads],
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step([torch.from_numpy(g) for g in grads])
        for a, b in zip(params, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    assert opt.count == (steps // max(1, cfg.accumulate_grad_batches))


# -- task and trainer ---------------------------------------------------------

N_MELS, HOP = 80, 256


def _write_split(binary_dir, prefix, n_items, rng):
    builder = IndexedDatasetBuilder(os.path.join(binary_dir, prefix))
    lengths = []
    for i in range(n_items):
        frames = int(rng.integers(20, 30))
        t = np.arange(frames * HOP) / 22050.0
        wav = (0.4 * np.sin(2 * np.pi * (220 + 30 * i) * t)
               + 0.02 * rng.standard_normal(t.size)).astype(np.float32)
        mel = (rng.normal(size=(frames, N_MELS)) - 4.0).astype(np.float32)
        builder.add_item({"item_name": f"{prefix}{i}", "mel": mel, "wav": wav,
                          "len": frames})
        lengths.append(frames)
    builder.finalize()
    np.save(os.path.join(binary_dir, f"{prefix}_lengths.npy"), lengths)


def _tiny_hparams(tmp_path):
    binary = tmp_path / "binary"
    binary.mkdir(exist_ok=True)
    rng = np.random.default_rng(0)
    _write_split(str(binary), "train", 8, rng)
    _write_split(str(binary), "valid", 2, rng)
    return {
        "binary_data_dir": str(binary), "work_dir": str(tmp_path / "work"),
        "hop_size": HOP, "audio_num_mel_bins": N_MELS,
        "inner_channels": 8, "cond_channels": N_MELS,
        "upsample_ratios": [8, 8, 4], "lvc_layers_each_block": 2,
        "kpnet_hidden_channels": 8, "diffusion_step_embed_dim_in": 16,
        "diffusion_step_embed_dim_mid": 32, "diffusion_step_embed_dim_out": 32,
        "compute_dtype": "float32", "use_pallas_block": "ncl_sr",
        "T": 50, "beta_0": 1e-4, "beta_T": 0.05,
        "max_updates": 12, "max_samples": 4096, "max_sentences": 4,
        "max_valid_sentences": 2, "val_check_interval": 6,
        "num_sanity_val_steps": 1, "tb_log_interval": 4, "lr": 1e-3,
        "clip_grad_norm": 1, "num_ckpt_keep": 2, "seed": 1234,
        "eval_max_batches": 2,
    }


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("torch_train")
    hp = _tiny_hparams(tmp_path)
    task = FastDiffTask(hp, device="cpu")
    before = {k: p.detach().clone()
              for k, p in task.build_state().model.named_parameters()}
    result = Trainer(task, hp["work_dir"]).fit()
    return hp, before, result


def test_fit_runs_to_max_updates(trained):
    hp, before, result = trained
    assert result["step"] == 12
    assert np.isfinite(result["val"]["loss"])
    after = dict(result["state"].model.named_parameters())
    assert any(not torch.equal(before[k], after[k]) for k in before)
    logged = open(os.path.join(hp["work_dir"], "tb_logs",
                               "metrics.jsonl")).read()
    assert '"tr/grad_norm"' in logged and '"val/loss"' in logged


def test_checkpoints_written_with_retention(trained):
    hp, _, _ = trained
    ckpts = glob.glob(os.path.join(hp["work_dir"], "model_ckpt_steps_*.ckpt"))
    assert sorted(os.path.basename(c) for c in ckpts) == [
        "model_ckpt_steps_12.ckpt", "model_ckpt_steps_6.ckpt"]
    assert os.path.exists(os.path.join(hp["work_dir"], "model_ckpt_best.pt"))
    assert not glob.glob(os.path.join(hp["work_dir"], "*.part"))
    assert ckpt.get_last_checkpoint(hp["work_dir"])[1] == 12
    saved = ckpt.load_checkpoint(os.path.join(hp["work_dir"],
                                              "model_ckpt_best.pt"))
    assert saved["best_val"] > 0 and saved["step"] in (6, 12)


def test_resume_continues_from_step(trained):
    hp, _, result = trained
    task = FastDiffTask(dict(hp, max_updates=14), device="cpu")
    trainer = Trainer(task, hp["work_dir"])
    state, step = trainer.restore(task.build_state())
    assert step == 12 and state.optimizer.count == 12
    for name, p in state.model.named_parameters():
        torch.testing.assert_close(
            p, dict(result["state"].model.named_parameters())[name],
            rtol=0, atol=0)
    assert trainer.fit()["step"] == 14


def test_nan_gradients_skip_the_update(tmp_path):
    hp = _tiny_hparams(tmp_path)
    task = FastDiffTask(hp, device="cpu")
    state = task.build_state()
    batch = next(task.train_dataloader())
    task.train_step(state, batch, torch.Generator().manual_seed(0))
    params = {k: p.detach().clone() for k, p in
              state.model.named_parameters()}
    mu = [m.clone() for m in state.optimizer.mu]
    bad = dict(batch, wavs=np.full_like(batch["wavs"], np.nan))
    metrics = task.train_step(state, bad, torch.Generator().manual_seed(1))
    assert float(metrics["nonfinite"]) == 1.0
    assert not np.isfinite(float(metrics["loss"]))
    assert state.step == 2 and state.optimizer.count == 1
    for k, p in state.model.named_parameters():
        assert torch.equal(p, params[k]), k
    for a, b in zip(state.optimizer.mu, mu):
        assert torch.equal(a, b)


def test_ema_tracks_parameters(tmp_path):
    hp = dict(_tiny_hparams(tmp_path), ema_decay=0.9)
    task = FastDiffTask(hp, device="cpu")
    state = task.build_state()
    init = {k: v.clone() for k, v in state.ema.items()}
    task.train_step(state, next(task.train_dataloader()),
                    torch.Generator().manual_seed(0))
    for name, p in state.model.named_parameters():
        torch.testing.assert_close(state.ema[name],
                                   init[name] * 0.9 + p.detach() * 0.1)
    assert any(not torch.equal(state.ema[k], p)
               for k, p in state.model.named_parameters())


def test_training_reduces_loss_on_overfit(tmp_path):
    """One fixed batch and fixed draws: the loss falls over 30 updates."""
    hp = dict(_tiny_hparams(tmp_path), use_pallas_block="ncl_vjp")
    task = FastDiffTask(hp, device="cpu")
    state = task.build_state()
    batch = next(task.train_dataloader())
    gen = torch.Generator().manual_seed(0)
    ts = torch.randint(0, 50, (4, 1, 1), generator=gen)
    z = torch.randn(batch["wavs"].shape, generator=gen)
    losses = [float(task.train_step(state, batch, ts=ts, z=z)["loss"])
              for _ in range(30)]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
