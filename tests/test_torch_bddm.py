"""The port's BDDM noise predictor (``diffusion/noise_predictor.py``), its
training and the reverse schedule search against the JAX package's, and
the port's ``scripts/bddm_search.py`` end to end on a micro dataset.

Small sizes on the CPU: phi with hidden 8 and 3 convs, T = 400 diffusion
steps, 1,024 samples; the score network a small FastDiff (C = 8, ratios
4/2/2, f32) on the route ``auto`` gives it on the CPU (NCL, each kernel's
plain version) against JAX's ``fastdiff_apply``, or a fixed fake
denoiser. JAX's draws (``phi_loss``'s t and z, the search's initial x) are
recomputed from its keys and injected. Tolerances: the predictor 1e-5
(f32), the loss 1e-5 and every phi gradient 1e-4 (largest error over the
tensor's largest value), 3 Adam steps against ``optax.adam(1e-4)`` 1e-6,
the searched schedule of the same length with betas at 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fastdiff_tpu.config import DiffusionConfig, ModelConfig
from fastdiff_tpu.diffusion import noise_predictor as jax_np
from fastdiff_tpu.diffusion import schedules as jax_schedules
from fastdiff_tpu.models.fastdiff import get_apply_fn
from fastdiff_tpu_torch.config import DiffusionConfig as PortDiffusionConfig
from fastdiff_tpu_torch.diffusion import schedules
from fastdiff_tpu_torch.diffusion.noise_predictor import (
    NoisePredictor, phi_loss, phi_train_step, search_noise_schedule)
from fastdiff_tpu_torch.models.bridge import (params_to_jax,
                                              phi_params_from_jax,
                                              phi_params_to_jax)
from fastdiff_tpu_torch.models.fastdiff import FastDiff
from fastdiff_tpu_torch.training.task import FastDiffTask
from fastdiff_tpu_torch.vocoders.fastdiff_vocoder import inference_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = dict(inner_channels=8, cond_channels=16, upsample_ratios=(4, 2, 2),
            kpnet_hidden_channels=8, diffusion_step_embed_dim_in=16,
            diffusion_step_embed_dim_mid=32, diffusion_step_embed_dim_out=32,
            compute_dtype="float32")
SMALL = ModelConfig(**ARCH)
T_DIFF, TAU, LENGTH, BATCH = 400, 50, 1024, 2
FRAMES = LENGTH // 16


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


def _hyper():
    return schedules.compute_hyperparams_given_schedule(
        schedules.linear_beta_schedule(PortDiffusionConfig(T=T_DIFF)))


def _jax_hyper():
    return jax_schedules.compute_hyperparams_given_schedule(
        jax_schedules.linear_beta_schedule(DiffusionConfig(T=T_DIFF)))


def _phi(seed=0):
    """JAX's predictor (hidden 8, 3 convs) and the port's with its weights."""
    tree = jax_np.init_noise_predictor(jax.random.PRNGKey(seed), hidden=8,
                                       n_convs=3)
    model = NoisePredictor(hidden=8, n_convs=3, seed=None)
    model.load_state_dict(phi_params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree)))
    return tree, model


@pytest.fixture(scope="module")
def fastdiff():
    """The small FastDiff: seed-0 trainable weights (weight norm kept) as
    JAX's tree under JAX's apply, and fused by ``inference_state_dict``
    into the port's inference model (FastDiffTask.inference_model, route
    auto -> ncl), as scripts/bddm_search.py fuses them. (Drawn by the port:
    JAX's eager initializers compile per shape.)"""
    task = FastDiffTask(dict(ARCH, use_pallas_block="auto"), device="cpu")
    trained = FastDiff(task.model_cfg, seed=0,
                       train_route="plain").state_dict()
    params = jax.tree_util.tree_map(jnp.asarray,
                                    params_to_jax(trained, task.model_cfg))
    apply = get_apply_fn(SMALL)
    model = task.inference_model(inference_state_dict(trained,
                                                      task.model_cfg))
    assert model.infer_route == "ncl" and not model.training
    return jax.jit(lambda x, m, t: apply(params, x, m, t)), model


def _denoisers(kind, fastdiff, scale):
    if kind == "fake":
        return (lambda x, m, t: scale * x), (lambda x, m, t: scale * x)
    return fastdiff


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_predictor_matches_jax_and_round_trips():
    tree, model = _phi()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, LENGTH, 1)).astype(np.float32)
    beta_next = np.asarray([[0.1], [0.01]], np.float32)
    delta_sq = np.asarray([[0.5], [0.02]], np.float32)
    want = np.asarray(jax_np.noise_predictor_apply(
        tree, jnp.asarray(x), jnp.asarray(beta_next), jnp.asarray(delta_sq)))
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (x, beta_next, delta_sq))).numpy()
    assert got.shape == (2, 1)
    assert _rel(got, want) <= 1e-5
    assert (got > 0).all() and (got <= np.minimum(beta_next, delta_sq)).all()
    back = phi_params_to_jax(model.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        assert a.shape == b.shape and np.array_equal(a, np.asarray(b))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    mel = rng.normal(size=(BATCH, FRAMES, 16)).astype(np.float32)
    audio = (0.3 * rng.standard_normal((BATCH, LENGTH, 1))).astype(np.float32)
    return mel, audio


def _jax_draws(key, audio_shape, t_total):
    """phi_loss's draws from ``key``, split as it splits them."""
    k_t, k_z = jax.random.split(key)
    ts = jax.random.randint(k_t, (audio_shape[0],), TAU, t_total - TAU)
    z = jax.random.normal(k_z, audio_shape)
    return torch.tensor(np.asarray(ts)), torch.tensor(np.asarray(z))


@pytest.mark.parametrize("kind", ["fake", "fastdiff"])
def test_phi_loss_and_gradients_match_jax(kind, fastdiff):
    """phi_loss with JAX's draws injected: loss 1e-5 and every phi gradient
    1e-4, against a 0.5 x fake denoiser and against the small FastDiff."""
    jax_fn, port_fn = _denoisers(kind, fastdiff, 0.5)
    tree, model = _phi()
    mel, audio = _batch()
    alpha = _jax_hyper().alpha
    key = jax.random.PRNGKey(1)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jax_np.phi_loss(p, jax_fn, key, jnp.asarray(mel),
                                  jnp.asarray(audio), jnp.asarray(alpha),
                                  tau=TAU)))(tree)
    ts, z = _jax_draws(key, audio.shape, len(alpha))
    loss = phi_loss(model, port_fn, torch.from_numpy(mel),
                    torch.from_numpy(audio), torch.from_numpy(_hyper().alpha),
                    tau=TAU, ts=ts, z=z)
    loss.backward()
    assert np.isfinite(float(loss_j))
    assert abs(loss.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    grads = phi_params_to_jax({k: p.grad for k, p in
                               model.named_parameters()})
    for got, want in zip(jax.tree_util.tree_leaves(grads),
                         jax.tree_util.tree_leaves(grads_j)):
        assert np.abs(np.asarray(want)).max() > 0
        assert _rel(got, want) <= 1e-4


def test_adam_steps_match_optax():
    """Three phi_train_step updates with torch.optim.Adam(lr=1e-4) against
    optax.adam(1e-4) on the same draws (0.5 x fake denoiser): 1e-6."""
    tree, model = _phi()
    mel, audio = _batch(1)
    alpha = _jax_hyper().alpha
    opt = optax.adam(1e-4)
    opt_state = opt.init(tree)
    torch_opt = torch.optim.Adam(model.parameters(), lr=1e-4)

    def fake(x, m, t):
        return 0.5 * x

    @jax.jit
    def step(p, s, key):
        loss, g = jax.value_and_grad(
            lambda q: jax_np.phi_loss(q, fake, key, jnp.asarray(mel),
                                      jnp.asarray(audio), jnp.asarray(alpha),
                                      tau=TAU))(p)
        updates, s = opt.update(g, s, p)
        return optax.apply_updates(p, updates), s, loss

    for i in range(3):
        key = jax.random.PRNGKey(10 + i)
        tree, opt_state, loss_j = step(tree, opt_state, key)
        ts, z = _jax_draws(key, audio.shape, len(alpha))
        loss = phi_train_step(model, torch_opt, fake, torch.from_numpy(mel),
                              torch.from_numpy(audio),
                              torch.from_numpy(_hyper().alpha), TAU,
                              ts=ts, z=z)
        assert abs(float(loss) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    got = phi_params_to_jax(model.state_dict())
    moved = 0.0
    for a, b, b0 in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(tree),
                        jax.tree_util.tree_leaves(_phi()[0])):
        assert np.abs(a - np.asarray(b)).max() <= 1e-6
        moved = max(moved, float(np.abs(np.asarray(b) - b0).max()))
    assert moved > 1e-4      # three steps of lr 1e-4 moved the weights


def _alpha_margins(desc_betas, alpha_start: float) -> float:
    """The smallest relative distance of the loop's next alpha to 1.0 over
    the steps taken, recomputed on the host as the search computes it."""
    margin, a = np.inf, alpha_start
    for b in desc_betas:
        a_next = a / np.sqrt(max(1.0 - float(b), 1e-12))
        margin = min(margin, abs(a_next - 1.0))
        a = a_next
    return margin


@pytest.mark.parametrize("kind", ["fake", "fastdiff"])
def test_search_matches_jax(kind, fastdiff):
    """search_noise_schedule from JAX's initial x: the same length and
    betas at rel 1e-5, with every step more than 1e-4 from the loop's
    boundaries (alpha > 1, beta < rho) so one ulp cannot change the
    length; the schedule feeds sampler_constants_for_schedule."""
    jax_fn, port_fn = _denoisers(kind, fastdiff, 0.1)
    tree, model = _phi(3)
    mel = _batch(2)[0][:1]
    key = jax.random.PRNGKey(2)
    max_steps, beta_start, alpha_start, rho = 6, 0.5, 0.3, 1e-9
    want = jax_np.search_noise_schedule(
        tree, jax_fn, key, jnp.asarray(mel), _jax_hyper(), LENGTH,
        max_steps=max_steps, beta_start=beta_start, alpha_start=alpha_start,
        rho=rho)
    _, sub = jax.random.split(key)
    x = torch.tensor(np.asarray(jax.random.normal(sub, (1, LENGTH, 1))))
    got = search_noise_schedule(model, port_fn, torch.from_numpy(mel),
                                _hyper(), LENGTH, max_steps=max_steps,
                                beta_start=beta_start,
                                alpha_start=alpha_start, rho=rho, x=x)
    assert got.dtype == np.float32 and len(got) == len(want) == max_steps
    assert np.all(np.diff(got) > 0) and got[-1] == np.float32(beta_start)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert _alpha_margins(want[::-1], alpha_start) > 1e-4
    assert want.min() > rho * (1 + 1e-4)
    const = schedules.sampler_constants_for_schedule(got, _hyper())
    assert const.n_steps == len(got)


def test_bddm_search_script(tmp_path, monkeypatch):
    """The port's scripts/bddm_search.py with --phi_steps 2 on a synthetic
    micro dataset at small width on the CPU: it writes its JSON and report
    under checkpoints/<exp_name> only, and docs/BDDM.md is unchanged."""
    import json

    import chip_smoke
    from fastdiff_tpu_torch.scripts import bddm_search

    docs = os.path.join(REPO, "docs", "BDDM.md")
    before = open(docs, "rb").read()
    binary = tmp_path / "binary"
    binary.mkdir()
    chip_smoke.write_synthetic_dataset(str(binary))
    monkeypatch.chdir(tmp_path)
    hp = ("binary_data_dir=binary,inner_channels=8,kpnet_hidden_channels=8,"
          "diffusion_step_embed_dim_in=16,diffusion_step_embed_dim_mid=32,"
          "diffusion_step_embed_dim_out=32,max_samples=8192,max_sentences=2,"
          "compute_dtype=float32")
    assert bddm_search.main([
        "--config", os.path.join(REPO, "fastdiff_tpu", "configs",
                                 "ljspeech.yaml"),
        "--exp_name", "bddm", "--hparams", hp, "--phi_steps", "2",
        "--device", "cpu"]) == 0
    assert open(docs, "rb").read() == before
    assert sorted(os.listdir(tmp_path)) == ["binary", "checkpoints"]
    assert os.listdir(tmp_path / "checkpoints") == ["bddm"]
    work = tmp_path / "checkpoints" / "bddm"
    results = json.loads((work / "bddm_schedules.json").read_text())
    assert sorted(results, key=int) == ["3", "4", "6", "8"]
    for n, r in results.items():
        assert 1 <= len(r["searched"]["schedule"]) <= int(n)
        assert r["published"]["schedule"] == bddm_search.PUBLISHED[int(n)]
        for side in ("searched", "published"):
            assert all(np.isfinite(r[side][k])
                       for k in ("mcd", "mrstft", "pesq"))
    report = (work / "bddm_report.md").read_text()
    assert report.count("(published)") == 4
