"""The port's MoL WaveNet family against the JAX package on the CPU.

Small configs (4 layers, 8-16 channels, hop 16; logistic, Normal,
categorical one-hot and speaker-conditioned), weights drawn in numpy into
JAX's init trees' shapes and carried across by ``models/bridge.py:
zoo_params_from_jax``, the same numpy inputs on both sides:

- the mixture losses 1e-5 and their gradients rel L2 1e-4, finite at
  y = +-1; the samplers equal JAX's with JAX's uniforms injected; mu-law;
- the teacher-forced forward 1e-5 (bf16 2e-2), ``wavenet_mol_loss`` 1e-5
  and its gradients 1e-4;
- the one-sample loop (``wavenet_incremental_logits``) equal to the
  teacher-forced forward (1e-5), and ``wavenet_generate`` equal to JAX's
  with its draws injected (1e-4), and in deterministic mode;
- fold / xfade, ``convert_wavenet_state_dict`` against JAX's converter;
- ``MoLWaveNetTask``: a step against JAX's loss, the NaN skip, and
  ``run.main`` on ``micro_lj_armol.yaml`` (fit, then ``--infer``).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdiff_tpu.models import wavenet_mol as jmol
from fastdiff_tpu.ops import mixture as jmix
from fastdiff_tpu_torch import run
from fastdiff_tpu_torch.models import wavenet_mol as pmol
from fastdiff_tpu_torch.models.bridge import (zoo_params_from_jax,
                                              zoo_params_to_jax)
from fastdiff_tpu_torch.ops import mixture
from fastdiff_tpu_torch.training.armol_task import MoLWaveNetTask
from tests.test_torch_training import _write_split
from tests.test_torch_zoo_denoisers import _rel, _tree


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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = dict(out_channels=6, layers=4, stacks=2, residual_channels=8,
            gate_channels=16, skip_channels=8, cin_channels=10,
            upsample_scales=(4, 4))
CONFIGS = {
    "logistic": ARCH,
    "normal": dict(ARCH, output_distribution="Normal"),
    "onehot": dict(ARCH, scalar_input=False, out_channels=16),
    "speaker": dict(ARCH, gin_channels=4, n_speakers=3),
}
FRAMES = 3


@functools.lru_cache(maxsize=None)
def _setup(kind: str, dtype: str = "float32"):
    """(JAX config, numpy tree, port model, x (B, T, in), wav target,
    mel, g) of a config."""
    kw = dict(CONFIGS[kind], compute_dtype=dtype)
    jcfg = jmol.MoLWaveNetConfig(**kw)
    tree = _tree(jmol.init_wavenet_mol, jcfg, seed=1)
    model = pmol.MoLWaveNet(pmol.MoLWaveNetConfig(**kw), seed=None)
    model.load_state_dict(zoo_params_from_jax(tree))
    rng = np.random.default_rng(2)
    steps = FRAMES * jcfg.hop
    mel = rng.standard_normal((2, FRAMES, jcfg.cin_channels)).astype(
        np.float32)
    if jcfg.scalar_input:
        wav = np.tanh(rng.standard_normal((2, steps, 1))).astype(np.float32)
        wav[0, :3, 0] = (1.0, -1.0, 0.9995)      # the edge bins
    else:
        ids = rng.integers(0, jcfg.out_channels, (2, steps))
        wav = np.eye(jcfg.out_channels, dtype=np.float32)[ids]
    g = np.array([0, 2]) if jcfg.gin_channels else None
    return jcfg, tree, model, wav, mel, g


# -- mixtures -----------------------------------------------------------------

def _mixture_inputs():
    rng = np.random.default_rng(0)
    y_hat = rng.standard_normal((2, 40, 9)).astype(np.float32)
    y = np.clip(rng.standard_normal((2, 40)), -1, 1).astype(np.float32)
    y[0, :4] = (1.0, -1.0, 0.9995, -0.9995)
    return y_hat, y


@pytest.mark.parametrize("name,channels", [
    ("discretized_mix_logistic_loss", 9), ("mix_gaussian_loss", 9),
    ("mix_gaussian_loss", 2)])
def test_mixture_losses_and_gradients_match_jax(name, channels):
    y_hat, y = _mixture_inputs()
    y_hat = y_hat[..., :channels]
    fn = getattr(jmix, name)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p: fn(p, jnp.asarray(y), log_scale_min=-7.0)))(
        jnp.asarray(y_hat))
    p = torch.tensor(y_hat, requires_grad=True)
    got = getattr(mixture, name)(p, torch.from_numpy(y), log_scale_min=-7.0)
    (got_g,) = torch.autograd.grad(got, p)
    assert abs(float(got.detach()) - float(want)) <= 1e-5 * abs(float(want))
    assert torch.isfinite(got_g).all()
    assert _rel(got_g.numpy(), want_g) <= 1e-4
    per = getattr(mixture, name)(torch.from_numpy(y_hat), torch.from_numpy(y),
                                 log_scale_min=-7.0, reduce=False)
    np.testing.assert_allclose(per.numpy(), np.asarray(fn(
        jnp.asarray(y_hat), jnp.asarray(y), log_scale_min=-7.0,
        reduce=False)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["logistic", "gaussian", "gaussian2"])
def test_samplers_match_jax_with_its_uniforms(kind):
    """JAX's draws recomputed from its key as its sampler splits it and
    injected; the sample and the mode equal JAX's (1e-6)."""
    y = np.random.default_rng(1).standard_normal((3, 5, 9 if kind != "gaussian2"
                                                  else 2)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    k1, k2 = jax.random.split(key)
    nr_mix = y.shape[-1] // 3
    lo, hi = 1e-5, 1.0 - 1e-5
    u = np.asarray(jax.random.uniform(k1, (3, 5, nr_mix), minval=lo,
                                      maxval=hi))
    yt = torch.from_numpy(y)
    if kind == "logistic":
        want = jmix.sample_from_discretized_mix_logistic(key, jnp.asarray(y))
        u2 = np.asarray(jax.random.uniform(k2, (3, 5), minval=lo, maxval=hi))
        got = mixture.sample_from_discretized_mix_logistic(
            yt, draws=(torch.from_numpy(u), torch.from_numpy(u2)))
        modes = (mixture.mix_logistic_mode(yt), jmix.mix_logistic_mode(y))
    else:
        want = jmix.sample_from_mix_gaussian(key, jnp.asarray(y))
        z = np.asarray(jax.random.normal(k2, (3, 5)))
        got = mixture.sample_from_mix_gaussian(
            yt, draws=(torch.from_numpy(u), torch.from_numpy(z)))
        modes = (mixture.mix_gaussian_mode(yt), jmix.mix_gaussian_mode(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_array_equal(modes[0].numpy(), np.asarray(modes[1]))
    drawn = mixture.sample_from_discretized_mix_logistic(
        yt if kind == "logistic" else torch.from_numpy(
            np.random.default_rng(2).standard_normal((3, 5, 9))
            .astype(np.float32)),
        generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (3, 5) and drawn.abs().max() <= 1.0


def test_mulaw_matches_jax():
    x = np.linspace(-1, 1, 101).astype(np.float32)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(mixture.mulaw(xt).numpy(),
                               np.asarray(jmix.mulaw(x)), atol=1e-6)
    np.testing.assert_allclose(mixture.inv_mulaw(xt).numpy(),
                               np.asarray(jmix.inv_mulaw(x)), atol=1e-6)
    np.testing.assert_array_equal(mixture.mulaw_quantize(xt).numpy(),
                                  np.asarray(jmix.mulaw_quantize(x)))
    ids = np.arange(256)
    np.testing.assert_allclose(
        mixture.inv_mulaw_quantize(torch.from_numpy(ids)).numpy(),
        np.asarray(jmix.inv_mulaw_quantize(ids)), atol=1e-6)
    assert int(mixture.mulaw_quantize(torch.zeros(1))[0]) == 127


# -- the network ---------------------------------------------------------------

@pytest.mark.parametrize("kind", list(CONFIGS))
def test_forward_loss_and_gradients_match_jax(kind):
    jcfg, tree, model, wav, mel, g = _setup(kind)
    x_in = np.pad(wav[:, :-1], ((0, 0), (1, 0), (0, 0)))

    @jax.jit
    def ref(p):
        out = jmol.wavenet_mol_apply(p, x_in, mel, jcfg, g=g)
        loss, grads = jax.value_and_grad(jmol.wavenet_mol_loss)(
            p, wav, mel, jcfg, g=g)
        return out, loss, grads
    want, loss_j, grads_j = ref(tree)
    gt = None if g is None else torch.from_numpy(g)
    with torch.no_grad():
        got = model(torch.from_numpy(x_in), torch.from_numpy(mel), g=gt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    names, params = zip(*model.named_parameters())
    loss = pmol.wavenet_mol_loss(model, torch.from_numpy(wav),
                                 torch.from_numpy(mel), g=gt)
    grads = torch.autograd.grad(loss, params, materialize_grads=True)
    assert abs(float(loss.detach()) - float(loss_j)) <= \
        1e-5 * abs(float(loss_j))
    got_g = zoo_params_to_jax(dict(zip(names, grads)))
    paths = jax.tree_util.tree_flatten_with_path(grads_j)[0]
    for (path, w), a in zip(paths, jax.tree_util.tree_leaves(got_g)):
        if not np.abs(np.asarray(w)).max():     # the last block's out conv
            assert not np.abs(a).max()
            continue
        assert _rel(a, w) <= 1e-4, jax.tree_util.keystr(path)


def test_bf16_forward_matches_jax():
    jcfg, tree, model, wav, mel, _ = _setup("logistic", "bfloat16")
    want = np.asarray(jax.jit(functools.partial(
        jmol.wavenet_mol_apply, cfg=jcfg))(tree, wav, mel))
    with torch.no_grad():
        got = model(torch.from_numpy(wav), torch.from_numpy(mel)).numpy()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_incremental_equals_teacher_forced(kind):
    _, _, model, wav, mel, g = _setup(kind)
    gt = None if g is None else torch.from_numpy(g)
    x = torch.from_numpy(wav)
    with torch.no_grad():
        want = model(x, torch.from_numpy(mel), g=gt)
    got = pmol.wavenet_incremental_logits(model, x, torch.from_numpy(mel),
                                          g=gt)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    assert pmol._chunk(13824) == 64 and pmol._chunk(97) == 1


def _jax_draws(key, steps, batch, nr_mix):
    """The uniforms JAX's generation loop draws from ``key``."""
    def body(k, _):
        k, sub = jax.random.split(k)
        k1, k2 = jax.random.split(sub)
        lo, hi = 1e-5, 1.0 - 1e-5
        return k, (jax.random.uniform(k1, (batch, nr_mix), minval=lo,
                                      maxval=hi),
                   jax.random.uniform(k2, (batch,), minval=lo, maxval=hi))
    return tuple(np.asarray(d) for d in jax.jit(
        lambda k: jax.lax.scan(body, k, None, length=steps)[1])(key))


def test_generate_matches_jax_with_its_draws():
    """``wavenet_generate`` (folds of 64 + 2 x 16 samples over 12 frames)
    against JAX's with JAX's draws injected."""
    jcfg, tree, model, _, _, _ = _setup("logistic")
    mel = np.random.default_rng(3).standard_normal((1, 12, 10)).astype(
        np.float32)
    key = jax.random.PRNGKey(5)
    want = jmol.wavenet_generate(tree, jnp.asarray(mel), jcfg, key,
                                 target=64, overlap=16)
    folds = pmol.fold_with_overlap(torch.zeros(1, 12 * jcfg.hop, 1), 64, 16)
    draws = _jax_draws(key, folds.shape[1], folds.shape[0],
                       jcfg.out_channels // 3)
    got = pmol.wavenet_generate(model, torch.from_numpy(mel), target=64,
                                overlap=16, draws=draws)
    assert got.shape == want.shape == (12 * jcfg.hop,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    again = pmol.wavenet_generate(model, torch.from_numpy(mel),
                                  torch.Generator().manual_seed(1),
                                  target=64, overlap=16)
    # each fold clips to [-1, 1]; the equal-power crossfade sums to sqrt(2)
    assert np.isfinite(again).all() and np.abs(again).max() <= np.sqrt(2)


@pytest.mark.parametrize("kind", ["logistic", "onehot"])
def test_deterministic_generation_matches_jax(kind):
    jcfg, tree, model, _, mel, _ = _setup(kind)
    cond = np.asarray(jmol.upsample_cond(tree, jnp.asarray(mel), jcfg))
    want = np.asarray(jmol.wavenet_generate_batched(
        tree, jnp.asarray(cond), jcfg, jax.random.PRNGKey(0),
        deterministic=True))
    got = pmol.wavenet_generate_batched(model, torch.from_numpy(cond),
                                        deterministic=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_fold_and_xfade_match_jax():
    c = np.random.default_rng(6).standard_normal((1, 300, 3)).astype(
        np.float32)
    for target, overlap in ((64, 16), (100, 40), (290, 4)):
        want = np.asarray(jmol.fold_with_overlap(jnp.asarray(c), target,
                                                 overlap))
        got = pmol.fold_with_overlap(torch.from_numpy(c), target, overlap)
        np.testing.assert_array_equal(got.numpy(), want)
        y = want[..., 0]
        np.testing.assert_array_equal(pmol.xfade_and_unfold(y, overlap),
                                      jmol.xfade_and_unfold(y, overlap))


def test_convert_state_dict_matches_jax():
    """An r9y9 state_dict in the reference's names (weight norm on the
    convs, a speaker table and g convs): JAX's converter + forward against
    the port's loader + forward."""
    jcfg, _, _, wav, mel, g = _setup("speaker")
    cfg = pmol.MoLWaveNetConfig(**CONFIGS["speaker"])
    rng = np.random.default_rng(7)
    sd = {}

    def conv(prefix, o, i, *k, bias=True):
        sd[f"{prefix}.weight_v"] = torch.from_numpy(
            rng.standard_normal((o, i) + k).astype(np.float32) * 0.3)
        sd[f"{prefix}.weight_g"] = torch.from_numpy(
            rng.uniform(0.5, 1.5, (o,) + (1,) * (1 + len(k)))
            .astype(np.float32))
        if bias:
            sd[f"{prefix}.bias"] = torch.from_numpy(
                rng.standard_normal(o).astype(np.float32) * 0.1)

    r, gate, s, cin = 8, 16, 8, 10
    conv("first_conv", r, 1, 1)
    sd["upsample_net.conv_in.weight"] = torch.eye(cin)[..., None]
    for i, scale in enumerate(cfg.upsample_scales):
        sd[f"upsample_net.upsample.up_layers.{2 * i + 1}.weight"] = \
            torch.full((1, 1, 1, 2 * scale + 1), 1.0 / (2 * scale + 1))
    conv("last_conv_layers.1", s, s, 1)
    conv("last_conv_layers.3", cfg.out_channels, s, 1)
    sd["embed_speakers.weight"] = torch.from_numpy(
        rng.standard_normal((3, 4)).astype(np.float32))
    for layer in range(cfg.layers):
        p = f"conv_layers.{layer}"
        conv(f"{p}.conv", gate, r, 3)
        conv(f"{p}.conv1x1c", gate, cin, 1, bias=False)
        conv(f"{p}.conv1x1g", gate, 4, 1, bias=False)
        conv(f"{p}.conv1x1_out", r, gate // 2, 1)
        conv(f"{p}.conv1x1_skip", s, gate // 2, 1)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jmol.convert_wavenet_state_dict(sd, jcfg))
    want = np.asarray(jax.jit(functools.partial(
        jmol.wavenet_mol_apply, cfg=jcfg))(tree, wav, mel, g=g))
    model = pmol.MoLWaveNet(cfg, seed=None)
    model.load_state_dict(pmol.convert_wavenet_state_dict(sd, cfg))
    with torch.no_grad():
        got = model(torch.from_numpy(wav), torch.from_numpy(mel),
                    g=torch.from_numpy(g)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


# -- the task -------------------------------------------------------------------

HP = {"hop_size": 16, "audio_num_mel_bins": 10, "wn_layers": 4,
      "wn_stacks": 2, "wn_residual_channels": 8, "wn_gate_channels": 16,
      "wn_skip_channels": 8, "wn_out_channels": 6,
      "wn_upsample_scales": [4, 4], "lr": 1e-3, "seed": 0,
      "binary_data_dir": ""}


@pytest.mark.parametrize("finite", [True, False])
def test_task_step_and_nan_skip(finite):
    """``train_step``: the loss equals JAX's ``wavenet_mol_loss`` at the
    same weights (1e-5) and the update applies; a non-finite batch changes
    neither the weights nor the optimizer, and the step still counts."""
    jcfg, tree, _, wav, mel, _ = _setup("logistic")
    task = MoLWaveNetTask(HP, device="cpu")
    assert task.model_cfg == pmol.MoLWaveNetConfig(**ARCH)
    state = task.build_state()
    state.model.load_state_dict(zoo_params_from_jax(tree))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    batch = {"mels": mel, "wavs": wav if finite else np.full_like(wav,
                                                                  np.nan)}
    metrics = task.train_step(state, batch)
    assert state.step == 1
    after = state.model.state_dict()
    if finite:
        want = float(jax.jit(functools.partial(
            jmol.wavenet_mol_loss, cfg=jcfg))(tree, wav, mel))
        assert abs(float(metrics["loss"]) - want) <= 1e-5 * abs(want)
        assert float(metrics["nonfinite"]) == 0.0
        assert state.optimizer.count == 1
        assert any(not torch.equal(before[k], after[k]) for k in before)
        assert np.isfinite(float(task.val_step(state, batch)["loss"]))
    else:
        assert float(metrics["nonfinite"]) == 1.0
        assert state.optimizer.count == 0
        assert all(torch.equal(before[k], after[k]) for k in before)
    assert task.sampler_constants() is None


def test_run_main_fits_and_generates(tmp_path, monkeypatch):
    """``run.py --config micro_lj_armol.yaml`` reaches ``MoLWaveNetTask``
    through ``resolve_class``: 2 fit steps at small widths, then
    ``--infer`` writes each test item's ``_pred.wav`` and ``_gt.wav``."""
    monkeypatch.chdir(tmp_path)
    binary = tmp_path / "binary"
    binary.mkdir()
    rng = np.random.default_rng(0)
    for prefix, n in (("train", 4), ("valid", 1), ("test", 1)):
        _write_split(str(binary), prefix, n, rng)
    config = os.path.join(REPO, "fastdiff_tpu", "configs",
                          "micro_lj_armol.yaml")
    overrides = (f"binary_data_dir={binary},wn_layers=2,wn_stacks=1,"
                 "wn_residual_channels=8,wn_gate_channels=16,"
                 "wn_skip_channels=8,max_samples=2048,max_sentences=2,"
                 "max_updates=2,val_check_interval=2,num_sanity_val_steps=0,"
                 "tb_log_interval=1,wn_fold_target=1024,wn_fold_overlap=64")
    fit = run.main(["--config", config, "--exp_name", "armol", "--device",
                    "cpu", "--hparams", overrides])
    assert fit["step"] == 2 and np.isfinite(fit["val"]["loss"])
    assert isinstance(fit["state"].model, pmol.MoLWaveNet)
    results = run.main(["--config", config, "--exp_name", "armol",
                        "--infer", "--device", "cpu", "--hparams",
                        overrides])
    assert len(results) == 1 and results[0]["audio_seconds"] > 0
    gen = [d for d in os.listdir(os.path.join("checkpoints", "armol"))
           if d.startswith("generated_2")]
    assert len(gen) == 1
    names = os.listdir(os.path.join("checkpoints", "armol", gen[0]))
    assert sorted(names) == ["test0_gt.wav", "test0_pred.wav"]
