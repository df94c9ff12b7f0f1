"""The port's zoo denoisers (WaveNet, diffusion PWG) in ``FastDiffTask``, the
PWG generator and the PWG vocoder against the JAX package on the CPU.

Small widths (3-4 layers, 8-16 channels, 4 frames at hop 256), weights
drawn in numpy into JAX's init trees' shapes, carried across by
``models/bridge.py:zoo_params_from_jax``, the same numpy inputs on both
sides:

- forwards: f32 1e-5, bf16 2e-2 of the largest output;
- the task's loss at JAX's draws of t and z (injected) 1e-5 and each
  gradient leaf rel L2 1e-4, at each of three steps; the task's optimizer
  and optax's on the same (JAX's) gradients 1e-6; ``train_step`` runs;
- the N = 4 graph sampler (``make_test_sampler``) against JAX's
  ``make_param_sampler`` with its draws injected, 1e-3;
- ``convert_pwg_state_dict`` / ``convert_pwg_diffusion_state_dict``: a
  synthetic state_dict in the reference's names gives the same outputs
  through JAX's converter and the port's loader;
- the PWG vocoder: seed-0 fallback, a released-style checkpoint, lengths.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fastdiff_tpu.config import DiffusionConfig
from fastdiff_tpu.config import TrainConfig as JaxTrainConfig
from fastdiff_tpu.diffusion import schedules as jsched
from fastdiff_tpu.diffusion.losses import theta_timestep_loss as jax_loss
from fastdiff_tpu.diffusion.sampler import \
    make_param_sampler as jax_make_param_sampler
from fastdiff_tpu.models import pwg as jpwg
from fastdiff_tpu.models import wavenet as jwn
from fastdiff_tpu.training.optim import make_optimizer
from fastdiff_tpu_torch.models import pwg, wavenet
from fastdiff_tpu_torch.models.bridge import (zoo_params_from_jax,
                                              zoo_params_to_jax)
from fastdiff_tpu_torch.ops import lvc_block_ncl, lvc_head
from fastdiff_tpu_torch.training.task import FastDiffTask
from fastdiff_tpu_torch.vocoders import get_vocoder_cls
from fastdiff_tpu_torch.vocoders.pwg_vocoder import PWG as PWGVocoder


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

FRAMES, HOP = 4, 256
COMMON = {"hop_size": HOP, "audio_num_mel_bins": 80, "T": 20,
          "beta_0": 1e-4, "beta_T": 0.05, "lr": 2e-4, "seed": 0,
          "max_samples": FRAMES * HOP, "max_sentences": 2,
          "binary_data_dir": "", "N": 4}
HP = {
    "wavenet": dict(COMMON, denoiser="wavenet", res_channels=8,
                    skip_channels=8, num_res_layers=3, dilation_cycle=2,
                    multiband=False, diffusion_step_embed_dim_in=16,
                    diffusion_step_embed_dim_mid=32,
                    diffusion_step_embed_dim_out=32,
                    compute_dtype="float32"),
    "pwg": dict(COMMON, denoiser="pwg", pwg_layers=4, pwg_stacks=2,
                pwg_residual_channels=8, pwg_gate_channels=16,
                pwg_skip_channels=8, pwg_upsample_scales=[4, 8, 8],
                compute_dtype="float32"),
}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(seed=0, b=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, FRAMES * HOP, 1)).astype(np.float32),
            rng.standard_normal((b, FRAMES, 80)).astype(np.float32),
            np.array([[3.0], [17.5]], np.float32)[:b])


def _tree(init, cfg, seed: int = 0) -> dict:
    """A tree of ``init``'s structure and shapes (``jax.eval_shape``: no
    compile) with weights drawn in numpy: kernels N(0, 1 / fan_in), biases
    N(0, 0.01), weight-norm gains U(0.5, 1.5). Eager JAX would compile each
    initializer's shape on its own, and any weights serve a parity test."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "g":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "b":
            return (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)
        fan_in = max(1, int(np.prod(leaf.shape[:-1])))
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(
            np.float32)
    shapes = jax.eval_shape(lambda key: init(key, cfg),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def _family(name: str, dtype: str = "float32"):
    """(JAX config, JAX tree, jitted JAX apply(params, x, mel, t), port
    config, port module class) of a denoiser family."""
    hp = dict(HP[name], compute_dtype=dtype)
    if name == "wavenet":
        jcfg = jwn.WaveNetConfig.from_hparams(hp)
        tree = _tree(jwn.init_wavenet, jcfg)
        apply = jwn.get_apply_fn(jcfg)
        return (jcfg, tree, jax.jit(apply), wavenet.WaveNetConfig
                .from_hparams(hp), wavenet.WaveNet)
    jcfg = jpwg.PWGConfig.from_hparams(hp)
    tree = _tree(jpwg.init_pwg_diffusion, jcfg)
    return (jcfg, tree, jax.jit(jpwg.get_apply_fn(jcfg)),
            pwg.PWGConfig.from_hparams(hp), pwg.PWGDiffusion)


def _port(name, dtype="float32", tree=None):
    _, ref_tree, _, cfg, cls = _family(name, dtype)
    model = cls(cfg, seed=None)
    model.load_state_dict(zoo_params_from_jax(
        ref_tree if tree is None else tree))
    return model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["wavenet", "pwg"])
def test_denoiser_forward_matches_jax(name, dtype):
    _, tree, apply, _, _ = _family(name, dtype)
    x, mel, t = _inputs()
    want = np.asarray(apply(tree, x, mel, t))
    with torch.no_grad():
        got = _port(name, dtype)(*map(torch.from_numpy, (x, mel, t))).numpy()
    assert got.shape == want.shape == x.shape and got.dtype == np.float32
    scale = float(np.abs(want).max())
    bound = 1e-5 if dtype == "float32" else 2e-2 * scale
    assert np.abs(got - want).max() <= bound, np.abs(got - want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pwg_generator_matches_jax(dtype):
    jcfg = jpwg.PWGConfig(layers=4, stacks=2, residual_channels=8,
                          gate_channels=16, skip_channels=8,
                          upsample_scales=(4, 8, 8), compute_dtype=dtype)
    tree = _tree(jpwg.init_pwg, jcfg, seed=1)
    model = pwg.PWG(pwg.PWGConfig(**jcfg.__dict__), seed=None)
    model.load_state_dict(zoo_params_from_jax(tree))
    x, mel, _ = _inputs(1)
    want = np.asarray(jax.jit(functools.partial(jpwg.pwg_apply, cfg=jcfg))(
        tree, x, mel))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(mel)).numpy()
    bound = 1e-5 if dtype == "float32" else 2e-2 * float(np.abs(want).max())
    assert np.abs(got - want).max() <= bound


@pytest.mark.parametrize("name", ["wavenet", "pwg"])
def test_bridge_round_trip_is_exact(name):
    _, tree, _, _, _ = _family(name)
    back = zoo_params_to_jax(_port(name).state_dict())
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_port_init_distributions():
    """The port's seed weights follow JAX's init rules: WaveNet's output
    conv zero (the model starts at eps = 0), every weight-normed kernel's
    g = ||v|| (so the kernel is v) and the upsamplers' biases zero; PWG's
    upsampling filters the mean 1 / (2s + 1); one seed, one set."""
    wn = _port_model("wavenet", seed=3)
    assert not wn.out_conv.weight.any() and not wn.out_conv.bias.any()
    for blk in wn.blocks:
        torch.testing.assert_close(blk.dilated_conv.weight,
                                   blk.dilated_conv.v)
        for up in blk.upsamplers:
            torch.testing.assert_close(up.g, up.v.norm())
            assert not up.bias.any()
    x, mel, t = map(torch.from_numpy, _inputs())
    with torch.no_grad():
        assert not wn(x, mel, t).any()
    pd = _port_model("pwg", seed=3)
    for up, s in zip(pd.up_convs, pd.cfg.upsample_scales):
        assert torch.all(up.weight == 1.0 / (2 * s + 1))
    again = _port_model("pwg", seed=3).state_dict()
    assert all(torch.equal(v, again[k]) for k, v in pd.state_dict().items())


def _port_model(name, seed):
    _, _, _, cfg, cls = _family(name)
    return cls(cfg, seed=seed)


def _task(name, **extra) -> FastDiffTask:
    return FastDiffTask(dict(HP[name], **extra), device="cpu")


def test_task_builds_each_family_without_a_kernel_route():
    """``denoiser`` picks the module; a zoo denoiser resolves no LVC route
    (``use_pallas_block: true``, which the fastdiff denoiser refuses in
    training, is ignored), and any other name trains FastDiff, as JAX."""
    for name, cls in (("wavenet", wavenet.WaveNet),
                      ("pwg", pwg.PWGDiffusion)):
        task = _task(name, use_pallas_block=True)
        assert task.route is None
        assert isinstance(task.build_state().model, cls)
    other = FastDiffTask({"denoiser": "unknown", "inner_channels": 8},
                         device="cpu")
    assert other.zoo is None and other.route == "plain"


@pytest.fixture(scope="module", params=["wavenet", "pwg"])
def jax_steps(request):
    """Three JAX steps (value_and_grad of theta_timestep_loss, then the
    task's optax chain) from ``_family``'s tree, with each step's draws.
    WaveNet's output conv there is not zero: at JAX's zero init every other
    gradient is exactly zero in the port and rounding noise (~1e-13) in
    JAX, which no relative bound can compare (the port's zero init is
    ``test_port_init_distributions``)."""
    name = request.param
    _, tree, apply, _, _ = _family(name)
    hp = HP[name]
    alpha = jsched.compute_hyperparams_given_schedule(
        jsched.linear_beta_schedule(DiffusionConfig.from_hparams(hp))).alpha
    x, mel, _ = _inputs(2)
    wav = (x * 0.3).astype(np.float32)
    tx = make_optimizer(JaxTrainConfig.from_hparams(hp))

    @jax.jit
    def value_and_grad(p, key):
        return jax.value_and_grad(lambda q: jax_loss(
            lambda a, m, t: apply(q, a, m, t), key, jnp.asarray(mel),
            jnp.asarray(wav), jnp.asarray(alpha)))(p)

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    @jax.jit
    def draws(key):
        k_t, k_z = jax.random.split(key)
        return (jax.random.randint(k_t, (2, 1, 1), 0, len(alpha)),
                jax.random.normal(k_z, wav.shape, jnp.float32))

    params, opt_state, steps = tree, jax.jit(tx.init)(tree), []
    for i in range(3):
        key = jax.random.PRNGKey(20 + i)
        loss, grads = value_and_grad(params, key)
        ts, z = _np(draws(key))
        steps.append(dict(loss=float(loss), grads=_np(grads), ts=ts, z=z))
        params, opt_state = update(grads, opt_state, params)
    return dict(name=name, tree=tree, final=_np(params), steps=steps,
                batch={"mels": mel, "wavs": wav})


def test_task_loss_gradients_and_steps_match_jax(jax_steps):
    r = jax_steps
    task = _task(r["name"])
    state = task.build_state()
    state.model.load_state_dict(zoo_params_from_jax(r["tree"]))
    names = [n for n, _ in state.model.named_parameters()]
    for step in r["steps"]:
        ts, z = torch.tensor(step["ts"]), torch.tensor(step["z"])
        loss = task.loss(state.model, r["batch"], ts=ts, z=z)
        grads = torch.autograd.grad(loss, list(state.model.parameters()),
                                    materialize_grads=True)
        assert abs(float(loss.detach()) - step["loss"]) <= \
            1e-5 * abs(step["loss"])
        got = zoo_params_to_jax(dict(zip(names, grads)))
        paths = jax.tree_util.tree_flatten_with_path(step["grads"])[0]
        # WaveNet's init_conv has one input channel and k = 1, so weight norm
        # makes its kernel g * sign(v) and dL/dv is exactly 0: the port
        # gives 0, JAX rounding noise. Such a leaf is held to zero (1e-7 of
        # the global gradient norm) on both sides instead.
        noise = 1e-7 * float(np.sqrt(sum(
            np.sum(np.square(w, dtype=np.float64)) for _, w in paths)))
        for (path, want), g in zip(paths, jax.tree_util.tree_leaves(got)):
            if np.abs(want).max() <= noise:
                assert np.abs(g).max() <= noise, jax.tree_util.keystr(path)
                continue
            assert _rel(g, want) <= 1e-4, jax.tree_util.keystr(path)
        ref = zoo_params_from_jax(step["grads"])
        state.optimizer.step([ref[n] for n in names])
    got = zoo_params_to_jax(state.model.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(r["final"])):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    # train_step: the first step's loss at its draws, one update
    fresh = task.build_state()
    fresh.model.load_state_dict(zoo_params_from_jax(r["tree"]))
    first = r["steps"][0]
    metrics = task.train_step(fresh, r["batch"],
                              ts=torch.tensor(first["ts"]),
                              z=torch.tensor(first["z"]))
    assert abs(float(metrics["loss"]) - first["loss"]) <= \
        1e-5 * abs(first["loss"])
    assert float(metrics["nonfinite"]) == 0.0 and fresh.step == 1
    assert fresh.optimizer.count == 1


@pytest.mark.parametrize("name", ["wavenet", "pwg"])
def test_graph_sampler_matches_jax_with_injected_noise(name):
    """``make_test_sampler`` (the graph sampler over the zoo module) against
    JAX's ``make_param_sampler`` over the family's apply, N = 4, with JAX's
    draws reproduced from its key and injected: 1e-3."""
    jcfg, tree, _, _, _ = _family(name)
    get_apply = jwn.get_apply_fn if name == "wavenet" else jpwg.get_apply_fn
    task = _task(name)
    const = task.sampler_constants()
    length = FRAMES * HOP
    _, mel, _ = _inputs(3, b=1)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_make_param_sampler(get_apply(jcfg), const)(
        tree, key, jnp.asarray(mel), length))
    key, sub = jax.random.split(key)
    shape = (1, length, 1)
    x_t = torch.from_numpy(np.array(jax.random.normal(sub, shape)))
    zs = [torch.from_numpy(np.array(jax.random.normal(k, shape)))
          for k in jax.random.split(key, const.n_steps)]
    sampler = task.make_test_sampler(
        task.inference_state_dict({"params": zoo_params_from_jax(tree)}),
        const)
    before = [dict(c) for c in (lvc_head.LAUNCHES, lvc_block_ncl.LAUNCHES)]
    for _ in range(2):          # the warm-up, then the capture (eager here)
        got = sampler(None, None, torch.from_numpy(mel), length,
                      noise=(x_t, zs)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    assert sampler.captures == 1
    assert [lvc_head.LAUNCHES, lvc_block_ncl.LAUNCHES] == before


def _reference_state_dict(cfg: pwg.PWGConfig, diffusion: bool,
                          seed: int = 0) -> dict:
    """A random state_dict in the reference's PWG names: weight norm as
    (weight_g, weight_v) on most convs, plain weights on conv_in and every
    block's aux conv."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(prefix, o, i, *k, bias=True, norm=True):
        v = rng.standard_normal((o, i) + k).astype(np.float32) * 0.3
        if norm:
            sd[f"{prefix}.weight_v"] = torch.from_numpy(v)
            sd[f"{prefix}.weight_g"] = torch.from_numpy(
                rng.uniform(0.5, 1.5, (o,) + (1,) * (1 + len(k)))
                .astype(np.float32))
        else:
            sd[f"{prefix}.weight"] = torch.from_numpy(v)
        if bias:
            sd[f"{prefix}.bias"] = torch.from_numpy(
                rng.standard_normal(o).astype(np.float32) * 0.1)

    r, g, s, a = (cfg.residual_channels, cfg.gate_channels,
                  cfg.skip_channels, cfg.aux_channels)
    conv("first_conv", r, 1, 1)
    conv("upsample_net.conv_in", a, a, 2 * cfg.aux_context_window + 1,
         bias=False, norm=False)
    for i, scale in enumerate(cfg.upsample_scales):
        conv(f"upsample_net.upsample.up_layers.{2 * i + 1}", 1, 1, 1,
             2 * scale + 1, bias=False)
    conv("last_conv_layers.1", s, s, 1)
    conv("last_conv_layers.3", 1, s, 1)
    for layer in range(cfg.layers):
        p = f"conv_layers.{layer}"
        conv(f"{p}.conv", g, r, cfg.kernel_size)
        conv(f"{p}.conv1x1_aux", g, a, 1, bias=False, norm=False)
        conv(f"{p}.conv1x1_out", r, g // 2, 1)
        conv(f"{p}.conv1x1_skip", s, g // 2, 1)
        if diffusion:
            sd[f"{p}.fc_t.weight"] = torch.from_numpy(
                rng.standard_normal((r, 512)).astype(np.float32) * 0.05)
            sd[f"{p}.fc_t.bias"] = torch.zeros(r)
    if diffusion:
        for name, (o, i) in (("fc_t1", (512, 128)), ("fc_t2", (512, 512))):
            sd[f"{name}.weight"] = torch.from_numpy(
                rng.standard_normal((o, i)).astype(np.float32) * 0.05)
            sd[f"{name}.bias"] = torch.zeros(o)
    return sd


@pytest.mark.parametrize("diffusion", [False, True])
def test_convert_state_dict_matches_jax(diffusion):
    jcfg, _, apply, cfg, _ = _family("pwg")
    sd = _reference_state_dict(cfg, diffusion)
    x, mel, t = _inputs(4)
    if diffusion:
        tree = jpwg.convert_pwg_diffusion_state_dict(sd, jcfg)
        want = np.asarray(apply(_np(tree), x, mel, t))
        model = pwg.PWGDiffusion(cfg, seed=None)
        model.load_state_dict(pwg.convert_pwg_diffusion_state_dict(sd, cfg))
        args = (x, mel, t)
    else:
        tree = jpwg.convert_pwg_state_dict(sd, jcfg)
        want = np.asarray(jax.jit(functools.partial(
            jpwg.pwg_apply, cfg=jcfg))(_np(tree), x, mel))
        model = pwg.PWG(cfg, seed=None)
        model.load_state_dict(pwg.convert_pwg_state_dict(sd, cfg))
        args = (x, mel)
    with torch.no_grad():
        got = model(*map(torch.from_numpy, args)).numpy()
    assert np.abs(want).max() > 1e-3
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


def test_pwg_vocoder(tmp_path):
    """``vocoder: pwg``: seed-0 weights without a checkpoint (a warning),
    frames * 256 finite samples, the generator's noise from ``seed``; a
    released-style checkpoint (``state_dict.model.generator``) loads."""
    hp = {"vocoder": "pwg", "compute_dtype": "float32", "seed": 3}
    assert get_vocoder_cls(hp) is PWGVocoder
    voc = PWGVocoder(hp, device="cpu")
    mel = np.random.default_rng(5).standard_normal((6, 80)).astype(
        np.float32)
    a = voc.spec2wav(mel)
    assert a.shape == (6 * HOP,) and np.isfinite(a).all()
    b = PWGVocoder(hp, device="cpu").spec2wav(mel)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, voc.spec2wav(mel))    # the next draw
    sd = _reference_state_dict(voc.cfg, False, seed=1)
    path = tmp_path / "pwg.ckpt"
    torch.save({"state_dict": {"model": {"generator": sd}}}, path)
    loaded = PWGVocoder(dict(hp, vocoder_ckpt=str(path)), device="cpu")
    want = pwg.PWG(voc.cfg, seed=None)
    want.load_state_dict(pwg.convert_pwg_state_dict(sd, voc.cfg))
    for k, v in want.state_dict().items():
        assert torch.equal(loaded.model.state_dict()[k], v)
