"""The port's NWC route as a whole against the JAX package.

``NWC_SMALL`` keeps the full ratios (8, 8, 4), so the hops are 8 / 64 / 256
and the JAX ``use_pallas_block=True`` route runs its NWC block kernel
(interpret mode) on two blocks; 16 frames are 4,096 samples, two halo units
of the (4, 8, 8) down path, so ``use_pallas_down`` runs its kernel too.
f32: rel L2 <= 3e-4 per denoiser call and <= 1e-3 through the N = 4
sampler (the down kernel is off in f32, as in JAX); bf16 with the down
kernel: rel L2 <= 2e-2, JAX's own bound for that flag.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdiff_tpu.config import DiffusionConfig, ModelConfig
from fastdiff_tpu.diffusion import schedules
from fastdiff_tpu.diffusion.sampler import sampling_given_noise_schedule
from fastdiff_tpu.models.fastdiff import fastdiff_apply, init_fastdiff
from fastdiff_tpu_torch.diffusion.sampler import sample
from fastdiff_tpu_torch.models.bridge import params_from_jax
from fastdiff_tpu_torch.models.fastdiff import (FastDiff, resolve_down_kernel,
                                                resolve_infer_route)
from fastdiff_tpu_torch.ops import downpath_pallas, lvc_block_pallas
from fastdiff_tpu_torch.vocoders.fastdiff_vocoder import FastDiffVocoder

NWC_SMALL = ModelConfig(inner_channels=8, cond_channels=16,
                        upsample_ratios=(8, 8, 4), kpnet_hidden_channels=8,
                        diffusion_step_embed_dim_in=16,
                        diffusion_step_embed_dim_mid=32,
                        diffusion_step_embed_dim_out=32)
F32 = dataclasses.replace(NWC_SMALL, compute_dtype="float32")
FRAMES = 16
LENGTH = FRAMES * NWC_SMALL.total_hop


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


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def params():
    return init_fastdiff(jax.random.PRNGKey(0), NWC_SMALL)


def _port(params, cfg, **route):
    model = FastDiff(cfg, seed=None, **route)
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), cfg))
    return model.eval()


def _inputs(b, seed):
    rng = np.random.default_rng(seed)
    audio = rng.normal(size=(b, LENGTH, 1)).astype(np.float32)
    mel = rng.normal(size=(b, FRAMES, NWC_SMALL.cond_channels)).astype(
        np.float32)
    t = rng.uniform(1.0, 900.0, size=(b, 1)).astype(np.float32)
    return audio, mel, t


def _counts():
    return (dict(lvc_block_pallas.LAUNCHES), dict(downpath_pallas.LAUNCHES))


def test_denoiser_matches_jax_nwc_f32(params):
    audio, mel, t = _inputs(2, seed=0)
    ref = fastdiff_apply(params, jnp.asarray(audio), jnp.asarray(mel),
                         jnp.asarray(t),
                         dataclasses.replace(F32, use_pallas_block=True))
    with torch.no_grad():
        out = _port(params, F32, infer_route="nwc")(
            *(torch.from_numpy(a) for a in (audio, mel, t)))
    assert out.shape == (2, LENGTH, 1) and out.dtype == torch.float32
    assert rel_l2(out.numpy(), ref) <= 3e-4


def test_one_state_dict_drives_both_routes(params):
    audio, mel, t = (torch.from_numpy(a) for a in _inputs(1, seed=1))
    ncl = _port(params, F32)
    nwc = _port(params, F32, infer_route="nwc")
    assert ncl.state_dict().keys() == nwc.state_dict().keys()
    with torch.no_grad():
        a, b = ncl(audio, mel, t), nwc(audio, mel, t)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=3e-4, atol=3e-4)


def test_sampler_matches_jax_nwc_with_injected_noise(params):
    """N = 4 DDPM on the NWC route, JAX's draws injected; 1e-3 because
    every step divides by sqrt(1 - beta), which grows earlier errors."""
    _, mel, _ = _inputs(1, seed=3)
    cfg = dataclasses.replace(F32, use_pallas_block=True)
    hyper = schedules.compute_hyperparams_given_schedule(
        schedules.linear_beta_schedule(DiffusionConfig()))
    const = schedules.sampler_constants_for_schedule(
        schedules.noise_schedule_for_steps(4), hyper)
    key = jax.random.PRNGKey(7)
    ref = sampling_given_noise_schedule(
        lambda x, m, t: fastdiff_apply(params, x, m, t, cfg), key,
        jnp.asarray(mel), const, LENGTH)
    key, sub = jax.random.split(key)
    shape = (1, LENGTH, 1)
    x_t = np.array(jax.random.normal(sub, shape, jnp.float32))
    zs = [torch.from_numpy(np.array(jax.random.normal(k, shape, jnp.float32)))
          for k in jax.random.split(key, const.n_steps)]
    with torch.no_grad():
        out = sample(_port(params, F32, infer_route="nwc"),
                     torch.from_numpy(mel), const, LENGTH,
                     noise=(torch.from_numpy(x_t), zs))
    assert rel_l2(out.numpy(), ref) <= 1e-3


def test_denoiser_matches_jax_nwc_bf16_with_down_kernel(params):
    audio, mel, t = _inputs(1, seed=4)
    cfg = dataclasses.replace(NWC_SMALL, use_pallas_block=True,
                              use_pallas_down=True)
    ref = fastdiff_apply(params, jnp.asarray(audio), jnp.asarray(mel),
                         jnp.asarray(t), cfg)
    model = _port(params, NWC_SMALL, infer_route="nwc", down_kernel=True)
    with torch.no_grad():
        out = model(*(torch.from_numpy(a) for a in (audio, mel, t)))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert rel_l2(out.numpy(), np.asarray(ref, np.float32)) <= 2e-2


def test_resolvers():
    for raw in (True, "true", "True", "1", "yes", "on", 1):
        assert resolve_infer_route({"use_pallas_block": raw}) == "nwc"
    for raw in ("auto", "", "ncl", "ncl_sr", "ncl_vjp"):
        assert resolve_infer_route({"use_pallas_block": raw}) == "ncl"
    for raw in (False, "false", 0, "nonsense"):
        assert resolve_infer_route({"use_pallas_block": raw}) == "plain"
    assert resolve_infer_route({"use_pallas_block": "ncl_fh"}) == "ncl_fh"
    assert resolve_infer_route({}) == "ncl"
    for raw, want in (("auto", False), ("", False), ("on", True),
                      ("true", True), ("false", False), (True, True),
                      (False, False), ("nonsense", False)):
        assert resolve_down_kernel({"use_pallas_down": raw}) is want
    assert resolve_down_kernel({}) is False


def test_resolvers_match_jax_policy():
    from fastdiff_tpu.config import resolve_pallas_block, resolve_pallas_down
    for raw in (True, "true", "on", "ncl", "ncl_sr", "ncl_vjp", False,
                "false"):
        hp = {"use_pallas_block": raw}
        jax_nwc = resolve_pallas_block(hp) is True
        assert (resolve_infer_route(hp) == "nwc") == jax_nwc, raw
    for raw in ("auto", "", "on", "true", "yes", "false", True, False):
        hp = {"use_pallas_down": raw}
        assert resolve_down_kernel(hp) == resolve_pallas_down(hp), raw


def test_vocoder_selects_nwc_route_and_gates_the_kernels():
    """Through ``FastDiffVocoder``: true picks the NWC route; on a CPU
    tensor the kernel wrappers run their plain versions and count nothing;
    a 16-frame mel vocodes to finite audio."""
    hp = {"inner_channels": 8, "cond_channels": 16,
          "upsample_ratios": [8, 8, 4], "kpnet_hidden_channels": 8,
          "diffusion_step_embed_dim_in": 16,
          "diffusion_step_embed_dim_mid": 32,
          "diffusion_step_embed_dim_out": 32, "N": 4, "seed": 3,
          "use_pallas_block": "true", "use_pallas_down": True}
    voc = FastDiffVocoder(hp, device="cpu")
    assert voc.route == "nwc" and voc.model.infer_route == "nwc"
    assert voc.model.down_kernel and hasattr(voc.model, "down_conv")
    assert hasattr(voc.model.lvc_blocks[1], "w_aug")
    before = _counts()
    wav = voc.spec2wav(np.random.default_rng(0).normal(
        size=(FRAMES, 16)).astype(np.float32))
    assert wav.shape == (LENGTH,) and np.isfinite(wav).all()
    assert _counts() == before
    for raw, route in (("auto", "ncl"), ("ncl_fh", "ncl_fh"),
                       (False, "plain")):
        voc = FastDiffVocoder(dict(hp, use_pallas_block=raw), device="cpu")
        assert voc.route == route and voc.model.infer_route == route


def test_ncl_fh_runs_ncl_and_says_so(capsys):
    """``ncl_fh`` is a route of its own now (K5 where JAX fuses the head),
    the vocoder builds it without a word about K1 + K3, and on the CPU its
    waveform equals the ``ncl`` route's bit for bit (K5's plain version is
    Kernel A's plain head then Kernel B's plain block)."""
    hp = {"inner_channels": 8, "cond_channels": 16,
          "upsample_ratios": [4, 2, 2], "kpnet_hidden_channels": 8,
          "diffusion_step_embed_dim_in": 16,
          "diffusion_step_embed_dim_mid": 32,
          "diffusion_step_embed_dim_out": 32, "use_pallas_block": "ncl_fh",
          "N": 4, "seed": 5}
    assert resolve_infer_route(hp) == "ncl_fh"
    voc = FastDiffVocoder(hp, device="cpu")
    assert voc.route == "ncl_fh" and voc.model.infer_route == "ncl_fh"
    assert hasattr(voc.model.lvc_blocks[0], "w_head")
    out = capsys.readouterr().out
    assert "ncl_fh" not in out and "K1 + K3" not in out
    ncl = FastDiffVocoder(dict(hp, use_pallas_block="ncl"), device="cpu")
    mel = np.random.default_rng(1).normal(size=(32, 16)).astype(np.float32)
    before = _counts()
    np.testing.assert_array_equal(voc.spec2wav(mel), ncl.spec2wav(mel))
    assert _counts() == before
