"""The port's fused-head (``ncl_fh``) and plain (``false``) routes against the
JAX package.

``SMALL`` keeps the full ratios (8, 8, 4), so the hops are 8 / 64 / 256. At
16 frames JAX's ``use_pallas_block="ncl_fh"`` route runs its fused-head
kernel (interpret mode) on the hop-64 and hop-256 blocks only (the hop-8
block needs frames % 16 == 0); at 32 frames on all three. The plain route
is ``use_pallas_block=False``, JAX's XLA path. f32: rel L2 <= 3e-4 per
denoiser call and <= 1e-3 through the N = 4 sampler with JAX's draws
injected (every step divides by sqrt(1 - beta), which grows earlier
errors).
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
from fastdiff_tpu_torch.models.fastdiff import FastDiff, resolve_infer_route
from fastdiff_tpu_torch.ops import (downpath_pallas, lvc_block_ncl,
                                    lvc_block_pallas, lvc_head)
from fastdiff_tpu_torch.vocoders.fastdiff_vocoder import FastDiffVocoder

SMALL = ModelConfig(inner_channels=8, cond_channels=16,
                    upsample_ratios=(8, 8, 4), kpnet_hidden_channels=8,
                    diffusion_step_embed_dim_in=16,
                    diffusion_step_embed_dim_mid=32,
                    diffusion_step_embed_dim_out=32)
F32 = dataclasses.replace(SMALL, compute_dtype="float32")
HOP = SMALL.total_hop
# (port route, JAX use_pallas_block)
ROUTES = {"ncl_fh": "ncl_fh", "plain": False}


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
    return init_fastdiff(jax.random.PRNGKey(0), SMALL)


def _port(params, route):
    model = FastDiff(F32, seed=None, infer_route=route)
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), F32))
    return model.eval()


def _inputs(frames, seed):
    rng = np.random.default_rng(seed)
    audio = rng.normal(size=(1, frames * HOP, 1)).astype(np.float32)
    mel = rng.normal(size=(1, frames, SMALL.cond_channels)).astype(np.float32)
    t = rng.uniform(1.0, 900.0, size=(1, 1)).astype(np.float32)
    return audio, mel, t


def _counts():
    return [dict(m.LAUNCHES) for m in (lvc_head, lvc_block_ncl,
                                       lvc_block_pallas, downpath_pallas)]


@pytest.mark.parametrize("route,frames", [("ncl_fh", 16), ("ncl_fh", 32),
                                          ("plain", 16)])
def test_denoiser_matches_jax_f32(params, route, frames):
    audio, mel, t = _inputs(frames, seed=frames)
    ref = fastdiff_apply(
        params, jnp.asarray(audio), jnp.asarray(mel), jnp.asarray(t),
        dataclasses.replace(F32, use_pallas_block=ROUTES[route]))
    with torch.no_grad():
        out = _port(params, route)(
            *(torch.from_numpy(a) for a in (audio, mel, t)))
    assert out.shape == (1, frames * HOP, 1) and out.dtype == torch.float32
    assert rel_l2(out.numpy(), ref) <= 3e-4


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_sampler_matches_jax_with_injected_noise(params, route):
    frames = 16
    length = frames * HOP
    _, mel, _ = _inputs(frames, seed=3)
    cfg = dataclasses.replace(F32, use_pallas_block=ROUTES[route])
    const = schedules.sampler_constants_for_schedule(
        schedules.noise_schedule_for_steps(4),
        schedules.compute_hyperparams_given_schedule(
            schedules.linear_beta_schedule(DiffusionConfig())))
    key = jax.random.PRNGKey(7)
    ref = sampling_given_noise_schedule(
        lambda x, m, t: fastdiff_apply(params, x, m, t, cfg), key,
        jnp.asarray(mel), const, length)
    key, sub = jax.random.split(key)
    shape = (1, length, 1)
    x_t = np.array(jax.random.normal(sub, shape, jnp.float32))
    zs = [torch.from_numpy(np.array(jax.random.normal(k, shape, jnp.float32)))
          for k in jax.random.split(key, const.n_steps)]
    with torch.no_grad():
        out = sample(_port(params, route), torch.from_numpy(mel), const,
                     length, noise=(torch.from_numpy(x_t), zs))
    assert rel_l2(out.numpy(), ref) <= 1e-3


def test_resolver_matches_jax_policy_for_ncl_fh_and_false():
    from fastdiff_tpu.config import resolve_pallas_block
    for raw in ("ncl_fh", " NCL_FH ", "ncl", "ncl_sr", "true", False,
                "false", "off", 0):
        hp = {"use_pallas_block": raw}
        jax_route = resolve_pallas_block(hp)
        port = resolve_infer_route(hp)
        assert (port == "ncl_fh") == (jax_route == "ncl_fh"), raw
        assert (port == "plain") == (jax_route is False), raw


def test_vocoder_runs_ncl_fh_and_plain_routes():
    """Through ``FastDiffVocoder`` on the CPU: ``ncl_fh`` packs K5's operands
    and ``false`` none; both vocode a 32-frame mel to finite audio, and on
    CPU tensors no kernel counts a launch."""
    hp = {"inner_channels": 8, "cond_channels": 16,
          "upsample_ratios": [8, 8, 4], "kpnet_hidden_channels": 8,
          "diffusion_step_embed_dim_in": 16,
          "diffusion_step_embed_dim_mid": 32,
          "diffusion_step_embed_dim_out": 32, "N": 4, "seed": 3}
    mel = np.random.default_rng(0).normal(size=(32, 16)).astype(np.float32)
    for raw, route in (("ncl_fh", "ncl_fh"), (False, "plain"),
                       ("false", "plain")):
        voc = FastDiffVocoder(dict(hp, use_pallas_block=raw), device="cpu")
        assert voc.route == route and voc.model.infer_route == route
        packed = hasattr(voc.model.lvc_blocks[0], "w_head")
        assert packed == (route == "ncl_fh")
        before = _counts()
        wav = voc.spec2wav(mel)
        assert wav.shape == (32 * HOP,) and np.isfinite(wav).all()
        assert _counts() == before
