"""Port denoiser, weight bridge and sampler against the JAX package.

Small config (C=8, ratios 4/2/2 -> hops 4/8/16) at 16 frames, so that the
JAX "ncl" route runs its Pallas kernels (interpret mode) on the hop-8 and
hop-16 blocks and its XLA path on the hop-4 block. f32 throughout.
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
from fastdiff_tpu.models.fastdiff import (fastdiff_apply, fuse_weight_norm,
                                          init_fastdiff, num_params)
from fastdiff_tpu_torch.diffusion.sampler import sample
from fastdiff_tpu_torch.models.bridge import params_from_jax
from fastdiff_tpu_torch.models.fastdiff import FastDiff
from fastdiff_tpu_torch.models.fastdiff import num_params as port_num_params

SMALL = ModelConfig(inner_channels=8, cond_channels=16,
                    upsample_ratios=(4, 2, 2), kpnet_hidden_channels=8,
                    diffusion_step_embed_dim_in=16,
                    diffusion_step_embed_dim_mid=32,
                    diffusion_step_embed_dim_out=32, compute_dtype="float32")
FRAMES = 16


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_model(params):
    model = FastDiff(SMALL, seed=None)
    model.load_state_dict(params_from_jax(_np_tree(params), SMALL))
    return model.eval()


def _inputs(b, seed):
    rng = np.random.default_rng(seed)
    audio = rng.normal(size=(b, FRAMES * SMALL.total_hop, 1)).astype(np.float32)
    mel = rng.normal(size=(b, FRAMES, SMALL.cond_channels)).astype(np.float32)
    return audio, mel


def test_bridge_layouts_are_exact():
    """Every converted weight equals its (fused) JAX source after the
    layout change, bit for bit."""
    fused = _np_tree(fuse_weight_norm(init_fastdiff(jax.random.PRNGKey(1),
                                                    SMALL)))
    sd = params_from_jax(fused, SMALL)
    conv = lambda p: p["w"].transpose(2, 1, 0)             # noqa: E731
    expect = {
        "first_audio_conv": conv(fused["first_audio_conv"]),
        "final_conv": conv(fused["final_conv"]),
        "fc_t1": fused["fc_t1"]["w"].T,
        "fc_t2": fused["fc_t2"]["w"].T,
    }
    for n, (down, blk) in enumerate(zip(fused["downsample"],
                                        fused["lvc_blocks"])):
        expect[f"downsample.{n}.residual_dense"] = conv(down["residual_dense"])
        for i, cv in enumerate(down["convs"]):
            expect[f"downsample.{n}.convs.{i}"] = conv(cv)
        pre = f"lvc_blocks.{n}"
        expect[f"{pre}.upsample"] = blk["upsample"]["w"][::-1].transpose(1, 2, 0)
        expect[f"{pre}.fc_t"] = blk["fc_t"]["w"].T
        for i, cv in enumerate(blk["convs"]):
            expect[f"{pre}.convs.{i}"] = conv(cv)
        kp = blk["kernel_predictor"]
        expect[f"{pre}.kernel_predictor.input_conv"] = conv(kp["input_conv"])
        for i, cv in enumerate(kp["residual_convs"]):
            expect[f"{pre}.kernel_predictor.residual_convs.{i}"] = conv(cv)
        expect[f"{pre}.kernel_predictor.kernel_conv"] = conv(kp["kernel_conv"])
        expect[f"{pre}.kernel_predictor.bias_conv"] = conv(kp["bias_conv"])
    assert set(sd) == {f"{k}.{s}" for k in expect for s in ("weight", "bias")}
    model_sd = FastDiff(SMALL, seed=None).state_dict()
    assert set(sd) == set(model_sd)
    for name, w in expect.items():
        np.testing.assert_array_equal(sd[f"{name}.weight"].numpy(), w)
        assert sd[f"{name}.weight"].shape == model_sd[f"{name}.weight"].shape


def test_bridge_fuses_weight_norm_like_jax():
    params = init_fastdiff(jax.random.PRNGKey(2), SMALL)
    from_gv = params_from_jax(_np_tree(params), SMALL)
    from_fused = params_from_jax(_np_tree(fuse_weight_norm(params)), SMALL)
    for name, w in from_fused.items():
        np.testing.assert_allclose(from_gv[name].numpy(), w.numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_param_count_matches_jax_full_size():
    cfg = ModelConfig()
    jax_count = num_params(fuse_weight_norm(
        init_fastdiff(jax.random.PRNGKey(0), cfg)))
    assert port_num_params(FastDiff(cfg)) == jax_count


def test_denoiser_matches_jax_ncl():
    params = init_fastdiff(jax.random.PRNGKey(0), SMALL)
    audio, mel = _inputs(2, seed=0)
    t = np.array([[37.4], [512.0]], np.float32)
    ref = fastdiff_apply(params, jnp.asarray(audio), jnp.asarray(mel),
                         jnp.asarray(t),
                         dataclasses.replace(SMALL, use_pallas_block="ncl"))
    with torch.no_grad():
        out = _port_model(params)(torch.from_numpy(audio),
                                  torch.from_numpy(mel), torch.from_numpy(t))
    assert out.shape == (2, FRAMES * SMALL.total_hop, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("ddim", [False, True])
def test_sampler_matches_jax_with_injected_noise(ddim):
    """N=4 DDPM / DDIM against the JAX sampler (XLA path). The JAX draws
    are reproduced from its key (split as in the sampler) and injected.
    1e-3: each step divides by sqrt(1 - beta), which grows earlier errors."""
    params = init_fastdiff(jax.random.PRNGKey(0), SMALL)
    _, mel = _inputs(1, seed=3)
    length = FRAMES * SMALL.total_hop
    hyper = schedules.compute_hyperparams_given_schedule(
        schedules.linear_beta_schedule(DiffusionConfig()))
    const = schedules.sampler_constants_for_schedule(
        schedules.noise_schedule_for_steps(4), hyper)
    key = jax.random.PRNGKey(7)
    ref = sampling_given_noise_schedule(
        lambda x, m, t: fastdiff_apply(params, x, m, t, SMALL), key,
        jnp.asarray(mel), const, length, ddim=ddim)
    key, sub = jax.random.split(key)
    shape = (1, length, 1)
    x_t = np.array(jax.random.normal(sub, shape, jnp.float32))
    zs = [torch.from_numpy(np.array(jax.random.normal(k, shape, jnp.float32)))
          for k in jax.random.split(key, const.n_steps)]
    with torch.no_grad():
        out = sample(_port_model(params), torch.from_numpy(mel), const,
                     length, ddim=ddim, noise=(torch.from_numpy(x_t), zs))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=1e-3, atol=1e-3)


def test_sampler_generator_draws_are_seeded():
    model = FastDiff(SMALL, seed=0).eval()
    _, mel = _inputs(1, seed=4)
    const = schedules.sampler_constants_for_schedule(
        schedules.noise_schedule_for_steps(4),
        schedules.compute_hyperparams_given_schedule(
            schedules.linear_beta_schedule(DiffusionConfig())))
    length = FRAMES * SMALL.total_hop
    with torch.no_grad():
        a = sample(model, torch.from_numpy(mel), const, length,
                   generator=torch.Generator().manual_seed(5))
        b = sample(model, torch.from_numpy(mel), const, length,
                   generator=torch.Generator().manual_seed(5))
    assert a.shape == (1, length, 1) and torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
