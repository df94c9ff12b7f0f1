"""Kernel A's plain version and operands against the JAX predictor head.

The JAX side is ``taug_head_matmul_5d`` in Pallas interpret mode, with its
rows padded to 128; the port pads rows to a multiple of 8. Only the first
3C + 1 rows carry values, so the comparison slices to those. f32 at 1e-5;
bf16 with the same cast points at a relative L2 error of 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdiff_tpu.config import ModelConfig
from fastdiff_tpu.models.fastdiff import (_taug_head_operands, fuse_weight_norm,
                                          init_fastdiff)
from fastdiff_tpu.ops.lvc_block_pallas import taug_head_matmul_5d
from fastdiff_tpu_torch.models.bridge import params_from_jax
from fastdiff_tpu_torch.models.fastdiff import FastDiff
from fastdiff_tpu_torch.ops import lvc_head

CFG = ModelConfig(inner_channels=8, cond_channels=16, upsample_ratios=(4, 2, 2),
                  kpnet_hidden_channels=8, diffusion_step_embed_dim_in=16,
                  diffusion_step_embed_dim_mid=32,
                  diffusion_step_embed_dim_out=32, compute_dtype="float32")
LAYERS, C = 4, 8
ROWS = 3 * C + 1


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


def _jax_head(tap, w, b, rows_jax, dtype):
    """(M, K) @ (K, layers, 2C, ROWS) weights padded to rows_jax, interpret."""
    wp = np.pad(w, [(0, 0)] * 3 + [(0, rows_jax - ROWS)])
    bp = np.pad(b, [(0, 0)] * 2 + [(0, rows_jax - ROWS)])
    out = taug_head_matmul_5d(
        jnp.asarray(tap, dtype), jnp.asarray(wp.reshape(tap.shape[1], -1), dtype),
        jnp.asarray(bp.reshape(-1), jnp.float32), LAYERS, 2 * C, rows_jax,
        interpret=True)
    return np.asarray(out.astype(jnp.float32))[..., :ROWS]


def _port_head(tap, w, b, dtype):
    rows_p = lvc_head.rows_padded(C)
    wp = np.pad(w, [(0, 0)] * 3 + [(0, rows_p - ROWS)])
    bp = np.pad(b, [(0, 0)] * 2 + [(0, rows_p - ROWS)])
    out = lvc_head.taug_head_matmul(
        torch.from_numpy(tap).to(dtype),
        torch.from_numpy(wp.reshape(tap.shape[1], -1)).to(dtype),
        torch.from_numpy(bp.reshape(-1)))
    return out.float().reshape(tap.shape[0], LAYERS, 2 * C, rows_p)[
        ..., :ROWS].numpy()


def _case(seed, m=32):
    rng = np.random.default_rng(seed)
    k = 24
    tap = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, LAYERS, 2 * C, ROWS)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(LAYERS, 2 * C, ROWS)) * 0.2).astype(np.float32)
    return tap, w, b


def test_head_matches_jax_f32():
    tap, w, b = _case(0)
    np.testing.assert_allclose(_port_head(tap, w, b, torch.float32),
                               _jax_head(tap, w, b, 128, jnp.float32),
                               rtol=1e-5, atol=1e-5)


def test_head_matches_jax_bf16():
    tap, w, b = _case(1)
    out = _port_head(tap, w, b, torch.bfloat16)
    ref = _jax_head(tap, w, b, 128, jnp.bfloat16)
    rel = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    assert rel <= 1e-2, rel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [32, 100, 131])
def test_head_matches_jax_ragged_m(m, dtype):
    """Row counts that are no multiple of the kernel's 128-row tile (or of
    8): the plain head against JAX's interpret-mode kernel, f32 at 1e-5 and
    bf16 at a relative L2 error of 1e-2."""
    tap, w, b = _case(m, m)
    out = _port_head(tap, w, b, getattr(torch, dtype))
    ref = _jax_head(tap, w, b, 128, getattr(jnp, dtype))
    assert out.shape == (m, LAYERS, 2 * C, ROWS)
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    else:
        rel = np.linalg.norm(out - ref) / np.linalg.norm(ref)
        assert rel <= 1e-2, rel


def test_rows_padded():
    assert lvc_head.rows_padded(32) == 104
    assert lvc_head.rows_padded(8) == 32


@pytest.mark.parametrize("frames", [5, 16])
def test_head_operands_match_jax(frames):
    """pack_head + head_taps reproduce ``_taug_head_operands`` (trunk taps,
    merged weights and bias), and the head output matches end to end."""
    params = fuse_weight_norm(init_fastdiff(jax.random.PRNGKey(3), CFG))
    kp = params["lvc_blocks"][1]["kernel_predictor"]
    rng = np.random.default_rng(frames)
    cond = rng.normal(size=(2, frames, CFG.cond_channels)).astype(np.float32)
    tap_j, w_j, b_j, rows_j = _taug_head_operands(kp, jnp.asarray(cond), CFG,
                                                  jnp.float32)
    model = FastDiff(CFG, seed=None)
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), CFG))
    block = model.lvc_blocks[1]
    with torch.no_grad():
        trunk = block.kernel_predictor.trunk(
            torch.from_numpy(cond).transpose(1, 2), torch.float32)
        tap_t = lvc_head.head_taps(trunk)
        out = lvc_head.taug_head_matmul(tap_t, block.w_head, block.b_head)
    np.testing.assert_allclose(tap_t.numpy(),
                               np.asarray(tap_j).reshape(2 * frames, -1),
                               rtol=1e-5, atol=1e-5)
    rows_p = lvc_head.rows_padded(C)
    w_t = block.w_head.reshape(-1, LAYERS, 2 * C, rows_p)
    np.testing.assert_array_equal(
        w_t[..., :ROWS].numpy(),
        np.asarray(w_j).reshape(-1, LAYERS, 2 * C, rows_j)[..., :ROWS])
    np.testing.assert_array_equal(w_t[..., ROWS:].numpy(), 0.0)
    np.testing.assert_array_equal(
        block.b_head.reshape(LAYERS, 2 * C, rows_p)[..., :ROWS].numpy(),
        np.asarray(b_j).reshape(LAYERS, 2 * C, rows_j)[..., :ROWS])
    ref = taug_head_matmul_5d(tap_j.reshape(2 * frames, -1), w_j,
                              b_j.reshape(-1), LAYERS, 2 * C, rows_j,
                              interpret=True)
    np.testing.assert_allclose(
        out.reshape(2 * frames, LAYERS, 2 * C, rows_p)[..., :ROWS].numpy(),
        np.asarray(ref)[..., :ROWS], rtol=1e-5, atol=1e-5)

