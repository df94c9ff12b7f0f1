"""Kernel B's plain version and operands against the JAX NCL block kernel.

The JAX side is ``lvc_block_ncl_aug`` in Pallas interpret mode (with and
without its final-conv epilogue). Its frame counts are multiples of the JAX
halo unit (16 frames at hop 8, 8 at hop 16), which the JAX kernel requires.
f32 at rtol = atol = 3e-4, the JAX package's own NCL-vs-XLA tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdiff_tpu.ops.lvc_block_ncl import lvc_block_ncl_aug, wstack_t_from
from fastdiff_tpu.ops.lvc_block_pallas import stack_conv_weights
from fastdiff_tpu_torch.ops import lvc_block_ncl as port
from fastdiff_tpu_torch.ops.lvc_head import rows_padded

LAYERS, C = 4, 8
ROWS = 3 * C + 1
TOL = dict(rtol=3e-4, atol=3e-4)


def _case(b, frames, hop, seed):
    rng = np.random.default_rng(seed)
    length = frames * hop
    f32 = np.float32
    return dict(
        x=rng.normal(size=(b, C, length)).astype(f32),
        skip=rng.normal(size=(b, C, length)).astype(f32),
        kern=(rng.normal(size=(b, frames, LAYERS, 2 * C, ROWS)) * 0.1
              ).astype(f32),
        wstack_t=(rng.normal(size=(LAYERS, C, ROWS)) * 0.1).astype(f32),
        final_wb=np.concatenate(
            [rng.normal(size=(7, C)) * 0.1,
             np.full((1, C), rng.normal() * 0.1)]).astype(f32),
    )


def _port(kw, hop, final):
    pad = rows_padded(C) - ROWS
    kern = np.pad(kw["kern"], [(0, 0)] * 4 + [(0, pad)])
    return port.lvc_block_ncl(
        torch.from_numpy(kw["x"]), torch.from_numpy(kw["skip"]),
        torch.from_numpy(kern), torch.from_numpy(kw["wstack_t"]), hop,
        torch.from_numpy(kw["final_wb"]) if final else None)


def _jax(kw, hop, final):
    return lvc_block_ncl_aug(
        jnp.asarray(kw["x"]), jnp.asarray(kw["skip"]), jnp.asarray(kw["kern"]),
        jnp.asarray(kw["wstack_t"]), hop, interpret=True,
        final_wb=jnp.asarray(kw["final_wb"]) if final else None)


@pytest.mark.parametrize("b,frames,hop,final", [
    (1, 16, 8, False),
    (2, 32, 8, True),
    (1, 8, 16, True),
    (2, 16, 16, False),
    # 48 * 8 = 384 samples: both sequence edges inside one kernel tile
    (2, 48, 8, True),
])
def test_block_matches_jax(b, frames, hop, final):
    kw = _case(b, frames, hop, seed=frames + hop)
    out = _port(kw, hop, final)
    ref = _jax(kw, hop, final)
    if final:
        np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), **TOL)
        np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), **TOL)
        assert out[1].dtype == torch.float32 and out[1].shape == (
            b, 1, frames * hop)
    else:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_stack_conv_weights_matches_jax():
    rng = np.random.default_rng(0)
    ws = [rng.normal(size=(3, C, C)).astype(np.float32) for _ in range(LAYERS)]
    bs = [rng.normal(size=(C,)).astype(np.float32) for _ in range(LAYERS)]
    ref = wstack_t_from(stack_conv_weights(
        [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs],
        dtype=jnp.float32))
    out = port.stack_conv_weights(
        [torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0)))
         for w in ws], [torch.from_numpy(b) for b in bs], dtype=torch.float32)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_final_conv_wb_matches_jax_layout():
    rng = np.random.default_rng(1)
    fw = rng.normal(size=(7, C, 1)).astype(np.float32)        # JAX (K, I, O)
    fb = rng.normal(size=(1,)).astype(np.float32)
    ref = np.concatenate([fw[:, :, 0], np.full((1, C), fb[0])], axis=0)
    out = port.final_conv_wb(
        torch.from_numpy(np.ascontiguousarray(fw.transpose(2, 1, 0))),
        torch.from_numpy(fb), dtype=torch.float32)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_plain_block_takes_any_hop_and_frame_count():
    """No tiling gate: a hop-4 block of 5 frames runs (JAX cannot fuse it)."""
    kw = _case(1, 5, 4, seed=9)
    out, fin = _port(kw, 4, True)
    assert out.shape == (1, C, 20) and fin.shape == (1, 1, 20)
    assert torch.isfinite(fin).all()
