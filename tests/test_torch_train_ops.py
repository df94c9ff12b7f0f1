"""The port's training ops against the JAX package and against autograd.

- Kernel B-SR's plain twin against ``lvc_block_ncl_aug_sr`` in Pallas
  interpret mode (out, s, y, z), f32 at rel 1e-5 and bf16 at the bounds the
  card holds Kernel B to;
- ``lvc_block_sr_backward`` against JAX's ``_sr_backward`` on the same
  saved arrays and output gradient, rel 1e-5;
- the gradients of ``LVCBlockSR``, ``LVCBlockRecompute`` and ``TaugHead``
  against autograd through the plain ops, rel 1e-5 (the plain ops sum in
  float32, so a float64 gradcheck does not apply);
- weight norm against the JAX formulas.

JAX rows are padded to 128 (its lane tile), the port's to rows_padded(C).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdiff_tpu.ops import nn as jnn
from fastdiff_tpu.ops.lvc_block_ncl import _sr_backward, lvc_block_ncl_aug_sr
from fastdiff_tpu_torch.ops import lvc_block_ncl as port
from fastdiff_tpu_torch.ops import lvc_head
from fastdiff_tpu_torch.ops import nn as pnn

LAYERS, C = 4, 8
ROWS = 3 * C + 1
ROWS_P = lvc_head.rows_padded(C)


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _case(b, frames, hop, seed):
    rng = np.random.default_rng(seed)
    length = frames * hop
    f32 = np.float32
    kern = np.zeros((b, frames, LAYERS, 2 * C, 128), f32)
    kern[..., :ROWS] = rng.normal(size=(b, frames, LAYERS, 2 * C, ROWS)) * 0.1
    return dict(
        x=rng.normal(size=(b, C, length)).astype(f32),
        skip=rng.normal(size=(b, C, length)).astype(f32),
        kern=kern,
        wstack_t=(rng.normal(size=(LAYERS, C, ROWS)) * 0.1).astype(f32),
        g=rng.normal(size=(b, C, length)).astype(f32),
    )


def _port_args(kw, dtype=torch.float32):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dtype) for a in
            (kw["x"], kw["skip"], kw["kern"][..., :ROWS_P], kw["wstack_t"])]


def _jax_sr(kw, hop, dtype=jnp.float32):
    return lvc_block_ncl_aug_sr(
        jnp.asarray(kw["x"], dtype), jnp.asarray(kw["skip"], dtype),
        jnp.asarray(kw["kern"], dtype), jnp.asarray(kw["wstack_t"], dtype),
        hop, interpret=True)


# (b, frames, hop): multiples of the JAX halo unit (16 frames at hop 8, 8 at
# hop 16), which its kernel requires
CASES = [(1, 16, 8), (2, 8, 16), (2, 32, 8)]


@pytest.mark.parametrize("b,frames,hop", CASES)
def test_sr_plain_matches_jax_f32(b, frames, hop):
    kw = _case(b, frames, hop, seed=frames + hop)
    got = port.lvc_block_ncl_sr(*_port_args(kw), hop)
    ref = _jax_sr(kw, hop)
    for name, a, r in zip(("out", "s", "y", "z"), got, ref):
        assert a.shape == r.shape, name
        assert _rel(a.numpy(), r) <= 1e-5, (name, _rel(a.numpy(), r))


def test_sr_plain_matches_jax_bf16():
    """bf16 at the card's Kernel B bounds: rel L2 <= 1e-2 and max abs <= 4
    bf16 ulps of the largest value (a flipped rounding in s or y moves the
    later layers by a few ulps)."""
    kw = _case(2, 16, 8, seed=3)
    got = port.lvc_block_ncl_sr(*_port_args(kw, torch.bfloat16), 8)
    ref = _jax_sr(kw, 8, jnp.bfloat16)
    for name, a, r in zip(("out", "s", "y", "z"), got, ref):
        a = a.float().numpy()
        r = np.asarray(r.astype(jnp.float32))
        assert _rel(a, r) <= 1e-2, name
        assert np.abs(a - r).max() <= 2.0 ** -5 * np.abs(r).max(), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sr_backward_matches_jax(dtype):
    """Same saved arrays, same output gradient, through both backwards.
    bf16 compares at 1e-2: the two frameworks sum the f32 products in other
    orders before each bf16 rounding."""
    hop = 8
    kw = _case(2, 16, hop, seed=11)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, s_all, y_all, z_all = _jax_sr(kw, hop, jdt)
    ref = _sr_backward(jnp.asarray(kw["kern"], jdt),
                       jnp.asarray(kw["wstack_t"], jdt), s_all, y_all, z_all,
                       jnp.asarray(kw["g"]), hop)

    def t(a):
        return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(tdt)

    got = port.lvc_block_sr_backward(
        t(kw["kern"][..., :ROWS_P]), t(kw["wstack_t"]), t(s_all), t(y_all),
        t(z_all), torch.from_numpy(kw["g"]), hop)
    tol = 1e-5 if dtype == "float32" else 1e-2
    for name, a, r in zip(("dx", "dskip", "dkern", "dwstack"), got, ref):
        r = np.asarray(r.astype(jnp.float32))
        if name == "dkern":
            np.testing.assert_array_equal(a[..., ROWS:].float().numpy(), 0.0)
            a, r = a[..., :ROWS], r[..., :ROWS]
        assert a.dtype == tdt, name
        assert _rel(a.float().numpy(), r) <= tol, (name, _rel(a.float().numpy(), r))


def _grads(fn, args, g):
    args = [a.clone().requires_grad_() for a in args]
    out = fn(*args)
    return out, torch.autograd.grad(out, args, g)


@pytest.mark.parametrize("fn", ["sr", "recompute"])
@pytest.mark.parametrize("b,frames,hop", [(2, 16, 8), (1, 5, 4)])
def test_block_functions_match_autograd(fn, b, frames, hop):
    """LVCBlockSR / LVCBlockRecompute against autograd through
    lvc_block_ncl_plain (any hop and frame count, as the kernels take)."""
    kw = _case(b, frames, hop, seed=frames * hop)
    args = _port_args(kw)
    g = torch.from_numpy(kw["g"])
    block = port.LVCBlockSR if fn == "sr" else port.LVCBlockRecompute
    out, got = _grads(lambda *a: block.apply(*a, hop), args, g)
    ref_out, ref = _grads(lambda *a: port.lvc_block_ncl_plain(*a, hop), args, g)
    assert _rel(out.detach(), ref_out.detach()) <= 1e-6
    for name, a, r in zip(("dx", "dskip", "dkern", "dwstack"), got, ref):
        assert _rel(a, r) <= 1e-5, (name, _rel(a, r))
    np.testing.assert_array_equal(got[2][..., ROWS:].numpy(), 0.0)


def test_head_function_matches_autograd():
    rng = np.random.default_rng(4)
    m, k, n = 24, 24, LAYERS * 2 * C * ROWS_P
    args = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((m, k), (k, n), (n,))]
    g = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32))
    out, got = _grads(lvc_head.TaugHead.apply, args, g)
    ref_out, ref = _grads(lvc_head.taug_head_matmul_plain, args, g)
    assert _rel(out.detach(), ref_out.detach()) <= 1e-6
    for name, a, r in zip(("dtap", "dw", "db"), got, ref):
        assert a.dtype == r.dtype and _rel(a, r) <= 1e-5, name


def test_head_function_backward_casts_like_jax():
    """bf16 tap and weights, f32 bias: dtap and dw come back in bf16, db in
    f32, as in ``_taug5d_bwd``."""
    rng = np.random.default_rng(5)
    tap = torch.from_numpy(rng.normal(size=(16, 24)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(24, 64)).astype(np.float32))
    b = torch.zeros(64, requires_grad=True)
    tap = tap.bfloat16().requires_grad_()
    w = w.bfloat16().requires_grad_()
    out = lvc_head.TaugHead.apply(tap, w, b)
    out.float().sum().backward()
    assert out.dtype == torch.bfloat16
    assert tap.grad.dtype == w.grad.dtype == torch.bfloat16
    assert b.grad.dtype == torch.float32
    torch.testing.assert_close(b.grad, torch.full((64,), 16.0))


@pytest.mark.parametrize("transpose", [False, True])
def test_weight_norm_matches_jax(transpose):
    rng = np.random.default_rng(6)
    v = rng.normal(size=(3, 5, 7)).astype(np.float32)      # JAX (K, I, O)
    if transpose:
        g = rng.uniform(0.5, 2, size=(5,)).astype(np.float32)
        ref = jnn.conv_transpose_weight({"v": v, "g": g})
        # torch (I, O, K) is the flipped JAX kernel, transposed
        vt = np.ascontiguousarray(v[::-1].transpose(1, 2, 0))
        got = pnn.conv_transpose_weight(torch.from_numpy(vt),
                                        torch.from_numpy(g))
        got = got.numpy().transpose(2, 0, 1)[::-1]
    else:
        g = rng.uniform(0.5, 2, size=(7,)).astype(np.float32)
        ref = jnn.conv_weight({"v": v, "g": g})
        got = pnn.conv_weight(torch.from_numpy(
            np.ascontiguousarray(v.transpose(2, 1, 0))), torch.from_numpy(g))
        got = got.numpy().transpose(2, 1, 0)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6, atol=1e-7)
