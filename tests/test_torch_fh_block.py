"""K5's plain version against the JAX fused-head block kernel.

The JAX side is ``lvc_block_ncl_fh`` in Pallas interpret mode (with and
without its final-conv epilogue) at the production width (C = 32, a head
contraction of 192), a few tens of frames at hops 8, 64 and 256 (frame
counts that JAX's halo units divide). Both pack the same head weights,
JAX with rows padded to 128 and the port to 104. float32: rtol = atol =
3e-4, the tolerance of the port's Kernel B test. bfloat16: both sides cast
at the same points (f32 sums, one rounding per head output, s, y and
gate), but a sum in another order flips a bf16 rounding now and then and
the flip travels through the later layers, so the bound is the one the
port holds Kernel B to in bf16 (``chip_smoke.py`` phase 4): relative L2
<= 1e-2 and max abs <= 4 bf16 ulps (2^-5) of the largest value. Also: the
plain K5 is Kernel A's plain head followed by Kernel B's plain block, bit
for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdiff_tpu.ops.lvc_block_ncl import lvc_block_ncl_fh
from fastdiff_tpu_torch.ops import lvc_block_ncl as port
from fastdiff_tpu_torch.ops import lvc_head

LAYERS, C, K = 4, 32, 192
ROWS = 3 * C + 1
TOL = dict(rtol=3e-4, atol=3e-4)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _case(b, frames, hop, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    length = frames * hop
    return dict(
        x=rng.normal(size=(b, C, length)).astype(f32),
        skip=rng.normal(size=(b, C, length)).astype(f32),
        tap_c=rng.normal(size=(b, frames, K)).astype(f32),
        # head weights and bias per (layer, out channel, row); kernels ~0.05
        w=(rng.normal(size=(K, LAYERS, 2 * C, ROWS)) * 0.004).astype(f32),
        bias=(rng.normal(size=(LAYERS, 2 * C, ROWS)) * 0.01).astype(f32),
        wstack_t=(rng.normal(size=(LAYERS, C, ROWS)) * 0.1).astype(f32),
        final_wb=np.concatenate(
            [rng.normal(size=(7, C)) * 0.1,
             np.full((1, C), rng.normal() * 0.1)]).astype(f32),
    )


def _pack(kw, rows_p):
    """The merged head (K, layers * 2C * rows_p) and bias, rows zero-padded."""
    pad = [(0, 0)] * 3 + [(0, rows_p - ROWS)]
    w = np.pad(kw["w"], pad).reshape(K, -1)
    b = np.pad(kw["bias"], pad[1:]).reshape(-1)
    return w, b


def _run_port(kw, hop, final, dtype, fn=port.lvc_block_ncl_fh):
    t = DTYPES[dtype][1]
    w, b = _pack(kw, lvc_head.rows_padded(C))
    return fn(torch.from_numpy(kw["x"]).to(t),
              torch.from_numpy(kw["skip"]).to(t),
              torch.from_numpy(kw["tap_c"]).to(t), torch.from_numpy(w).to(t),
              torch.from_numpy(b), torch.from_numpy(kw["wstack_t"]).to(t), hop,
              torch.from_numpy(kw["final_wb"]).to(t) if final else None)


def _run_jax(kw, hop, final, dtype):
    t = DTYPES[dtype][0]
    w, b = _pack(kw, 128)
    return lvc_block_ncl_fh(
        jnp.asarray(kw["x"], t), jnp.asarray(kw["skip"], t),
        jnp.asarray(kw["tap_c"], t), jnp.asarray(w, t),
        jnp.asarray(b)[None], jnp.asarray(kw["wstack_t"], t), hop,
        interpret=True,
        final_wb=jnp.asarray(kw["final_wb"], t) if final else None)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,frames,hop,final", [
    (1, 32, 8, False),
    (2, 16, 8, True),
    (1, 8, 64, True),
    (2, 4, 64, False),
    (1, 3, 256, True),
])
def test_fh_block_matches_jax(b, frames, hop, final, dtype):
    kw = _case(b, frames, hop, seed=frames + hop + b)
    out = _run_port(kw, hop, final, dtype)
    ref = _run_jax(kw, hop, final, dtype)
    pairs = list(zip(out, ref)) if final else [(out, ref)]
    for got, want in pairs:
        got, want = _f32(got), _f32(want)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, **TOL)
            continue
        err = np.abs(got - want)
        assert np.linalg.norm(err) <= 1e-2 * np.linalg.norm(want)
        assert err.max() <= 2.0 ** -5 * np.abs(want).max()
    if final:
        assert out[1].dtype == torch.float32 and out[1].shape == (
            b, 1, frames * hop)


@pytest.mark.parametrize("final", [False, True])
def test_plain_fh_is_head_then_block(final):
    """``lvc_block_ncl_fh_plain`` == ``taug_head_matmul_plain`` then
    ``lvc_block_ncl_plain``, bit for bit, in bf16 at hop 64."""
    b, frames, hop = 2, 6, 64
    kw = _case(b, frames, hop, seed=11)
    out = _run_port(kw, hop, final, "bfloat16",
                    fn=port.lvc_block_ncl_fh_plain)
    w, bias = _pack(kw, lvc_head.rows_padded(C))
    bf = torch.bfloat16
    kern = lvc_head.taug_head_matmul_plain(
        torch.from_numpy(kw["tap_c"]).to(bf).reshape(b * frames, K),
        torch.from_numpy(w).to(bf), torch.from_numpy(bias)).reshape(
            b, frames, LAYERS, 2 * C, -1)
    ref = port.lvc_block_ncl_plain(
        torch.from_numpy(kw["x"]).to(bf), torch.from_numpy(kw["skip"]).to(bf),
        kern, torch.from_numpy(kw["wstack_t"]).to(bf), hop,
        torch.from_numpy(kw["final_wb"]).to(bf) if final else None)
    for got, want in (zip(out, ref) if final else [(out, ref)]):
        assert torch.equal(got, want)


def test_fusable_matches_jax():
    from fastdiff_tpu.ops.lvc_block_ncl import fusable
    for hop in (1, 4, 8, 16, 64, 256):
        for frames in (1, 2, 3, 16, 32, 100, 864):
            assert port.fusable(hop, frames) == fusable(hop, frames)


def test_frame_taps_are_head_taps_per_frame():
    trunk = torch.randn(2, 8, 5, generator=torch.Generator().manual_seed(0))
    taps = lvc_head.frame_taps(trunk)
    assert taps.shape == (2, 5, 24) and taps.is_contiguous()
    assert torch.equal(taps.reshape(10, 24), lvc_head.head_taps(trunk))


def test_fh_wrapper_raises_off_cpu_and_cuda():
    kw = _case(1, 2, 8, seed=0)
    with pytest.raises(ValueError, match="unsupported device"):
        _run_port(kw, 8, False, "bfloat16",
                  fn=lambda *a: port.lvc_block_ncl_fh(
                      *(t.to("meta") if isinstance(t, torch.Tensor) else t
                        for t in a)))
