"""The NWC route's block, head and plain ops against the JAX package.

K6's plain version (``lvc_block_nwc``, run on CPU tensors) against the JAX
NWC block kernel ``_fused_call`` in Pallas interpret mode, f32, at rtol =
atol = 3e-4 (the JAX package's own kernel-vs-XLA tolerance for the NCL
block); K7's plain version against ``aug_head_matmul`` in interpret mode,
bf16, within one bf16 ulp of the largest output; the packers bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdiff_tpu.ops import nn as jnn
from fastdiff_tpu.ops.lvc import lvc_gated_residual as jax_lvc_gated_residual
from fastdiff_tpu.ops.lvc_block_pallas import (_fused_call, aug_head_matmul,
                                               augment_lvc_kernels,
                                               stack_conv_weights)
from fastdiff_tpu_torch.ops import lvc_block_pallas as port
from fastdiff_tpu_torch.ops import nn as pnn
from fastdiff_tpu_torch.ops.lvc import lvc_gated_residual_nwc

LAYERS = 4
TOL = dict(rtol=3e-4, atol=3e-4)


def _block_case(b, frames, hop, c, seed):
    rng = np.random.default_rng(seed)
    length = frames * hop
    f32 = np.float32
    rows = 3 * c + 1
    return dict(
        x=rng.normal(size=(b, length, c)).astype(f32),
        skip=rng.normal(size=(b, length, c)).astype(f32),
        kern_aug=(rng.normal(size=(b, frames, LAYERS, rows, 2 * c)) * 0.1
                  ).astype(f32),
        wstack=(rng.normal(size=(LAYERS, rows, c)) * 0.1).astype(f32),
    )


@pytest.mark.parametrize("b,frames,hop,c", [
    (1, 16, 64, 8),      # multi-tile at hop 64, both sequence edges
    (2, 4, 256, 8),      # hop 256, two batch rows
    (1, 4, 64, 32),      # the kernel's width
])
def test_block_matches_jax_kernel(b, frames, hop, c):
    kw = _block_case(b, frames, hop, c, seed=frames + hop + c)
    ref = _fused_call(*(jnp.asarray(kw[k]) for k in
                        ("x", "skip", "kern_aug", "wstack")), hop,
                      interpret=True)
    out = port.lvc_block_nwc(*(torch.from_numpy(kw[k]) for k in
                               ("x", "skip", "kern_aug", "wstack")), hop)
    assert out.shape == (b, frames * hop, c) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_nwc_block_equals_ncl_block_transposed():
    """K6's plain version is K1's plain version in the other layout."""
    from fastdiff_tpu_torch.ops import lvc_block_ncl
    c, hop, frames = 8, 8, 6
    kw = {k: torch.from_numpy(v) for k, v in
          _block_case(2, frames, hop, c, seed=5).items()}
    rows = 3 * c + 1
    kern_taug = kw["kern_aug"].transpose(3, 4).contiguous()   # (.., 2C, R)
    wstack_t = kw["wstack"].transpose(1, 2).contiguous()      # (l, C, R)
    ncl = lvc_block_ncl.lvc_block_ncl_plain(
        kw["x"].transpose(1, 2), kw["skip"].transpose(1, 2), kern_taug,
        wstack_t, hop)
    nwc = port.lvc_block_nwc(kw["x"], kw["skip"], kw["kern_aug"],
                             kw["wstack"], hop)
    assert kern_taug.shape[-1] == rows
    np.testing.assert_allclose(nwc.numpy(), ncl.transpose(1, 2).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_aug_head_matches_jax_kernel():
    """N = 1,536 has a 128-multiple tile, so JAX runs its Pallas body."""
    rng = np.random.default_rng(0)
    m, k, n = 64, 24, 1536
    tap = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * 0.2).astype(np.float32)
    bias = (rng.normal(size=(n,)) * 0.1).astype(np.float32)
    ref = aug_head_matmul(jnp.asarray(tap, jnp.bfloat16),
                          jnp.asarray(w, jnp.bfloat16), jnp.asarray(bias),
                          interpret=True)
    out = port.aug_head_matmul(torch.from_numpy(tap).bfloat16(),
                               torch.from_numpy(w).bfloat16(),
                               torch.from_numpy(bias))
    ref = np.asarray(ref.astype(jnp.float32))
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    ulp = 2.0 ** -7 * np.abs(ref).max()
    assert np.abs(out.float().numpy() - ref).max() <= ulp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stack_conv_weights_matches_jax(dtype):
    rng = np.random.default_rng(1)
    c = 8
    ws = [rng.normal(size=(3, c, c)).astype(np.float32)
          for _ in range(LAYERS)]
    bs = [rng.normal(size=(c,)).astype(np.float32) for _ in range(LAYERS)]
    ref = stack_conv_weights([jnp.asarray(w) for w in ws],
                             [jnp.asarray(b) for b in bs],
                             dtype=getattr(jnp, dtype))
    out = port.stack_conv_weights(
        [torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0)))
         for w in ws], [torch.from_numpy(b) for b in bs],
        dtype=getattr(torch, dtype))
    assert out.shape == (LAYERS, 3 * c + 1, c)
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_augment_and_split_match_jax():
    rng = np.random.default_rng(2)
    kernels = rng.normal(size=(2, 3, LAYERS, 3, 8, 16)).astype(np.float32)
    biases = rng.normal(size=(2, 3, LAYERS, 16)).astype(np.float32)
    ref = augment_lvc_kernels(jnp.asarray(kernels), jnp.asarray(biases))
    out = port.augment_lvc_kernels(torch.from_numpy(kernels),
                                   torch.from_numpy(biases))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    k2, b2 = port.split_aug_kernels(out)
    np.testing.assert_array_equal(k2.numpy(), kernels)
    np.testing.assert_array_equal(b2.numpy(), biases)


def test_pack_aug_head_matches_jax_merge():
    """The merged head of ``_kernel_predictor_apply_aug`` (its weight and
    bias merge, written out from JAX's (K, I, O) leaves) bit for bit."""
    rng = np.random.default_rng(3)
    c, hid, ksz, k = 8, 6, 3, 3
    cout, rows = 2 * c, k * c + 1
    kw = rng.normal(size=(ksz, hid, LAYERS * k * c * cout)).astype(np.float32)
    kb = rng.normal(size=(LAYERS * k * c * cout,)).astype(np.float32)
    bw = rng.normal(size=(ksz, hid, LAYERS * cout)).astype(np.float32)
    bb = rng.normal(size=(LAYERS * cout,)).astype(np.float32)
    ref_w = np.concatenate(
        [kw.reshape(ksz, hid, LAYERS, k * c, cout),
         bw.reshape(ksz, hid, LAYERS, 1, cout)], axis=3
    ).reshape(ksz * hid, LAYERS * rows * cout)
    ref_b = np.concatenate([kb.reshape(LAYERS, k * c, cout),
                            bb.reshape(LAYERS, 1, cout)], axis=1).reshape(-1)
    to_t = lambda a: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
        a.transpose(2, 1, 0)))
    w, b = port.pack_aug_head(to_t(kw), torch.from_numpy(kb), to_t(bw),
                              torch.from_numpy(bb), layers=LAYERS, c=c,
                              dtype=torch.float32)
    np.testing.assert_array_equal(w.numpy(), ref_w)
    np.testing.assert_array_equal(b.numpy(), ref_b)
    assert b.dtype == torch.float32


def test_nwc_plain_ops_match_jax():
    """conv1d_dot, conv_transpose1d_dot, nearest_downsample and the NWC
    LVC gated residual, f32."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 24, 8)).astype(np.float32)
    w = (rng.normal(size=(3, 8, 6)) * 0.3).astype(np.float32)   # (K, I, O)
    b = rng.normal(size=(6,)).astype(np.float32)
    ref = jnn.conv1d_dot({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                         jnp.asarray(x), dilation=2)
    out = pnn.conv1d_nwc(torch.from_numpy(np.ascontiguousarray(
        w.transpose(2, 1, 0))), torch.from_numpy(b), torch.from_numpy(x),
        dilation=2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)

    r = 4
    wt = (rng.normal(size=(2 * r, 8, 8)) * 0.3).astype(np.float32)
    ref = jnn.conv_transpose1d_dot(
        {"w": jnp.asarray(wt), "b": jnp.asarray(b[:1].repeat(8))},
        jnp.asarray(x), stride=r, torch_padding=r // 2 + r % 2,
        output_padding=r % 2)
    out = pnn.conv_transpose1d_nwc(
        torch.from_numpy(np.ascontiguousarray(wt[::-1].transpose(1, 2, 0))),
        torch.from_numpy(b[:1].repeat(8)), torch.from_numpy(x), stride=r,
        torch_padding=r // 2 + r % 2, output_padding=r % 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(
        pnn.nearest_downsample_nwc(torch.from_numpy(x), 4).numpy(),
        np.asarray(jnn.nearest_downsample(jnp.asarray(x), 4)))

    hop, frames = 4, 6
    y = rng.normal(size=(2, hop * frames, 8)).astype(np.float32)
    kern = (rng.normal(size=(2, frames, 3, 8, 16)) * 0.2).astype(np.float32)
    bias = rng.normal(size=(2, frames, 16)).astype(np.float32)
    xin = y[:, :, ::-1].copy()
    ref = jax_lvc_gated_residual(jnp.asarray(xin), jnp.asarray(y),
                                 jnp.asarray(kern), jnp.asarray(bias), hop)
    out = lvc_gated_residual_nwc(torch.from_numpy(xin), torch.from_numpy(y),
                                 torch.from_numpy(kern),
                                 torch.from_numpy(bias), hop)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_fusable_gate_matches_jax():
    from fastdiff_tpu.ops.lvc_block_pallas import fusable
    for hop, frames in [(8, 100), (64, 100), (256, 1), (256, 2), (32, 4)]:
        assert port.fusable(hop, frames) == fusable(hop, frames)
