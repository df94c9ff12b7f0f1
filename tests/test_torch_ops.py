"""Port ops (fastdiff_tpu_torch/ops/nn.py, ops/lvc.py) against their JAX twins.

Same numpy inputs through both; f32 at rtol = atol = 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdiff_tpu.models.fastdiff import diffusion_step_embedding
from fastdiff_tpu.ops import lvc as jlvc
from fastdiff_tpu.ops import nn as jnn
from fastdiff_tpu_torch.ops import lvc as tlvc
from fastdiff_tpu_torch.ops import nn as tnn

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


@pytest.mark.parametrize("dilation", [1, 2, 4, 27])
def test_conv1d_ncl(dilation):
    rng = np.random.default_rng(dilation)
    x = rng.normal(size=(2, 8, 64)).astype(np.float32)
    w = rng.normal(size=(3, 8, 6)).astype(np.float32) * 0.3    # (K, I, O)
    b = rng.normal(size=(6,)).astype(np.float32)
    ref = jnn.conv1d_ncl({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                         jnp.asarray(x), dilation=dilation)
    out = tnn.conv1d_ncl(_t(w.transpose(2, 1, 0)), _t(b), _t(x),
                         dilation=dilation)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_conv1d_ncl_single_output_channel():
    """The model's final k=7 C->1 conv (a separate path in JAX)."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 8, 50)).astype(np.float32)
    w = rng.normal(size=(7, 8, 1)).astype(np.float32) * 0.3
    b = rng.normal(size=(1,)).astype(np.float32)
    ref = jnn.conv1d_ncl({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                         jnp.asarray(x))
    out = tnn.conv1d_ncl(_t(w.transpose(2, 1, 0)), _t(b), _t(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("stride", [2, 4, 8])
def test_conv_transpose1d_ncl(stride):
    rng = np.random.default_rng(stride)
    k = 2 * stride
    x = rng.normal(size=(2, 8, 12)).astype(np.float32)
    w = rng.normal(size=(k, 8, 8)).astype(np.float32) * 0.3    # flipped KIO
    b = rng.normal(size=(8,)).astype(np.float32)
    kw = dict(stride=stride, torch_padding=stride // 2 + stride % 2,
              output_padding=stride % 2)
    ref = jnn.conv_transpose1d_ncl({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                   jnp.asarray(x), **kw)
    out = tnn.conv_transpose1d_ncl(_t(w[::-1].transpose(1, 2, 0)), _t(b),
                                   _t(x), **kw)
    assert out.shape == (2, 8, 12 * stride)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_nearest_downsample_ncl(factor):
    x = np.random.default_rng(0).normal(size=(2, 4, 64)).astype(np.float32)
    ref = jnn.nearest_downsample_ncl(jnp.asarray(x), factor)
    out = tnn.nearest_downsample_ncl(_t(x), factor)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_dense_swish_leaky():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 16)).astype(np.float32)
    w = rng.normal(size=(16, 32)).astype(np.float32) * 0.2     # (I, O)
    b = rng.normal(size=(32,)).astype(np.float32)
    ref = jnn.swish(jnn.dense({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                              jnp.asarray(x)))
    out = tnn.swish(tnn.dense(_t(w.T), _t(b), _t(x)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(tnn.leaky_relu(_t(x), 0.1).numpy(),
                               np.asarray(jnn.leaky_relu(jnp.asarray(x), 0.1)),
                               **TOL)


def test_step_embedding():
    t = np.array([[0.0], [37.4], [498.25]], np.float32)
    ref = diffusion_step_embedding(jnp.asarray(t), 128)
    out = tnn.diffusion_step_embedding(_t(t), 128)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("hop", [4, 16])
def test_lvc_gated_residual(hop):
    rng = np.random.default_rng(hop)
    b, c, frames = 2, 8, 6
    length = frames * hop
    x = rng.normal(size=(b, length, c)).astype(np.float32)
    y = rng.normal(size=(b, length, c)).astype(np.float32)
    kern = rng.normal(size=(b, frames, 3, c, 2 * c)).astype(np.float32) * 0.2
    bias = rng.normal(size=(b, frames, 2 * c)).astype(np.float32) * 0.2
    ref = jlvc.lvc_gated_residual(jnp.asarray(x), jnp.asarray(y),
                                  jnp.asarray(kern), jnp.asarray(bias), hop)
    out = tlvc.lvc_gated_residual(_t(x.transpose(0, 2, 1)),
                                  _t(y.transpose(0, 2, 1)), _t(kern),
                                  _t(bias), hop)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(ref).transpose(0, 2, 1), **TOL)
