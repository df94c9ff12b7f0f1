"""K8's plain version and packed weights against the JAX down-path kernel.

At ``ModelConfig()`` width and 16 frames (4,096 samples, two 2,048-sample
halo units, so both tiles are edge tiles): the port's ``downpath_fused``
(its plain version on CPU tensors) against JAX's ``_fused_call`` in Pallas
interpret mode and against ``_unfused_reference``, bf16, max abs <= 2e-2,
the bound JAX's own test holds its kernel to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdiff_tpu.config import ModelConfig
from fastdiff_tpu.models.fastdiff import fuse_weight_norm, init_fastdiff
from fastdiff_tpu.ops import downpath_pallas as jdown
from fastdiff_tpu_torch.models.bridge import params_from_jax
from fastdiff_tpu_torch.models.fastdiff import FastDiff
from fastdiff_tpu_torch.ops import downpath_pallas as port

CFG = ModelConfig()
FACTORS = tuple(reversed(CFG.upsample_ratios))


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


@pytest.fixture(scope="module")
def weights():
    """(JAX down-path subtree, fused; the port model holding it)."""
    fused = jax.tree_util.tree_map(
        np.asarray, fuse_weight_norm(init_fastdiff(jax.random.PRNGKey(0),
                                                   CFG)))
    model = FastDiff(CFG, seed=None)
    model.load_state_dict(params_from_jax(fused, CFG))
    sub = {"first_audio_conv": fused["first_audio_conv"],
           "downsample": fused["downsample"]}
    return sub, model


def _port_packs(model, dtype=torch.bfloat16):
    return port.pack_downpath_weights(model.first_audio_conv,
                                      model.downsample, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_matches_jax(weights, dtype):
    sub, model = weights
    ref = jdown.pack_downpath_weights(sub, dtype=getattr(jnp, dtype))
    out = _port_packs(model, getattr(torch, dtype))
    for name, r, o in zip(("first_aug", "res_aug", "conv_aug"), ref, out):
        assert tuple(o.shape) == r.shape, name
        np.testing.assert_array_equal(o.float().numpy(),
                                      np.asarray(r.astype(jnp.float32)),
                                      err_msg=name)


@pytest.mark.parametrize("b,edges", [(1, False), (2, False), (1, True)])
def test_plain_matches_jax_kernel_and_reference(weights, b, edges):
    sub, model = weights
    length = 16 * CFG.total_hop
    rng = np.random.default_rng(b)
    audio = rng.standard_normal((b, length, 1)).astype(np.float32)
    if edges:
        # energy only at both sequence edges: circular wrap would leak
        audio[:, 64:-64] = 0.0
    assert port.downpath_fusable(length, FACTORS)
    kernel = jdown._fused_call(jnp.asarray(audio),
                               *jdown.pack_downpath_weights(sub), FACTORS,
                               interpret=True)
    reference = jdown._unfused_reference(sub, jnp.asarray(audio), FACTORS)
    out = port.downpath_fused(torch.from_numpy(audio), *_port_packs(model),
                              FACTORS)
    assert len(out) == len(FACTORS) + 1
    for i, o in enumerate(out):
        assert o.dtype == torch.bfloat16
        for name, ref in (("kernel", kernel[i]), ("reference", reference[i])):
            ref = np.asarray(ref.astype(jnp.float32))
            assert tuple(o.shape) == ref.shape, (name, i)
            err = np.abs(o.float().numpy() - ref).max()
            assert err <= 2e-2, (name, i, err)


def test_halo_and_gate_match_jax():
    assert port.required_halo(FACTORS) == jdown.required_halo(FACTORS) == 2048
    for frames in (4, 8, 16, 100, 256, 864):
        length = frames * CFG.total_hop
        assert (port.downpath_fusable(length, FACTORS)
                == jdown.downpath_fusable(length, FACTORS))
    assert port.required_halo((4, 2, 2)) == jdown.required_halo((4, 2, 2))
