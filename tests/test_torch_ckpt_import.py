"""The import of released checkpoints (``fastdiff_tpu_torch/utils/
ckpt_import.py``) against the JAX package's ``convert_torch_state_dict``.

No released checkpoint is in the repository, so the test builds a
synthetic ``state_dict`` in the reference's key layout (weight-norm
``weight_g`` / ``weight_v`` pairs, ``final_conv.0``, ``downsample.n.conv.i``,
the KernelPredictor's Sequential indices) from a seed. The port's import
equals ``params_from_jax`` of JAX's conversion exactly (``torch.equal``),
fused and unfused, and the trainable import equals
``trainable_params_from_jax`` of it. ``FastDiffVocoder`` loads it through
``vocoder_ckpt`` in each of the three envelopes, and its denoiser matches
JAX's ``fastdiff_apply`` on the imported weights (f32, 3e-4, the port's
per-call tolerance); ``load_ckpt`` loads it into the task's trainable model.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdiff_tpu.config import ModelConfig as JaxModelConfig
from fastdiff_tpu.models.fastdiff import fastdiff_apply, fuse_weight_norm
from fastdiff_tpu.utils import ckpt_import as jax_import
from fastdiff_tpu_torch.config import ModelConfig
from fastdiff_tpu_torch.models.bridge import (params_from_jax,
                                              trainable_params_from_jax)
from fastdiff_tpu_torch.models.fastdiff import FastDiff
from fastdiff_tpu_torch.training.task import FastDiffTask
from fastdiff_tpu_torch.utils import ckpt_import
from fastdiff_tpu_torch.vocoders.fastdiff_vocoder import FastDiffVocoder

ARCH = dict(inner_channels=8, cond_channels=16, upsample_ratios=(4, 2, 2),
            lvc_layers_each_block=2, kpnet_hidden_channels=8,
            diffusion_step_embed_dim_in=16, diffusion_step_embed_dim_mid=32,
            diffusion_step_embed_dim_out=32, compute_dtype="float32")
CFG = ModelConfig(**ARCH)
JAX_CFG = JaxModelConfig(**ARCH)


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


def _released_name(name: str) -> str:
    """A trainable port state_dict key -> the reference's key."""
    name = name.replace("final_conv.", "final_conv.0.")
    name = name.replace(".input_conv.", ".input_conv.0.")
    for i, j in enumerate(ckpt_import._RESIDUAL_CONV_IDX):
        name = name.replace(f".residual_convs.{i}.", f".residual_conv.{j}.")
    if name.startswith("downsample.") and ".convs." in name:
        name = name.replace(".convs.", ".conv.")
    if name.endswith(".v"):
        return name[:-2] + ".weight_v"
    if name.endswith(".g"):
        return name[:-2] + ".weight_g"
    return name


def _synthetic_state_dict(seed=0) -> dict:
    """Every parameter of the reference model, shaped as the reference
    stores it, with values from ``seed``."""
    rng = np.random.default_rng(seed)
    shapes = FastDiff(CFG, seed=None, train_route="plain").state_dict()
    sd = {}
    for name, t in shapes.items():
        shape = tuple(t.shape)
        if name.endswith(".g"):
            shape = shape + (1, 1)             # weight_g is (C, 1, 1)
            value = rng.uniform(0.5, 1.5, shape)
        else:
            value = rng.normal(0.0, 0.3, shape)
        sd[_released_name(name)] = torch.tensor(value, dtype=torch.float32)
    return sd


@pytest.mark.parametrize("fuse", [False, True])
def test_import_equals_jax_conversion_carried_across(fuse):
    sd = _synthetic_state_dict()
    got = ckpt_import.inference_state_dict(sd, CFG, fuse=fuse)
    want = params_from_jax(jax_import.convert_torch_state_dict(
        sd, JAX_CFG, fuse=fuse), CFG)
    assert sorted(got) == sorted(want)
    for key in got:
        assert torch.equal(got[key], want[key]), key
    # it loads into the inference model, strictly
    FastDiff(CFG, seed=None).load_state_dict(got)


def test_trainable_import_equals_jax_conversion():
    sd = _synthetic_state_dict(1)
    got = ckpt_import.trainable_state_dict(sd, CFG)
    want = trainable_params_from_jax(
        jax_import.convert_torch_state_dict(sd, JAX_CFG), CFG)
    assert sorted(got) == sorted(want)
    for key in got:
        assert torch.equal(got[key], want[key]), key
    FastDiff(CFG, seed=None, train_route="plain").load_state_dict(got)


def _save(sd, path, envelope):
    if envelope == "nested":
        torch.save({"state_dict": {"model": sd}, "global_step": 500000},
                   path)
    elif envelope == "flat":
        torch.save({"state_dict": {f"model.{k}": v for k, v in sd.items()}},
                   path)
    else:
        torch.save(sd, path)


@pytest.mark.parametrize("envelope", ["nested", "flat", "bare"])
def test_vocoder_loads_a_released_checkpoint(tmp_path, envelope):
    sd = _synthetic_state_dict(2)
    path = str(tmp_path / "model_ckpt_steps_500000.ckpt")
    _save(sd, path, envelope)
    tree = ckpt_import.load_torch_checkpoint(path, CFG)
    for key, value in params_from_jax(tree, CFG).items():
        assert torch.equal(value, ckpt_import.inference_state_dict(
            sd, CFG)[key])

    hp = dict(ARCH, vocoder_ckpt=path, N=4, use_pallas_block=False)
    voc = FastDiffVocoder(hp, device="cpu")
    want = ckpt_import.inference_state_dict(sd, CFG)
    for key, value in voc.model.state_dict().items():
        if key in want:
            assert torch.equal(value, want[key]), key

    # the denoiser on the imported weights against JAX's on its conversion
    rng = np.random.default_rng(3)
    frames = 4
    audio = rng.standard_normal((1, frames * CFG.total_hop, 1)).astype(
        np.float32)
    mel = rng.standard_normal((1, frames, 16)).astype(np.float32)
    t = np.asarray([[100.0]], np.float32)
    params = fuse_weight_norm(jax_import.convert_torch_state_dict(sd,
                                                                  JAX_CFG))
    ref = np.asarray(fastdiff_apply(params, jnp.asarray(audio),
                                    jnp.asarray(mel), jnp.asarray(t),
                                    JAX_CFG))
    with torch.no_grad():
        got = voc.model(torch.from_numpy(audio), torch.from_numpy(mel),
                        torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, ref, rtol=3e-4, atol=3e-4)
    assert voc.spec2wav(mel[0]).shape == (frames * CFG.total_hop,)


def test_task_load_ckpt_takes_a_released_checkpoint(tmp_path):
    sd = _synthetic_state_dict(4)
    path = str(tmp_path / "released.ckpt")
    _save(sd, path, "nested")
    hp = dict(ARCH, load_ckpt=path, use_pallas_block=False)
    state = FastDiffTask(hp, device="cpu").build_state()
    want = ckpt_import.trainable_state_dict(sd, CFG)
    for key, value in state.model.state_dict().items():
        assert torch.equal(value, want[key]), key
    with pytest.raises(ValueError, match="not a released"):
        torch.save({"params": state.model.state_dict()}, path)
        ckpt_import.load_torch_checkpoint(path, CFG)
