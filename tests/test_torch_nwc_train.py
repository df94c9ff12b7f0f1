"""The trainable NWC route (``use_pallas_block: true`` in training, JAX's
``nwc_vjp``) against the JAX package.

``NWC_TRAIN`` keeps the full ratios (8, 8, 4), so the hops are 8 / 64 / 256
and JAX's ``fusable`` admits the hop-64 and hop-256 blocks: JAX runs them
through ``lvc_block_fused_aug`` (its NWC block kernel in interpret mode,
the recompute backward) after ``aug_head_matmul``, and the hop-8 block on
its plain loop. The port runs K7 (``AugHead``) and K6
(``LVCBlockNWCRecompute``) on those two blocks (their plain versions on
CPU tensors) and the plain head and block on the hop-8 one. f32, 4 frames,
batch 2: loss to rel 1e-5, each gradient leaf to rel L2 1e-4, as for the
other routes (``tests/test_torch_training.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdiff_tpu.config import DiffusionConfig, ModelConfig
from fastdiff_tpu.diffusion import schedules
from fastdiff_tpu.diffusion.losses import theta_timestep_loss as jax_loss
from fastdiff_tpu.models.fastdiff import fastdiff_apply, init_fastdiff
from fastdiff_tpu.ops import lvc_block_pallas as jax_nwc
from fastdiff_tpu_torch.diffusion.losses import theta_timestep_loss
from fastdiff_tpu_torch.models.bridge import (params_to_jax,
                                              trainable_params_from_jax)
from fastdiff_tpu_torch.models.fastdiff import FastDiff
from fastdiff_tpu_torch.ops import lvc_block_pallas as nwc_ops
from fastdiff_tpu_torch.training.task import FastDiffTask

NWC_TRAIN = ModelConfig(inner_channels=8, cond_channels=16,
                        upsample_ratios=(8, 8, 4), kpnet_hidden_channels=8,
                        diffusion_step_embed_dim_in=16,
                        diffusion_step_embed_dim_mid=32,
                        diffusion_step_embed_dim_out=32,
                        compute_dtype="float32")
FRAMES = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch intra-op thread: the suite runs several workers on the
    machine's cores, and torch's CPU kernels oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_nwc_vjp():
    """JAX's loss and gradients on ``use_pallas_block=True``, with the
    hops that reached ``lvc_block_fused_aug`` while it traced."""
    params = init_fastdiff(jax.random.PRNGKey(0), NWC_TRAIN)
    rng = np.random.default_rng(0)
    b = 2
    audio = rng.normal(size=(b, FRAMES * NWC_TRAIN.total_hop, 1)).astype(
        np.float32)
    mel = rng.normal(size=(b, FRAMES, NWC_TRAIN.cond_channels)).astype(
        np.float32)
    alpha = schedules.compute_hyperparams_given_schedule(
        schedules.linear_beta_schedule(DiffusionConfig())).alpha
    key = jax.random.PRNGKey(3)
    k_t, k_z = jax.random.split(key)
    ts = np.asarray(jax.random.randint(k_t, (b, 1, 1), 0, alpha.shape[0]))
    z = np.asarray(jax.random.normal(k_z, audio.shape, jnp.float32))
    cfg = dataclasses.replace(NWC_TRAIN, use_pallas_block=True)
    fused_hops = []
    original = jax_nwc.lvc_block_fused_aug

    def spy(x, skip, kern_aug, wstack, hop, interpret=False):
        fused_hops.append(hop)
        return original(x, skip, kern_aug, wstack, hop, interpret)

    def loss(p):
        return jax_loss(lambda x, m, t: fastdiff_apply(p, x, m, t, cfg), key,
                        jnp.asarray(mel), jnp.asarray(audio),
                        jnp.asarray(alpha))
    jax_nwc.lvc_block_fused_aug = spy
    try:
        value, grads = jax.jit(jax.value_and_grad(loss))(params)
    finally:
        jax_nwc.lvc_block_fused_aug = original
    return dict(params=_np_tree(params), audio=audio, mel=mel,
                alpha=np.array(alpha), ts=np.array(ts), z=np.array(z),
                loss=float(value), grads=_np_tree(grads),
                fused_hops=fused_hops)


def test_nwc_vjp_loss_and_gradients_match_jax(jax_nwc_vjp, monkeypatch):
    r = jax_nwc_vjp
    # not vacuous: JAX fused the hop-64 and hop-256 blocks
    assert sorted(set(r["fused_hops"])) == [64, 256]
    calls = {"head": 0, "block": []}
    head_fwd = nwc_ops.AugHead.forward
    block_fwd = nwc_ops.LVCBlockNWCRecompute.forward

    def head_spy(ctx, *args):
        calls["head"] += 1
        return head_fwd(ctx, *args)

    def block_spy(ctx, x, skip, kern_aug, wstack, hop):
        calls["block"].append(hop)
        return block_fwd(ctx, x, skip, kern_aug, wstack, hop)
    monkeypatch.setattr(nwc_ops.AugHead, "forward", staticmethod(head_spy))
    monkeypatch.setattr(nwc_ops.LVCBlockNWCRecompute, "forward",
                        staticmethod(block_spy))
    model = FastDiff(NWC_TRAIN, seed=None, train_route="nwc_vjp")
    model.load_state_dict(trainable_params_from_jax(r["params"], NWC_TRAIN))
    loss = theta_timestep_loss(
        model, torch.from_numpy(r["mel"]), torch.from_numpy(r["audio"]),
        torch.from_numpy(r["alpha"]), ts=torch.from_numpy(r["ts"]),
        z=torch.from_numpy(r["z"]))
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    assert calls == {"head": 2, "block": [64, 256]}
    assert abs(float(loss.detach()) - r["loss"]) <= 1e-5 * abs(r["loss"])
    got = params_to_jax(dict(zip(names, grads)), NWC_TRAIN)
    paths = jax.tree_util.tree_flatten_with_path(r["grads"])[0]
    flat_got = jax.tree_util.tree_leaves(got)
    assert len(flat_got) == len(paths)
    for (path, ref), g in zip(paths, flat_got):
        assert _rel(g, ref) <= 1e-4, (jax.tree_util.keystr(path), _rel(g, ref))


def test_use_pallas_block_true_trains_on_the_cpu():
    """``use_pallas_block: true`` resolves to ``nwc_vjp`` and the task's
    train step runs it (the plain versions of K7 and K6 on the CPU)."""
    hp = {k: getattr(NWC_TRAIN, k) for k in (
        "inner_channels", "cond_channels", "kpnet_hidden_channels",
        "diffusion_step_embed_dim_in", "diffusion_step_embed_dim_mid",
        "diffusion_step_embed_dim_out", "compute_dtype")}
    hp.update(upsample_ratios=[8, 8, 4], use_pallas_block=True,
              max_samples=FRAMES * 256, max_sentences=2)
    task = FastDiffTask(hp, device="cpu")
    assert task.route == "nwc_vjp" and task.model_cfg.upsample_ratios == (
        8, 8, 4)
    state = task.build_state(seed=0)
    before = {k: p.detach().clone()
              for k, p in state.model.named_parameters()}
    rng = np.random.default_rng(1)
    batch = {"wavs": rng.normal(size=(2, FRAMES * 256, 1)).astype(np.float32),
             "mels": rng.normal(size=(2, FRAMES, 16)).astype(np.float32)}
    out = task.train_step(state, batch, torch.Generator().manual_seed(0))
    assert torch.isfinite(out["loss"]) and not float(out["nonfinite"])
    assert state.step == 1
    changed = [k for k, p in state.model.named_parameters()
               if not torch.equal(p, before[k])]
    assert any(k.startswith("lvc_blocks.2.kernel_predictor.kernel_conv")
               for k in changed)


def test_aug_head_backward_casts_match_jax():
    """AugHead's bf16 backward against JAX's ``_aug_head_bwd`` on the same
    bf16 operands: dtap and dw round to bf16 from float32 sums (within one
    bf16 ulp of JAX's: the sums run in another order), db is float32
    (rel 1e-6)."""
    rng = np.random.default_rng(5)
    m, k, n = 24, 48, 400
    tap = rng.normal(size=(m, k)).astype(np.float32)
    w = (0.05 * rng.normal(size=(k, n))).astype(np.float32)
    b = (0.1 * rng.normal(size=n)).astype(np.float32)
    g = rng.normal(size=(m, n)).astype(np.float32)
    bf = jnp.bfloat16
    ref = jax_nwc._aug_head_bwd(
        False, (jnp.asarray(tap, bf), jnp.asarray(w, bf), jnp.asarray(b)),
        jnp.asarray(g, bf))
    tt = torch.from_numpy(tap).bfloat16().requires_grad_()
    tw = torch.from_numpy(w).bfloat16().requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    out = nwc_ops.AugHead.apply(tt, tw, tb)
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    got = torch.autograd.grad(out, (tt, tw, tb),
                              torch.from_numpy(g).bfloat16())
    for name, gt, rt in zip(("dtap", "dw", "db"), got, ref):
        assert str(gt.dtype).split(".")[-1] == str(rt.dtype), name
        r = np.asarray(rt.astype(jnp.float32), np.float64)
        v = gt.float().numpy().astype(np.float64)
        if name == "db":
            assert _rel(v, r) <= 1e-6
        else:
            # one bf16 ulp of each value: 2^-8 relative
            assert np.all(np.abs(v - r) <= 2.0 ** -8 * np.abs(r) + 1e-30), name
