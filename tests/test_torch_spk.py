"""The port's speaker encoder, its verification training and the TTS
binarizer's ``spk_embed`` against the JAX package on the CPU.

Weights: JAX's seed tree (``init_spk_encoder()``, ``PRNGKey(20260816)``)
through ``models/bridge.py:zoo_params_from_jax``. The forward to 1e-5,
``proto_loss`` to 1e-5 and its gradients to rel L2 1e-4 (per leaf, back
through ``zoo_params_to_jax``), three Adam steps on the same gradients
against ``optax.adam`` 1e-6, ``make_crops`` bit for bit, ``eer`` exactly,
training on JAX's toy corpus, and the binarizer's records (``spk_embed`` 1e-5 from a port checkpoint of JAX's seed tree
against JAX's own seed weights; every other field equal).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fastdiff_tpu.data.indexed_dataset import IndexedDataset as JaxIndexed
from fastdiff_tpu.data.tts_binarizer import TTSBinarizer as JaxTTSBinarizer
from fastdiff_tpu.models import spk_encoder as jspk
from fastdiff_tpu.training import spk_task as jtask
from fastdiff_tpu_torch.data.indexed_dataset import IndexedDataset
from fastdiff_tpu_torch.data.tts_binarizer import TTSBinarizer
from fastdiff_tpu_torch.models.bridge import (zoo_params_from_jax,
                                              zoo_params_to_jax)
from fastdiff_tpu_torch.models.spk_encoder import (SpeakerEncoder,
                                                   get_speaker_encoder)
from fastdiff_tpu_torch.training import checkpoint as ckpt
from fastdiff_tpu_torch.training import spk_task
from tests.test_spk_training import _toy_corpus
from tests.test_tts_binarizer import _make_tts_dataset


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


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _mels(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((int(rng.integers(30, 90)), 80)) - 4.0)
            .astype(np.float32) for _ in range(n)]


@pytest.fixture(scope="module")
def seed_tree():
    return jax.tree_util.tree_map(np.asarray, jspk.init_spk_encoder())


def _port(tree) -> SpeakerEncoder:
    model = SpeakerEncoder(seed=None, device="cpu")
    model.load_state_dict(zoo_params_from_jax(tree))
    return model


def test_forward_and_embed_match_jax(seed_tree):
    model = _port(seed_tree)
    mel = np.random.default_rng(1).standard_normal((3, 37, 80)).astype(
        np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(mel)).numpy()
    want = np.asarray(jspk.spk_encoder_apply(seed_tree, jnp.asarray(mel)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1, atol=1e-6)
    # fewer than 8 frames: both edge-pad to 8
    short = mel[0, :5]
    np.testing.assert_allclose(
        model.embed(short), jspk.SpeakerEncoder().embed(short), atol=1e-5)
    back = zoo_params_to_jax(model.state_dict())
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(seed_tree))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(seed_tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("holdout", [False, True])
def test_make_crops_bit_equal(holdout):
    mels = _mels()
    got = spk_task.make_crops(mels, 4, 3, 40, np.random.default_rng(5),
                              holdout=holdout)
    want = jtask.make_crops(mels, 4, 3, 40, np.random.default_rng(5),
                            holdout=holdout)
    assert got.dtype == want.dtype and got.shape == (4, 3, 40, 80)
    np.testing.assert_array_equal(got, want)


def test_proto_loss_gradients_and_adam_match_jax(seed_tree):
    """Three steps on the same crops: at each, the loss 1e-5 and each
    gradient leaf rel L2 1e-4 against ``jax.value_and_grad``; then
    ``torch.optim.Adam(lr=1e-3)`` and ``optax.adam(1e-3)`` apply the same
    (JAX's) gradients, so the weights stay within 1e-6 of each other."""
    model = _port(seed_tree)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    tx = optax.adam(1e-3)
    tree = jax.tree_util.tree_map(jnp.asarray, seed_tree)
    opt_state = tx.init(tree)

    @jax.jit
    def step(p, s, batch):
        loss, grads = jax.value_and_grad(jtask.proto_loss)(p, batch)
        updates, s = tx.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss, grads

    rng = np.random.default_rng(2)
    for _ in range(3):
        batch = spk_task.make_crops(_mels(), 4, 3, 40, rng)
        tree, opt_state, loss_j, grads_j = step(tree, opt_state,
                                                jnp.asarray(batch))
        loss = spk_task.proto_loss(model, torch.from_numpy(batch))
        opt.zero_grad()
        loss.backward()
        assert abs(float(loss.detach()) - float(loss_j)) <= \
            1e-5 * abs(float(loss_j))
        grads = zoo_params_to_jax({n: p.grad for n, p in
                                   model.named_parameters()})
        for got, want in zip(jax.tree_util.tree_leaves(grads),
                             jax.tree_util.tree_leaves(grads_j)):
            assert np.abs(np.asarray(want)).max() > 0
            assert _rel(got, want) <= 1e-4
        ref = zoo_params_from_jax(jax.tree_util.tree_map(np.asarray, grads_j))
        for name, p in model.named_parameters():
            p.grad = ref[name]
        opt.step()
    got = zoo_params_to_jax(model.state_dict())
    moved = 0.0
    for a, b, b0 in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(tree),
                        jax.tree_util.tree_leaves(seed_tree)):
        assert np.abs(a - np.asarray(b)).max() <= 1e-6
        moved = max(moved, float(np.abs(np.asarray(b) - b0).max()))
    assert moved > 1e-3          # three steps of lr 1e-3 moved the weights


def test_eer_exact_and_verification():
    rng = np.random.default_rng(3)
    same = rng.normal(0.6, 0.2, 50)
    diff = rng.normal(0.1, 0.3, 300)
    assert spk_task.eer(same, diff) == jtask.eer(same, diff)
    assert spk_task.eer(np.array([0.9, 0.8]), np.array([0.1, 0.2])) == 0.0


def test_training_lowers_the_loss_and_beats_the_seed_eer():
    """JAX's own training check on its toy corpus (a formant comb: noise
    alone makes the pseudo-voices information-free), on the port's seed
    weights: the loss falls, a run replays its history, and the trained
    EER beats the seed weights' by 0.02."""
    mels = _toy_corpus()
    model, history = spk_task.train_spk_encoder(
        mels, steps=60, n_spk=6, n_utt=3, crop=60, lr=2e-3, device="cpu")
    _, again = spk_task.train_spk_encoder(
        mels, steps=2, n_spk=6, n_utt=3, crop=60, lr=2e-3, device="cpu")
    assert again == history[:2]
    assert history[-1] < history[0], history[:3] + history[-3:]
    trained = spk_task.verification_eer(model, mels, n_spk=10, n_utt=4,
                                        crop=60)
    seed = spk_task.verification_eer(SpeakerEncoder(seed=0, device="cpu"),
                                     mels, n_spk=10, n_utt=4, crop=60)
    assert trained < seed - 0.02, (trained, seed)


def test_binarizer_spk_embed_matches_jax(tmp_path, seed_tree):
    """``with_spk_embed``: the port's records from a checkpoint of JAX's
    seed tree written through the bridge, JAX's from its own seed weights."""
    hp = _make_tts_dataset(tmp_path, n_items=5)
    hp["binarization_args"] = dict(hp["binarization_args"],
                                   with_spk_embed=True)
    path = ckpt.save_checkpoint(str(tmp_path / "spk"), 0, {
        "params": zoo_params_from_jax(seed_tree)})
    ours = dict(hp, binary_data_dir=str(tmp_path / "binary"),
                spk_embed_ckpt=path)
    ref = dict(hp, binary_data_dir=str(tmp_path / "binary_jax"))
    TTSBinarizer(ours, device="cpu").process()
    JaxTTSBinarizer(ref).process()
    assert get_speaker_encoder(path, "cpu") is get_speaker_encoder(path,
                                                                   "cpu")
    n = 0
    for prefix in ("valid", "test", "train"):
        got = IndexedDataset(os.path.join(ours["binary_data_dir"], prefix))
        want = JaxIndexed(os.path.join(ref["binary_data_dir"], prefix))
        assert len(got) == len(want)
        for i in range(len(want)):
            a, b = got[i], want[i]
            assert sorted(a) == sorted(b)
            assert a["spk_embed"].shape == (256,)
            assert a["spk_embed"].dtype == np.float32
            np.testing.assert_allclose(a["spk_embed"], b["spk_embed"],
                                       rtol=0, atol=1e-5)
            assert abs(np.linalg.norm(a["spk_embed"]) - 1) <= 1e-5
            for key in b:
                if key == "spk_embed":
                    continue
                if isinstance(b[key], np.ndarray):
                    np.testing.assert_array_equal(a[key], b[key])
                else:
                    assert a[key] == b[key], key
            n += 1
    assert n == 6                # the valid item is the test item too
