"""FastSpeech 2 training in the port against the JAX package on the CPU.

- the mel losses (l1, mse, ssim, gdl) within 1e-6 on masked batches;
- ``FastSpeech2Task.loss`` (the teacher-mode forward and
  ``fastspeech2_loss``) and every term within 1e-5 of JAX's task
  ``_loss``, and the gradients of the total within relative L2 1e-4 per
  tensor, for ``pitch_type`` frame, cwt and coarse, and for energy with the
  word and sentence duration terms, ``l1 + ssim + gdl`` mel loss and MSE
  pitch loss. JAX's gradient tree is mapped to the port's names by
  ``fs2_params_from_jax``, as the weights are;
- three ``train_step``s under the rsqrt schedule and the global-norm clip
  against JAX's ``FastSpeech2Task.train_step``: each step's losses within
  1e-5 and the parameters within relative L2 1e-5 per tensor;
- the recipe's schedule (``fs2_ljspeech.yaml``: lr 2e-4, rsqrt, warm-up
  8000, hidden 256) equal to JAX's, peaking at ~1.4e-7.

Widths: hidden 32, 1 + 1 layers, FFN 64, kernel 3. The weights are
``tests/test_torch_fastspeech2.py:_random_tree``'s numpy draws; the batch
is ``collate_tts`` of seeded numpy records. JAX's ``value_and_grad`` is
jitted once per case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdiff_tpu.config import TrainConfig as JaxTrainConfig
from fastdiff_tpu.ops import mel_losses as jml
from fastdiff_tpu.parallel import mesh as meshlib
from fastdiff_tpu.training.optim import make_lr_schedule
from fastdiff_tpu.training.tts_task import FastSpeech2Task as JaxTask
from fastdiff_tpu_torch.config import TrainConfig
from fastdiff_tpu_torch.models.bridge import fs2_params_from_jax
from fastdiff_tpu_torch.models.fastspeech2 import mel_energy
from fastdiff_tpu_torch.ops import mel_losses as ml
from fastdiff_tpu_torch.training.optim import global_norm, learning_rate
from fastdiff_tpu_torch.training.tts_task import FastSpeech2Task, collate_tts
from tests.test_torch_fastspeech2 import _random_tree

BASE = {"vocab_size": 24, "hidden_size": 32, "enc_layers": 1,
        "dec_layers": 1, "num_heads": 2, "ffn_hidden": 64,
        "enc_ffn_kernel_size": 3, "max_frames": 96, "audio_num_mel_bins": 80,
        "use_pitch_embed": True, "seed": 0, "lr": 2e-4, "weight_decay": 0,
        "scheduler": "none", "clip_grad_norm": 1}
CASES = {
    "frame": {},
    "cwt": {"pitch_type": "cwt"},
    "coarse": {"pitch_type": "coarse", "use_uv": False},
    "energy_words": {"use_energy_embed": True, "lambda_word_dur": 1.0,
                     "lambda_sent_dur": 0.5, "lambda_energy": 0.3,
                     "mel_loss": "l1:0.5|ssim:0.5|gdl:0.1",
                     "pitch_loss": "mse"},
}
# (phones, frames) per utterance; the second leaves padding in both axes
SHAPES = ((11, 61), (7, 37))


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


def _items(seed: int = 0) -> list:
    """Seeded records as the TTS binarizer writes them: phone ids, a log10
    mel, f0 with unvoiced frames, coarse pitch, an aligned mel2ph and a
    ``ph`` string with word boundaries and punctuation."""
    rng = np.random.default_rng(seed)
    out = []
    for t_ph, t_mel in SHAPES:
        dur = rng.integers(1, 2 * t_mel // t_ph, t_ph)
        dur = np.maximum(1, np.round(dur * t_mel / dur.sum())).astype(int)
        dur[-1] += t_mel - dur.sum()
        assert dur[-1] > 0
        f0 = rng.uniform(90, 260, t_mel).astype(np.float32)
        f0[rng.uniform(size=t_mel) < 0.25] = 0.0
        ph = rng.choice(["AH", "K", "S", "|", "IY", ",", "T"], t_ph)
        ph[0], ph[-1] = "<BOS>", "<EOS>"
        out.append({"phone": rng.integers(3, BASE["vocab_size"], t_ph),
                    "mel": rng.uniform(-5, 1, (t_mel, 80)).astype(np.float32),
                    "f0": f0, "pitch": rng.integers(1, 255, t_mel),
                    "mel2ph": np.repeat(np.arange(1, t_ph + 1), dur),
                    "ph": " ".join(ph)})
    return out


def _tasks(extra: dict):
    hp = dict(BASE, **extra)
    return FastSpeech2Task(hp, device="cpu"), JaxTask(hp)


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(np.linalg.norm(np.asarray(b)), 1e-30))


# -- mel losses --------------------------------------------------------------

# 1 - SSIM lies in [0, 2]: held at 1e-6 of that range, since float32 JAX
# itself lands ~1e-6 relative from the float64 value at these shapes
@pytest.mark.parametrize("name,rtol,atol", [
    ("l1", 1e-6, 0), ("mse", 1e-6, 0), ("ssim", 0, 1e-6), ("gdl", 1e-6, 0)])
def test_mel_losses_match_jax(name, rtol, atol):
    rng = np.random.default_rng(4)
    target = rng.uniform(-6, 2, (3, 45, 80)).astype(np.float32)
    target[1, 30:] = 0.0                          # padding frames
    target[2, :, 70:] = 0.0
    pred = (target + 0.3 * rng.standard_normal(target.shape)).astype(
        np.float32)
    ours = float(ml.MEL_LOSS_FNS[name](torch.from_numpy(pred),
                                       torch.from_numpy(target)))
    ref = float(jml.MEL_LOSS_FNS[name](jnp.asarray(pred), jnp.asarray(target)))
    assert ref > 0
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=atol)
    # identical inputs: no loss
    same = torch.from_numpy(target)
    assert float(ml.MEL_LOSS_FNS[name](same, same)) < 1e-5


def test_parse_mel_losses_and_energy():
    for spec in ("l1", "l1:0.5|ssim:0.5", " mse:2 | gdl:0.1 |", ""):
        assert ml.parse_mel_losses(spec) == jml.parse_mel_losses(spec)
    from fastdiff_tpu.models.fastspeech2 import mel_energy as jax_energy
    mel = np.random.default_rng(5).uniform(-6, 1.5, (2, 9, 80)).astype(
        np.float32)
    for base in ("10", "e"):
        np.testing.assert_allclose(
            mel_energy(torch.from_numpy(mel), base).numpy(),
            np.asarray(jax_energy(jnp.asarray(mel), base)), rtol=1e-6)


# -- the loss and its gradients ----------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_gradients_match_jax(name):
    task, jtask = _tasks(CASES[name])
    tree = _random_tree(jtask.model_cfg, seed=1)
    batch = collate_tts(_items(), 16, 64, 80,
                        pitch_type=task.model_cfg.pitch_type)
    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(
        jtask._loss, has_aux=True))(tree, batch)
    ref = {k: float(v) for k, v in jlosses.items()}
    jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
    model = task.build_state().model
    model.load_state_dict(fs2_params_from_jax(tree, task.model_cfg))
    losses = task.loss(model, task._to_device(batch))
    assert sorted(losses) == sorted(ref)
    expected = {"frame": {"uv", "f0"}, "cwt": {"cwt", "cwt_stats", "uv"},
                "coarse": {"pitch"},
                "energy_words": {"wdur", "sdur", "energy", "ssim", "gdl"}}
    assert expected[name] <= set(losses)
    for key, value in ref.items():
        assert value != 0, key
        np.testing.assert_allclose(losses[key].item(), value, rtol=1e-5,
                                   err_msg=key)

    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(losses["total"],
                                [p for _, p in model.named_parameters()])
    ref_grads = fs2_params_from_jax(jgrads, task.model_cfg)
    assert sorted(names) == sorted(ref_grads)
    errs = {n: _rel_l2(g, ref_grads[n]) for n, g in zip(names, grads)}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-4, (worst, errs[worst])
    assert float(global_norm(grads)) > 0


# -- optimizer steps ---------------------------------------------------------

def test_three_train_steps_match_jax():
    """rsqrt with a short warm-up and an lr that moves the weights (lr
    2e-2, 4 warm-up updates: 1.1e-3 -> 3.3e-3), the clip at 1 active."""
    task, jtask = _tasks({"scheduler": "rsqrt", "warmup_updates": 4,
                          "lr": 2e-2})
    tree = _random_tree(jtask.model_cfg, seed=2)
    batch = collate_tts(_items(1), 16, 64, 80)
    state = task.build_state()
    state.model.load_state_dict(fs2_params_from_jax(tree, task.model_cfg))
    params = {"params": jax.tree_util.tree_map(jnp.asarray, tree),
              "step": jnp.zeros((), jnp.int32)}
    params["opt_state"] = jtask.optimizer.init(params["params"])
    jstate = meshlib.replicate(params, jtask.mesh)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    grads = torch.autograd.grad(
        task.loss(state.model, task._to_device(batch))["total"],
        list(state.model.parameters()))
    assert float(global_norm(grads)) > task.train_cfg.clip_grad_norm
    lrs = [learning_rate(task.train_cfg, s, 4, 32) for s in range(3)]
    for _ in range(3):
        jstate, jlosses = jtask.train_step(jstate, batch)
        losses = task.train_step(state, batch)
        assert set(losses) == set(jlosses)
        for key, value in jlosses.items():
            np.testing.assert_allclose(losses[key], float(value), rtol=1e-5,
                                       err_msg=key)
    assert state.step == int(jstate["step"]) == 3
    ref = fs2_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jstate["params"]), task.model_cfg)
    d = task.model_cfg.hidden
    for name, value in state.model.state_dict().items():
        moved = _rel_l2(value, before[name])
        if name.endswith("qkv.bias"):
            # the key bias shifts every logit of a query alike, so its
            # gradient is zero but for rounding, which Adam's first steps
            # scale to up to lr a step in either package: it is held to
            # that, and the query and value biases to 1e-5
            key = slice(d, 2 * d)
            assert float((value[key] - ref[name][key]).abs().max()) <= \
                2 * sum(lrs)
            value, want = value.clone(), ref[name].clone()
            value[key] = want[key] = 0.0
            assert _rel_l2(value, want) <= 1e-5, name
            continue
        assert _rel_l2(value, ref[name]) <= 1e-5, (name, moved)
    assert _rel_l2(state.model.mel_out.weight.detach(),
                   before["mel_out.weight"]) > 1e-3


def test_recipe_schedule_matches_jax():
    """``fs2_ljspeech.yaml``'s rsqrt schedule at hidden 256: ~1.4e-7 at its
    peak and floored at 1e-7, as in JAX (the recipe trains at that rate)."""
    hp = {"lr": "2e-4", "scheduler": "rsqrt"}
    cfg = TrainConfig.from_hparams(hp)
    jschedule = make_lr_schedule(JaxTrainConfig.from_hparams(hp), 8000, 256)
    steps = (0, 1, 100, 4000, 7999, 8000, 8001, 20000, 160000)
    ours = [learning_rate(cfg, s, 8000, 256) for s in steps]
    np.testing.assert_allclose(ours, [float(jschedule(s)) for s in steps],
                               rtol=1e-6)
    assert max(ours) == pytest.approx(2e-4 / np.sqrt(8000) / 16, rel=1e-6)
    assert max(ours) < 1.5e-7 and min(ours) == pytest.approx(1e-7)
