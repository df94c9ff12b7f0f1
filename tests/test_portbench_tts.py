"""The text-to-wav cell (``fs2-lj.tts-b1``) through the benchmark's whole
harness on the CPU (``portbench.harness.run_cell``, the look for a card
skipped), at small widths: FastSpeech 2 at hidden 32, 1 + 1 layers,
``max_frames`` 128, the vocoder at the vocoder cells' test widths, buckets
of 32 frames and sentences of a few phones; every other size is the
cell's own.

``correct`` is true on the program and false on the control (the
reference with FastSpeech 2 in bfloat16 and the vocoder in float8 in the
program's place) and on three faults of the program: one phone's duration
off by one, the decoder's key mask left out, the pitch embedding left out.
A program without the text-to-wav entry (the parent of the change that
brings it) fails as the cell's traffic driver is made. The readers of the cell's own
metrics are held to hand counts on a made-up trace.
"""

import json
import os
import shutil
import types

import numpy as np
import pytest
import torch

from portbench import harness, tts_readers, work, work_tts
from portbench.drivers import tts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "fs2-lj.tts-b1"
TINY = dict(hidden_size=32, enc_layers=1, dec_layers=1, ffn_hidden=64,
            max_frames=128, infer_frame_bucket=32, inner_channels=8,
            kpnet_hidden_channels=8, diffusion_step_embed_dim_in=16,
            diffusion_step_embed_dim_mid=32, diffusion_step_embed_dim_out=32)
TINY_MIX = dict(sentences_per_round=8, check_sample=3, warm_seconds=0.2)
TINY_LENGTHS = dict(mean_s=0.6, std_s=0.3, min_s=0.25, max_s=1.0)


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch intra-op thread: the suite runs several workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _edit(path, edit):
    with open(path) as f:
        data = json.load(f)
    edit(data)
    with open(path, "w") as f:
        json.dump(data, f)


@pytest.fixture
def root(tmp_path):
    """A copy of ``BENCHMARK.json`` and ``portbench/`` with the cell made
    small."""
    root = str(tmp_path / "checkout")
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    _edit(os.path.join(root, "portbench", "configs", "fs2-lj.json"),
          lambda cfg: cfg["hparams"].update(TINY))

    def mix(data):
        data.update(TINY_MIX)
        data["lengths"].update(TINY_LENGTHS)
    _edit(os.path.join(root, "portbench", "traffic", "tts-b1.json"), mix)
    return root


def run(root, seed=2 ** 31 + 17):
    result, _ = harness.run_cell(root, CELL, seed, 0.3, False, "cpu", 0.0)
    return result


def test_program_is_correct(root):
    result = run(root)
    assert result["correct"] is True, result["compared"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["compared"]["mel_rel_l2"]["value"] < 1e-5
    assert result["metrics"]["utt_latency_p95_ms"]["value"] > 0


def test_control_is_not_correct(root, monkeypatch):
    from portbench.control_tts import ControlTask
    monkeypatch.setattr(tts, "build_program", lambda hp, weights, device: (
        ControlTask(hp, weights, device), None))
    result = run(root)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["compared"].values())


def one_duration_off(monkeypatch):
    """The first phone of every sentence gets one frame more."""
    from fastdiff_tpu_torch.models import fastspeech2
    real = fastspeech2.dur_to_mel2ph

    def shifted(durations, t_mel):
        durations = durations.clone()
        durations[:, 0] += 1
        return real(durations, t_mel)
    monkeypatch.setattr(fastspeech2, "dur_to_mel2ph", shifted)


def decoder_unmasked(monkeypatch):
    """The decoder's attention sees every key, padded frames too."""
    real = tts.build_program

    def build(hp, weights, device):
        task, state = real(hp, weights, device)
        for layer in state.model.decoder:
            forward = layer.attn.forward
            layer.attn.forward = lambda x, mask, forward=forward: forward(
                x, torch.ones_like(mask))
        return task, state
    monkeypatch.setattr(tts, "build_program", build)


def no_pitch_embedding(monkeypatch):
    """The pitch is predicted, but its embedding is not added."""
    from fastdiff_tpu_torch.models.fastspeech2 import FastSpeech2
    real = FastSpeech2._pitch_branch

    def branch(self, *args):
        embed, extras = real(self, *args)
        return torch.zeros_like(embed), extras
    monkeypatch.setattr(FastSpeech2, "_pitch_branch", branch)


@pytest.mark.parametrize("fault", [one_duration_off, decoder_unmasked,
                                   no_pitch_embedding])
def test_fault_is_not_correct(root, fault, monkeypatch):
    fault(monkeypatch)
    result = run(root)
    assert result["correct"] is False, (fault.__name__, result["compared"])


def test_a_program_without_the_entry_fails_at_once(root, monkeypatch):
    from fastdiff_tpu_torch.training.tts_task import FastSpeech2Task
    monkeypatch.delattr(FastSpeech2Task, "synthesize")
    with pytest.raises(RuntimeError, match="text-to-wav entry"):
        run(root)


def test_sentences_follow_the_lengths():
    with open(os.path.join(REPO, "portbench", "traffic", "tts-b1.json")) as f:
        mix = json.load(f)
    phones = tts.sentence_phones(mix)
    assert len(phones) == mix["sentences_per_round"] == 256
    # LJSpeech's 1.11-10.10 s at 12.5 phones a second
    assert min(phones) == 14 and max(phones) == 126
    assert phones == sorted(phones)


def test_decision_counts_take_the_band():
    program = np.array([3, 4, 1, 7, 2])
    reference = np.array([3, 3, 2, 5, 1])
    value = np.array([3.1, 3.49, 1.2, 5.0, 0.3])
    # 4 vs 3 at 3.49: in the band; 1 vs 2 at 1.2: out; 7 vs 5: out;
    # 2 vs 1 at 0.3 (clipped to 1): out
    assert tts.decision_counts(program, reference, value, 0.05) == (3, 1)


class _Trace:
    """A made-up traced window: host spans and device busy stretches."""

    def __init__(self, host, busy, window):
        self.host, self.window_ns, self.by_name = host, window, {"k": [1, 1]}
        self._busy = busy

    @property
    def window_s(self):
        return (self.window_ns[1] - self.window_ns[0]) * 1e-9

    def gaps(self):
        out, at = [], self.window_ns[0]
        for s, t in self._busy:
            if s > at:
                out.append((at, s))
            at = max(at, t)
        if self.window_ns[1] > at:
            out.append((at, self.window_ns[1]))
        return out


def _run(trace, calls=(), platform="gpu"):
    with open(os.path.join(REPO, "portbench", "configs", "fs2-lj.json")) as f:
        config = {"hparams": json.load(f)["hparams"]}
    return types.SimpleNamespace(trace=trace, platform=platform, calls=calls,
                                 config=config, window_s=1.0)


def test_tts_readers_on_a_made_up_trace():
    us = 1000
    host = [(0, 900 * us, "tts.call"), (0, 500 * us, "tts.acoustic"),
            (300 * us, 500 * us, "tts.length"),
            (500 * us, 900 * us, "tts.vocode"),
            (510 * us, 890 * us, "vocoder.vocode"),
            (600 * us, 700 * us, "sampler.replay"),
            (950 * us, 990 * us, "portbench.record")]
    # idle: 0-100 (tts.acoustic), 500-540 (vocoder.vocode: 520 is inside
    # it), 600-610 (under 20 us: no span), 650-700 (sampler.replay),
    # 900-1000 (at 950 only portbench.record)
    busy = [(100 * us, 500 * us), (540 * us, 600 * us),
            (610 * us, 650 * us), (700 * us, 900 * us)]
    trace = _Trace(host, busy, (0, 1000 * us))
    assert tts_readers.idle_by_span(trace) == pytest.approx(
        {"tts.acoustic": 100e-6, "vocoder.vocode": 40e-6,
         "sampler.replay": 50e-6})
    run = _run(trace)
    assert tts_readers.host_idle_share(run) == pytest.approx(10.0)
    assert tts_readers.acoustic_share(run) == pytest.approx(50.0)
    # no tts span (a program without the entry's spans) reads nothing
    bare = _run(_Trace([h for h in host if not h[2].startswith("tts.")],
                       busy, (0, 1000 * us)))
    assert tts_readers.host_idle_share(bare) is None
    assert tts_readers.acoustic_share(bare) is None
    assert tts_readers.host_idle_share(_run(trace, platform="cpu")) is None


def test_mfu_counts_both_models():
    calls = [types.SimpleNamespace(tokens=60, padded=512),
             types.SimpleNamespace(tokens=100, padded=896)]
    run = _run(None, calls)
    hp = run.config["hparams"]
    flops = sum(work_tts.fastspeech2_flops(hp, c.tokens)
                + work.model_flops("fastdiff", hp, 1, c.padded)
                for c in calls)
    assert tts_readers.mfu(run) == pytest.approx(
        100.0 * flops / work.H100_BF16_PEAK)
    assert tts_readers.mfu(_run(None, calls, platform="cpu")) is None
    # the decoder at 1,548 frames: 4 blocks of ~17.9 GFLOP
    assert 4 * work_tts.fft_block_flops(256, 1024, 9, 1548) == \
        pytest.approx(71.5e9, rel=0.001)
