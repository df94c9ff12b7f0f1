"""``correct`` against its control and the faults a vocoder cell can have,
through the whole harness on the CPU at small widths (the look for a card
skipped, ``run_cell`` on the CPU's plain path)."""

import types

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import common, diffusion

CELLS = ("fastdiff-lj.offline-b16", "diffwave-base-lj.offline-b16")


class ControlVocoder:
    """The plain reference in the program's place, every product in
    per-tensor scaled float8 e4m3: the batch vocoder's contract (zero-padded
    buckets, the call's generator drawn in DDPM's order, trimmed waves)."""

    def __init__(self, ref, hp, weights, traffic):
        self.ref, self.hp, self.weights = ref, hp, weights
        self.bucket = int(traffic["frame_bucket"])
        self.hop = int(hp["hop_size"])
        self.sampler = types.SimpleNamespace(warmups=0, captures=0)

    def vocode(self, mels, generator):
        frames = [m.shape[0] for m in mels]
        padded = -(-max(frames) // self.bucket) * self.bucket
        shape = (len(mels), padded * self.hop, 1)
        x_t = torch.empty(shape).normal_(generator=generator)
        zs = [torch.empty(shape).normal_(generator=generator)[..., 0]
              for _ in range(int(self.hp["N"]) - 1)]
        stack = torch.zeros(len(mels), padded, mels[0].shape[1])
        for row, mel in enumerate(mels):
            stack[row, : mel.shape[0]] = torch.from_numpy(mel)
        with torch.no_grad(), common.exact_float32():
            wav = diffusion.reverse(self.ref.forward, self.weights, self.hp,
                                    stack, x_t[..., 0], zs, common.fp8_round)
        return [wav[row, : f * self.hop].numpy()
                for row, f in enumerate(frames)]


def run(root, cell, seed=2 ** 31 + 17):
    result, _ = harness.run_cell(root, cell, seed, 0.3, False, "cpu", 0.0)
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(tiny_root, cell):
    result = run(tiny_root, cell)
    assert result["correct"] is True, result["compared"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_root, cell, monkeypatch):
    from portbench.drivers import vocode

    def build(hp, weights, traffic, device):
        # the configurations' denoiser names their reference's family
        ref = vocode.importlib.import_module(
            f"portbench.reference.{hp['denoiser']}")
        return ControlVocoder(ref, hp, weights, traffic)
    monkeypatch.setattr(vocode, "build_program", build)
    result = run(tiny_root, cell)
    check = result["compared"]["wav_rel_l2"]
    assert result["correct"] is False
    assert check["value"] > check["limit"]


def step_unchanged(monkeypatch):
    """Every reverse step returns its state unchanged."""
    from fastdiff_tpu_torch.diffusion import sampler
    monkeypatch.setattr(sampler, "reverse_step",
                        lambda x, eps, coef, ddim, z: x)


def half_batch(monkeypatch):
    """The denoiser runs half the rows and gives the rest their mean."""
    from fastdiff_tpu_torch.models.fastdiff import FastDiff
    from fastdiff_tpu_torch.models.wavenet import WaveNet
    for cls in (FastDiff, WaveNet):
        forward = cls.forward

        def half(self, audio, mel, t, forward=forward):
            h = max(1, audio.shape[0] // 2)
            eps = forward(self, audio[:h], mel[:h], t[:h])
            rest = eps.mean(0, keepdim=True).expand(
                (audio.shape[0] - h,) + tuple(eps.shape[1:]))
            return torch.cat([eps, rest])
        monkeypatch.setattr(cls, "forward", half)


def answer_altered(monkeypatch):
    """The waveforms come back one sample late where they are made."""
    from fastdiff_tpu_torch.serving import batch_vocoder
    wav_numpy = batch_vocoder.wav_numpy
    monkeypatch.setattr(batch_vocoder, "wav_numpy",
                        lambda wav: np.roll(wav_numpy(wav), 1, axis=-1))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [step_unchanged, half_batch,
                                   answer_altered])
def test_fault_is_not_correct(tiny_root, cell, fault, monkeypatch):
    fault(monkeypatch)
    result = run(tiny_root, cell)
    assert result["correct"] is False, (fault.__name__, result["compared"])
