"""Vocoder traffic (``kind: vocode``): one caller in a closed loop on the
port's entry, ``serving/batch_vocoder.py:BatchedVocoder.vocode``, which
runs ``diffusion/sampler.py``'s graph sampler over the configuration's
denoiser.

Set-up makes the weights and the mels from the seed on the device, builds
the program through the port's own task (``training/task.py:
FastDiffTask.inference_model``), warms every call shape of the mix twice
(a shape's first call runs eagerly, its second captures), then runs the
mix untimed for ``warm_seconds``. The window sends the mix's calls in the
seed's order until ``seconds`` have passed;
each call's noise comes from a generator seeded for that call. A
reservoir drawn from the seed keeps ``check_sample`` of the finished
utterances, and the longest one, for the check.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import time

import numpy as np
import torch

from portbench import weights as weightlib
from portbench.reference import common, diffusion
from portbench.trace import span
from portbench.traffic import (MELS, NOISE, PRIME, SAMPLE, WARM, Mix,
                               seed_for)


@dataclasses.dataclass
class Call:
    start: float            # host clock at the call
    end: float              # host clock with every waveform in host memory
    frames: list            # mel frames of each utterance
    padded: int             # the bucket's frames


@dataclasses.dataclass
class Kept:
    """One finished utterance kept for the check."""
    noise_seed: int
    rows: int
    padded: int
    row: int
    mel: np.ndarray
    wav: np.ndarray


def build_program(hp: dict, weights: dict, traffic: dict, device):
    """The system under test: the port's denoiser for ``hp`` holding
    ``weights`` (loaded strictly), its sampler constants, and the batch
    vocoder on ``device``."""
    from fastdiff_tpu_torch.serving.batch_vocoder import BatchedVocoder
    from fastdiff_tpu_torch.training.task import FastDiffTask
    task = FastDiffTask(dict(hp), device=device)
    model = task.inference_model(weights)
    return BatchedVocoder(model, task.sampler_constants(),
                          hop_size=int(hp["hop_size"]),
                          frame_bucket=int(traffic["frame_bucket"]),
                          max_batch=traffic.get("max_batch"),
                          devices=[device])


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.hp = config["hparams"]
        self.hop = int(self.hp["hop_size"])
        self.sample_rate = int(self.hp["audio_sample_rate"])
        self.ref = importlib.import_module(
            f"portbench.reference.{config['family']}")
        self.mix = Mix(traffic, self.sample_rate, self.hop)
        self.calls = self.mix.calls
        self.vocoder = None
        self.build_s = 0.0
        self.kept, self.longest = [], None
        self.attempted = self.failed = 0
        self.counters = {}

    # -- set-up --------------------------------------------------------------
    def setup(self):
        # the port's kernel library, built on a checkout's first run, is
        # timed apart; the FastDiff family is the one that launches it
        if self.device.type == "cuda" and self.config["family"] == "fastdiff":
            from fastdiff_tpu_torch.ops import _build
            t0 = time.perf_counter()
            _build.library()
            self.build_s = time.perf_counter() - t0
        self.weights = weightlib.make(self.ref.param_shapes(self.hp),
                                      self.seed, self.device)
        self.vocoder = build_program(self.hp, self.weights, self.traffic,
                                     self.device)
        self.mels = self._mels()
        gen = torch.Generator(device=self.device)
        for i in self.mix.warm_calls():
            for rep in range(2):
                gen.manual_seed(seed_for(self.seed, WARM, i, rep))
                self.vocoder.vocode(self.mels[i], generator=gen)
        # the mix itself, untimed, until the loop runs as it will in the
        # window (the first seconds of a fresh process run slower)
        order = self.mix.order(seed_for(self.seed, PRIME), 0)
        start, k = time.perf_counter(), 0
        while time.perf_counter() - start < float(self.traffic["warm_seconds"]):
            gen.manual_seed(seed_for(self.seed, PRIME, k))
            self.vocoder.vocode(self.mels[order[k % len(order)]], generator=gen)
            k += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def reseed(self, seed: int):
        """New weights and mels from ``seed``, loaded into the program
        already set up (its parameters keep their storage, so its graphs
        replay the new weights); the window's records start again."""
        self.seed = int(seed)
        self.weights = weightlib.make(self.ref.param_shapes(self.hp),
                                      self.seed, self.device)
        self.vocoder.sampler.model.load_state_dict(self.weights)
        self.mels = self._mels()
        self.kept, self.longest = [], None
        self.attempted = self.failed = 0

    def _mels(self) -> list:
        """The round's mels, [call][utterance] (frames, n_mels) float32,
        drawn on the device in one call and copied to the host once."""
        spec = self.traffic["mel"]
        if spec["distribution"] != "normal":
            raise ValueError(f"unknown mel distribution {spec['distribution']!r}")
        n_mels = int(self.hp["audio_num_mel_bins"])
        sizes = [f for frames in self.calls for f in frames]
        gen = torch.Generator(device=self.device).manual_seed(
            seed_for(self.seed, MELS))
        flat = torch.randn(sum(sizes), n_mels, generator=gen,
                           device=self.device)
        flat = (flat * float(spec["std"]) + float(spec["mean"])).cpu().numpy()
        parts = iter(np.split(flat, np.cumsum(sizes)[:-1]))
        return [[next(parts) for _ in frames] for frames in self.calls]

    # -- window --------------------------------------------------------------
    def window(self, seconds: float, traced: bool) -> list:
        """Calls until ``seconds`` have passed since the first; returns
        their records."""
        sampler = self.vocoder.sampler
        before = (sampler.warmups, sampler.captures)
        rng = np.random.default_rng(seed_for(self.seed, SAMPLE))
        want = int(self.traffic["check_sample"])
        gen = torch.Generator(device=self.device)
        records, seen, k, rnd = [], 0, 0, 0
        start = time.perf_counter()
        while True:
            for idx in self.mix.order(self.seed, rnd):
                with span("portbench.prepare", traced):
                    frames, mels = self.calls[idx], self.mels[idx]
                    noise_seed = seed_for(self.seed, NOISE, k)
                    gen.manual_seed(noise_seed)
                t0 = time.perf_counter()
                with span("portbench.call", traced):
                    wavs = self.vocoder.vocode(mels, generator=gen)
                t1 = time.perf_counter()
                padded = self.mix.padded(max(frames))
                records.append(Call(t0, t1, frames, padded))
                with span("portbench.record", traced):
                    wavs = list(wavs) + [None] * (len(frames) - len(wavs))
                    for row, (f, wav) in enumerate(zip(frames, wavs)):
                        self.attempted += 1
                        if wav is None or wav.shape != (f * self.hop,):
                            self.failed += 1
                            continue
                        seen += 1
                        keep = Kept(noise_seed, len(frames), padded, row,
                                    mels[row], wav)
                        if self.longest is None or f > self.longest.mel.shape[0]:
                            self.longest = keep
                        if len(self.kept) < want:
                            self.kept.append(keep)
                        else:
                            j = int(rng.integers(seen))
                            if j < want:
                                self.kept[j] = keep
                k += 1
                if t1 - start >= seconds:
                    per_call = self.traffic.get("max_batch") or 1
                    self.counters = {
                        "sampler_calls": sum(-(-len(c.frames) // per_call)
                                             for c in records),
                        "warmups": sampler.warmups - before[0],
                        "captures": sampler.captures - before[1]}
                    return records
            rnd += 1

    def free_program(self):
        """Drop the program (model, sampler, graphs) before the check."""
        self.vocoder = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- check ---------------------------------------------------------------
    def sample(self) -> list:
        """The utterances compared: the reservoir and the longest."""
        out = list(self.kept)
        if self.longest is not None and all(k is not self.longest
                                            for k in out):
            out.append(self.longest)
        return out

    def reference(self, kept: list, quant: str) -> list:
        """The plain reference's waveform of each kept utterance, from the
        same mel, zero-padded to its bucket as the call padded it, and the
        same noise, drawn again from the call's seed."""
        n_steps = int(self.hp["N"])
        n_mels = int(self.hp["audio_num_mel_bins"])
        out = []
        with torch.inference_mode(), common.exact_float32():
            for k in kept:
                x_t, zs = diffusion.draws(k.noise_seed, k.rows,
                                          k.padded * self.hop, n_steps,
                                          self.device)
                mel = torch.zeros(1, k.padded, n_mels, device=self.device)
                mel[0, : k.mel.shape[0]] = torch.from_numpy(k.mel).to(
                    self.device)
                wav = diffusion.reverse(
                    self.ref.forward, self.weights, self.hp, mel,
                    x_t[k.row: k.row + 1], [z[k.row: k.row + 1] for z in zs],
                    common.QUANT[quant])
                out.append(wav[0, : k.mel.shape[0] * self.hop].double()
                           .cpu().numpy())
        return out

    def check(self) -> dict:
        """{name: value} compared: the worst relative L2 gap of a served
        waveform to the reference's, and the count of served waveforms
        that are not finite."""
        kept = self.sample()
        refs = self.reference(kept, "float32")
        worst, nonfinite = 0.0, 0
        for k, ref in zip(kept, refs):
            wav = k.wav.astype(np.float64)
            if not np.isfinite(wav).all():
                nonfinite += 1
                continue
            gap = rel_l2(wav, ref)
            worst = max(worst, gap if np.isfinite(gap) else float("inf"))
        return {"wav_rel_l2": worst, "nonfinite_wavs": float(nonfinite)}


def rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    """||got - want|| / ||want||; infinite where the reference is 0 or
    not finite."""
    norm = float(np.linalg.norm(want))
    if not np.isfinite(norm) or norm == 0.0:
        return float("inf")
    return float(np.linalg.norm(got - want)) / norm
