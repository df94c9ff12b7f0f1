"""Text-to-speech traffic (``kind: tts``): one caller in a closed loop on the
port's text-to-wav entry, ``training/tts_task.py:FastSpeech2Task.
synthesize``: FastSpeech 2 with predicted durations at ``t_mel =
max_frames``, then FastDiff through the frame-bucketed graph sampler
(``infer_frame_bucket``), the waveform trimmed and in host memory.

A round is ``sentences_per_round`` distinct sentences: their lengths at
evenly spaced quantiles of the mix's distribution of seconds (the same for
every seed), ``phones_per_s`` phones a second, their token ids drawn from
the seed uniformly over the vocabulary without the pad id 0. Every round
sends the same sentences, in an order drawn from the seed for that round.

Set-up makes both models' weights from the seed on the device
(``reference/fastspeech2.py:param_shapes``) and sets the duration and pitch
predictors' output biases from the reference run over the round's
sentences (``_output_biases``), so that every seed's phones get the frames a
phone the mix implies (sample rate / hop / ``phones_per_s``: LJSpeech's mel
lengths) and its frames the configuration's ``bias_targets`` of f0 and
voicing; a seed's random weights alone would shift every duration, f0 and
voicing logit of a run by one offset. It builds the program through the port's task, loads the weights strictly,
runs every sentence twice (the first call of a token count runs FastSpeech
2 eagerly and the first of a bucket the vocoder, the second of each
captures), then the mix untimed for ``warm_seconds``. The window sends sentences until
``seconds`` have passed, each call's noise from a generator seeded for
that call; a reservoir drawn from the seed keeps ``check_sample`` finished
sentences, and the longest, with the program's decisions and mel.

``check`` holds them to the plain reference from the same tokens, float32
with TF32 off:

- decisions: each phone's frame count against the reference's exp(d) - 1,
  each frame's voicing against its voicing logit, and each frame's pitch
  bin, where the program voiced it, against its scaled f0. A decision that
  differs from the reference's own is a mismatch unless the reference's
  value lies within the configuration's ``decision_bands`` of the rounding
  boundary between the two (a band set from the worst gap measured between
  the program's values and the reference's);
- mel: the reference's mel from the same tokens with the program's decisions
  (frames and pitch bins);
- waveform: the reference vocoder on that mel, zero-padded to the program's
  bucket as the program padded its own, from the same noise.

The mix's sentences stay far below ``max_frames``, where FastSpeech 2 would
cut the last phone short.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time
from statistics import NormalDist

import numpy as np
import torch

from portbench import weights as weightlib
from portbench.drivers.vocode import rel_l2
from portbench.reference import common, diffusion, fastdiff
from portbench.reference import fastspeech2 as fs2ref
from portbench.trace import span
from portbench.traffic import (MELS, NOISE, ORDER, PRIME, SAMPLE, WARM,
                               seed_for)

DURATION_BIAS = "dur_predictor.out.bias"
PITCH_BIAS = "pitch_predictor.out.bias"


@dataclasses.dataclass
class Call:
    start: float            # host clock at the call
    end: float              # host clock with the waveform in host memory
    frames: list            # [predicted mel frames]
    padded: int             # the vocoder's bucket
    tokens: int             # phones of the sentence


@dataclasses.dataclass
class Kept:
    """One finished sentence kept for the check: its inputs, the program's
    continuous values and decisions (over ``t_mel`` frames), mel and wave."""
    noise_seed: int
    tokens: np.ndarray      # (P,)
    padded: int
    d: np.ndarray           # (P,) log durations
    mel2ph: np.ndarray      # (t_mel,)
    f0: np.ndarray          # (t_mel,) log2 f0
    uv: np.ndarray          # (t_mel,) voicing logit
    bins: np.ndarray        # (t_mel,) pitch bins
    mel: np.ndarray         # (frames, n_mels)
    wav: np.ndarray


def entry():
    """The port's text-to-wav task; a program without the entry fails here,
    before any set-up."""
    from fastdiff_tpu_torch.training.tts_task import FastSpeech2Task
    if not hasattr(FastSpeech2Task, "synthesize"):
        raise RuntimeError("the program has no text-to-wav entry "
                           "(FastSpeech2Task.synthesize)")
    return FastSpeech2Task


def build_program(hp: dict, weights: dict, device) -> tuple:
    """The system under test: the port's FastSpeech 2 task and its state
    holding FastSpeech 2's weights, its vocoder holding FastDiff's (both
    loaded strictly)."""
    task = entry()(dict(hp), device=device)
    state = task.build_state(seed=0)
    acoustic, vocoder = fs2ref.split(weights)
    state.model.load_state_dict(acoustic)
    task.tts_vocoder().sampler.model.load_state_dict(vocoder)
    return task, state


def record(noise_seed: int, tokens, padded: int, wav: np.ndarray,
           out: dict) -> Kept:
    """A finished sentence with the host copies of what the check reads of
    the forward's output (``FastSpeech2Task.synthesize``'s dict); the pitch
    bins are the port's own mapping of the f0 it embedded."""
    from fastdiff_tpu_torch.ops.pitch import f0_to_coarse_t

    def host(t):
        return t[0].cpu().numpy()
    frames = int(out["mel_mask"][0].sum())
    return Kept(noise_seed, np.array(tokens), padded, host(out["dur_pred"]),
                host(out["mel2ph"]), host(out["f0_pred"]),
                host(out["uv_pred"]), host(f0_to_coarse_t(out["f0_denorm"])),
                out["mel"][0, :frames].cpu().numpy(), wav)


def sentence_phones(traffic: dict) -> list:
    """Phones of each sentence of a round: seconds at the quantiles
    (j + 0.5) / n of the clipped normal, ``phones_per_s`` a second."""
    lengths = traffic["lengths"]
    if lengths["distribution"] != "normal_clipped":
        raise ValueError(f"unknown length distribution "
                         f"{lengths['distribution']!r}")
    dist = NormalDist(float(lengths["mean_s"]), float(lengths["std_s"]))
    lo, hi = float(lengths["min_s"]), float(lengths["max_s"])
    n = int(traffic["sentences_per_round"])
    rate = float(traffic["phones_per_s"])
    return [max(1, round(rate * min(hi, max(lo, dist.inv_cdf((j + 0.5) / n)))))
            for j in range(n)]


def decision_counts(program, reference, value, band: float) -> tuple:
    """(mismatches, in band) of integer decisions against the reference's,
    taken by rounding ``value``: a differing decision is in the band when it
    is one away and ``value`` lies within ``band`` of the boundary between
    the two."""
    differ = program != reference
    near = (np.abs(program - reference) == 1) & (
        np.abs(value - (np.minimum(program, reference) + 0.5)) <= band)
    return int((differ & ~near).sum()), int((differ & near).sum())


def scaled_pitch(f0: np.ndarray) -> np.ndarray:
    """The pitch bin before rounding of a voiced frame's log2 f0 (float64)."""
    hz = np.clip(np.exp2(f0.astype(np.float64)), 0.0, fs2ref.F0_MAX)
    scaled, _ = fs2ref.pitch_scale(torch.from_numpy(hz))
    return scaled.numpy()


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        entry()
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.hp = config["hparams"]
        self.hop = int(self.hp["hop_size"])
        self.sample_rate = int(self.hp["audio_sample_rate"])
        self.bucket = int(self.hp["infer_frame_bucket"])
        self.phones = sentence_phones(traffic)
        self.task = self.state = self.sampler = None
        self.build_s = 0.0
        self.kept, self.longest = [], None
        self.attempted = self.failed = 0
        self.counters = {}

    # -- set-up --------------------------------------------------------------
    def setup(self):
        # the port's kernel library (the vocoder's), built on a checkout's
        # first run, is timed apart
        if self.device.type == "cuda":
            from fastdiff_tpu_torch.ops import _build
            t0 = time.perf_counter()
            _build.library()
            self.build_s = time.perf_counter() - t0
        self.sentences = self._sentences()
        self.weights = self._weights()
        self.task, self.state = build_program(self.hp, self.weights,
                                              self.device)
        self.sampler = self.task.tts_vocoder().sampler
        gen = torch.Generator(device=self.device)
        # every sentence twice: a token count's or a bucket's first call
        # runs eagerly, its second captures
        for i in range(2 * len(self.sentences)):
            gen.manual_seed(seed_for(self.seed, WARM, i))
            self.task.synthesize(self.state,
                                 self.sentences[i % len(self.sentences)],
                                 generator=gen)
        # the mix itself, untimed, until the loop runs as it will in the
        # window (the first seconds of a fresh process run slower)
        start, k = time.perf_counter(), 0
        while time.perf_counter() - start < float(self.traffic["warm_seconds"]):
            order = self.order(k // len(self.sentences), PRIME)
            gen.manual_seed(seed_for(self.seed, PRIME, k))
            self.task.synthesize(self.state,
                                 self.sentences[order[k % len(order)]],
                                 generator=gen)
            k += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def padded(self, frames: int) -> int:
        return -(-frames // self.bucket) * self.bucket

    def order(self, round_index: int, stream: int = ORDER) -> list:
        rng = np.random.default_rng(seed_for(self.seed, stream, round_index))
        return [int(i) for i in rng.permutation(len(self.sentences))]

    def _sentences(self) -> list:
        rng = np.random.default_rng(seed_for(self.seed, MELS))
        vocab = int(self.hp["vocab_size"])
        return [rng.integers(1, vocab, size=p).astype(np.int64)
                for p in self.phones]

    def _weights(self) -> dict:
        weights = weightlib.make(fs2ref.param_shapes(self.hp), self.seed,
                                 self.device)
        acoustic, _ = fs2ref.split(weights)
        for name, value in self._output_biases(acoustic).items():
            weights[fs2ref.ACOUSTIC + name] = value
        return weights

    def _output_biases(self, acoustic: dict) -> dict:
        """The duration and pitch predictors' output biases that give the
        round's sentences the configuration's ``bias_targets``, from the
        reference's encoder and predictors without those biases (d0, f0_0,
        uv_0; float32): log((1 + f) / mean(exp(d0))) over every phone, f the
        frames a phone the mix implies, so the phones get f frames on
        average; the voicing bias that leaves ``unvoiced_share`` of the
        frames so regulated with a logit above 0; the log2 f0 bias that puts
        their voiced frames' median at ``f0_hz``."""
        targets = self.config["bias_targets"]
        w = dict(acoustic, **{DURATION_BIAS: torch.zeros(1, device=self.device),
                              PITCH_BIAS: torch.zeros(2, device=self.device)})
        tokens = torch.zeros(len(self.sentences), max(self.phones),
                             dtype=torch.long)
        for row, sentence in enumerate(self.sentences):
            tokens[row, : len(sentence)] = torch.from_numpy(sentence)
        frames = self.sample_rate / self.hop / float(self.traffic["phones_per_s"])
        with torch.inference_mode(), common.exact_float32():
            x, mask = fs2ref.encode(w, self.hp, tokens.to(self.device))
            d0 = fs2ref.log_durations(w, self.hp, x, mask).double()
            dur_bias = math.log((1.0 + frames) / float(
                (torch.exp(d0) * mask).sum() / mask.sum()))
            dur = fs2ref.durations(d0 + dur_bias, mask)
            m2p = fs2ref.mel2ph(dur, int(dur.sum(1).max()))
            valid = m2p > 0
            f0, uv = fs2ref.pitch(w, self.hp, fs2ref.regulate(x, m2p),
                                  valid.float())
            uv_bias = -float(torch.quantile(
                uv[valid].double(), 1.0 - float(targets["unvoiced_share"])))
            f0_bias = math.log2(float(targets["f0_hz"])) - float(
                f0[valid & (uv + uv_bias <= 0)].double().median())
        return {DURATION_BIAS: torch.tensor([dur_bias], device=self.device),
                PITCH_BIAS: torch.tensor([f0_bias, uv_bias],
                                         device=self.device)}

    # -- window --------------------------------------------------------------
    def window(self, seconds: float, traced: bool) -> list:
        """Calls until ``seconds`` have passed since the first; returns
        their records."""
        acoustic = self.task.acoustic_graphs
        before = (self.sampler.warmups, self.sampler.captures,
                  dict(self.task.counters), acoustic.warmups,
                  acoustic.captures)
        rng = np.random.default_rng(seed_for(self.seed, SAMPLE))
        want = int(self.traffic["check_sample"])
        gen = torch.Generator(device=self.device)
        records, seen, k, rnd = [], 0, 0, 0
        start = time.perf_counter()
        while True:
            for idx in self.order(rnd):
                with span("portbench.prepare", traced):
                    tokens = self.sentences[idx]
                    noise_seed = seed_for(self.seed, NOISE, k)
                    gen.manual_seed(noise_seed)
                t0 = time.perf_counter()
                with span("portbench.call", traced):
                    wav, out = self.task.synthesize(self.state, tokens,
                                                    generator=gen)
                t1 = time.perf_counter()
                with span("portbench.record", traced):
                    self.attempted += 1
                    if (wav is None or wav.ndim != 1 or not len(wav)
                            or len(wav) % self.hop):
                        self.failed += 1
                    else:
                        frames = len(wav) // self.hop
                        records.append(Call(t0, t1, [frames],
                                            self.padded(frames), len(tokens)))
                        seen += 1
                        self._keep(rng, want, seen, noise_seed, tokens, wav,
                                   out)
                k += 1
                if t1 - start >= seconds:
                    now = dict(self.task.counters)
                    self.counters = {
                        "sampler_calls": len(records),
                        "warmups": self.sampler.warmups - before[0],
                        "captures": self.sampler.captures - before[1],
                        "tokens": now["tokens"] - before[2]["tokens"],
                        "frames": now["frames"] - before[2]["frames"],
                        "acoustic_warmups": acoustic.warmups - before[3],
                        "acoustic_captures": acoustic.captures - before[4]}
                    return records
            rnd += 1

    def _keep(self, rng, want, seen, noise_seed, tokens, wav, out):
        """The reservoir's draw, and the longest sentence so far."""
        slot = len(self.kept) if len(self.kept) < want else int(
            rng.integers(seen))
        frames = len(wav) // self.hop
        longest = self.longest is None or frames > self.longest.mel.shape[0]
        if slot >= want and not longest:
            return
        kept = record(noise_seed, tokens, self.padded(frames), wav, out)
        if slot < want:
            if slot == len(self.kept):
                self.kept.append(kept)
            else:
                self.kept[slot] = kept
        if longest:
            self.longest = kept

    def free_program(self):
        """Drop the program (models, sampler, graphs) before the check."""
        self.task = self.state = self.sampler = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- check ---------------------------------------------------------------
    def sample(self) -> list:
        """The sentences compared: the reservoir and the longest."""
        out = list(self.kept)
        if self.longest is not None and all(k is not self.longest
                                            for k in out):
            out.append(self.longest)
        return out

    def compare(self, kept: list) -> tuple:
        """({name: value} compared, {name: value} reported) of ``kept``
        (the program's sentences, or a control's) against the reference."""
        acoustic, vocoder = fs2ref.split(self.weights)
        bands = self.config["decision_bands"]
        n_steps, n_mels = int(self.hp["N"]), int(self.hp["audio_num_mel_bins"])
        dev = self.device
        worst_mel = worst_wav = 0.0
        nonfinite = mismatches = in_band = decisions = 0
        gaps = dict.fromkeys(bands, 0.0)
        with torch.inference_mode(), common.exact_float32():
            for k in kept:
                frames = k.mel.shape[0]
                ref = fs2ref.forward(
                    acoustic, self.hp, torch.from_numpy(k.tokens)[None].to(dev),
                    m2p=torch.from_numpy(k.mel2ph)[None].to(dev),
                    bins=torch.from_numpy(k.bins)[None].to(dev))
                valid = k.mel2ph > 0

                # durations: frames a phone against exp(d) - 1
                n_ph = len(k.tokens)
                dur = np.bincount(k.mel2ph, minlength=n_ph + 1)[1: n_ph + 1]
                value = np.exp(ref["d"][0].double().cpu().numpy()) - 1.0
                ref_dur = np.maximum(np.rint(value), 1.0)
                m, b = decision_counts(dur, ref_dur, value, bands["duration"])
                gaps["duration"] = max(gaps["duration"], float(np.abs(
                    np.exp(k.d.astype(np.float64)) - 1.0 - value).max()))
                decisions += n_ph

                # voicing: the logit's sign, frame by frame
                uv = ref["uv"][0].double().cpu().numpy()[valid]
                p_uv, r_uv = k.uv[valid] > 0, uv > 0
                differ = p_uv != r_uv
                near = differ & (np.abs(uv) <= bands["voicing"])
                m, b = m + int((differ & ~near).sum()), b + int(near.sum())
                gaps["voicing"] = max(gaps["voicing"], float(np.abs(
                    k.uv[valid] - uv).max()))
                decisions += int(valid.sum())

                # pitch bins of the frames the program voiced
                voiced = valid & (k.uv <= 0)
                if voiced.any():
                    value = scaled_pitch(ref["f0"][0].cpu().numpy()[voiced])
                    pm, pb = decision_counts(
                        k.bins[voiced].astype(np.float64), np.rint(value),
                        value, bands["pitch"])
                    m, b = m + pm, b + pb
                    gaps["pitch"] = max(gaps["pitch"], float(np.abs(
                        scaled_pitch(k.f0[voiced]) - value).max()))
                    decisions += int(voiced.sum())
                mismatches += m
                in_band += b

                mel = ref["mel"][0, :frames]
                worst_mel = max(worst_mel, rel_l2(
                    k.mel.astype(np.float64), mel.double().cpu().numpy()))

                x_t, zs = diffusion.draws(k.noise_seed, 1, k.padded * self.hop,
                                          n_steps, dev)
                padded = torch.zeros(1, k.padded, n_mels, device=dev)
                padded[0, :frames] = mel
                wav = diffusion.reverse(fastdiff.forward, vocoder, self.hp,
                                        padded, x_t, zs, common.identity)
                want = wav[0, : frames * self.hop].double().cpu().numpy()
                got = k.wav.astype(np.float64)
                if not np.isfinite(got).all():
                    nonfinite += 1
                    continue
                gap = rel_l2(got, want) if got.shape == want.shape \
                    else float("inf")
                worst_wav = max(worst_wav, gap if np.isfinite(gap)
                                else float("inf"))
        compared = {"decision_mismatches": float(mismatches),
                    "mel_rel_l2": worst_mel, "wav_rel_l2": worst_wav,
                    "nonfinite_wavs": float(nonfinite)}
        reported = {"decisions": decisions, "decisions_in_band": in_band,
                    **{f"gap_{name}": gap for name, gap in gaps.items()}}
        return compared, reported

    def check(self) -> dict:
        """{name: value} compared: decisions outside the band, the worst
        relative L2 gaps of a mel and of a waveform to the reference's, and
        the count of waveforms that are not finite. The count of decisions
        inside the band and the worst gaps go to ``counters``."""
        compared, reported = self.compare(self.sample())
        self.counters.update(reported)
        return compared
