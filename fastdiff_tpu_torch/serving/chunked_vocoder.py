"""Chunked long-utterance vocoding with halo overlap
(``fastdiff_tpu/serving/chunked_vocoder.py``).

Every op of the FastDiff denoiser is local (convs with a bounded receptive
field, frame-local LVC kernels), so a long mel is split into fixed-size
chunks with a halo on each side, the chunks are vocoded as one batch, and
the waveforms are overlap-added with an equal-power crossfade across the
halos. Every chunk has one shape, but the batched call (the default) puts
all of an utterance's chunks in one sampler call, as JAX does: its batch
is the chunk count, so each chunk count is a shape of its own (one CUDA
graph each), and the graph's memory grows with the utterance. With
``per_chunk_keys`` every call is one chunk: one shape for any length.

The sampler is ``sample(generator, mel (B, F, n_mels), audio_length) ->
(B, L, 1)``, e.g. ``FastDiffVocoder.sample`` or a ``make_sampler``
runner. ``DistributedChunkedVocoder`` spreads the chunk batch over every
visible device in one process, with no collective
(``parallel/mesh.py:ShardedSampler``): JAX's sequence parallelism over its
mesh.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from fastdiff_tpu_torch.diffusion.sampler import (fold_in,
                                                  inference_generator, split)
from fastdiff_tpu_torch.parallel.mesh import ShardedSampler

# FastDiff receptive field in mel frames: kernel-predictor context (~9
# frames) plus the sample-level conv stacks (< 2 frames at hop 256)
DEFAULT_HALO_FRAMES = 16


def crossfade_window(core_s: int, halo_s: int) -> np.ndarray:
    """Equal-power sin^2 crossfade over one halo width on each side of a
    chunk of ``core_s + 2 * halo_s`` samples."""
    ramp = np.sin(0.5 * np.pi * np.linspace(0, 1, halo_s)) ** 2
    win = np.ones(core_s + 2 * halo_s, np.float32)
    win[:halo_s] = ramp
    win[-halo_s:] = ramp[::-1]
    return win


def wav_numpy(wav: torch.Tensor) -> np.ndarray:
    """A sampler's (B, L, 1) output as a (B, L) float32 numpy array."""
    return wav[..., 0].float().cpu().numpy()


class ChunkedVocoder:
    def __init__(self, sampler: Callable, hop_size: int,
                 chunk_frames: int = 256,
                 halo_frames: int = DEFAULT_HALO_FRAMES,
                 per_chunk_keys: bool = False):
        """``per_chunk_keys`` draws each chunk's noise from a generator
        derived from the stream position (``fold_in(split(generator), i)``,
        one ``split`` per ``vocode``) in one sampler call per chunk instead
        of one batched call: identical to ``StreamingVocoder``'s output, at
        the cost of batching."""
        if chunk_frames <= 2 * halo_frames:
            raise ValueError(f"chunk_frames ({chunk_frames}) must exceed "
                             f"twice halo_frames ({halo_frames})")
        self.sampler = sampler
        self.hop = hop_size
        self.chunk = chunk_frames
        self.halo = halo_frames
        self.per_chunk_keys = per_chunk_keys

    def vocode(self, mel: np.ndarray, generator=None) -> np.ndarray:
        """mel (T, n_mels) -> wav (T * hop,). Inputs of at most one chunk
        go through in one call; longer ones are chunked and crossfaded.
        ``generator`` defaults to ``inference_generator(0)`` on the card."""
        if generator is None:
            generator = inference_generator(0)
        mel = np.asarray(mel, np.float32)
        frames = mel.shape[0]
        core = self.chunk - 2 * self.halo
        if frames <= self.chunk:
            wav = self.sampler(generator, torch.from_numpy(mel)[None],
                               frames * self.hop)
            return wav_numpy(wav)[0]

        n_chunks = int(np.ceil(frames / core))
        padded_frames = n_chunks * core + 2 * self.halo
        mel_pad = np.pad(mel, ((self.halo, padded_frames - frames - self.halo),
                               (0, 0)), mode="edge")
        # chunk i covers the core window [i*core, (i+1)*core) with a halo on
        # both sides
        chunks = np.stack([mel_pad[i * core: i * core + self.chunk]
                           for i in range(n_chunks)])
        if self.per_chunk_keys:
            stream = split(generator)
            wavs = np.stack([
                wav_numpy(self.sampler(fold_in(stream, i),
                                       torch.from_numpy(chunks[i])[None],
                                       self.chunk * self.hop))[0]
                for i in range(n_chunks)])
        else:
            wavs = wav_numpy(self.sampler(generator, torch.from_numpy(chunks),
                                          self.chunk * self.hop))

        halo_s = self.halo * self.hop
        core_s = core * self.hop
        out = np.zeros(n_chunks * core_s, np.float32)
        weight = np.zeros_like(out)
        win = crossfade_window(core_s, halo_s)
        for i in range(n_chunks):
            seg = wavs[i] * win
            start = i * core_s - halo_s
            lo = max(0, start)
            seg_lo = lo - start
            hi = min(len(out), start + len(seg))
            out[lo:hi] += seg[seg_lo: seg_lo + hi - lo]
            weight[lo:hi] += win[seg_lo: seg_lo + hi - lo]
        out = out / np.maximum(weight, 1e-8)
        return out[: frames * self.hop]


class DistributedChunkedVocoder(ChunkedVocoder):
    """Chunked vocoding with the chunk batch sharded over devices: the
    chunk count is padded with zero chunks to a multiple of the device
    count, each device vocodes its contiguous block of chunks, and the
    crossfade runs on the gathered rows (``fastdiff_tpu/serving/
    chunked_vocoder.py:DistributedChunkedVocoder``). ``sampler`` is one
    sampler per device or one callable for all (``ShardedSampler``);
    ``devices`` defaults to every visible card. On one device it is
    ``ChunkedVocoder``, call for call."""

    def __init__(self, sampler, hop_size: int, devices=None,
                 chunk_frames: int = 256,
                 halo_frames: int = DEFAULT_HALO_FRAMES):
        super().__init__(sampler, hop_size, chunk_frames, halo_frames)
        self.sampler = ShardedSampler(sampler, devices)
        self.devices = self.sampler.devices
