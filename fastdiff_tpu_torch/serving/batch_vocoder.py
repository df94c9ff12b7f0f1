"""Batched vocoding of many utterances over the visible cards
(``fastdiff_tpu/serving/batch_vocoder.py``).

Mel frame counts are padded up to multiples of ``frame_bucket``, so the
padded length is the sampler's graph key and the number of CUDA graphs
stays bounded; utterances of one bucket are stacked ``max_batch`` at a time
and the outputs are trimmed back to ``frames * hop`` samples. Over more
than one device each stack is padded to a multiple of the device count and
split into one row block per device (``parallel/mesh.py:ShardedSampler``,
a copy of the model and its sampler on each), as JAX shards it over its
``dp`` axis; on one device the sampler runs the stack as it is.

Under ``torch.profiler`` a call is the span ``vocoder.vocode``; each stack
adds ``vocoder.stack`` (pad and stack on the host, ``torch.from_numpy``),
the sampler's own spans, ``vocoder.fetch`` (wait, D2H, ``.numpy()``) and
``vocoder.trim``.
"""

from __future__ import annotations

import copy
from typing import Callable, List, Optional

import numpy as np
import torch

from fastdiff_tpu_torch.diffusion.sampler import (inference_generator,
                                                  make_sampler)
from fastdiff_tpu_torch.parallel.mesh import ShardedSampler, local_devices
from fastdiff_tpu_torch.serving.chunked_vocoder import wav_numpy
from fastdiff_tpu_torch.utils.profiling import span


class BatchedVocoder:
    def __init__(self, model, constants, hop_size: int,
                 frame_bucket: int = 128, max_batch: Optional[int] = None,
                 devices=None):
        """``model(x, mel, t) -> eps`` (a ``FastDiff``); ``constants`` from
        ``sampler_constants_for_schedule``; ``devices`` defaults to every
        visible card (the CPU without one).

        ``max_batch`` defaults to the device count, JAX's per-device batch
        1: extra utterances run as more rounds, not fatter batches. Raise
        it only after measuring."""
        devices = list(devices or local_devices())
        if len(devices) == 1:
            sampler = make_sampler(model, constants)
        else:
            sampler = [make_sampler(copy.deepcopy(model).to(d), constants)
                       for d in devices]
        self._setup(sampler, hop_size, frame_bucket, max_batch, devices)

    @classmethod
    def from_sampler(cls, sampler: Callable, hop_size: int,
                     frame_bucket: int = 128,
                     max_batch: Optional[int] = None,
                     devices=None) -> "BatchedVocoder":
        """Wrap an existing ``sampler(generator, mel, audio_length)`` (one
        per device, or one for all)."""
        self = cls.__new__(cls)
        self._setup(sampler, hop_size, frame_bucket, max_batch,
                    list(devices or local_devices()))
        return self

    def _setup(self, sampler, hop_size, frame_bucket, max_batch, devices):
        self.devices = devices
        if len(devices) > 1:
            sampler = ShardedSampler(sampler, devices)
        elif isinstance(sampler, (list, tuple)):
            sampler, = sampler
        self.sampler = sampler
        self.hop = hop_size
        self.frame_bucket = frame_bucket
        self.max_batch = max_batch if max_batch is not None else len(devices)

    def _bucket(self, frames: int) -> int:
        b = self.frame_bucket
        return ((frames + b - 1) // b) * b

    def vocode(self, mels: List[np.ndarray],
               generator=None) -> List[np.ndarray]:
        """mels: list of (T_i, n_mels) arrays -> list of (T_i * hop,) wavs.
        The buckets run in increasing padded length, each in input order,
        all drawing from ``generator`` (default ``inference_generator(0)``
        on the card)."""
        with span("vocoder.vocode"):
            if generator is None:
                generator = inference_generator(0)
            buckets = {}
            for i, mel in enumerate(mels):
                buckets.setdefault(self._bucket(mel.shape[0]), []).append(i)

            out: List[np.ndarray] = [None] * len(mels)
            for padded_frames, idxs in sorted(buckets.items()):
                for start in range(0, len(idxs), self.max_batch):
                    with span("vocoder.stack"):
                        chunk = idxs[start: start + self.max_batch]
                        stack = np.zeros((len(chunk), padded_frames,
                                          mels[chunk[0]].shape[1]),
                                         np.float32)
                        for row, i in enumerate(chunk):
                            stack[row, : mels[i].shape[0]] = mels[i]
                        stack = torch.from_numpy(stack)
                    wav = self.sampler(generator, stack,
                                       padded_frames * self.hop)
                    with span("vocoder.fetch"):
                        wavs = wav_numpy(wav)
                    del wav     # the device output is free for the next call
                    with span("vocoder.trim"):
                        for row, i in enumerate(chunk):
                            out[i] = wavs[row, : mels[i].shape[0] * self.hop]
            return out
