"""Batched vocoding of many utterances on one card
(``fastdiff_tpu/serving/batch_vocoder.py`` without the mesh).

Mel frame counts are padded up to multiples of ``frame_bucket``, so the
padded length is the sampler's graph key and the number of CUDA graphs
stays bounded; utterances of one bucket are stacked ``max_batch`` at a time
and the outputs are trimmed back to ``frames * hop`` samples.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from fastdiff_tpu_torch.diffusion.sampler import (inference_generator,
                                                  make_sampler)
from fastdiff_tpu_torch.serving.chunked_vocoder import wav_numpy


class BatchedVocoder:
    def __init__(self, model, constants, hop_size: int,
                 frame_bucket: int = 128, max_batch: Optional[int] = None):
        """``model(x, mel, t) -> eps`` (a ``FastDiff``); ``constants`` from
        ``sampler_constants_for_schedule``.

        ``max_batch`` defaults to 1, JAX's per-device batch 1 on its one
        device: extra utterances run as more rounds, not fatter batches.
        Raise it only after measuring."""
        self.sampler = make_sampler(model, constants)
        self.hop = hop_size
        self.frame_bucket = frame_bucket
        self.max_batch = max_batch if max_batch is not None else 1

    @classmethod
    def from_sampler(cls, sampler: Callable, hop_size: int,
                     frame_bucket: int = 128,
                     max_batch: Optional[int] = None) -> "BatchedVocoder":
        """Wrap an existing ``sampler(generator, mel, audio_length)``."""
        self = cls.__new__(cls)
        self.sampler = sampler
        self.hop = hop_size
        self.frame_bucket = frame_bucket
        self.max_batch = max_batch if max_batch is not None else 1
        return self

    def _bucket(self, frames: int) -> int:
        b = self.frame_bucket
        return ((frames + b - 1) // b) * b

    def vocode(self, mels: List[np.ndarray],
               generator=None) -> List[np.ndarray]:
        """mels: list of (T_i, n_mels) arrays -> list of (T_i * hop,) wavs.
        The buckets run in increasing padded length, each in input order,
        all drawing from ``generator`` (default ``inference_generator(0)``
        on the card)."""
        if generator is None:
            generator = inference_generator(0)
        buckets = {}
        for i, mel in enumerate(mels):
            buckets.setdefault(self._bucket(mel.shape[0]), []).append(i)

        out: List[np.ndarray] = [None] * len(mels)
        for padded_frames, idxs in sorted(buckets.items()):
            for start in range(0, len(idxs), self.max_batch):
                chunk = idxs[start: start + self.max_batch]
                stack = np.zeros((len(chunk), padded_frames,
                                  mels[chunk[0]].shape[1]), np.float32)
                for row, i in enumerate(chunk):
                    stack[row, : mels[i].shape[0]] = mels[i]
                wavs = wav_numpy(self.sampler(generator,
                                              torch.from_numpy(stack),
                                              padded_frames * self.hop))
                for row, i in enumerate(chunk):
                    out[i] = wavs[row, : mels[i].shape[0] * self.hop]
        return out
