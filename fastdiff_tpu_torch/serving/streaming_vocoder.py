"""Streaming vocoder: incremental mel -> waveform synthesis
(``fastdiff_tpu/serving/streaming_vocoder.py``).

A stateful API on top of the chunked path (``serving/chunked_vocoder.py``):
it takes mel frames as they are produced (e.g. by an autoregressive
acoustic model) and returns the waveform samples that no later chunk can
change, carrying the crossfade halo forward from chunk to chunk.

Guarantees:
- the output does not depend on how the frames are fed: frame by frame, in
  bursts or all at once gives the same samples (each chunk's generator is
  derived from the stream position, ``fold_in(stream, i)``, not from
  arrival, where ``stream = split(generator)`` is drawn once when the
  vocoder is made, so streams that share a generator differ);
- identical to ``ChunkedVocoder(..., per_chunk_keys=True)`` with the same
  generator where the chunked path's cores end within a halo of the
  stream's end (frames <= ceil(frames / core) * core - halo); otherwise the
  stream runs one more chunk, which changes the last samples, as JAX's
  module does;
- memory does not grow with the stream; one sampler shape (one CUDA graph);
- a sample is final once the next chunk cannot touch it: at worst
  ``core + halo`` frames behind the newest fed frame.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from fastdiff_tpu_torch.diffusion.sampler import (fold_in,
                                                  inference_generator, split)
from fastdiff_tpu_torch.serving.chunked_vocoder import (DEFAULT_HALO_FRAMES,
                                                        crossfade_window,
                                                        wav_numpy)

__all__ = ["StreamingVocoder", "crossfade_window"]


class StreamingVocoder:
    def __init__(self, sampler: Callable, hop_size: int,
                 chunk_frames: int = 256,
                 halo_frames: int = DEFAULT_HALO_FRAMES,
                 generator: Optional[torch.Generator] = None):
        """sampler(generator, mel (1, F, n_mels), audio_length) -> (1, L, 1);
        ``generator`` defaults to ``inference_generator(0)`` on the card;
        the stream's own generator is split from it here."""
        if chunk_frames <= 2 * halo_frames:
            raise ValueError(f"chunk_frames ({chunk_frames}) must exceed "
                             f"twice halo_frames ({halo_frames})")
        self.sampler = sampler
        self.hop = hop_size
        self.chunk = chunk_frames
        self.halo = halo_frames
        self.core = chunk_frames - 2 * halo_frames
        self.generator = split(generator if generator is not None
                               else inference_generator(0))

        self._mel_buf: Optional[np.ndarray] = None   # frames seen so far,
        self._consumed = 0                           # minus what chunks used
        self._chunk_idx = 0
        self._total_frames = 0
        # overlap-add state: samples >= self._final_s are still mutable
        self._tail = np.zeros(0, np.float32)
        self._tail_w = np.zeros(0, np.float32)
        self._final_s = 0                            # finalized sample count
        self._finished = False

    # -- latency accounting -------------------------------------------------
    @property
    def latency_frames(self) -> int:
        """Worst-case finalization latency in mel frames: a sample is final
        once the next chunk cannot touch it -> (core + halo) frames behind
        the newest fed frame."""
        return self.core + self.halo

    def latency_seconds(self, sample_rate: int) -> float:
        return self.latency_frames * self.hop / sample_rate

    @classmethod
    def low_latency(cls, sampler: Callable, hop_size: int,
                    generator: Optional[torch.Generator] = None
                    ) -> "StreamingVocoder":
        """Sub-500 ms finalization preset: chunk 48 / halo 8 -> latency
        (32 + 8) frames = 464 ms at hop 256 / 22.05 kHz. The halo is half
        the receptive-field default, so chunk seams lose some long-context
        conditioning; the invariants above are unchanged."""
        return cls(sampler, hop_size, chunk_frames=48, halo_frames=8,
                   generator=generator)

    # -- internals ------------------------------------------------------------
    def _vocode_chunk(self, mel_chunk: np.ndarray, idx: int) -> np.ndarray:
        wav = self.sampler(fold_in(self.generator, idx),
                           torch.from_numpy(np.ascontiguousarray(
                               mel_chunk, np.float32))[None],
                           self.chunk * self.hop)
        return wav_numpy(wav)[0]

    def _emit_chunk(self, mel_chunk: np.ndarray) -> np.ndarray:
        """Overlap-add one haloed chunk; return newly finalized samples."""
        i = self._chunk_idx
        self._chunk_idx += 1
        core_s, halo_s = self.core * self.hop, self.halo * self.hop
        win = crossfade_window(core_s, halo_s)
        seg = self._vocode_chunk(mel_chunk, i) * win

        start = i * core_s - halo_s                   # global sample position
        if start < 0:                                 # first chunk: clip halo
            seg, win = seg[-start:], win[-start:]
            start = 0
        # grow the mutable tail to cover this segment
        end = start + len(seg)
        lo = self._final_s
        need = end - lo
        if len(self._tail) < need:
            pad = need - len(self._tail)
            self._tail = np.concatenate([self._tail, np.zeros(pad, np.float32)])
            self._tail_w = np.concatenate([self._tail_w,
                                           np.zeros(pad, np.float32)])
        off = start - lo
        self._tail[off: off + len(seg)] += seg
        self._tail_w[off: off + len(seg)] += win

        # samples the NEXT chunk can still touch start at (i+1)*core - halo
        safe_end = (i + 1) * core_s - halo_s
        n_final = max(0, safe_end - lo)
        out = self._tail[:n_final] / np.maximum(self._tail_w[:n_final], 1e-8)
        self._tail = self._tail[n_final:]
        self._tail_w = self._tail_w[n_final:]
        self._final_s = safe_end
        return out

    def _ready_chunk(self) -> Optional[np.ndarray]:
        """Mel window for the next chunk if enough frames arrived."""
        i = self._chunk_idx
        lo = i * self.core - self.halo
        hi = lo + self.chunk
        if self._mel_buf is None or self._total_frames < hi:
            return None
        buf_lo = lo - self._consumed
        if buf_lo < 0:                                # left edge padding
            pad = np.repeat(self._mel_buf[:1], -buf_lo, axis=0)
            window = np.concatenate([pad, self._mel_buf[: hi - self._consumed]])
        else:
            window = self._mel_buf[buf_lo: hi - self._consumed]
        # drop frames no future chunk needs: the next chunk starts at
        # (i+1)*core - halo
        keep_from = max(0, (i + 1) * self.core - self.halo - self._consumed)
        self._mel_buf = self._mel_buf[keep_from:]
        self._consumed += keep_from
        return window

    # -- public API -----------------------------------------------------------
    def feed(self, mel_frames: np.ndarray) -> np.ndarray:
        """Feed (T, n_mels) new frames; returns newly finalized samples."""
        if self._finished:
            raise RuntimeError("feed() after finish()")
        mel_frames = np.asarray(mel_frames, np.float32)
        if mel_frames.ndim == 1:
            mel_frames = mel_frames[None, :]
        self._mel_buf = (mel_frames if self._mel_buf is None
                         else np.concatenate([self._mel_buf, mel_frames]))
        self._total_frames += len(mel_frames)
        out = []
        while (window := self._ready_chunk()) is not None:
            out.append(self._emit_chunk(window))
        return np.concatenate(out) if out else np.zeros(0, np.float32)

    def finish(self) -> np.ndarray:
        """Flush: vocode the remaining partial chunk (edge-padded) and return
        all remaining samples. Total stream output is total_frames * hop."""
        if self._finished:
            raise RuntimeError("finish() called twice")
        self._finished = True
        total_s = self._total_frames * self.hop
        out = []
        # emit the remaining full / partial chunks, edge-padded on the right
        while self._final_s < total_s and self._mel_buf is not None \
                and len(self._mel_buf) > 0:
            i = self._chunk_idx
            lo = i * self.core - self.halo
            buf_lo = lo - self._consumed
            window = self._mel_buf[max(0, buf_lo):]
            if buf_lo < 0:
                pad = np.repeat(self._mel_buf[:1], -buf_lo, axis=0)
                window = np.concatenate([pad, window])
            if len(window) < self.chunk:              # right edge padding
                pad = np.repeat(window[-1:], self.chunk - len(window), axis=0)
                window = np.concatenate([window, pad])
            else:
                window = window[: self.chunk]
            keep_from = max(0, (i + 1) * self.core - self.halo - self._consumed)
            self._mel_buf = self._mel_buf[keep_from:]
            self._consumed += keep_from
            out.append(self._emit_chunk(window))
        # whatever is still mutable is now final
        if self._final_s < total_s:
            n = total_s - self._final_s
            tail = self._tail[:n] / np.maximum(self._tail_w[:n], 1e-8)
            out.append(tail)
            self._final_s = total_s
        full = np.concatenate(out) if out else np.zeros(0, np.float32)
        # the last chunk was edge-padded past the true stream end: trim
        overshoot = self._final_s - total_s
        if overshoot > 0:
            full = full[:-overshoot] if overshoot < len(full) else full[:0]
        return full
