"""FastSpeech 2's inference forward replayed from CUDA graphs, one per token
count: the acoustic half of the text-to-wav entry
(``training/tts_task.py:FastSpeech2Task.synthesize``).

At inference the forward holds no host sync: the durations, the length
regulator's mel2ph and the pitch bins are computed on the device, and the
decoder runs all ``t_mel = max_frames`` frames, so a sentence's shapes follow
from its token count alone. Run eagerly the forward is ~280 launches, which
the host issues more slowly than the card runs them (8.4-12.6 ms a call
against 5.6-5.8 ms of card time on an H100, ``PERF_HISTORY.md``), so a
call's time would follow the host's speed.

``AcousticGraphs(model)(tokens)`` serves the forward as
``diffusion/sampler.py:GraphSampler`` serves the vocoder: a token count's
first call runs the forward eagerly on a side stream (``warmups``), its
second captures it on that stream into a memory pool all the graphs share
and replays (``captures``), later calls copy the tokens into that graph's
static buffer and replay. A replay answers with clones of the graph's
static outputs, which the next replay of any graph may overwrite. At most
``max_graphs`` token counts are kept, the least recently used evicted; when
the storage of a parameter moved since the last call (``.to``,
``load_state_dict(..., assign=True)``) every graph is dropped. The keys hold
the TF32 settings. On the CPU the same calls run the forward eagerly (and
count as on the card). Calls must not overlap.
"""

from __future__ import annotations

import collections

import torch

from fastdiff_tpu_torch.diffusion.sampler import _storage


class AcousticGraphs:
    def __init__(self, model, max_graphs: int = 256):
        if max_graphs < 1:
            raise ValueError(f"max_graphs must be >= 1, got {max_graphs}")
        self.model, self.max_graphs = model, max_graphs
        self._entries = collections.OrderedDict()   # key -> _Entry
        self._storage = self._pool = self._stream = None
        self.warmups = self.captures = 0

    @property
    def graphs_cached(self) -> int:
        return sum(e.captured for e in self._entries.values())

    def _side(self, device) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def _warm(self, tokens: torch.Tensor) -> dict:
        """The forward run eagerly, on the card on the side stream the
        captures use (cuDNN and cuBLAS set up there before any capture)."""
        if not tokens.is_cuda:
            return self.model(tokens)
        current = torch.cuda.current_stream(tokens.device)
        side = self._side(tokens.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self.model(tokens)
        current.wait_stream(side)
        return out

    def _capture(self, entry: "_Entry"):
        """The forward over the entry's static tokens captured into the
        shared pool (on the CPU only marked captured). A failed capture
        raises and drops every graph, the stream and the pool."""
        if entry.tokens.is_cuda:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            device = entry.tokens.device
            current = torch.cuda.current_stream(device)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, pool=self._pool,
                                      stream=self._side(device)):
                    entry.out = self.model(entry.tokens)
            except BaseException:
                self._entries.clear()
                self._pool = self._stream = None
                raise
            finally:
                # a capture that fails to end leaves its stream current
                torch.cuda.set_stream(current)
            entry.graph = graph
        entry.captured = True
        self.captures += 1

    def __call__(self, tokens: torch.Tensor) -> dict:
        """tokens (1, T_ph) on the model's device -> the forward's output
        dict (predicted durations, ``t_mel = max_frames``)."""
        storage = _storage(self.model)
        if storage != self._storage:
            self._entries.clear()
            self._pool = self._stream = None
            self._storage = storage
        key = (tuple(tokens.shape), torch.backends.cudnn.allow_tf32,
               torch.backends.cuda.matmul.allow_tf32)
        entry = self._entries.get(key)
        if entry is None:
            while len(self._entries) >= self.max_graphs:
                self._entries.popitem(last=False)
            out = self._warm(tokens)
            self._entries[key] = _Entry(tokens.clone())
            self.warmups += 1
            return out
        self._entries.move_to_end(key)
        entry.tokens.copy_(tokens)
        if not entry.captured:
            self._capture(entry)
        if entry.graph is None:
            return self.model(entry.tokens)
        entry.graph.replay()
        return {k: None if v is None else v.clone()
                for k, v in entry.out.items()}


class _Entry:
    """One token count: its static tokens, and once captured its graph and
    the graph's static outputs."""

    def __init__(self, tokens: torch.Tensor):
        self.tokens = tokens
        self.captured = False
        self.graph = None
        self.out = None
