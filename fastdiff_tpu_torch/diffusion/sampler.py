"""Reverse-diffusion sampling (``fastdiff_tpu/diffusion/sampler.py``).

``sample`` is a Python loop over the N steps of the inference schedule; the
per-step constants come from ``diffusion/schedules.py``. DDPM update:

    x <- (x - beta_n / sqrt(1 - alpha_n^2) * eps(x, mel, t_n)) / sqrt(1 - beta_n)
    x <- x + sigma_n * z            (no noise after the final step)

and the DDIM variant. Noise is drawn from a ``torch.Generator`` on the
model's device, or injected as ``noise=(x_T, [z_0, ..., z_{N-1}])`` so that a
test can replay another sampler's draws.

``make_sampler`` and ``make_param_sampler`` are the twins of JAX's compiled
samplers (one ``lax.scan`` program per shape): the same loop on static
buffers, run eagerly on a shape's first call and from its second on
captured on the card as one CUDA graph per shape and replayed
(``GraphSampler``).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
from typing import Callable

import numpy as np
import torch

from fastdiff_tpu_torch.config import DiffusionConfig
from fastdiff_tpu_torch.diffusion import schedules
from fastdiff_tpu_torch.diffusion.schedules import SamplerConstants
from fastdiff_tpu_torch.ops import downpath_pallas, lvc_block_ncl
from fastdiff_tpu_torch.ops import lvc_block_pallas, lvc_head

# the launch counters of the kernels a denoiser forward can reach
COUNTERS = (lvc_head.LAUNCHES, lvc_block_ncl.LAUNCHES,
            lvc_block_pallas.LAUNCHES, downpath_pallas.LAUNCHES)


def constants_for_hparams(hp: dict) -> SamplerConstants:
    """Sampler constants for the hparams' ``noise_schedule`` / ``N`` over
    the training schedule (``T``, ``beta_0``, ``beta_T``)."""
    hyper = schedules.compute_hyperparams_given_schedule(
        schedules.linear_beta_schedule(DiffusionConfig.from_hparams(hp)))
    return schedules.sampler_constants_for_schedule(
        schedules.resolve_noise_schedule(hp), hyper)


def inference_generator(seed: int = 0, device="cuda") -> torch.Generator:
    """The generator of the inference paths' noise (the twin of
    ``inference_key``): seeded with ``seed``, on ``device``, the card unless
    the caller names another."""
    from fastdiff_tpu_torch.models.fastdiff import checked_device
    return torch.Generator(device=checked_device(device)).manual_seed(
        int(seed))


def split(generator: torch.Generator) -> torch.Generator:
    """A new generator on ``generator``'s device seeded from one draw of
    ``generator`` (the twin of taking a fresh ``jax.random.split`` key):
    successive calls give different generators."""
    seed = torch.randint(0, 2 ** 62, (), generator=generator,
                         device=generator.device)
    return torch.Generator(device=generator.device).manual_seed(int(seed))


def fold_in(generator: torch.Generator, index: int) -> torch.Generator:
    """A new generator on ``generator``'s device seeded from its initial
    seed and ``index`` (the twin of ``jax.random.fold_in``): like a JAX key,
    it depends only on that seed and the index, never on what was drawn
    from ``generator``, so a stream folds indices into a generator of its
    own (``split``)."""
    seed = np.random.SeedSequence(
        [generator.initial_seed(), int(index)]).generate_state(1, np.uint64)
    return torch.Generator(device=generator.device).manual_seed(int(seed[0]))


def _f32(v) -> np.float32:
    return np.float32(v)


def reverse_step(x: torch.Tensor, eps: torch.Tensor, i: int,
                 constants: SamplerConstants, ddim: bool,
                 z: torch.Tensor | None) -> torch.Tensor:
    """Step ``i`` of the reverse process: x and the denoiser's eps -> the
    next x; ``z`` is the step's noise draw (None on the last DDPM step and
    for DDIM). The step constants are combined in float32, as in the JAX
    scan body."""
    one = _f32(1.0)
    b_n, a_n = _f32(constants.beta[i]), _f32(constants.alpha[i])
    if ddim:
        a_next = a_n / np.sqrt(one - b_n)
        c1 = a_next / a_n
        c2 = -np.sqrt(one - a_n * a_n) * c1
        c3 = np.sqrt(one - a_next * a_next)
        return float(c1) * x + float(c2 + c3) * eps
    x = x - float(b_n / np.sqrt(one - a_n * a_n)) * eps
    x = x / float(np.sqrt(one - b_n))
    if z is not None:
        x = x + float(constants.sigma[i]) * z
    return x


def _check_noise(noise, n_steps: int):
    x_t, zs = noise
    if len(zs) != n_steps:
        raise ValueError(f"noise has {len(zs)} step draws, the schedule "
                         f"has {n_steps} steps")
    return x_t, zs


def sample(denoise_fn: Callable, mel: torch.Tensor,
           constants: SamplerConstants, audio_length: int, *,
           ddim: bool = False, generator: torch.Generator | None = None,
           noise: tuple | None = None) -> torch.Tensor:
    """mel (B, T', n_mels) -> waveform (B, audio_length, 1) float32.

    ``denoise_fn(x (B, L, 1), mel, t (B, 1)) -> eps``. Either ``generator``
    (on mel's device) draws x_T and the per-step noise, or ``noise`` gives
    them: ``(x_T (B, L, 1), [z_i (B, L, 1) for each of the N steps])``."""
    batch = mel.shape[0]
    device = mel.device
    shape = (batch, audio_length, 1)
    n_steps = constants.n_steps
    zs = None
    if noise is not None:
        x, zs = _check_noise(noise, n_steps)
        x = x.to(device, torch.float32)
    else:
        x = torch.randn(shape, generator=generator, device=device)
    if tuple(x.shape) != shape:
        raise ValueError(f"x_T shape {tuple(x.shape)} != {shape}")
    for i in range(n_steps):
        t_vec = torch.full((batch, 1), float(constants.steps[i]),
                           dtype=torch.float32, device=device)
        eps = denoise_fn(x, mel, t_vec)
        z = None
        if not ddim and i < n_steps - 1:
            z = (zs[i].to(device, torch.float32) if zs is not None
                 else torch.randn(shape, generator=generator, device=device))
        x = reverse_step(x, eps, i, constants, ddim, z)
    return x


def _counts() -> list:
    return [dict(counter) for counter in COUNTERS]


@contextlib.contextmanager
def _counts_held(rise: dict):
    """Leave every launch counter as it was before the block, and record
    in ``rise`` how much each rose inside it."""
    before = _counts()
    try:
        yield
    finally:
        for j, (counter, saved) in enumerate(zip(COUNTERS, before)):
            for key, value in counter.items():
                if value != saved.get(key, 0):
                    rise[j, key] = value - saved.get(key, 0)
            counter.update(saved)


class _Runner:
    """The reverse loop of one shape on static buffers: mel, x_T, the
    N - 1 step draws (none for DDIM) and the (B, 1) step vectors. Its first
    call runs the loop eagerly (``warm``); from its second on it runs a
    CUDA graph of the loop on the card (``capture``, ``replay``), the same
    eager loop on the CPU."""

    def __init__(self, model, constants: SamplerConstants, ddim: bool,
                 mel: torch.Tensor, audio_length: int, device):
        batch = mel.shape[0]
        n_steps = constants.n_steps
        self.model, self.constants, self.ddim = model, constants, ddim
        self.shape = (batch, audio_length, 1)
        self.mel = torch.empty(mel.shape, dtype=mel.dtype, device=device)
        self.x_t = torch.empty(self.shape, device=device)
        self.zs = [torch.empty(self.shape, device=device)
                   for _ in range(0 if ddim else n_steps - 1)]
        self.t = [torch.full((batch, 1), float(constants.steps[i]),
                             dtype=torch.float32, device=device)
                  for i in range(n_steps)]
        self.captured = False
        self.graph = None
        self.out = None
        self.rise = {}                  # (counter index, key) -> launches

    def fill(self, generator, mel, noise):
        """Copy mel in, and x_T and the step draws: from ``generator`` in
        the order ``sample`` draws them (x_T, z_0, ..., z_{N-2}), or from
        the injected ``noise``."""
        self.mel.copy_(mel)
        if noise is None:
            for buf in [self.x_t] + self.zs:
                buf.normal_(generator=generator)
            return
        x_t, zs = _check_noise(noise, self.constants.n_steps)
        if tuple(x_t.shape) != self.shape:
            raise ValueError(f"x_T shape {tuple(x_t.shape)} != {self.shape}")
        for buf, src in zip([self.x_t] + self.zs, [x_t] + list(zs)):
            buf.copy_(src)

    def body(self) -> torch.Tensor:
        x = self.x_t
        for i in range(self.constants.n_steps):
            eps = self.model(x, self.mel, self.t[i])
            z = self.zs[i] if i < len(self.zs) else None
            x = reverse_step(x, eps, i, self.constants, self.ddim, z)
        return x

    def warm(self, side):
        """The first call: the loop run eagerly, on the card on the ``side``
        stream (it builds the kernels, lets cuDNN pick its algorithms and
        encodes the TMA maps before any capture); its output is the call's
        answer and its launches count as launches."""
        if side is None:
            self.out = self.body()
            return
        current = torch.cuda.current_stream(self.x_t.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.out = self.body()
        current.wait_stream(side)

    def capture(self, pool, stream):
        """The loop captured on ``stream`` into ``pool`` (on the CPU, where
        both are None, only marked captured). The capture launches nothing:
        the counters' rise inside it is recorded and added on every replay.
        A failed capture raises."""
        if pool is not None:
            current = torch.cuda.current_stream(stream.device)
            graph = torch.cuda.CUDAGraph()
            rise = {}
            try:
                with _counts_held(rise):
                    with torch.cuda.graph(graph, pool=pool, stream=stream):
                        out = self.body()
            finally:
                # a capture that fails to end leaves its stream current
                torch.cuda.set_stream(current)
            self.graph, self.rise, self.out = graph, rise, out
        self.captured = True

    def replay(self):
        """Replay the graph (on the CPU: run the body, its launches
        counted as a replay's) and add the capture's launches."""
        if self.graph is not None:
            self.graph.replay()
        else:
            self.rise = {}
            with _counts_held(self.rise):
                self.out = self.body()
        for (j, key), n in self.rise.items():
            COUNTERS[j][key] += n


def _storage(model) -> tuple:
    return tuple(t.data_ptr() for t in itertools.chain(model.parameters(),
                                                       model.buffers()))


class GraphSampler:
    """``sample(generator, mel, audio_length, *, noise=None)`` with the
    model's current weights: ``sample``'s loop on static buffers, one
    runner per (mel shape and dtype, audio length, ddim, ``use_kernels``,
    TF32 settings). The first call at a shape runs the loop eagerly and
    answers with its output; the second captures it as one CUDA graph on a
    CUDA model, and every call from then on replays it. A shape that comes
    once costs one eager run, not a capture. A failed capture raises
    (nothing falls back to the eager loop) and leaves the sampler on a new
    capture stream and pool. On a CPU model the same runners run eagerly.

    A call fills the runner's buffers (``_Runner.fill``), runs, and returns
    a clone of the static output, which the next replay overwrites. With a
    generator of the same seed it draws what ``sample`` draws. All graphs
    share one memory pool; at most ``max_graphs`` shapes are kept, the
    least recently used evicted (its graph's memory goes back to the
    pool). Before every call the storage of every parameter and buffer is
    compared with the last call's: when it moved (``load_state_dict(...,
    assign=True)``, ``.to``), every runner is dropped (``recaptures``
    counts the drops) and the shapes start again from their first call.
    Calls must not overlap (the server serializes them). The launch
    counters rise on every replay by the launches the graph holds."""

    def __init__(self, model, constants: SamplerConstants,
                 ddim: bool = False, max_graphs: int = 8):
        if max_graphs < 1:
            raise ValueError(f"max_graphs must be >= 1, got {max_graphs}")
        self.model, self.constants, self.ddim = model, constants, ddim
        self.max_graphs = max_graphs
        self._runners = collections.OrderedDict()
        self._storage = None
        self._pool = None
        self._stream = None             # warm-up runs' and captures'
        self.warmups = 0
        self.captures = 0
        self.recaptures = 0

    @property
    def graphs_cached(self) -> int:
        return sum(runner.captured for runner in self._runners.values())

    def _device(self) -> torch.device:
        tensor = next(itertools.chain(self.model.parameters(),
                                      self.model.buffers()), None)
        if tensor is None:
            raise ValueError("the sampler's model has no parameter or buffer "
                             "to place its buffers by")
        return tensor.device

    def _shape_key(self, mel: torch.Tensor, audio_length: int) -> tuple:
        return (tuple(mel.shape), mel.dtype, int(audio_length), self.ddim,
                getattr(self.model, "use_kernels", True),
                torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)

    def _key(self, mel: torch.Tensor, audio_length: int) -> tuple:
        """The runner key of a call; drops every runner first when the
        model's storage moved since the last call."""
        storage = _storage(self.model)
        if storage != self._storage:
            if self._runners:
                self.recaptures += 1
            self._runners.clear()
            self._pool = self._stream = None
            self._storage = storage
        return self._shape_key(mel, audio_length)

    def replay_launches(self, mel: torch.Tensor, audio_length: int) -> dict:
        """The kernel launches one replay at this call's shape adds to the
        counters ({counter key: launches}), as recorded at its capture;
        None when no graph of that shape is held."""
        runner = self._runners.get(self._shape_key(mel, audio_length))
        if runner is None or runner.graph is None:
            return None
        return {key: n for (_, key), n in runner.rise.items()}

    def _side(self, device: torch.device):
        if device.type != "cuda":
            return None
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def _capture(self, key, runner):
        pool = None
        if runner.x_t.is_cuda:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            pool = self._pool
        try:
            runner.capture(pool, self._side(runner.x_t.device))
        except BaseException:
            # the failed capture's stream and pool may be left unusable
            del self._runners[key]
            self._pool = self._stream = None
            raise
        self.captures += 1

    def __call__(self, generator, mel: torch.Tensor, audio_length: int, *,
                 noise: tuple | None = None) -> torch.Tensor:
        with torch.inference_mode():
            key = self._key(mel, audio_length)
            runner = self._runners.get(key)
            if runner is None:
                while len(self._runners) >= self.max_graphs:
                    self._runners.popitem(last=False)
                device = self._device()
                runner = _Runner(self.model, self.constants, self.ddim, mel,
                                 int(audio_length), device)
                runner.fill(generator, mel, noise)
                runner.warm(self._side(device))
                self._runners[key] = runner     # kept once its warm-up ran
                self.warmups += 1
            else:
                self._runners.move_to_end(key)
                runner.fill(generator, mel, noise)
                if not runner.captured:
                    self._capture(key, runner)
                runner.replay()
        return runner.out.clone()


class ParamGraphSampler(GraphSampler):
    """``sample(state_dict, generator, mel, audio_length, *, noise=None)``:
    a ``state_dict`` that is not None is loaded into the model in place
    (``FastDiff.load_state_dict`` keeps every parameter's and buffer's
    storage) before the replay, so one graph serves every checkpoint or
    EMA snapshot, as JAX's params-traced executable does."""

    def __call__(self, state_dict, generator, mel: torch.Tensor,
                 audio_length: int, *,
                 noise: tuple | None = None) -> torch.Tensor:
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        return super().__call__(generator, mel, audio_length, noise=noise)


def make_sampler(model, constants: SamplerConstants, ddim: bool = False,
                 max_graphs: int = 8) -> GraphSampler:
    """``sample(generator, mel, audio_length, *, noise=None) -> wav`` over
    ``model``'s current weights, one CUDA graph per shape (``GraphSampler``);
    the twin of JAX's closure sampler."""
    return GraphSampler(model, constants, ddim=ddim, max_graphs=max_graphs)


def make_param_sampler(model, constants: SamplerConstants,
                       ddim: bool = False,
                       max_graphs: int = 8) -> ParamGraphSampler:
    """``sample(state_dict, generator, mel, audio_length, *, noise=None)
    -> wav``: one graph per shape across states (``ParamGraphSampler``);
    the twin of JAX's params-traced sampler."""
    return ParamGraphSampler(model, constants, ddim=ddim,
                             max_graphs=max_graphs)
