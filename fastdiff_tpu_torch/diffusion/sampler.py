"""Reverse-diffusion sampling (``fastdiff_tpu/diffusion/sampler.py``).

``sample`` is a Python loop over the N steps of the inference schedule; the
per-step constants come from ``diffusion/schedules.py``. DDPM update:

    x <- (x - beta_n / sqrt(1 - alpha_n^2) * eps(x, mel, t_n)) / sqrt(1 - beta_n)
    x <- x + sigma_n * z            (no noise after the final step)

and the DDIM variant. Noise is drawn from a ``torch.Generator`` on the
model's device, or injected as ``noise=(x_T, [z_0, ..., z_{N-1}])`` so that a
test can replay another sampler's draws.

``make_sampler`` and ``make_param_sampler`` are the twins of JAX's compiled
samplers (one ``lax.scan`` program per shape, its step compiled once): the
same loop on static buffers, run eagerly on a shape's first call and from
its second on as replays of a CUDA graph of a block of up to eight
reverse steps (``GraphSampler``), so N = 1000 costs the capture and the
memory of N = 8.
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
from fastdiff_tpu_torch.ops import lvc_block_pallas, lvc_head, wavenet_block
from fastdiff_tpu_torch.utils.profiling import span

# the launch counters of the kernels a denoiser forward can reach
COUNTERS = (lvc_head.LAUNCHES, lvc_block_ncl.LAUNCHES,
            lvc_block_pallas.LAUNCHES, downpath_pallas.LAUNCHES,
            wavenet_block.LAUNCHES)


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


def _fma(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """a * b + c of float32 arrays as one fused multiply-add: the product
    is exact in float64, and the sum is rounded to float32."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _rsqrt(x: np.ndarray) -> np.ndarray:
    """1 / sqrt(x) of a float32 array, rounded to float32 once."""
    return (1.0 / np.sqrt(x.astype(np.float64))).astype(np.float32)


def step_coefficients(constants: SamplerConstants,
                      ddim: bool) -> np.ndarray:
    """(N, 3) float32: step i's scalars of ``reverse_step``. DDPM:
    (beta / sqrt(1 - alpha^2), 1 / sqrt(1 - beta), sigma); DDIM: (c1,
    c2 + c3, 0). JAX's scan body's float32 formula as its compiler
    evaluates it: a division by a square root is a product with the
    reciprocal square root, and a product feeds the sum that consumes it
    as one fused multiply-add (1 - alpha^2, c2 + c3). Where alpha nears 1
    (the last steps of N = 200 and N = 1000), 1 - alpha^2 and c2 + c3
    cancel most of their terms, so two-rounding float32 would miss JAX's
    value by up to 2 % there. Where rounding puts DDIM's a_next above 1,
    1 - a_next^2 is held at 0 (not a NaN from its square root)."""
    beta, alpha, sigma = (np.asarray(v, np.float32) for v in
                          (constants.beta, constants.alpha, constants.sigma))
    one = np.ones_like(alpha)
    inv_root = _rsqrt(one - beta)
    if ddim:
        a_next = alpha * inv_root
        c1 = a_next / alpha
        root = np.sqrt(_fma(-alpha, alpha, one))
        c3 = np.sqrt(np.maximum(_fma(-a_next, a_next, one), np.float32(0)))
        cols = (c1, _fma(-root, c1, c3), np.zeros_like(c1))
    else:
        cols = (beta * _rsqrt(_fma(-alpha, alpha, one)), inv_root, sigma)
    return np.stack(cols, axis=1)


def reverse_step(x: torch.Tensor, eps: torch.Tensor, coef: torch.Tensor,
                 ddim: bool, z: torch.Tensor | None) -> torch.Tensor:
    """One step of the reverse process: x and the denoiser's eps -> the
    next x. ``coef`` is the step's row of ``step_coefficients`` (3,), on
    x's device; ``z`` is the step's noise draw (None on the last DDPM step
    and for DDIM)."""
    if ddim:
        return coef[0] * x + coef[1] * eps
    x = (x - coef[0] * eps) * coef[1]
    if z is not None:
        x = x + coef[2] * z
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
    coef = torch.from_numpy(step_coefficients(constants, ddim)).to(device)
    for i in range(n_steps):
        t_vec = torch.full((batch, 1), float(constants.steps[i]),
                           dtype=torch.float32, device=device)
        eps = denoise_fn(x, mel, t_vec)
        z = None
        if not ddim and i < n_steps - 1:
            z = (zs[i].to(device, torch.float32) if zs is not None
                 else torch.randn(shape, generator=generator, device=device))
        x = reverse_step(x, eps, coef[i], ddim, z)
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


MAX_BLOCK = 8       # reverse steps one captured graph holds at most


def block_steps(n_steps: int) -> int:
    """The steps one graph of the runner holds: the largest divisor of N
    up to ``MAX_BLOCK`` (all N steps for N <= 8; 8 at N = 200 and N =
    1000)."""
    return max(k for k in range(1, min(n_steps, MAX_BLOCK) + 1)
               if n_steps % k == 0)


class _Runner:
    """The reverse loop of one shape on static buffers: mel, x (x_T, then
    the state), the draws of one block of steps (none for DDIM), the step
    vectors and ``step_coefficients`` on the device, and a (B,) step index
    that each step reads and advances. The N steps run in blocks of
    ``block_steps(N)``. Its first call runs the loop eagerly (``warm``);
    from its second on each block is a replay of a CUDA graph of that many
    reverse steps (``capture``, ``replay``), as JAX's scan runs one
    compiled step N times; on the CPU the same eager loop. Two graphs a
    shape at most, a block whose steps all add their draws and the last
    block (its last step adds none; every DDIM step adds none), so the
    graphs' nodes, capture time and memory do not grow with N. A block's
    draws are made on the host's stream just before the block, from the
    generator in the order ``sample`` draws (x_T, z_0, ..., z_{N-2}), or
    copied from the injected ``noise``."""

    def __init__(self, model, constants: SamplerConstants, ddim: bool,
                 mel: torch.Tensor, audio_length: int, device):
        batch = mel.shape[0]
        self.model, self.ddim = model, ddim
        self.n_steps = constants.n_steps
        self.block = block_steps(self.n_steps)
        self.shape = (batch, audio_length, 1)
        self.mel = torch.empty(mel.shape, dtype=mel.dtype, device=device)
        self.x = torch.empty(self.shape, device=device)
        self.zs = [torch.empty(self.shape, device=device) for _ in range(
            0 if ddim else min(self.block, self.n_steps - 1))]
        self.t = torch.from_numpy(np.asarray(constants.steps, np.float32)
                                  .reshape(-1, 1)).to(device)
        self.coef = torch.from_numpy(
            step_coefficients(constants, ddim)).to(device)
        self.index = torch.zeros(batch, dtype=torch.long, device=device)
        self.captured = False
        self.graphs = {}                # block kind -> CUDAGraph
        self.rise = {}                  # block kind -> {(counter, key): n}

    def fill(self, generator, mel, noise):
        """Copy mel in, draw x_T from ``generator`` (or copy the injected
        one) and set the step index to 0."""
        with span("sampler.fill"):
            self.mel.copy_(mel)
            self.index.zero_()
            if noise is None:
                self.x.normal_(generator=generator)
                return
            x_t, _ = _check_noise(noise, self.n_steps)
            if tuple(x_t.shape) != self.shape:
                raise ValueError(
                    f"x_T shape {tuple(x_t.shape)} != {self.shape}")
            self.x.copy_(x_t)

    def _kind(self, start: int) -> tuple:
        """The block from step ``start``: whether each of its steps adds a
        draw (every DDPM step but the last)."""
        return tuple(bool(self.zs) and i < self.n_steps - 1
                     for i in range(start, start + self.block))

    def step(self, z: torch.Tensor | None):
        """One reverse step at the device's step index, in place on x."""
        t = self.t.index_select(0, self.index)
        coef = self.coef.index_select(0, self.index[:1])[0]
        eps = self.model(self.x, self.mel, t)
        self.x.copy_(reverse_step(self.x, eps, coef, self.ddim, z))
        self.index.add_(1)

    def steps(self, kind: tuple):
        """The block's steps, step j adding draw j where it adds one."""
        for j, noisy in enumerate(kind):
            self.step(self.zs[j] if noisy else None)

    def run(self, generator, noise, launch):
        """The blocks, each by ``launch(kind)``, each block's draws made
        just before it."""
        zs = None if noise is None else noise[1]
        for start in range(0, self.n_steps, self.block):
            kind = self._kind(start)
            for j, noisy in enumerate(kind):
                if noisy and zs is None:
                    self.zs[j].normal_(generator=generator)
                elif noisy:
                    self.zs[j].copy_(zs[start + j])
            launch(kind)

    def warm(self, side, generator, noise):
        """The first call: the loop run eagerly, on the card on the ``side``
        stream (it builds the kernels, lets cuDNN pick its algorithms and
        encodes the TMA maps before any capture); its output is the call's
        answer and its launches count as launches."""
        with span("sampler.warm"):
            if side is None:
                self.run(generator, noise, self.steps)
                return
            current = torch.cuda.current_stream(self.x.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                self.run(generator, noise, self.steps)
            current.wait_stream(side)

    def capture(self, pool, stream):
        """Each kind of block the loop runs captured on ``stream`` into
        ``pool`` (on the CPU, where both are None, only marked captured).
        The capture launches nothing: the counters' rise inside it is
        recorded and added on every replay of that block. A failed capture
        raises."""
        if pool is not None:
            current = torch.cuda.current_stream(stream.device)
            kinds = {self._kind(0), self._kind(self.n_steps - self.block)}
            graphs, rises = {}, {}
            try:
                for kind in sorted(kinds):
                    graphs[kind] = torch.cuda.CUDAGraph()
                    rises[kind] = {}
                    with _counts_held(rises[kind]):
                        with torch.cuda.graph(graphs[kind], pool=pool,
                                              stream=stream):
                            self.steps(kind)
            finally:
                # a capture that fails to end leaves its stream current
                torch.cuda.set_stream(current)
            self.graphs, self.rise = graphs, rises
        self.captured = True

    def replay(self, generator, noise):
        """The blocks as replays of their graphs, each adding its
        capture's launches to the counters (on the CPU: the eager loop)."""
        with span("sampler.replay"):
            if not self.graphs:
                self.run(generator, noise, self.steps)
                return

            def launch(kind):
                self.graphs[kind].replay()
                for (j, key), n in self.rise[kind].items():
                    COUNTERS[j][key] += n
            self.run(generator, noise, launch)

    def launches(self) -> dict:
        """{(counter index, key): launches} one sample's replays add."""
        total = collections.Counter()
        for start in range(0, self.n_steps, self.block):
            total.update(self.rise[self._kind(start)])
        return dict(total)


def _storage(model) -> tuple:
    return tuple(t.data_ptr() for t in itertools.chain(model.parameters(),
                                                       model.buffers()))


class GraphSampler:
    """``sample(generator, mel, audio_length, *, noise=None)`` with the
    model's current weights: ``sample``'s loop on static buffers, one
    runner per (mel shape and dtype, audio length, ddim, ``use_kernels``,
    TF32 settings). The first call at a shape runs the loop eagerly and
    answers with its output; the second captures its blocks of reverse
    steps as CUDA graphs on a CUDA model (``_Runner``), and every call from
    then on replays them, N / ``block_steps(N)`` replays a call. A shape
    that comes once costs one eager run, not a capture. A failed capture raises
    (nothing falls back to the eager loop) and leaves the sampler on a new
    capture stream and pool. On a CPU model the same runners run eagerly.

    A call fills the runner's buffers (``_Runner.fill``), runs, and returns
    a clone of the static output, which the next replay overwrites. With a
    generator of the same seed it draws what ``sample`` draws. All graphs
    share one memory pool; at most ``max_graphs`` shapes are kept, the
    least recently used evicted (its graphs' memory goes back to the
    pool; ``evictions`` counts them). Before every call the storage of
    every parameter and buffer is compared with the last call's: when it
    moved (``load_state_dict(..., assign=True)``, ``.to``), every runner is
    dropped (``recaptures`` counts the drops) and the shapes start again
    from their first call. Calls must not overlap (the server serializes
    them). The launch counters rise on every block replayed by the
    launches its graph holds.

    Under ``torch.profiler`` a call is the span ``sampler.call`` holding
    ``sampler.lookup`` (storage scan, key, LRU move or eviction), then
    ``sampler.fill`` and ``sampler.warm`` (first call), or ``sampler.fill``,
    ``sampler.capture`` (second call only) and ``sampler.replay``, then
    ``sampler.clone``; none is opened inside a captured region."""

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
        self.evictions = 0

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
        """The kernel launches one call's replays at this call's shape add
        to the counters ({counter key: launches}), as recorded at the
        capture of its blocks; None when no graph of that shape is held."""
        runner = self._runners.get(self._shape_key(mel, audio_length))
        if runner is None or not runner.graphs:
            return None
        return {key: n for (_, key), n in runner.launches().items()}

    def _side(self, device: torch.device):
        if device.type != "cuda":
            return None
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def _capture(self, key, runner):
        with span("sampler.capture"):
            pool = None
            if runner.x.is_cuda:
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                pool = self._pool
            try:
                runner.capture(pool, self._side(runner.x.device))
            except BaseException:
                # the failed capture's stream and pool may be left unusable
                del self._runners[key]
                self._pool = self._stream = None
                raise
            self.captures += 1

    def __call__(self, generator, mel: torch.Tensor, audio_length: int, *,
                 noise: tuple | None = None) -> torch.Tensor:
        with span("sampler.call"):
            with torch.inference_mode():
                with span("sampler.lookup"):
                    key = self._key(mel, audio_length)
                    runner = self._runners.get(key)
                    if runner is None:
                        while len(self._runners) >= self.max_graphs:
                            self._runners.popitem(last=False)
                            self.evictions += 1
                    else:
                        self._runners.move_to_end(key)
                if runner is None:
                    device = self._device()
                    runner = _Runner(self.model, self.constants, self.ddim,
                                     mel, int(audio_length), device)
                    runner.fill(generator, mel, noise)
                    runner.warm(self._side(device), generator, noise)
                    self._runners[key] = runner  # kept once its warm-up ran
                    self.warmups += 1
                else:
                    runner.fill(generator, mel, noise)
                    if not runner.captured:
                        self._capture(key, runner)
                    runner.replay(generator, noise)
            with span("sampler.clone"):
                return runner.x.clone()


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
