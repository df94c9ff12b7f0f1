"""The port's graph sampler (``make_sampler`` / ``make_param_sampler``)
against the JAX package's compiled samplers and the port's eager ``sample``.

Small config (C = 8, ratios 4/2/2, f32) at 16 frames on the CPU, where the
runner runs its static-buffer loop eagerly with the same keys, first-call
warm-up, second-call capture, cache and eviction as on the card. Tolerances: 1e-3 against JAX with its draws
injected (each step divides by sqrt(1 - beta), which grows earlier
errors, as ``tests/test_torch_model.py``); bit for bit against the eager
sampler with a generator of the same seed, and between samplers on the
same weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdiff_tpu.config import DiffusionConfig, ModelConfig
from fastdiff_tpu.diffusion import schedules
from fastdiff_tpu.diffusion.sampler import \
    make_param_sampler as jax_make_param_sampler
from fastdiff_tpu.models.fastdiff import get_apply_fn, init_fastdiff
from fastdiff_tpu_torch.config import ModelConfig as PortModelConfig
from fastdiff_tpu_torch.diffusion import sampler as port_sampler
from fastdiff_tpu_torch.diffusion.sampler import (fold_in,
                                                  inference_generator,
                                                  make_param_sampler,
                                                  make_sampler, sample, split)
from fastdiff_tpu_torch.models.bridge import params_from_jax
from fastdiff_tpu_torch.models.fastdiff import FastDiff
from fastdiff_tpu_torch.serving.server import VocoderService

ARCH = dict(inner_channels=8, cond_channels=16, upsample_ratios=(4, 2, 2),
            kpnet_hidden_channels=8, diffusion_step_embed_dim_in=16,
            diffusion_step_embed_dim_mid=32, diffusion_step_embed_dim_out=32,
            compute_dtype="float32")
SMALL = ModelConfig(**ARCH)
PORT_SMALL = PortModelConfig(**ARCH)
FRAMES = 16
LENGTH = FRAMES * PORT_SMALL.total_hop


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch intra-op thread: the suite runs several workers on the
    machine's cores, and torch's CPU kernels oversubscribe them (a 60-step
    training test took 135 s under five busy neighbours, 0.8 s with one
    thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _constants(n=4):
    hyper = schedules.compute_hyperparams_given_schedule(
        schedules.linear_beta_schedule(DiffusionConfig()))
    return schedules.sampler_constants_for_schedule(
        schedules.noise_schedule_for_steps(n), hyper)


CONST = _constants()


def _mel(b=1, seed=0, frames=FRAMES):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(b, frames, 16))
                            .astype(np.float32))


def _state(seed, cfg=PORT_SMALL, **route):
    return FastDiff(cfg, seed=seed, **route).state_dict()


def _model(seed, cfg=PORT_SMALL, **route):
    return FastDiff(cfg, seed=seed, **route).eval()


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _eager(model, mel, gen, ddim=False, length=LENGTH, const=CONST):
    with torch.no_grad():
        return sample(model, mel, const, length, ddim=ddim, generator=gen)


def _jax_step_coefficients(const, ddim):
    """The (N, 3) scalars JAX's scan body combines at each step
    (``fastdiff_tpu/diffusion/sampler.py:reverse_step``, under jit, in
    float32), in the port's ``step_coefficients`` layout; the division by
    sqrt(1 - beta) as its reciprocal, the factor the port multiplies by."""
    beta, alpha, sigma = (jnp.asarray(np.asarray(v, np.float32))
                          for v in (const.beta, const.alpha, const.sigma))

    def body(_, i):
        b_n, a_n = beta[i], alpha[i]
        if ddim:
            a_next = a_n / jnp.sqrt(1.0 - b_n)
            c1 = a_next / a_n
            c2 = -jnp.sqrt(1.0 - a_n ** 2) * c1
            c3 = jnp.sqrt(1.0 - a_next ** 2)
            return None, jnp.stack([c1, c2 + c3, 0.0 * c1])
        return None, jnp.stack([b_n / jnp.sqrt(1.0 - a_n ** 2),
                                1.0 / jnp.sqrt(1.0 - b_n), sigma[i]])
    steps = jnp.arange(const.n_steps)
    return np.asarray(jax.jit(lambda: jax.lax.scan(body, None, steps)[1])())


@pytest.mark.parametrize("n_steps", [4, 200, 1000])
@pytest.mark.parametrize("ddim", [False, True])
def test_param_sampler_matches_jax_with_injected_noise(ddim, n_steps):
    """make_param_sampler(state_dict, ...) against JAX's
    make_param_sampler(params, key, mel, L), the JAX draws reproduced from
    its key (split as in its sampler) and injected; 1e-3, at the
    reference's N = 4 and at its full reverse processes, N = 200 and
    N = 1000. The largest error, at N = 1000 (DDPM, |x| up to 1.6e4 from
    the untrained model): 0.73 of the bound; DDIM at N = 1000: 1.3e-3
    absolute on |x| up to 383, 0.15 of the bound."""
    const = _constants(n_steps)
    params = init_fastdiff(jax.random.PRNGKey(0), SMALL)
    mel = _mel(seed=3)
    key = jax.random.PRNGKey(7)
    ref = jax_make_param_sampler(get_apply_fn(SMALL), const, ddim=ddim)(
        params, key, jnp.asarray(mel.numpy()), LENGTH)
    key, sub = jax.random.split(key)
    shape = (1, LENGTH, 1)
    x_t = torch.from_numpy(np.array(jax.random.normal(sub, shape)))
    zs = [torch.from_numpy(np.array(jax.random.normal(k, shape)))
          for k in jax.random.split(key, const.n_steps)]
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                            PORT_SMALL)
    run = make_param_sampler(FastDiff(PORT_SMALL, seed=None).eval(), const,
                             ddim=ddim)
    out = run(state, None, mel, LENGTH, noise=(x_t, zs))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("n_steps", [4, 200, 1000])
@pytest.mark.parametrize("ddim", [False, True])
def test_step_coefficients_match_the_jax_scan(ddim, n_steps):
    """The port's step scalars against those JAX's compiled scan body
    combines, 1e-3 relative, and finite. Largest difference: 3.3e-4, DDIM's
    c2 + c3 at the last steps of N = 1000, where XLA's reciprocal square
    root differs from the correctly rounded one by an ulp and the sum
    cancels all but ~1e-3 of its terms; two-rounding float32 arithmetic
    misses by 2.4 % there, float64 by 0.8 %."""
    const = _constants(n_steps)
    got = port_sampler.step_coefficients(const, ddim)
    assert got.dtype == np.float32 and got.shape == (n_steps, 3)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _jax_step_coefficients(const, ddim),
                               rtol=1e-3, atol=0)


@pytest.mark.parametrize("n_steps,block", [(4, 4), (6, 6), (200, 8),
                                           (1000, 8), (12, 6), (11, 1)])
def test_block_steps(n_steps, block):
    """A graph holds the largest divisor of N up to eight steps."""
    assert port_sampler.block_steps(n_steps) == block


@pytest.mark.parametrize("n_steps", [4, 200])
@pytest.mark.parametrize("ddim,batch", [(False, 1), (True, 1), (False, 2)])
def test_runner_draws_what_the_eager_sampler_draws(ddim, batch, n_steps):
    """A generator of the same seed: bit for bit, on the first call (the
    warm-up), the second (the capture) and a later one at the same
    shape, at N = 4 and at the full reverse process of N = 200."""
    const = _constants(n_steps)
    model = _model(0)
    mel = _mel(batch, seed=1)
    run = make_sampler(model, const, ddim=ddim)
    for i, seed in enumerate((5, 6, 7)):
        want = _eager(model, mel, _gen(seed), ddim, const=const)
        got = run(_gen(seed), mel, LENGTH)
        assert got.shape == (batch, LENGTH, 1)
        assert torch.equal(got, want)
        assert run.warmups == 1 and run.captures == min(i, 1)
    assert run.graphs_cached == 1


def test_injected_noise_matches_eager():
    model = _model(0)
    mel = _mel(seed=2)
    rng = np.random.default_rng(4)
    draws = [torch.from_numpy(rng.normal(size=(1, LENGTH, 1))
                              .astype(np.float32))
             for _ in range(1 + CONST.n_steps)]
    noise = (draws[0], draws[1:])
    with torch.no_grad():
        want = sample(model, mel, CONST, LENGTH, noise=noise)
    got = make_sampler(model, CONST)(None, mel, LENGTH, noise=noise)
    assert torch.equal(got, want)


def test_two_states_one_cache_entry():
    """Mirrors tests/test_sampler_caching.py:test_two_states_one_trace: two
    states through one entry, no new capture, different audio, each equal
    to the eager sampler of a model built on that state."""
    states = [_state(0), _state(1)]
    run = make_param_sampler(_model(None), CONST)
    mel = _mel(seed=0)
    outs = [run(sd, _gen(42), mel, LENGTH) for sd in states]
    assert run.captures == 1 and run.graphs_cached == 1
    assert run.recaptures == 0
    assert not torch.allclose(outs[0], outs[1])
    for sd, out in zip(states, outs):
        model = FastDiff(PORT_SMALL, seed=None)
        model.load_state_dict(sd)
        assert torch.equal(out, _eager(model.eval(), mel, _gen(42)))
        assert torch.isfinite(out).all()


def test_sampler_matches_param_sampler():
    """Mirrors tests/test_sampler_caching.py:
    test_param_sampler_matches_closure_sampler: the closure sampler and the
    params sampler on the same weights and seed, bit for bit."""
    model = _model(0)
    mel = _mel(seed=0)
    a = make_sampler(model, CONST)(_gen(7), mel, LENGTH)
    b = make_param_sampler(_model(None), CONST)(model.state_dict(), _gen(7),
                                                mel, LENGTH)
    assert torch.equal(a, b)


@pytest.mark.parametrize("route", [dict(infer_route="ncl"),
                                   dict(infer_route="nwc", down_kernel=True),
                                   dict(infer_route="ncl_fh")])
def test_load_state_dict_keeps_every_packed_buffer(route):
    """After load_state_dict every parameter and packed buffer keeps its
    storage, and each packed buffer equals a fresh model's packing."""
    model = _model(0, **route)
    ptrs = {name: t.data_ptr() for name, t in
            list(model.named_parameters()) + list(model.named_buffers())}
    assert any(not n.endswith(("weight", "bias")) for n in ptrs)
    state = _state(1, **route)
    model.load_state_dict(state)
    fresh = FastDiff(PORT_SMALL, seed=None, **route)
    fresh.load_state_dict(state)
    fresh_buffers = dict(fresh.named_buffers())
    for name, t in list(model.named_parameters()) + \
            list(model.named_buffers()):
        assert t.data_ptr() == ptrs[name], name
    for name, t in model.named_buffers():
        assert torch.equal(t, fresh_buffers[name]), name


def test_reload_follows_new_weights_and_assign_recaptures():
    """A reload after capture replays the new weights through the same
    entry; load_state_dict(assign=True) moves the storage, so the graphs
    are dropped (counted) and the shape starts again from its warm-up, and
    the output still matches the eager sampler."""
    model = _model(0)
    run = make_sampler(model, CONST)
    mel = _mel(seed=5)
    run(_gen(1), mel, LENGTH)
    run(_gen(1), mel, LENGTH)
    model.load_state_dict(_state(1))
    assert torch.equal(run(_gen(1), mel, LENGTH),
                       _eager(_model(1), mel, _gen(1)))
    assert run.captures == 1 and run.recaptures == 0
    model.load_state_dict({k: v.clone() for k, v in _state(2).items()},
                          assign=True)
    want = _eager(_model(2), mel, _gen(1))
    assert torch.equal(run(_gen(1), mel, LENGTH), want)
    assert run.recaptures == 1 and run.graphs_cached == 0
    assert run.warmups == 2 and run.captures == 1
    assert torch.equal(run(_gen(1), mel, LENGTH), want)
    assert run.captures == 2 and run.graphs_cached == 1


class _StubDenoiser(torch.nn.Module):
    """eps = 0.1 x + 0.01 mel mean per sample; one launch of ``counter``'s
    "stub" per call, as a kernel wrapper counts its launch."""

    def __init__(self, hop, counter):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.tensor(0.1))
        self.hop, self.counter = hop, counter

    def forward(self, x, mel, t):
        self.counter["stub"] += 1
        cond = torch.repeat_interleave(mel.mean(-1, keepdim=True), self.hop,
                                       dim=1)
        return self.scale * x + 0.01 * cond


def test_lru_eviction_and_launch_accounting(monkeypatch):
    """At most max_graphs entries, the least recently used evicted; a
    shape's first call warms, its second captures; every call (warm-up and
    capture included) raises the counters by the launches one run holds,
    N per call, and nothing else."""
    counter = {"stub": 0}
    monkeypatch.setattr(port_sampler, "COUNTERS", (counter,))
    run = make_sampler(_StubDenoiser(4, counter), CONST, max_graphs=2)
    calls = [8, 9, 8, 10, 10, 9, 8, 8]
    for i, frames in enumerate(calls):
        out = run(_gen(0), _mel(frames=frames), frames * 4)
        assert out.shape == (1, frames * 4, 1)
        assert counter["stub"] == (i + 1) * CONST.n_steps
    # 8, 9 warmed; 8 captured; 10 evicts 9, then is captured; 9 evicts 8;
    # 8 evicts 10, then is captured
    assert run.warmups == 5 and run.captures == 3
    assert run.graphs_cached == 1
    assert [k[0][1] for k in run._runners] == [9, 8]


def test_counts_held_restores_on_error(monkeypatch):
    counter = {"stub": 3}
    monkeypatch.setattr(port_sampler, "COUNTERS", (counter,))
    rise = {}
    with pytest.raises(RuntimeError):
        with port_sampler._counts_held(rise):
            counter["stub"] += 5
            raise RuntimeError("capture failed")
    assert counter == {"stub": 3} and rise == {(0, "stub"): 5}


def test_failed_capture_raises_and_drops_the_entry(monkeypatch):
    """A capture that raises drops its entry and the capture stream and
    pool, counts no capture, and the next calls at that shape warm and
    capture again and match the eager loop."""
    counter = {"stub": 0}
    monkeypatch.setattr(port_sampler, "COUNTERS", (counter,))
    model = _StubDenoiser(4, counter)
    run = make_sampler(model, CONST)
    mel = _mel(frames=8)
    failing = port_sampler._Runner.capture

    def capture(self, pool, stream):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(port_sampler._Runner, "capture", capture)
    run(_gen(0), mel, 32)
    run._pool = run._stream = object()
    with pytest.raises(RuntimeError, match="capture failed"):
        run(_gen(0), mel, 32)
    assert not run._runners and run._pool is None and run._stream is None
    assert run.captures == 0
    monkeypatch.setattr(port_sampler._Runner, "capture", failing)
    want = _eager(model, mel, _gen(2), length=32)
    for _ in range(2):
        assert torch.equal(run(_gen(2), mel, 32), want)
    assert run.warmups == 2 and run.captures == 1


def test_replay_launches():
    """replay_launches is None for a shape with no graph (on the CPU no
    shape has one)."""
    run = make_sampler(_model(0), CONST)
    mel = _mel(seed=0)
    assert run.replay_launches(mel, LENGTH) is None
    run(_gen(0), mel, LENGTH)
    run(_gen(0), mel, LENGTH)
    assert run.replay_launches(mel, LENGTH) is None


def test_max_graphs_must_be_positive():
    with pytest.raises(ValueError, match="max_graphs"):
        make_sampler(_model(0), CONST, max_graphs=0)


def test_generators():
    """inference_generator seeds a generator; fold_in depends only on the
    initial seed and the index, never on what was drawn; split draws from
    its generator, so successive splits differ and equal seeds split
    alike."""
    g = inference_generator(3, "cpu")
    assert g.initial_seed() == 3 and g.device.type == "cpu"
    first = torch.randn(4, generator=fold_in(g, 1))
    torch.randn(100, generator=g)
    assert torch.equal(torch.randn(4, generator=fold_in(g, 1)), first)
    assert not torch.equal(torch.randn(4, generator=fold_in(g, 2)), first)
    assert not torch.equal(
        torch.randn(4, generator=fold_in(inference_generator(4, "cpu"), 1)),
        first)
    a, b = split(g), split(g)
    assert a.initial_seed() != b.initial_seed()
    assert split(_gen(5)).initial_seed() == split(_gen(5)).initial_seed()


def test_server_metrics_count_graphs():
    """The server's sampler keeps at most max_graphs frame counts; warm-up
    captures its shape; /metrics counts the graphs held, the captures and
    the first-call warm-ups."""
    hp = dict(ARCH, upsample_ratios=[4, 2, 2], audio_num_mel_bins=16, N=4,
              seed=3)
    service = VocoderService(hp, device="cpu", max_graphs=2)
    service.warmup(frames=4)
    assert service.metrics()["graph_captures"] == 1
    for frames in (5, 6, 5):
        wav = service.vocode(np.zeros((frames, 16), np.float32))
        assert wav.shape == (frames * 16,)
    metrics = service.metrics()
    # 4 warmed and captured; 5 warmed; 6 evicts 4; 5 captured
    assert metrics["graph_warmups"] == 3 and metrics["graph_captures"] == 2
    assert metrics["graphs_cached"] == 1
