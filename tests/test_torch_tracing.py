"""The port's program spans (``utils/profiling.py:span``) in the batch
vocoder and the graph sampler, the sampler's eviction count and the
server's queue wait, on the CPU.

With no profiler running a span enters no ``RecordFunction``; under
``torch.profiler`` every call yields one ``vocoder.vocode`` span holding
each stack's ``vocoder.stack`` / ``vocoder.fetch`` / ``vocoder.trim`` and
the sampler's ``sampler.call``, which holds that call's phases."""

import collections
import http.client
import json
import threading
import time

import numpy as np
import pytest
import torch

from fastdiff_tpu_torch.config import DiffusionConfig
from fastdiff_tpu_torch.diffusion import schedules
from fastdiff_tpu_torch.diffusion.sampler import make_sampler, sample
from fastdiff_tpu_torch.serving.batch_vocoder import BatchedVocoder
from fastdiff_tpu_torch.serving.server import VocoderService, start_server
from fastdiff_tpu_torch.utils import profiling

HOP = 4
FRAMES = (5, 12, 7)     # buckets of 8: 8 (5, 7) and 16 (12)
VOCODER_SPANS = ("vocoder.stack", "vocoder.fetch", "vocoder.trim")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch intra-op thread: the suite runs several workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _constants(n=4):
    hp = schedules.compute_hyperparams_given_schedule(
        schedules.linear_beta_schedule(DiffusionConfig(T=50, beta_0=1e-4,
                                                       beta_T=0.05)))
    return schedules.sampler_constants_for_schedule(
        np.linspace(1e-4, 0.05, n), hp)


class _Denoise(torch.nn.Module):
    """A mel-conditioned toy denoiser with one parameter."""

    def __init__(self, hop=HOP):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.tensor(0.1))
        self.hop = hop

    def forward(self, x, mel, t):
        cond = torch.repeat_interleave(mel.mean(-1, keepdim=True), self.hop,
                                       dim=1)
        return self.scale * x + 0.01 * cond + 1e-3 * t[:, :, None]


def _mels():
    rng = np.random.default_rng(7)
    return [rng.standard_normal((f, 6)).astype(np.float32) for f in FRAMES]


def _vocoder():
    return BatchedVocoder(_Denoise(), _constants(), hop_size=HOP,
                          frame_bucket=8, max_batch=2,
                          devices=[torch.device("cpu")])


def _expected(model, mels, seed):
    """Each stack through the eager ``sample``, in the vocoder's order,
    from one generator, trimmed to frames * hop."""
    gen = torch.Generator().manual_seed(seed)
    out = [None] * len(mels)
    for bucket, rows in ((8, [0, 2]), (16, [1])):
        stack = np.zeros((len(rows), bucket, 6), np.float32)
        for r, i in enumerate(rows):
            stack[r, :FRAMES[i]] = mels[i]
        with torch.no_grad():
            wav = sample(model, torch.from_numpy(stack), _constants(),
                         bucket * HOP, generator=gen)
        for r, i in enumerate(rows):
            out[i] = wav[r, :FRAMES[i] * HOP, 0].numpy()
    return out


def test_span_is_a_shared_no_op_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("a") is profiling.span("b")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = profiling.span("a")
        assert isinstance(on, torch.profiler.record_function)
        assert on is not profiling.span("a")


def test_no_record_function_without_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    voc, mels = _vocoder(), _mels()
    for seed in (11, 12, 13):       # warm, capture and replay each shape
        wavs = voc.vocode(mels, generator=torch.Generator().manual_seed(seed))
        for got, want in zip(wavs, _expected(voc.sampler.model, mels, seed)):
            np.testing.assert_array_equal(got, want)
    assert entered == []
    assert (voc.sampler.warmups, voc.sampler.captures) == (2, 2)


def _spans(prof) -> list:
    """(start_ns, end_ns, name) of the program's spans in the trace."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith(("vocoder.", "sampler.")):
            out.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    return sorted(out)


def _inside(span, spans, name) -> bool:
    return any(s <= span[0] and span[1] <= t
               for s, t, n in spans if n == name and (s, t) != span[:2])


def test_spans_of_each_call_nest_and_name_its_phases():
    voc, mels = _vocoder(), _mels()
    unprofiled = _vocoder()
    # first call warms both shapes, second captures them, third replays
    phase = {1: "sampler.warm", 2: "sampler.capture", 3: "sampler.replay"}
    for n in (1, 2, 3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            wavs = voc.vocode(mels, generator=torch.Generator().manual_seed(n))
        want = unprofiled.vocode(mels,
                                 generator=torch.Generator().manual_seed(n))
        for got, ref in zip(wavs, want):
            np.testing.assert_array_equal(got, ref)
        spans = _spans(prof)
        count = collections.Counter(name for _, _, name in spans)
        stacks = calls = 2
        assert count["vocoder.vocode"] == 1
        for name in VOCODER_SPANS:
            assert count[name] == stacks, name
        for name in ("sampler.call", "sampler.lookup", "sampler.fill",
                     "sampler.clone"):
            assert count[name] == calls, name
        assert count[phase[n]] == calls
        assert count["sampler.warm"] == (calls if n == 1 else 0)
        assert count["sampler.capture"] == (calls if n == 2 else 0)
        assert count["sampler.replay"] == (calls if n > 1 else 0)
        for span in spans:
            if span[2] == "vocoder.vocode":
                continue
            assert _inside(span, spans, "vocoder.vocode"), span
            if span[2].startswith("sampler.") and span[2] != "sampler.call":
                assert _inside(span, spans, "sampler.call"), span
            if span[2] in VOCODER_SPANS:
                assert not _inside(span, spans, "sampler.call"), span


def test_lru_eviction_is_counted():
    sampler = make_sampler(_Denoise(), _constants(), max_graphs=2)
    gen = torch.Generator().manual_seed(0)

    def call(frames):
        return sampler(gen, torch.zeros(1, frames, 6), frames * HOP)

    for frames in (8, 16, 8):
        call(frames)
    assert (sampler.warmups, sampler.evictions) == (2, 0)
    call(24)        # a third shape evicts the least recently used, 16
    assert (sampler.warmups, sampler.evictions) == (3, 1)
    assert sampler.graphs_cached == 1       # 8 was captured on its return
    call(8)
    assert (sampler.warmups, sampler.evictions) == (3, 1)
    call(16)        # the evicted shape runs its first call again
    assert (sampler.warmups, sampler.evictions) == (4, 2)


HP = {"inner_channels": 8, "cond_channels": 16, "upsample_ratios": [4, 2, 2],
      "kpnet_hidden_channels": 8, "diffusion_step_embed_dim_in": 16,
      "diffusion_step_embed_dim_mid": 32, "diffusion_step_embed_dim_out": 32,
      "compute_dtype": "float32", "audio_num_mel_bins": 16,
      "audio_sample_rate": 22050, "N": 4, "seed": 3}


def test_server_counts_queue_wait_and_graph_churn():
    service = VocoderService(dict(HP), device="cpu")
    service.warmup(frames=4)
    assert service.queue_wait_seconds < 0.1
    mel = np.zeros((4, 16), np.float32)
    done = []
    service._lock.acquire()         # a request in flight holds the device
    try:
        worker = threading.Thread(target=lambda: done.append(
            service.vocode(mel)))
        worker.start()
        time.sleep(0.3)
        assert not done             # still waiting on the lock
    finally:
        service._lock.release()
    worker.join(timeout=60)
    assert not worker.is_alive() and done[0].shape == (4 * 16,)
    assert service.queue_wait_seconds >= 0.25

    httpd, thread = start_server(service)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1],
                                          timeout=60)
        conn.request("GET", "/metrics")
        metrics = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert metrics["graph_evictions"] == 0
    assert metrics["graph_recaptures"] == 0
    assert metrics["queue_wait_seconds"] >= 0.25
    assert metrics["graph_warmups"] == 1 and metrics["graph_captures"] == 1
