"""The readers that put the card's idle time down to the port's own host
spans (``portbench/program_spans.py``), on synthetic traces, and the
program's spans as the harness's trace collects them."""

import pytest

from portbench import harness, program_spans, readers, trace as tracelib
from portbench.drivers.vocode import Call

from .conftest import ROOT
from .test_portbench_metrics import fake_trace, run_of

US = 1_000
NAMES = ("vocoder.host_idle_share.offline", "vocoder.host_idle_share.utt",
         "sampler.host_idle_share.offline", "sampler.host_idle_share.utt")


def shares(trace):
    run = run_of([Call(0.0, 0.001, [1], 4)], 0.001, trace)
    return {name: harness.reader(ROOT, name)(run) for name in NAMES}


def one_call_trace():
    """A 1 ms window: kernels at 0-100, 150-160, 400-500 and 900-950 us;
    a call's spans, and the harness's record span after it."""
    ops = [("k", 0, 100 * US), ("k", 150 * US, 160 * US),
           ("k", 160 * US + 10 * US, 400 * US),   # a 10 us gap
           ("k", 400 * US, 500 * US), ("k", 900 * US, 950 * US)]
    host = [(0, 700 * US, "portbench.call"),
            (0, 690 * US, "vocoder.vocode"),
            (95 * US, 500 * US, "sampler.call"),
            (95 * US, 300 * US, "sampler.lookup"),
            (300 * US, 500 * US, "sampler.replay"),
            (110 * US, 140 * US, "aten::normal_"),
            (500 * US, 650 * US, "vocoder.fetch"),
            (700 * US, 1000 * US, "portbench.record"),
            (950 * US, 1000 * US, "Buffer_Flush")]
    return fake_trace((0, 1000 * US), ops, host)


def test_idle_goes_to_the_innermost_program_span():
    trace = one_call_trace()
    idle = program_spans.idle_by_layer(trace)
    # 100-150 us: mid 125, under aten::normal_ inside sampler.lookup inside
    # vocoder.vocode: the sampler's, whatever host event is innermost
    # 160-170 us: under 20 us, nobody's
    # 500-900 us: mid 700, inside portbench.record alone: nobody's
    # 950-1000 us: the trailing gap, under the profiler's flush: nobody's
    assert idle == pytest.approx({"sampler": 50e-6, "vocoder": 0.0})
    assert program_spans.idle_by_span(trace) == pytest.approx(
        {"sampler.lookup": 50e-6})
    got = shares(trace)
    assert got["sampler.host_idle_share.utt"] == pytest.approx(5.0)
    assert got["sampler.host_idle_share.offline"] == pytest.approx(5.0)
    assert got["vocoder.host_idle_share.utt"] == pytest.approx(0.0)
    # the rule the breakdown names gaps by sees the host event instead
    assert trace.idle_by_host()["aten::normal_"] == pytest.approx(50e-6)


def test_a_gap_after_the_sampler_returns_goes_to_the_vocoder():
    ops = [("k", 0, 100 * US), ("k", 300 * US, 1000 * US)]
    host = [(0, 1000 * US, "vocoder.vocode"),
            (0, 120 * US, "sampler.call"),
            (0, 120 * US, "sampler.replay"),
            (120 * US, 290 * US, "vocoder.trim")]
    idle = program_spans.idle_by_layer(fake_trace((0, 1000 * US), ops, host))
    # 100-300 us: mid 200, in vocoder.trim (sampler.call ended at 120)
    assert idle == pytest.approx({"sampler": 0.0, "vocoder": 200e-6})


def test_shares_stay_within_the_idle_share_less_the_short_gaps():
    trace = one_call_trace()
    run = run_of([Call(0.0, 0.001, [1], 4)], 0.001, trace)
    idle = readers.idle_share(run)
    short = trace.idle_by_host()[
        f"gaps under {tracelib.SHORT_GAP_NS // 1000} us"]
    got = shares(trace)
    for value in got.values():
        assert 0.0 <= value <= idle
    total = got["sampler.host_idle_share.utt"] + got[
        "vocoder.host_idle_share.utt"]
    assert total <= idle - 100.0 * short / trace.window_s + 1e-9


def test_no_program_span_or_no_card_reads_none():
    ops = [("k", 0, 100 * US)]
    parent = fake_trace((0, 1000 * US), ops,
                        [(0, 900 * US, "portbench.call"),
                         (100 * US, 800 * US, "cudaGraphLaunch")])
    assert program_spans.idle_by_layer(parent) is None
    assert set(shares(parent).values()) == {None}
    run = run_of([], 0.001, one_call_trace(), platform="cpu")
    assert program_spans.host_idle_share(run, "sampler") is None


def test_the_harness_trace_holds_the_program_spans(tiny_root, monkeypatch):
    """A traced CPU run of the one-at-a-time mix: the window's host events
    carry every span of a replayed call (the warm-up ran the first and
    second calls of each shape before the window)."""
    made = []

    class Kept(tracelib.Trace):
        def __init__(self, device):
            super().__init__(device)
            made.append(self)

    monkeypatch.setattr(harness, "Trace", Kept)
    result, _ = harness.run_cell(tiny_root, "fastdiff-lj.utt-b1", 2 ** 31 + 7,
                                 0.3, True, "cpu", 0.0)
    assert result["correct"] is True
    names = {name for _, _, name in program_spans.program_spans(made[0])}
    assert names == {"vocoder.vocode", "vocoder.stack", "vocoder.fetch",
                     "vocoder.trim", "sampler.call", "sampler.lookup",
                     "sampler.fill", "sampler.replay", "sampler.clone"}
    idle = program_spans.idle_by_layer(made[0])
    assert sum(idle.values()) <= made[0].window_s
    # off the card the readers report nothing
    assert not set(NAMES) & set(result["metrics"])
