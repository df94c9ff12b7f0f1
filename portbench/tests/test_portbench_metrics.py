"""The metrics' arithmetic, the yardstick of work, the result's schema and
the check that nothing of JAX or the JAX package is loaded."""

import ast
import json
import os
import sys

import pytest

from portbench import harness, readers, work
from portbench.drivers.vocode import Call
from portbench.trace import Trace

from .conftest import ROOT, read_json

FASTDIFF = read_json(os.path.join(ROOT, "portbench", "configs",
                                  "fastdiff-lj.json"))["hparams"]


def run_of(calls, window_s, trace=None, platform="gpu", family="fastdiff"):
    return harness.Run(config={"family": family, "hparams": FASTDIFF},
                       setup_s=12.5, window_s=window_s,
                       calls=calls, counters={}, trace=trace, hop=256,
                       sample_rate=22050, platform=platform)


def test_rate_is_all_audio_over_the_whole_window():
    calls = [Call(0.0, 0.5, [100, 200], 256), Call(0.6, 1.0, [300], 384)]
    run = run_of(calls, window_s=2.0)
    assert readers.vocode_x_realtime(run) == pytest.approx(
        600 * 256 / 22050 / 2.0)
    # padded frames 2 * 256 + 384 = 896 against 600 real ones
    assert readers.pad_share(run) == pytest.approx(100 * 296 / 896)


def test_p95_is_over_every_utterance():
    # 19 utterances at 10 ms in one call and one at 30 ms: every utterance
    # of a call carries the call's latency
    calls = [Call(0.0, 0.010, [100] * 19, 128), Call(1.0, 1.030, [100], 128)]
    p95 = readers.utt_latency_p95_ms(run_of(calls, 1.03))
    assert p95 == pytest.approx(10.0 + 0.05 * 20.0 * 0.95, rel=0.2)
    assert 10.0 < p95 < 30.0


def fake_trace(window, ops, host=()):
    trace = Trace.__new__(Trace)
    trace.window_ns = window
    trace.intervals = [(s, t) for _, s, t in ops]
    trace.by_name = {}
    for name, s, t in ops:
        entry = trace.by_name.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += (t - s) * 1e-9
    trace.host = sorted(host)
    return trace


def test_idle_share_counts_leading_and_trailing_gaps():
    ms = 1_000_000
    trace = fake_trace((0, 100 * ms), [("k", 10 * ms, 20 * ms),
                                       ("k", 15 * ms, 25 * ms),
                                       ("m", 30 * ms, 50 * ms)],
                       host=[(0, 100 * ms, "portbench.call"),
                             (55 * ms, 99 * ms, "cudaMemcpyAsync")])
    assert trace.busy_s == pytest.approx(0.035)
    run = run_of([Call(0.0, 0.1, [1], 4)], 0.1, trace)
    assert readers.idle_share(run) == pytest.approx(65.0)
    idle = trace.idle_by_host()
    assert idle["cudaMemcpyAsync"] == pytest.approx(0.050)
    assert idle["portbench.call"] == pytest.approx(0.015)
    # a device metric is never read off the card
    assert readers.idle_share(run_of([], 0.1, trace, platform="cpu")) is None
    assert readers.mfu(run_of([], 0.1, trace, platform="cpu")) is None


def test_library_share_and_roofline_by_kernel_name():
    us = 1000
    calls = [Call(0.0, 0.01, [864], 896)]
    works = work.lvc_kernel_works(FASTDIFF, 1, 896)
    ops = [("void (anonymous namespace)::lvc_block_tc_kernel<true>(x)",
            i * 100 * us, i * 100 * us + 50 * us)
           for i in range(len(works["lvc_block"]))]
    ops.append(("at::native::elementwise_kernel", 0, 150 * us))
    trace = fake_trace((0, 2_000 * us), ops)
    run = run_of(calls, 0.01, trace)
    bound = work.least_seconds(works["lvc_block"])
    assert readers.roofline(run, "lvc_block") == pytest.approx(
        100 * bound / (12 * 50e-6))
    # K3 did not run in the window: its roofline reads nothing
    assert readers.roofline(run, "taug_head") is None
    assert readers.library_share(run) == pytest.approx(
        100 * 150 / (150 + 12 * 50))
    assert readers.roofline(run_of(calls, 0.01, trace, family="wavenet"),
                            "lvc_block") is None


def test_fastdiff_flops_against_the_jax_count():
    # bench.py's XLA cost analysis of the JAX model counted 2.369e5 FLOP per
    # audio sample a denoiser call; this count leaves out the elementwise
    # work and the kernel heads' padding to 8 rows
    frames = 864
    per_sample = work.fastdiff_flops_per_forward(FASTDIFF, frames) / (
        frames * 256)
    assert per_sample == pytest.approx(2.2052e5, rel=1e-4)
    assert 0.9 < per_sample / 2.369e5 < 1.0
    assert work.model_flops("fastdiff", FASTDIFF, 16, frames) == pytest.approx(
        4 * 16 * per_sample * frames * 256)


def test_wavenet_flops_per_sample():
    cfg = read_json(os.path.join(ROOT, "portbench", "configs",
                                 "diffwave-base-lj.json"))["hparams"]
    per_sample = work.wavenet_flops_per_forward(cfg, 100, 256) / 25600
    # 30 layers of 2 (64 x 128 x 3 + 80 x 128 + 64 x 64 + 64 x 64) and the
    # two mel upsamplers
    assert per_sample == pytest.approx(2.6195e6, rel=1e-4)


def test_kernel_bytes_at_864_frames():
    """K1 (hop 8), K2 (hop 256, final conv) and K3 at b 1, 864 frames: the
    bounds the kernels' table gives (bytes at 3.35 TB/s)."""
    works = work.lvc_kernel_works(FASTDIFF, 1, 864)
    head = works["taug_head"][0]
    k1, _, k2 = works["lvc_block"][:3]
    assert head[1] == 2 * (864 * 192 + 192 * 26624 + 864 * 26624) + 4 * 26624
    assert k1[1] == 6 * 32 * 6912 + 2 * 864 * 26624
    assert k2[1] == 6 * 32 * 221184 + 2 * 864 * 26624 + 4 * 221184
    assert work.least_seconds([head]) * 1e3 == pytest.approx(0.0169, abs=1e-4)
    assert work.least_seconds([k1]) * 1e3 == pytest.approx(0.0141, abs=1e-4)
    assert work.least_seconds([k2]) * 1e3 == pytest.approx(0.0267, abs=1e-4)
    assert len(works["taug_head"]) == len(works["lvc_block"]) == 12


def test_banned_modules_compare_whole_top_level_names(monkeypatch):
    # this test process has JAX loaded (the repository's tests compare with
    # it), so the check reads a module table of its own here
    table = {name: sys for name in ("torch", "fastdiff_tpu_torch",
                                    "fastdiff_tpu_torch.models", "jaxtyping",
                                    "flaxen", "portbench.harness")}
    monkeypatch.setattr(sys, "modules", table)
    assert harness.banned_modules() == []
    table.update({"fastdiff_tpu.models": sys, "jaxlib.xla_client": sys})
    assert harness.banned_modules() == ["fastdiff_tpu", "jaxlib"]


def test_no_source_of_the_benchmark_imports_jax():
    found = []
    for folder, _, files in os.walk(os.path.join(ROOT, "portbench")):
        for name in files:
            if not name.endswith(".py") or folder.endswith("tests"):
                continue
            path = os.path.join(folder, name)
            with open(path) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                mods = ([a.name for a in node.names]
                        if isinstance(node, ast.Import) else
                        [node.module or ""] if isinstance(node, ast.ImportFrom)
                        else [])
                found += [(path, m) for m in mods
                          if m.split(".")[0] in harness.BANNED]
    assert found == []


def test_result_line_schema(tiny_root):
    result, lines = harness.run_cell(tiny_root, "fastdiff-lj.offline-b16",
                                     2 ** 31 + 99, 0.3, False, "cpu", 0.0)
    assert set(result) == {"correct", "attempted", "failed", "metrics",
                           "device", "compared"}
    assert list(result)[-1] == "compared"
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {"vocode_x_realtime", "setup_s"}
    for metric in result["metrics"].values():
        assert set(metric) == {"value", "unit"}
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    for check in result["compared"].values():
        assert set(check) == {"value", "limit"}
    assert lines[-2].startswith("compared wav_rel_l2 ")
    json.dumps(result)


def test_traced_run_reports_per_layer_metrics(tiny_root):
    result, _ = harness.run_cell(tiny_root, "fastdiff-lj.utt-b1", 5, 0.3,
                                 True, "cpu", 0.0)
    # counts from the program; device metrics read nothing off the card
    assert set(result["metrics"]) == {"batch.pad_share.utt",
                                      "sampler.replay_share.utt"}
    assert result["metrics"]["sampler.replay_share.utt"]["value"] == 100.0
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_main_refuses_without_a_card(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = harness.main(["--workload", "fastdiff-lj.utt-b1", "--seed", "1",
                         "--seconds", "1"], 0.0)
    out = capsys.readouterr()
    assert code != 0 and out.out == ""
    assert "CUDA" in out.err
