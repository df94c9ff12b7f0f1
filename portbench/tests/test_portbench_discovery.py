"""A configuration, a traffic mix and a per-layer metric added as new files
and new ``BENCHMARK.json`` entries are found and run, and no file that was
there is edited."""

import hashlib
import os

from portbench import harness

from .conftest import read_json, write_json


def digests(root):
    out = {}
    for folder, _, files in os.walk(os.path.join(root, "portbench")):
        for name in files:
            path = os.path.join(folder, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


def test_new_files_and_entries_are_found(tiny_root):
    before = digests(tiny_root)
    pb = os.path.join(tiny_root, "portbench")

    cfg = read_json(os.path.join(pb, "configs", "fastdiff-lj.json"))
    cfg["name"] = "fastdiff-wide"
    cfg["hparams"]["inner_channels"] = 16
    write_json(os.path.join(pb, "configs", "fastdiff-wide.json"), cfg)
    mix = read_json(os.path.join(pb, "traffic", "offline-b16.json"))
    mix.update(name="offline-b2", batch=2, max_batch=2, batches_per_round=5)
    write_json(os.path.join(pb, "traffic", "offline-b2.json"), mix)
    with open(os.path.join(pb, "metrics", "batch.calls.offline.py"), "w") as f:
        f.write('"""Calls in the window."""\n\n\ndef read(run):\n'
                '    return len(run.calls)\n')

    bench_path = os.path.join(tiny_root, "BENCHMARK.json")
    bench = read_json(bench_path)
    cell = "fastdiff-wide.offline-b2"
    bench["configs"].append({
        "name": "fastdiff-wide", "source": "https://arxiv.org/abs/2204.09934",
        "file": "portbench/configs/fastdiff-wide.json", "reduced": [],
        "why": "a wider FastDiff"})
    bench["workloads"].append({
        "name": cell, "config": "fastdiff-wide", "traffic": "offline-b2",
        "chips": 1, "why": "two utterances a call"})
    for metric in bench["end_to_end"]:
        if metric["name"] == "vocode_x_realtime":
            metric["workloads"].append(cell)
    bench["per_layer"].append({
        "name": "batch.calls.offline", "unit": "calls", "better": "higher",
        "source": "program_counter", "layer": "serving/batch_vocoder.py",
        "moves": "vocode_x_realtime", "workloads": [cell]})
    write_json(bench_path, bench)

    result, _ = harness.run_cell(tiny_root, cell, 123, 0.3, False, "cpu", 0.0)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"vocode_x_realtime", "setup_s"}
    traced, _ = harness.run_cell(tiny_root, cell, 124, 0.3, True, "cpu", 0.0)
    # the metrics that list their cells report in those alone
    assert set(traced["metrics"]) == {"batch.calls.offline"}
    assert traced["metrics"]["batch.calls.offline"]["value"] >= 1

    after = digests(tiny_root)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) >= {
        "portbench/configs/fastdiff-wide.json",
        "portbench/traffic/offline-b2.json",
        "portbench/metrics/batch.calls.offline.py"}
