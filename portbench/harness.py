"""One run of one cell of ``BENCHMARK.json``.

Everything that belongs to a configuration, a traffic mix or a metric is
found by its name: ``BENCHMARK.json`` names the cell's configuration and
mix; the configuration's ``file`` holds its sizes and its ``family``,
whose plain reference is ``portbench/reference/<family>.py``; the mix is
``portbench/traffic/<name>.json``, whose ``kind`` names its driver
(``portbench/drivers/<kind>.py``); each metric is read by
``portbench/metrics/<name>.py``'s ``read(run)``, which returns a number or
None when it finds nothing to read. A cell reports an end-to-end metric
unless the metric lists other ``workloads``, and a per-layer metric when
its ``workloads`` list the cell or, without that key, when the cell
reports the end-to-end metric it ``moves``.

``--trace 0`` measures the end-to-end metrics over ``--seconds``.
``--trace 1`` traces a window of at most ``TRACE_SECONDS`` (whole calls)
and reads the per-layer metrics from it.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

from portbench.trace import Trace

TRACE_SECONDS = 3.0
BANNED = ("jax", "jaxlib", "flax", "fastdiff_tpu")


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""
    config: dict
    setup_s: float
    window_s: float
    calls: list             # the window's calls (drivers' records)
    counters: dict          # program counters over the window
    trace: Trace | None     # the traced window (``--trace 1``)
    hop: int
    sample_rate: int
    platform: str           # "gpu" on the card; "cpu" in the tests


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def resolve(root: str, workload: str) -> tuple:
    """(benchmark, cell, configuration file, traffic mix) of ``workload``."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[cell["config"]]["file"]))
    traffic = load_json(os.path.join(root, "portbench", "traffic",
                                     f"{cell['traffic']}.json"))
    return bench, cell, config, traffic


def metrics_for(bench: dict, cell: str, traced: bool) -> list:
    """The metric entries a run of ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def reader(root: str, name: str):
    """``read`` of ``portbench/metrics/<name>.py``."""
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def banned_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(BANNED))


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def run_cell(root: str, workload: str, seed: int, seconds: float,
             traced: bool, device, t0: float) -> tuple:
    """Set up, measure and check one run; (result, lines for stderr).
    ``t0`` is the host clock at the process's start."""
    bench, cell, config, traffic = resolve(root, workload)
    device = torch.device(device)
    driver_module = importlib.import_module(
        f"portbench.drivers.{traffic['kind']}")
    driver = driver_module.Driver(config, traffic, seed, device)
    driver.setup()
    setup_s = time.perf_counter() - t0

    trace = None
    if traced:
        trace = Trace(device)
        trace.start()
        calls = driver.window(min(seconds, TRACE_SECONDS), True)
        trace.stop()
    else:
        calls = driver.window(seconds, False)
    window_s = calls[-1].end - calls[0].start
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    driver.free_program()

    compared = driver.check()
    limits = config.get("limits", {})
    checks = {name: {"value": value, "limit": limits.get(name)}
              for name, value in compared.items()}
    correct = (driver.failed == 0 and driver.attempted > 0
               and all(c["limit"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))

    run = Run(config, setup_s, window_s, calls,
              driver.counters, trace, driver.hop, driver.sample_rate,
              "gpu" if device.type == "cuda" else "cpu")
    metrics = {}
    for entry in metrics_for(bench, workload, traced):
        value = reader(root, entry["name"])(run)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value),
                                      "unit": entry["unit"]}

    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    result = {"correct": bool(correct), "attempted": driver.attempted,
              "failed": driver.failed, "metrics": metrics, "device": dev}
    if trace is not None:
        dev["busy_s"] = trace.busy_s
        dev["window_s"] = trace.window_s
        result["breakdown"] = trace.breakdown()
    result["compared"] = checks

    lines = [f"setup_s {setup_s!r} (kernel build {driver.build_s!r} s), "
             f"window_s {window_s!r}, calls {len(calls)}, "
             f"counters {driver.counters}"]
    lines += [f"compared {name} {c['value']!r} limit {c['limit']!r}"
              for name, c in checks.items()]
    return result, lines


def main(argv: list, t0: float) -> int:
    parser = argparse.ArgumentParser(prog="portbench/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    chips = int(resolve(root, args.workload)[1]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    print(f"portbench: card {card_line()}", file=sys.stderr)
    result, lines = run_cell(root, args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda:0", t0)

    found = banned_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{found}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
