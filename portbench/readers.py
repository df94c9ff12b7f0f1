"""The arithmetic the metric readers share (``portbench/metrics/*.py``
each name one of these). A reader returns None where it finds nothing to
read: a device metric off the card, a kernel that the traced window never
ran or ran other than the call shapes imply."""

from __future__ import annotations

import numpy as np

from portbench import work

# the port's hand-written kernels, by the names the profiler gives them
PORT_KERNELS = ("head_gemm_kernel", "lvc_block_tc_kernel", "lvc_block_kernel",
                "lvc_block_fh_tc_kernel", "lvc_block_fh_kernel",
                "lvc_block_nwc_tc_kernel", "down_stage1", "down_stage2")
# the kernel of each roofline metric, and its works' key in
# work.lvc_kernel_works
ROOFLINE_KERNELS = {"lvc_block": "lvc_block_tc_kernel",
                    "taug_head": "head_gemm_kernel"}


def vocode_x_realtime(run):
    """Unpadded audio seconds returned over the window's seconds."""
    audio_s = sum(sum(c.frames) for c in run.calls) * run.hop / run.sample_rate
    return audio_s / run.window_s


def utt_latency_p95_ms(run):
    """The 95th percentile of every utterance's latency: its call's start
    to its waveform in host memory."""
    lat = [c.end - c.start for c in run.calls for _ in c.frames]
    return float(np.percentile(lat, 95)) * 1e3


def pad_share(run):
    """Padded frames over the frames the calls ran, in %."""
    ran = sum(c.padded * len(c.frames) for c in run.calls)
    real = sum(sum(c.frames) for c in run.calls)
    return 100.0 * (ran - real) / ran


def replay_share(run):
    """Sampler calls the window served by replaying a graph, in %."""
    calls = run.counters.get("sampler_calls", 0)
    if not calls:
        return None
    return 100.0 * (calls - run.counters["warmups"]) / calls


def _device_trace(run):
    if run.platform != "gpu" or run.trace is None or not run.trace.by_name:
        return None
    return run.trace


def idle_share(run):
    """1 - the device's busy time over the traced window, in %."""
    trace = _device_trace(run)
    if trace is None:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def library_share(run):
    """The share of device time in operations that are not the port's own
    kernels (library kernels, copies, sets), in %."""
    trace = _device_trace(run)
    if trace is None:
        return None
    total = trace.op_total_s
    own = sum(trace.seconds_matching(k)[1] for k in PORT_KERNELS)
    return 100.0 * (total - own) / total


def roofline(run, kernel: str):
    """The least time the kernel's calls need, bytes at the HBM rate or
    FLOPs at the bf16 peak (``work.py``), over their device time, in %."""
    trace = _device_trace(run)
    if trace is None or run.config["family"] != "fastdiff":
        return None
    hp = run.config["hparams"]
    works = [w for c in run.calls for w in work.lvc_kernel_works(
        hp, len(c.frames), c.padded)[kernel]]
    count, seconds = trace.seconds_matching(ROOFLINE_KERNELS[kernel])
    if count != len(works) or seconds <= 0:
        return None
    return 100.0 * work.least_seconds(works) / seconds


def mfu(run):
    """Model FLOPs of the window's calls (padded shapes) over the window's
    seconds at the card's bf16 peak, in %."""
    if run.platform != "gpu":
        return None
    flops = sum(work.model_flops(run.config["family"], run.config["hparams"],
                                 len(c.frames), c.padded) for c in run.calls)
    return 100.0 * flops / (run.window_s * work.H100_BF16_PEAK)
