"""Data parallelism, sharded vocoding and the profiling helpers of the port
(``fastdiff_tpu_torch/parallel/mesh.py``, ``utils/profiling.py``) against
the JAX package's.

- four gloo processes, started as ``torchrun`` starts them (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``, through
  ``maybe_initialize_distributed``), each keeping its rows of one global
  batch under ``DistributedDataParallel``, give one process's loss and
  gradients on that batch, and the same parameters after one update
  (rel 1e-6), after ``replicate`` has undone a drift of ranks 1-3;
- ``shard_batch``'s row blocks are the shards JAX's ``shard_batch`` puts on
  each device of the root conftest's 8-device CPU mesh;
- ``DistributedChunkedVocoder`` over two CPU devices equals
  ``ChunkedVocoder``, and at one device it passes the generator through;
- ``RTFMeter`` equals JAX's on one clock; ``device_timer_slope``'s
  arithmetic, ``force`` and ``trace`` on the CPU.
"""

import os
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from fastdiff_tpu.parallel import mesh as jmesh
from fastdiff_tpu.utils import profiling as jprof
from fastdiff_tpu_torch.parallel import mesh as meshlib
from fastdiff_tpu_torch.serving.batch_vocoder import BatchedVocoder
from fastdiff_tpu_torch.serving.chunked_vocoder import (
    ChunkedVocoder, DistributedChunkedVocoder)
from fastdiff_tpu_torch.training.task import FastDiffTask
from fastdiff_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_HP = {"inner_channels": 8, "cond_channels": 16,
            "upsample_ratios": [4, 2, 2], "kpnet_hidden_channels": 8,
            "diffusion_step_embed_dim_in": 16,
            "diffusion_step_embed_dim_mid": 32,
            "diffusion_step_embed_dim_out": 32, "compute_dtype": "float32",
            "use_pallas_block": False, "lr": 1e-3}
WORLD = 4
BATCH = 8
FRAMES = 8

# one rank of the data-parallel run: the batch and draws from the parent's
# npz, gradients of one loss, then one update; writes rank<r>.npz
WORKER = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from fastdiff_tpu_torch.parallel import mesh as meshlib
from fastdiff_tpu_torch.training.task import FastDiffTask
hp, root = eval(sys.argv[1]), sys.argv[2]
assert meshlib.maybe_initialize_distributed({}, "cpu")
task = FastDiffTask(hp, device="cpu")
assert task.mesh.world_size == 4
state = task.build_state(seed=0)
assert state.ddp is not None
# replicate must undo any rank's drift from rank 0's weights
if task.mesh.rank:
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
meshlib.replicate(state.model, task.mesh)
data = np.load(root + "/batch.npz")
batch = {"mels": data["mels"], "wavs": data["wavs"]}
ts, z = torch.from_numpy(data["ts"]), torch.from_numpy(data["z"])
names, params = zip(*state.model.named_parameters())
loss = task.loss(state.net, batch, ts=ts, z=z)
grads = meshlib.gradients(loss, params, state.ddp)
out = task.train_step(state, batch, ts=ts, z=z)
np.savez(root + f"/rank{task.mesh.rank}.npz", loss=float(out["loss"]),
         **{"g:" + n: g.numpy() for n, g in zip(names, grads)},
         **{"p:" + n: p.detach().numpy()
            for n, p in state.model.named_parameters()})
torch.distributed.destroy_process_group()
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch intra-op thread: the suite runs several workers on the
    machine's cores, and torch's CPU kernels oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_four_gloo_ranks_match_one_process(tmp_path):
    rng = np.random.default_rng(0)
    length = FRAMES * 16
    batch = {"mels": rng.normal(size=(BATCH, FRAMES, 16)).astype(np.float32),
             "wavs": (0.3 * rng.normal(size=(BATCH, length, 1))).astype(
                 np.float32)}
    ts = rng.integers(0, 1000, (BATCH, 1, 1)).astype(np.int64)
    z = rng.normal(size=(BATCH, length, 1)).astype(np.float32)
    np.savez(tmp_path / "batch.npz", ts=ts, z=z, **batch)
    port = _free_port()
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, PYTHONPATH=REPO, RANK=str(rank),
                   LOCAL_RANK=str(rank), WORLD_SIZE=str(WORLD),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, repr(SMALL_HP), str(tmp_path)],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]

    # one process, the whole batch, the same draws
    task = FastDiffTask(SMALL_HP, device="cpu")
    assert task.mesh.world_size == 1
    state = task.build_state(seed=0)
    assert state.ddp is None
    names, params = zip(*state.model.named_parameters())
    loss = task.loss(state.model, batch, ts=torch.from_numpy(ts),
                     z=torch.from_numpy(z))
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    out = task.train_step(state, batch, ts=torch.from_numpy(ts),
                          z=torch.from_numpy(z))
    after = dict(state.model.named_parameters())
    for rank in range(WORLD):
        got = np.load(tmp_path / f"rank{rank}.npz")
        assert abs(float(got["loss"]) - float(out["loss"])) <= \
            1e-6 * abs(float(out["loss"]))
        for n in names:
            assert _rel(got["g:" + n], grads[n].numpy()) <= 1e-6, (rank, n)
            assert _rel(got["p:" + n], after[n].detach().numpy()) <= 1e-6, \
                (rank, n)


def test_shard_batch_rows_match_jax_mesh():
    jax_mesh = jmesh.make_mesh()
    width = jax_mesh.shape["dp"]
    assert width == 8
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    odd = np.arange(6, dtype=np.float32)
    placed = jmesh.shard_batch({"x": x, "odd": odd, "n": 5}, jax_mesh)
    for shard in placed["x"].addressable_shards:
        rank = list(jax_mesh.devices.flat).index(shard.device)
        port = meshlib.shard_batch(
            {"x": x, "odd": odd, "n": 5},
            meshlib.Mesh(width, rank, torch.device("cpu")))
        np.testing.assert_array_equal(port["x"], np.asarray(shard.data))
        # rows the axis does not divide stay whole on every rank
        np.testing.assert_array_equal(port["odd"], odd)
        assert port["n"] == 5
    mesh1 = meshlib.make_mesh()
    assert (mesh1.world_size, mesh1.rank, mesh1.distributed) == (1, 0, False)
    assert not meshlib.maybe_initialize_distributed({}, "cpu")


def _linear_sampler(generator, mel, audio_length):
    """Deterministic and local: the mel mean upsampled by hop."""
    hop = audio_length // mel.shape[1]
    return torch.repeat_interleave(mel.mean(-1), hop, dim=1)[..., None]


def test_distributed_chunked_vocoder_over_two_devices():
    mel = np.random.default_rng(2).standard_normal((200, 6)).astype(
        np.float32)
    calls = []

    def counting(generator, mel, audio_length):
        calls.append(mel.shape[0])
        return _linear_sampler(generator, mel, audio_length)
    local = ChunkedVocoder(_linear_sampler, hop_size=4, chunk_frames=32,
                           halo_frames=8)
    dist = DistributedChunkedVocoder(counting, hop_size=4,
                                     devices=["cpu", "cpu"], chunk_frames=32,
                                     halo_frames=8)
    gen = torch.Generator().manual_seed(0)
    np.testing.assert_allclose(dist.vocode(mel, generator=gen),
                               local.vocode(mel, generator=gen),
                               rtol=1e-6, atol=1e-7)
    # 13 chunks padded to 14: 7 on each device
    assert calls == [7, 7]
    # one device: the sampler gets the call itself, generator and all
    seen = []

    def recording(generator, mel, audio_length):
        seen.append(generator)
        return _linear_sampler(generator, mel, audio_length)
    one = DistributedChunkedVocoder(recording, hop_size=4, devices=["cpu"],
                                    chunk_frames=32, halo_frames=8)
    one.vocode(mel, generator=gen)
    assert seen == [gen]
    voc = BatchedVocoder.from_sampler(_linear_sampler, 4, frame_bucket=8,
                                      devices=["cpu", "cpu"])
    assert voc.max_batch == 2
    wavs = voc.vocode([mel[:13], mel[:5], mel[:30]], generator=gen)
    assert [w.shape for w in wavs] == [(52,), (20,), (120,)]


def test_rtf_meter_matches_jax(monkeypatch):
    port, ref = profiling.RTFMeter(), jprof.RTFMeter()
    for meter in (port, ref):
        ticks = iter([0.0, 0.25, 1.0, 1.75, 2.0, 2.05])
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        for samples in (22050, 44100, 2205):
            with meter.measure(samples):
                pass
    monkeypatch.undo()
    assert (port.rtf, port.x_realtime, port.count, port.summary()) == (
        ref.rtf, ref.x_realtime, ref.count, ref.summary())


def test_timers_force_and_trace_on_the_cpu(monkeypatch, tmp_path):
    x = torch.arange(6.0)
    assert profiling.force({"a": x, "b": (x, x * 2)}) == 10.0
    assert profiling.force([]) == 0.0
    # the slope: T(n) = 3 ms * n + a constant that changes per run
    runs = iter([0.05, 0.06, 0.09, 0.02, 0.03, 0.03])
    seen = []

    def fake(fn, *args, n, card=None):
        seen.append((n, card))
        return 0.003 * n + next(runs)
    monkeypatch.setattr(profiling, "timed_pipeline", fake)
    slope = profiling.device_timer_slope(lambda: x, n1=10, n2=50, reps=3)
    # per pair (T2 - T1) / 40 s: 0.13 / 40, 0.05 / 40, 0.12 / 40; the min
    assert slope == pytest.approx(0.05 / 40 * 1000)
    assert seen == [(10, False), (50, False)] * 3
    monkeypatch.undo()
    assert profiling.device_timer(lambda: x + 1, iters=3) >= 0.0
    assert profiling.timed_pipeline(torch.add, x, x, n=2) >= 0.0
    with profiling.trace(str(tmp_path)) as prof:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())
