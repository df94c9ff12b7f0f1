"""Data-parallel training across processes and sharded inference across the
visible devices (``fastdiff_tpu/parallel/mesh.py``).

Training is one process per card (``torchrun``). ``maybe_initialize_
distributed`` starts the process group (NCCL on the card, gloo on the CPU)
from ``torchrun``'s environment; every rank's loader yields the same global
batch (one seed), ``shard_batch`` keeps the rank's contiguous rows of it,
and ``data_parallel`` wraps the trainable module in
``DistributedDataParallel``, whose all-reduce averages the gradients. A
global batch of B rows at W ranks thus equals JAX's batch sharded over a
``dp`` axis of W devices: rank r holds rows [r*B/W, (r+1)*B/W), as JAX's
device r does. A batch whose rows W does not divide runs replicated on
every rank, as JAX places it.

Inference is one process over every visible device, with no collective:
``ShardedSampler`` splits a batch of utterances or chunks into contiguous
row blocks, one per device, runs each block through that device's sampler
and gathers the rows back in order (``serving/chunked_vocoder.py:
DistributedChunkedVocoder``, ``serving/batch_vocoder.py:BatchedVocoder``).

``Mesh`` is what a process sees of this: the world size, its rank, its
device and whether a process group is up. Under a group the trainable
module runs under DDP at any world size, one process included.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One process's view: ``world_size`` ranks (the ``dp`` axis), this
    process's ``rank``, its ``device``, and whether a process group is up
    (``distributed``)."""
    world_size: int
    rank: int
    device: torch.device
    distributed: bool = False


def _env_world() -> int:
    return int(os.environ.get("WORLD_SIZE", "1") or 1)


def maybe_initialize_distributed(hparams: Optional[dict] = None,
                                 device=None) -> bool:
    """Start the process group when running data parallel; returns whether
    one is active.

    Triggers (JAX's, for ``torchrun``): ``WORLD_SIZE`` > 1 in the
    environment, ``multihost: true`` in ``hparams`` or
    ``FASTDIFF_MULTIHOST=1``. The group reads ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` (``torchrun`` sets them);
    the backend is NCCL for a CUDA ``device`` (default: the card when
    there is one) and gloo otherwise. On the card the process takes
    ``cuda:LOCAL_RANK``. A no-op when a group is already up."""
    if dist.is_available() and dist.is_initialized():
        return True
    want = (_env_world() > 1 or bool((hparams or {}).get("multihost"))
            or os.environ.get("FASTDIFF_MULTIHOST") == "1")
    if not want:
        return False
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if cuda else "gloo", init_method="env://")
    print(f"| torch.distributed initialized ({dist.get_backend()}): rank "
          f"{dist.get_rank()}/{dist.get_world_size()}")
    return True


def make_mesh(device=None) -> Mesh:
    """The process's ``Mesh``: the process group's size and rank (1 and 0
    without one), and ``device`` (a bare ``cuda`` means the process's
    current card). The port has JAX's one ``dp`` axis."""
    up = dist.is_available() and dist.is_initialized()
    world, rank = (dist.get_world_size(), dist.get_rank()) if up else (1, 0)
    dev = torch.device(device if device is not None else "cpu")
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(world, rank, dev, up)


def shard_rows(n: int, mesh: Mesh) -> slice:
    """Rank ``mesh.rank``'s contiguous rows of ``n``; all ``n`` when the
    world size does not divide it (replicated)."""
    w = mesh.world_size
    if n % w:
        return slice(0, n)
    per = n // w
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """Keep this rank's contiguous rows of each array (numpy or torch)
    whose leading dimension the world size divides; anything else passes
    whole (JAX's ``shard_batch`` places it replicated)."""
    out = {}
    for k, v in batch.items():
        if hasattr(v, "shape") and len(v.shape) >= 1:
            out[k] = v[shard_rows(v.shape[0], mesh)]
        else:
            out[k] = v
    return out


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0 (in
    place; a no-op at world size 1)."""
    if mesh.world_size > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0)
    return module


def data_parallel(module: torch.nn.Module, mesh: Mesh):
    """``module`` wrapped in ``DistributedDataParallel`` when a process
    group is up (world size > 1 under ``torchrun``, or any size with
    ``multihost``), else None. DDP broadcasts rank 0's weights when it
    wraps them and averages the gradients of every backward over the
    ranks; parameters a loss does not reach are allowed (a zoo denoiser's
    last residual conv)."""
    if not mesh.distributed:
        return None
    ids = [mesh.device.index] if mesh.device.type == "cuda" else None
    return torch.nn.parallel.DistributedDataParallel(
        module, device_ids=ids, find_unused_parameters=True)


def warn_replicated(rows: int, mesh: Mesh) -> None:
    """JAX's warning for a training batch the ``dp`` axis does not
    divide."""
    if mesh.world_size > 1 and rows % mesh.world_size:
        print(f"| WARNING: batch size {rows} not divisible by "
              f"dp={mesh.world_size}; running replicated (no data parallel "
              "speedup). Increase max_sentences.")


def gradients(loss: torch.Tensor, params: Sequence[torch.Tensor],
              ddp) -> list:
    """d loss / d params, zeros for those the loss does not reach. Under
    DDP (``ddp`` not None) through ``backward``, whose hooks average them
    over the ranks; the ``.grad`` fields are cleared after."""
    if ddp is None:
        return list(torch.autograd.grad(loss, params, materialize_grads=True))
    loss.backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    for p in params:
        p.grad = None
    return grads


def mean_over_ranks(value: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean of a tensor over the ranks (itself at world size 1)."""
    if mesh.world_size <= 1:
        return value
    out = value.detach().clone()
    dist.all_reduce(out)
    return out / mesh.world_size


def local_devices() -> list:
    """Every visible card, or the CPU when there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return ([torch.device("cuda", i) for i in range(n)]
            or [torch.device("cpu")])


def _shard_generator(seed: int, index: int, device) -> torch.Generator:
    state = np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


class ShardedSampler:
    """``sample(generator, mel (B, F, n_mels), audio_length) -> (B, L, 1)``
    over several devices in one process, with no collective: B is padded
    with zero rows to a multiple of the device count (JAX pads the chunk
    batch the same way), device d runs the d-th contiguous block through
    ``samplers[d]``, and the rows come back in order on the first device,
    the padding cut.

    ``samplers`` is one sampler per device (each over a model on its
    device), or one callable that every device shares. On one device the
    call passes straight through, with ``generator``; on more, device d
    draws from a generator on it seeded from one draw of ``generator``
    and d."""

    def __init__(self, samplers, devices: Optional[Sequence] = None):
        self.devices = [torch.device(d) for d in (devices or local_devices())]
        if callable(samplers):
            samplers = [samplers] * len(self.devices)
        if len(samplers) != len(self.devices):
            raise ValueError(f"{len(samplers)} samplers for "
                             f"{len(self.devices)} devices")
        self.samplers: list[Callable] = list(samplers)

    def __call__(self, generator, mel: torch.Tensor, audio_length: int):
        width = len(self.devices)
        if width == 1:
            return self.samplers[0](generator, mel, audio_length)
        n = mel.shape[0]
        pad = (-n) % width
        if pad:
            mel = torch.cat([mel, mel.new_zeros((pad,) + tuple(mel.shape[1:]))])
        per = mel.shape[0] // width
        seed = int(torch.randint(0, 2 ** 62, (), generator=generator,
                                 device=generator.device))
        outs = [sampler(_shard_generator(seed, d, dev),
                        mel[d * per:(d + 1) * per].to(dev), audio_length)
                for d, (sampler, dev) in enumerate(zip(self.samplers,
                                                       self.devices))]
        first = outs[0].device
        return torch.cat([o.to(first) for o in outs])[:n]
