"""A stand-in for the card, so that a kernel's launcher runs to its C entry
on a CPU-only torch: tensors that report a CUDA device, and a kernel
library that records each call instead of launching."""

import contextlib
import itertools
import types

import torch

from fastdiff_tpu_torch.ops import _build

_ADDRESSES = itertools.count(1)


class FakeCuda:
    """What a launcher reads of a CUDA tensor: its shape, dtype, device and
    a 128-byte-aligned address. Allocations like it (``torch.empty_like``,
    ``new_empty``) return more of them."""

    device = torch.device("cuda", 0)

    def __init__(self, shape, dtype=torch.bfloat16):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self._address = next(_ADDRESSES) * 4096

    def dim(self) -> int:
        return len(self.shape)

    def is_contiguous(self) -> bool:
        return True

    def data_ptr(self) -> int:
        return self._address

    def new_empty(self, shape, dtype=None) -> "FakeCuda":
        return FakeCuda(shape, dtype or self.dtype)

    @classmethod
    def __torch_function__(cls, func, types_, args=(), kwargs=None):
        if func is torch.empty_like:
            return cls(args[0].shape, args[0].dtype)
        return NotImplemented


class FakeLibrary:
    """The kernel library: each C entry records (name, arguments) in
    ``calls`` and returns 0, CUDA's success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


def fake_card(monkeypatch, *modules, sms: int = 132) -> FakeLibrary:
    """Put a ``FakeLibrary`` behind ``_build.library``, a card of ``sms``
    SMs behind each module's ``_sm_count`` and a fresh copy of its
    ``LAUNCHES``, and make the device guard and current stream of
    ``torch.cuda`` inert; returns the library."""
    lib = FakeLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    for module in modules:
        monkeypatch.setattr(module, "_sm_count", lambda index: sms)
        monkeypatch.setattr(module, "LAUNCHES", dict(module.LAUNCHES))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    return lib
