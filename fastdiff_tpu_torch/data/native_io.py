"""Native (C++) binarized-dataset IO: the v2 flat format and its ctypes
loader (``fastdiff_tpu/data/native_io.py``).

v2 on-disk layout, written by the binarizer beside the pickle shards:

- ``<prefix>.bin``: concatenated records, each
  ``[int32 n_frames][int32 n_mels][int32 wav_len][int32 reserved]``
  followed by the mel as row-major float32 (n_frames, n_mels) and the
  waveform as float16 (wav_len == n_frames * hop).
- ``<prefix>.bidx``: ``int64 n_items`` then ``n_items + 1`` int64 offsets.

The C++ library (``fastdiff_tpu_torch/native/indexed_io.cpp``, the JAX
package's source with the same C ABI) mmaps ``.bin`` and serves threaded
batch crops straight into numpy buffers: no pickle, no interpreter lock,
no per-item Python. Its float16 -> float32 conversion is exact, so a crop
equals the pickle path's bit for bit; the JAX package's copy halves
subnormal halves (|x| < 2^-14), the one place where the two loaders
differ. It is built on first use with ``g++ -O3 -shared -fPIC
-std=c++17 -pthread`` into ``build/native/`` at the repository root, named
by a hash of the source and the flags, as ``ops/_build.py`` builds the CUDA
kernels; nothing is written into the package.

Unlike the JAX package, which catches every failure of the native path and
falls back to pickle, ``data/dataset.py:train_batch_iterator`` falls back
only where a split has no v2 files. Where they exist and the library
cannot be built or loaded, ``NativeBatchLoader`` raises.

``BATCHES`` counts the batches ``NativeBatchLoader.load`` has served, so a
run can show which path fed it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess

import numpy as np

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "native" / "indexed_io.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

# batches served by NativeBatchLoader.load since the last reset
BATCHES = 0

_HEADER_DTYPE = np.dtype([("n_frames", "<i4"), ("n_mels", "<i4"),
                          ("wav_len", "<i4"), ("reserved", "<i4")])


def has_v2(prefix: str) -> bool:
    """Whether ``<prefix>.bin`` and ``<prefix>.bidx`` both exist."""
    return os.path.exists(f"{prefix}.bin") and os.path.exists(f"{prefix}.bidx")


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join([CXX, *CXX_FLAGS]).encode())
    return BUILD_DIR / f"libfastdiff_io_{digest.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile ``indexed_io.cpp`` if this source has no library yet;
    raises with the compiler's output when it cannot."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
    except OSError as exc:
        raise RuntimeError(f"native io: cannot run {CXX}: {exc}") from exc
    if proc.returncode != 0:
        raise RuntimeError(f"native io: {CXX} failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, target)
    return target


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded native library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    handle, item = ctypes.c_void_p, ctypes.c_int64
    signatures = {
        "fd_open": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_char_p]),
        "fd_num_items": (ctypes.c_int64, [handle]),
        "fd_item_frames": (ctypes.c_int32, [handle, item]),
        "fd_item_wav_len": (ctypes.c_int32, [handle, item]),
        "fd_item_n_mels": (ctypes.c_int32, [handle, item]),
        "fd_batch_crop": (ctypes.c_int32, [handle, i64, i64, ctypes.c_int32,
                                           ctypes.c_int32, ctypes.c_int32,
                                           ctypes.c_int32, f32, f32]),
        "fd_read_item": (ctypes.c_int32, [handle, item, f32, f32]),
        "fd_close": (None, [handle]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


class NativeDatasetBuilder:
    """Writes a v2 dataset at ``prefix``, byte for byte as the JAX
    package's builder does."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        self.bin_file = open(f"{prefix}.bin", "wb")
        self.offsets = [0]

    def add_item(self, mel: np.ndarray, wav: np.ndarray) -> None:
        """mel (T, n_mels) float32; wav (T*hop,) float16."""
        mel = np.ascontiguousarray(mel, dtype=np.float32)
        wav = np.ascontiguousarray(wav, dtype=np.float16)
        header = np.zeros((), dtype=_HEADER_DTYPE)
        header["n_frames"] = mel.shape[0]
        header["n_mels"] = mel.shape[1]
        header["wav_len"] = wav.shape[0]
        written = self.bin_file.write(header.tobytes())
        written += self.bin_file.write(mel.tobytes())
        written += self.bin_file.write(wav.tobytes())
        self.offsets.append(self.offsets[-1] + written)

    def finalize(self) -> None:
        self.bin_file.close()
        with open(f"{self.prefix}.bidx", "wb") as f:
            f.write(np.asarray([len(self.offsets) - 1], np.int64).tobytes())
            f.write(np.asarray(self.offsets, np.int64).tobytes())


class NativeBatchLoader:
    """Threaded native crop-collate over a v2 dataset.

    ``load(items, starts, max_frames, hop, n_mels)`` returns the batch dict
    of ``data/dataset.py:crop_batch`` for those items and crop starts. The
    constructor raises when the files are missing or the library cannot be
    built or loaded."""

    def __init__(self, prefix: str):
        if not has_v2(prefix):
            raise FileNotFoundError(f"no v2 dataset at {prefix}.bin/.bidx")
        self.lib = library()
        self.handle = self.lib.fd_open(f"{prefix}.bin".encode(),
                                       f"{prefix}.bidx".encode())
        if not self.handle:
            raise RuntimeError(f"fd_open failed for {prefix}")

    def __len__(self) -> int:
        return int(self.lib.fd_num_items(self.handle))

    def item_frames(self, i: int) -> int:
        return int(self.lib.fd_item_frames(self.handle, i))

    def item_n_mels(self, i: int) -> int:
        return int(self.lib.fd_item_n_mels(self.handle, i))

    def load(self, items, starts, max_frames: int, hop: int,
             n_mels: int) -> dict:
        global BATCHES
        items = np.ascontiguousarray(items, dtype=np.int64)
        starts = np.ascontiguousarray(starts, dtype=np.int64)
        batch = len(items)
        mels = np.empty((batch, max_frames, n_mels), np.float32)
        wavs = np.empty((batch, max_frames * hop), np.float32)
        rc = self.lib.fd_batch_crop(self.handle, items, starts, batch,
                                    max_frames, hop, n_mels, mels, wavs)
        if rc != 0:
            raise RuntimeError(f"fd_batch_crop failed with {rc}")
        BATCHES += 1
        return {"mels": mels, "wavs": wavs[..., None]}

    def read_item(self, i: int) -> dict:
        frames = self.item_frames(i)
        wav_len = int(self.lib.fd_item_wav_len(self.handle, i))
        mel = np.empty((frames, self.item_n_mels(i)), np.float32)
        wav = np.empty((wav_len,), np.float32)
        rc = self.lib.fd_read_item(self.handle, i, mel, wav)
        if rc != 0:
            raise RuntimeError(f"fd_read_item failed with {rc}")
        return {"mel": mel, "wav": wav}

    def close(self):
        if getattr(self, "handle", None):
            self.lib.fd_close(self.handle)
            self.handle = None

    def __del__(self):
        self.close()
