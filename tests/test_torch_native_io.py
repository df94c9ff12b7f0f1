"""The port's C++ mmap loader (``fastdiff_tpu_torch/data/native_io.py``,
``fastdiff_tpu_torch/native/indexed_io.cpp``) against the JAX package's.

- the v2 files of the port's builder, and of the port's binarizer, are
  byte-equal to JAX's;
- the port's endless ``train_batch_iterator`` yields JAX's batches on the
  same binarized directory, with the v2 files present and without: bit
  for bit JAX's pickle-path batches (the same draws), and JAX's native
  batches everywhere but at subnormal float16 samples, which JAX's C++
  halves (the port's copy converts them exactly);
- with the v2 files present and a library that cannot be built, the
  port's loader raises instead of falling back;
- the library builds into ``build/native/`` under a hash of its source,
  ``read_item`` round-trips, ``BATCHES`` counts the native batches.
"""

import filecmp
import itertools
import os
import shutil

import numpy as np
import pytest
import torch

from fastdiff_tpu.data import binarizer as jbin
from fastdiff_tpu.data import dataset as jds
from fastdiff_tpu.data import native_io as jnative
from fastdiff_tpu.utils import audio_io as jaudio
from fastdiff_tpu_torch.data import binarizer as pbin
from fastdiff_tpu_torch.data import dataset as pds
from fastdiff_tpu_torch.data import native_io

SR = 22050
HOP = 256
MAX_FRAMES = 12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch intra-op thread: the suite runs several workers on the
    machine's cores, and torch's CPU kernels oversubscribe them (a 60-step
    training test took 135 s under five busy neighbours, 0.8 s with one
    thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def binarized(tmp_path_factory):
    """Five tones binarized by both packages (v2 files beside the pickle
    shards), and copies of both without the v2 files."""
    root = tmp_path_factory.mktemp("native")
    (root / "raw").mkdir()
    (root / "processed").mkdir()
    rng = np.random.default_rng(0)
    rows = []
    for i, sec in enumerate((0.5, 0.6, 0.45, 0.7, 0.55)):
        t = np.arange(int(sec * SR)) / SR
        wav = (0.4 * np.sin(2 * np.pi * (200 + 40 * i) * t)
               + 0.02 * rng.standard_normal(len(t))).astype(np.float32)
        fn = str(root / "raw" / f"u{i}.wav")
        jaudio.save_wav(wav, fn, SR)
        rows.append(f"u{i},{fn}")
    (root / "processed" / "metadata_phone.csv").write_text(
        "item_name,wav_fn\n" + "\n".join(rows) + "\n")
    dirs = {}
    for name, mod in (("port", pbin), ("jax", jbin)):
        hp = {"processed_data_dir": str(root / "processed"),
              "binary_data_dir": str(root / name), "audio_sample_rate": SR,
              "audio_num_mel_bins": 80, "fft_size": 1024, "hop_size": HOP,
              "win_size": 1024, "fmin": 80, "fmax": 7600, "test_num": 1,
              "binarization_args": {"with_wav": True, "shuffle": False},
              "N_PROC": 1}
        mod.VocoderBinarizer(hp).process()
        dirs[name] = str(root / name)
        bare = root / f"{name}_pickle"
        shutil.copytree(root / name, bare)
        for f in bare.glob("*.bi*"):
            f.unlink()
        dirs[f"{name}_pickle"] = str(bare)
    return dirs


def test_v2_files_byte_equal_jax(binarized, tmp_path):
    for prefix in ("train", "valid", "test"):
        for ext in (".bin", ".bidx"):
            port = os.path.join(binarized["port"], prefix + ext)
            assert filecmp.cmp(port, os.path.join(binarized["jax"],
                                                  prefix + ext),
                               shallow=False), prefix + ext
    # the builders alone, on ragged items of another width
    rng = np.random.default_rng(1)
    items = [(rng.standard_normal((f, 8)).astype(np.float32),
              (0.1 * rng.standard_normal(4 * f)).astype(np.float16))
             for f in (3, 10, 7)]
    for name, mod in (("port", native_io), ("jax", jnative)):
        builder = mod.NativeDatasetBuilder(str(tmp_path / name))
        for mel, wav in items:
            builder.add_item(mel, wav)
        builder.finalize()
    for ext in (".bin", ".bidx"):
        assert filecmp.cmp(tmp_path / f"port{ext}", tmp_path / f"jax{ext}",
                           shallow=False)


def _batches(mod, data_dir, n=5):
    ds = mod.VocoderDataset({"binary_data_dir": data_dir, "hop_size": HOP,
                             "max_samples": MAX_FRAMES * HOP}, "train",
                            shuffle=True)
    assert len(ds) == 4
    return list(itertools.islice(
        mod.train_batch_iterator(ds, 3, MAX_FRAMES, seed=7), n))


@pytest.mark.parametrize("files", ["v2", "pickle"])
def test_train_batches_equal_jax(binarized, files):
    key = "" if files == "v2" else "_pickle"
    before = native_io.BATCHES
    port = _batches(pds, binarized["port" + key])
    assert native_io.BATCHES - before == (5 if files == "v2" else 0)
    ref = _batches(jds, binarized["jax_pickle"])
    for a, b in zip(port, ref):
        assert sorted(a) == sorted(b) == ["mels", "wavs"]
        for k in a:
            assert a[k].dtype == b[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])
    if files == "pickle":
        return
    # JAX's native loader on its own v2 files: the same crops, but each
    # subnormal float16 sample at half its value
    subnormal = 0
    for a, b in zip(port, _batches(jds, binarized["jax"])):
        np.testing.assert_array_equal(a["mels"], b["mels"])
        tiny = (a["wavs"] != 0) & (np.abs(a["wavs"]) < 2.0 ** -14)
        np.testing.assert_array_equal(a["wavs"][~tiny], b["wavs"][~tiny])
        np.testing.assert_array_equal(a["wavs"][tiny] / 2, b["wavs"][tiny])
        subnormal += int(tiny.sum())
    assert subnormal > 0


def test_loader_raises_when_the_library_cannot_build(binarized, tmp_path,
                                                     monkeypatch):
    """v2 files present and no compiler: the loader raises, the iterator
    with it; no pickle fallback."""
    monkeypatch.setattr(native_io, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native_io, "BUILD_DIR", tmp_path / "build")
    native_io.library.cache_clear()
    try:
        prefix = os.path.join(binarized["port"], "train")
        with pytest.raises(RuntimeError, match="cannot run"):
            native_io.NativeBatchLoader(prefix)
        ds = pds.VocoderDataset({"binary_data_dir": binarized["port"],
                                 "hop_size": HOP,
                                 "max_samples": MAX_FRAMES * HOP}, "train",
                                shuffle=True)
        with pytest.raises(RuntimeError, match="native io"):
            next(pds.train_batch_iterator(ds, 2, MAX_FRAMES))
        # no v2 files: the pickle path, no build attempted
        bare = pds.VocoderDataset({"binary_data_dir": binarized[
            "port_pickle"], "hop_size": HOP, "max_samples": MAX_FRAMES * HOP},
            "train", shuffle=True)
        assert next(pds.train_batch_iterator(bare, 2, MAX_FRAMES))[
            "mels"].shape == (2, MAX_FRAMES, 80)
    finally:
        native_io.library.cache_clear()


def test_library_build_and_read_item(binarized):
    path = native_io.build()
    assert path.parent == native_io.BUILD_DIR
    assert path.name.startswith("libfastdiff_io_") and path.exists()
    assert str(native_io.BUILD_DIR).endswith(os.path.join("build", "native"))
    loader = native_io.NativeBatchLoader(
        os.path.join(binarized["port"], "valid"))
    pickled = pds.VocoderDataset({"binary_data_dir": binarized["port"],
                                  "hop_size": HOP, "max_samples": 0},
                                 "valid")[0]
    assert len(loader) == 1 and loader.item_n_mels(0) == 80
    rec = loader.read_item(0)
    np.testing.assert_array_equal(rec["mel"], pickled["mel"])
    np.testing.assert_array_equal(rec["wav"], pickled["wav"].astype(
        np.float32))
    loader.close()
