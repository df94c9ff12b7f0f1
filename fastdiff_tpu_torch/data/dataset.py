"""Vocoder dataset and host-side batch pipeline, a copy of
``fastdiff_tpu/data/dataset.py``.

- train/valid items shorter than the crop window are filtered out using
  ``<prefix>_lengths.npy`` (reference: tasks/vocoder/dataset_utils.py:66-72);
- the collater random-crops aligned (mel-frame, wav-sample) windows of
  ``max_samples`` (dataset_utils.py:114-131), so every batch has one shape;
- the endless sampler is an epoch-seeded shuffled index stream sharded by
  (shard_id, num_shards), the host-side replacement for
  ``EndlessDistributedSampler``'s rank-strided indices
  (dataset_utils.py:31-40);
- inference loads full utterances one at a time, or featurizes raw
  ``test_input_dir`` wavs / ``test_mel_dir`` ``.npy`` mels with the
  binarizer's ``process_item`` / ``process_mel_item``
  (dataset_utils.py:167-204).

Items are read from the pickle shards (``data/indexed_dataset.py``). The
endless training stream reads a split through the C++ mmap loader
(``data/native_io.py``) where the binarizer wrote its v2 files, with the
same items and crop starts as the pickle path; a split without them reads
the pickle shards, and one with them whose library cannot be built or
loaded raises (JAX falls back to pickle on any failure).

``resolve_class`` imports a class from its dotted path. The configs name
the JAX package's classes (``task_cls: fastdiff_tpu.training.task.
FastDiffTask``); a ``fastdiff_tpu.`` path resolves to the port's module of
the same name, and a name the port lacks raises ``NotImplementedError``
without importing the JAX package.
"""

from __future__ import annotations

import glob
import importlib
import importlib.util
import os
from typing import Iterator, List, Optional

import numpy as np

from fastdiff_tpu_torch.data import native_io
from fastdiff_tpu_torch.data.indexed_dataset import IndexedDataset


def resolve_class(dotted_path: str):
    """Import ``pkg.mod.Cls`` from its dotted path (the reference's importlib
    dispatch, tasks/run.py:7-11). ``fastdiff_tpu.x.Cls`` names the port's
    ``fastdiff_tpu_torch.x.Cls``; a module or class the port does not have
    raises ``NotImplementedError``."""
    pkg, cls_name = dotted_path.rsplit(".", 1)
    if pkg == "fastdiff_tpu" or pkg.startswith("fastdiff_tpu."):
        port = "fastdiff_tpu_torch" + pkg[len("fastdiff_tpu"):]
        try:    # a module under a subpackage the port lacks raises here
            spec = importlib.util.find_spec(port)
        except ModuleNotFoundError:
            spec = None
        if spec is None or not hasattr(importlib.import_module(port),
                                       cls_name):
            raise NotImplementedError(
                f"{dotted_path} is not ported to fastdiff_tpu_torch (no "
                f"{cls_name!r} in {port})")
        pkg = port
    return getattr(importlib.import_module(pkg), cls_name)


class VocoderDataset:
    def __init__(self, hparams: dict, prefix: str, shuffle: bool = False):
        self.hparams = hparams
        self.prefix = prefix
        self.shuffle = shuffle
        self.data_dir = hparams["binary_data_dir"]
        self.hop_size = int(hparams["hop_size"])
        self.is_infer = prefix == "test"
        self.batch_max_frames = (0 if self.is_infer
                                 else int(hparams["max_samples"]) // self.hop_size)
        self.indexed_ds: Optional[IndexedDataset] = None
        self._memory_items = None

        if self.is_infer and hparams.get("test_input_dir"):
            self._memory_items, self.sizes = self._load_test_inputs(
                hparams["test_input_dir"])
            self.avail_idxs = list(range(len(self.sizes)))
        elif self.is_infer and hparams.get("test_mel_dir"):
            self._memory_items, self.sizes = self._load_mel_inputs(
                hparams["test_mel_dir"])
            self.avail_idxs = list(range(len(self.sizes)))
        else:
            sizes = np.load(os.path.join(self.data_dir, f"{prefix}_lengths.npy"))
            self.avail_idxs = [i for i, s in enumerate(sizes)
                               if s > self.batch_max_frames]
            skipped = len(sizes) - len(self.avail_idxs)
            if skipped:
                print(f"| {skipped} short items skipped in {prefix} set.")
            self.sizes = [int(sizes[i]) for i in self.avail_idxs]

    def __len__(self) -> int:
        return len(self.avail_idxs)

    def __getitem__(self, index: int) -> dict:
        if self._memory_items is not None:
            return self._memory_items[index]
        if self.indexed_ds is None:
            self.indexed_ds = IndexedDataset(
                os.path.join(self.data_dir, self.prefix))
        return self.indexed_ds[self.avail_idxs[index]]

    # -- inference featurization ------------------------------------------
    def _binarizer_cls(self):
        return resolve_class(self.hparams.get(
            "binarizer_cls", "fastdiff_tpu.data.binarizer.VocoderBinarizer"))

    def _load_test_inputs(self, test_input_dir: str):
        paths = sorted(glob.glob(f"{test_input_dir}/*.wav")
                       + glob.glob(f"{test_input_dir}/**/*.wav"))
        binarizer = self._binarizer_cls()
        items, sizes = [], []
        for wav_fn in paths:
            item_name = os.path.relpath(wav_fn, test_input_dir).replace("/", "_")
            item = binarizer.process_item(
                item_name, wav_fn, self.hparams.get("binarization_args", {}),
                hparams=self.hparams)
            items.append(item)
            sizes.append(item["len"])
        return items, sizes

    def _load_mel_inputs(self, test_mel_dir: str):
        paths = sorted(glob.glob(f"{test_mel_dir}/*.npy"))
        binarizer = self._binarizer_cls()
        items, sizes = [], []
        for mel_fn in paths:
            mel = np.load(mel_fn)
            item_name = os.path.relpath(mel_fn, test_mel_dir).replace("/", "_")
            item = binarizer.process_mel_item(
                item_name, mel, None, self.hparams.get("binarization_args", {}))
            items.append(item)
            sizes.append(item["len"])
        return items, sizes


def crop_batch(items: List[dict], max_frames: int, hop_size: int,
               rng: np.random.Generator) -> dict:
    """Random aligned (mel, wav) crops -> fixed-shape arrays.

    Returns {'mels': (B, max_frames, n_mels) f32, 'wavs': (B, L, 1) f32}
    with L = max_frames * hop_size (dataset_utils.py:114-131 semantics, in
    NWC layout).
    """
    mels, wavs = [], []
    for item in items:
        mel = np.asarray(item["mel"], dtype=np.float32)       # (T, n_mels)
        wav = np.asarray(item["wav"], dtype=np.float32)       # (T*hop,)
        n_frames = mel.shape[0]
        start = int(rng.integers(0, n_frames - max_frames))
        mels.append(mel[start: start + max_frames])
        s = start * hop_size
        wavs.append(wav[s: s + max_frames * hop_size])
    return {
        "mels": np.stack(mels),
        "wavs": np.stack(wavs)[..., None],
    }


def endless_index_stream(n_items: int, seed: int, shuffle: bool,
                         shard_id: int = 0, num_shards: int = 1) -> Iterator[int]:
    """Infinite epoch-seeded index stream, rank-sharded.

    Epoch e uses RNG seed (seed + e) so every shard sees the same global
    permutation and takes a disjoint strided slice of it — the deterministic
    replacement for EndlessDistributedSampler (dataset_utils.py:31-40).
    """
    epoch = 0
    while True:
        if shuffle:
            order = np.random.default_rng(seed + epoch).permutation(n_items)
        else:
            order = np.arange(n_items)
        usable = (len(order) // num_shards) * num_shards
        for idx in order[shard_id:usable:num_shards]:
            yield int(idx)
        epoch += 1


def native_loader(dataset: VocoderDataset):
    """The C++ mmap loader of ``dataset``'s split where its v2 files exist,
    else None; raises where they exist and the library cannot be built or
    loaded."""
    if dataset._memory_items is not None or not dataset.data_dir:
        return None
    prefix = os.path.join(dataset.data_dir, dataset.prefix)
    if not native_io.has_v2(prefix):
        return None
    return native_io.NativeBatchLoader(prefix)


def train_batch_iterator(dataset: VocoderDataset, batch_size: int,
                         max_frames: int, seed: int = 1234,
                         shard_id: int = 0, num_shards: int = 1,
                         endless: bool = True) -> Iterator[dict]:
    """Yield fixed-shape training batches forever (or one epoch).

    The endless stream crops through the native loader where the split has
    v2 files (``native_loader``), drawing the crop starts as the pickle
    path does; otherwise, and for one epoch, from the pickle shards."""
    rng = np.random.default_rng(seed + 1000 * shard_id)
    hop = dataset.hop_size
    if endless:
        native = native_loader(dataset)
        stream = endless_index_stream(len(dataset), seed, True,
                                      shard_id, num_shards)
        buf = []
        for idx in stream:
            buf.append(idx)
            if len(buf) < batch_size:
                continue
            if native is not None:
                raw = np.asarray([dataset.avail_idxs[i] for i in buf],
                                 np.int64)
                starts = np.asarray(
                    [rng.integers(0, dataset.sizes[i] - max_frames)
                     for i in buf], np.int64)
                yield native.load(raw, starts, max_frames, hop,
                                  native.item_n_mels(int(raw[0])))
            else:
                yield crop_batch([dataset[i] for i in buf], max_frames, hop,
                                 rng)
            buf = []
    else:
        order = np.random.default_rng(seed).permutation(len(dataset))
        usable = (len(order) // num_shards) * num_shards
        order = order[shard_id:usable:num_shards]
        for i in range(0, len(order) - batch_size + 1, batch_size):
            items = [dataset[int(j)] for j in order[i: i + batch_size]]
            yield crop_batch(items, max_frames, hop, rng)


def infer_item_iterator(dataset: VocoderDataset) -> Iterator[dict]:
    """Yield full-utterance inference items: mel (1, T, n_mels) f32,
    optional ground-truth wav (1, L, 1)."""
    for i in range(len(dataset)):
        item = dataset[i]
        mel = np.asarray(item["mel"], dtype=np.float32)[None, ...]
        wav = np.asarray(item.get("wav", np.zeros(0)), dtype=np.float32)
        out = {"item_name": item["item_name"], "mels": mel}
        if wav.ndim == 1 and wav.size > 0:
            out["wavs"] = wav[None, :, None]
        yield out
