"""Vocoder dataset and host-side batch pipeline for training, a copy of the
parts of ``fastdiff_tpu/data/dataset.py`` that the trainer reads.

- train/valid items shorter than the crop window are filtered out using
  ``<prefix>_lengths.npy`` (reference: tasks/vocoder/dataset_utils.py:66-72);
- the collater random-crops aligned (mel-frame, wav-sample) windows of
  ``max_samples`` (dataset_utils.py:114-131), so every batch has one shape;
- the endless sampler is an epoch-seeded shuffled index stream sharded by
  (shard_id, num_shards), the host-side replacement for
  ``EndlessDistributedSampler``'s rank-strided indices
  (dataset_utils.py:31-40).

Items are read from the pickle shards (``data/indexed_dataset.py``). The
JAX package's C++ mmap loader (``fastdiff_tpu/data/native_io.py``) and the
featurization of raw ``test_input_dir`` / ``test_mel_dir`` inputs are not
ported; the crops and their order are the pickle path's.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional

import numpy as np

from fastdiff_tpu_torch.data.indexed_dataset import IndexedDataset


class VocoderDataset:
    def __init__(self, hparams: dict, prefix: str, shuffle: bool = False):
        if prefix == "test" and (hparams.get("test_input_dir")
                                 or hparams.get("test_mel_dir")):
            raise NotImplementedError(
                "featurizing test_input_dir / test_mel_dir is not ported; "
                "the port reads binarized splits only")
        self.hparams = hparams
        self.prefix = prefix
        self.shuffle = shuffle
        self.data_dir = hparams["binary_data_dir"]
        self.hop_size = int(hparams["hop_size"])
        self.is_infer = prefix == "test"
        self.batch_max_frames = (0 if self.is_infer
                                 else int(hparams["max_samples"]) // self.hop_size)
        self.indexed_ds: Optional[IndexedDataset] = None
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
        if self.indexed_ds is None:
            self.indexed_ds = IndexedDataset(
                os.path.join(self.data_dir, self.prefix))
        return self.indexed_ds[self.avail_idxs[index]]


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


def train_batch_iterator(dataset: VocoderDataset, batch_size: int,
                         max_frames: int, seed: int = 1234,
                         shard_id: int = 0, num_shards: int = 1,
                         endless: bool = True) -> Iterator[dict]:
    """Yield fixed-shape training batches forever (or one epoch), cropped
    from the pickle shards."""
    rng = np.random.default_rng(seed + 1000 * shard_id)
    hop = dataset.hop_size
    if endless:
        stream = endless_index_stream(len(dataset), seed, True,
                                      shard_id, num_shards)
        buf = []
        for idx in stream:
            buf.append(idx)
            if len(buf) < batch_size:
                continue
            yield crop_batch([dataset[i] for i in buf], max_frames, hop, rng)
            buf = []
    else:
        order = np.random.default_rng(seed).permutation(len(dataset))
        usable = (len(order) // num_shards) * num_shards
        order = order[shard_id:usable:num_shards]
        for i in range(0, len(order) - batch_size + 1, batch_size):
            items = [dataset[int(j)] for j in order[i: i + batch_size]]
            yield crop_batch(items, max_frames, hop, rng)
