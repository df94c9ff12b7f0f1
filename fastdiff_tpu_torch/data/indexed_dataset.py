"""Binarized record store (a copy of ``fastdiff_tpu/data/indexed_dataset.py``),
on-disk format compatible with the reference.

Format (reference: utils/indexed_datasets.py:7-54):
- ``<prefix>.data``: concatenated pickled records.
- ``<prefix>.idx``:  numpy-saved dict ``{'offsets': [0, end_0, end_1, ...]}``.

Random reads are O(1) seeks; a small LRU keeps hot items (the reference keeps
one). Datasets binarized by the reference load here unchanged and vice versa.
"""

from __future__ import annotations

import pickle
from collections import OrderedDict

import numpy as np


class IndexedDataset:
    def __init__(self, path: str, num_cache: int = 8):
        self.path = path
        idx = np.load(f"{path}.idx", allow_pickle=True).item()
        self.data_offsets = list(idx["offsets"])
        self.data_file = open(f"{path}.data", "rb", buffering=-1)
        self.num_cache = num_cache
        self._cache: "OrderedDict[int, object]" = OrderedDict()

    def __len__(self) -> int:
        return len(self.data_offsets) - 1

    def __getitem__(self, i: int):
        if i < 0 or i >= len(self):
            raise IndexError(f"index {i} out of range [0, {len(self)})")
        if i in self._cache:
            self._cache.move_to_end(i)
            return self._cache[i]
        self.data_file.seek(self.data_offsets[i])
        raw = self.data_file.read(self.data_offsets[i + 1] - self.data_offsets[i])
        item = pickle.loads(raw)
        if self.num_cache > 0:
            self._cache[i] = item
            while len(self._cache) > self.num_cache:
                self._cache.popitem(last=False)
        return item

    def close(self):
        if self.data_file:
            self.data_file.close()
            self.data_file = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class IndexedDatasetBuilder:
    def __init__(self, path: str):
        self.path = path
        self.out_file = open(f"{path}.data", "wb")
        self.byte_offsets = [0]

    def add_item(self, item) -> None:
        written = self.out_file.write(pickle.dumps(item))
        self.byte_offsets.append(self.byte_offsets[-1] + written)

    def finalize(self) -> None:
        self.out_file.close()
        np.save(open(f"{self.path}.idx", "wb"), {"offsets": self.byte_offsets})
