"""Precomputed image-feature stores ([M, g, g, C] grids + [M, C] pool5)
and the question table joined to one (``JoinedDataset``).

``FeatureStore`` reads the three layouts the extractor writes: an HDF5 file
(``grid``/``pool5``/``image_ids`` datasets), an ``.npz`` with the same keys,
or a raw directory (``meta.json`` + ``grid.f16.bin`` + ``pool5.f32.bin`` +
``image_ids.npy``) read through ``np.memmap`` fancy indexing.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np

from vqa_transfer_externaldata_torch.data.datasets import ArrayDataset


# Batch keys a store row's pool5 fills: stage 2's "pool5", and stage 1's
# "feature" (the region's pool5).
POOL5_KEYS = ("pool5", "feature")


class FeatureStore:
    """Random-access [M, ...] feature arrays, gathered by row."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._file = None
        if os.path.isdir(path):
            with open(os.path.join(path, "meta.json")) as fh:
                meta = json.load(fh)
            gshape = tuple(meta["grid_shape"])  # [M, g, g, C]
            self.grid = np.memmap(os.path.join(path, "grid.f16.bin"),
                                  dtype=np.float16, mode="r", shape=gshape)
            self.pool5 = np.memmap(
                os.path.join(path, "pool5.f32.bin"), dtype=np.float32,
                mode="r", shape=(gshape[0], meta["pool5_dim"]))
            self.image_ids = np.load(os.path.join(path, "image_ids.npy"))
        elif path.endswith((".h5", ".hdf5")):
            import h5py

            self._file = h5py.File(path, "r")
            self.grid = self._file["grid"]
            self.pool5 = self._file["pool5"]
            self.image_ids = np.asarray(self._file["image_ids"])
        else:
            data = np.load(path)
            self.grid = data["grid"]
            self.pool5 = data["pool5"]
            self.image_ids = data["image_ids"]
        self.index_of = {int(i): k for k, i in enumerate(self.image_ids)}

    def gather(self, indices: np.ndarray, *, flatten_grid: bool = True
               ) -> Dict[str, np.ndarray]:
        """Rows ``indices`` as float32 ``features`` ([n, g*g, C], or
        [n, g, g, C] unflattened) and ``pool5`` ([n, C])."""
        indices = np.asarray(indices)
        if self._file is not None:
            # h5py fancy indexing requires sorted unique indices.
            uniq, inverse = np.unique(indices, return_inverse=True)
            grid = np.asarray(self.grid[uniq])[inverse]
            pool5 = np.asarray(self.pool5[uniq])[inverse]
        else:
            grid = self.grid[indices]
            pool5 = self.pool5[indices]
        grid = np.asarray(grid, np.float32)
        if flatten_grid and grid.ndim == 4:
            b, h, w, c = grid.shape
            grid = grid.reshape(b, h * w, c)
        return {"features": grid, "pool5": np.asarray(pool5, np.float32)}

    def close(self) -> None:
        if self._file is not None:
            self._file.close()


class InMemoryFeatureStore(FeatureStore):
    """FeatureStore over arrays already in memory (synthetic corpora,
    tests, benchmarks) — same gather contract, no file backend."""

    def __init__(self, grid: np.ndarray, pool5: np.ndarray,
                 image_ids: Optional[np.ndarray] = None) -> None:
        self.path = "<memory>"
        self._file = None
        self.grid = grid
        self.pool5 = pool5
        self.image_ids = (image_ids if image_ids is not None
                          else np.arange(grid.shape[0], dtype=np.int64))
        self.index_of = {int(i): k for k, i in enumerate(self.image_ids)}


class JoinedDataset(ArrayDataset):
    """Question/region table + lazy feature join by ``index_key``: the
    store stays deduplicated, and :meth:`take` gathers the rows' features
    under ``feature_keys`` ("features" the grid, "pool5" the pooled
    vector, and for stage 1 "feature", the region's pool5). The resident
    trainer uploads the table and the store once instead."""

    def __init__(self, arrays: Dict[str, np.ndarray], store: FeatureStore,
                 index_key: str = "image_index",
                 feature_keys: Sequence[str] = ("features", "pool5")) -> None:
        super().__init__(arrays)
        self.store = store
        self.index_key = index_key
        self.feature_keys = tuple(feature_keys)

    def take(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        batch = super().take(idx)
        feats = self.store.gather(batch[self.index_key])
        for key in self.feature_keys:
            batch[key] = feats["pool5" if key in POOL5_KEYS else key]
        return batch
