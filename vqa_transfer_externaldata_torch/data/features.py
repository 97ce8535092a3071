"""Precomputed image-feature stores ([M, g, g, C] grids + [M, C] pool5),
the question table joined to one (``JoinedDataset``), and the extractor
that writes them (:func:`extract_features`: ResNet-101 over images or
region crops).

``FeatureStore`` reads the three layouts the extractor writes: an HDF5 file
(``grid``/``pool5``/``image_ids`` datasets), an ``.npz`` with the same keys,
or a raw directory (``meta.json`` + ``grid.f16.bin`` + ``pool5.f32.bin`` +
``image_ids.npy``), memory-mapped and gathered by the multi-threaded
native IO library (``data/native.py``; numpy fancy indexing where it is
not built).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional, Sequence

import numpy as np

from vqa_transfer_externaldata_torch.data import native
from vqa_transfer_externaldata_torch.data.datasets import ArrayDataset
from vqa_transfer_externaldata_torch.utils.logging import log


# Batch keys a store row's pool5 fills: stage 2's "pool5", and stage 1's
# "feature" (the region's pool5).
POOL5_KEYS = ("pool5", "feature")


class FeatureStore:
    """Random-access [M, ...] feature arrays, gathered by row."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._file = None
        self._raw = os.path.isdir(path)
        if self._raw:
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
        if self._raw:
            grid = native.gather_f16(self.grid, indices, widen=True)
            pool5 = native.gather_f32(self.pool5, indices)
        elif self._file is not None:
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
        self._raw = False
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


# ---------------------------------------------------------------------------
# Extraction
# ---------------------------------------------------------------------------


def _load_image(path: str, box: Optional[Sequence[int]] = None) -> np.ndarray:
    """An image file as [H, W, 3] uint8 RGB, cropped to ``box`` (x, y, w,
    h; at least one pixel a side) when given."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        if box is not None:
            x, y, w, h = box
            im = im.crop((x, y, x + max(1, w), y + max(1, h)))
        return np.asarray(im, np.uint8)


def _resize_host(img: np.ndarray, size: int) -> np.ndarray:
    """[H, W, 3] uint8 -> [size, size, 3] (PIL bilinear), unchanged when it
    has that size already."""
    from PIL import Image

    if img.shape[0] == size and img.shape[1] == size:
        return img
    return np.asarray(
        Image.fromarray(img).resize((size, size), Image.BILINEAR), np.uint8)


def extract_features(
    image_paths: Sequence[str],
    image_ids: Sequence[int],
    out_path: str,
    *,
    boxes: Optional[Sequence[Optional[Sequence[int]]]] = None,
    batch_size: int = 32,
    image_size: int = 448,
    state_dict: Optional[Mapping] = None,
    dtype: str = "bfloat16",
    fmt: str = "hdf5",
    device=None,
) -> str:
    """ResNet-101 over images (or their ``boxes`` crops) -> a feature store
    at ``out_path``: row k holds image k's grid (float16 [g, g, 2048], g =
    ``image_size`` / 32) and pool5 (float32 [2048]) under ``image_ids[k]``.

    ``fmt`` "raw": a directory of ``grid.f16.bin``, ``pool5.f32.bin``,
    ``image_ids.npy`` and ``meta.json``; "hdf5": one file with ``grid``,
    ``pool5`` and ``image_ids`` datasets (``h5py`` is imported only here).
    ``state_dict``: :class:`~..ops.resnet.ResNetV1`'s weights and
    BatchNorm statistics (``ops.resnet.convert_torch_state_dict`` of a
    torchvision checkpoint); without it the weights are random, for
    pipeline tests only, and a warning says so. Batches are padded to
    ``batch_size`` with copies of their first image, so every forward has
    one shape. Runs on CUDA unless ``device`` says otherwise."""
    import torch

    from vqa_transfer_externaldata_torch.ops.layers import dtype_of
    from vqa_transfer_externaldata_torch.ops.resnet import (
        BACKBONE_STEM, ResNetV1, preprocess_images)
    from vqa_transfer_externaldata_torch.serving import resolve_device

    if fmt not in ("hdf5", "raw"):
        raise ValueError(f"fmt={fmt!r}: expected 'hdf5' or 'raw'")
    dev = resolve_device(device)
    if state_dict is None:
        log.warning("extract_features: RANDOM ResNet weights (tests only)")
        model = ResNetV1(dtype=dtype_of(dtype), stem=BACKBONE_STEM,
                         generator=torch.Generator().manual_seed(0))
    else:
        with torch.device("meta"):  # no init: the weights are given
            model = ResNetV1(dtype=dtype_of(dtype), stem=BACKBONE_STEM)
        model.load_state_dict(state_dict, assign=True)
    model.to(dev).eval()
    n = len(image_paths)
    boxes = boxes if boxes is not None else [None] * n
    g, C = image_size // 32, model.out_channels

    if fmt == "raw":
        os.makedirs(out_path, exist_ok=True)
        d_grid = np.memmap(os.path.join(out_path, "grid.f16.bin"),
                           dtype=np.float16, mode="w+", shape=(n, g, g, C))
        d_pool = np.memmap(os.path.join(out_path, "pool5.f32.bin"),
                           dtype=np.float32, mode="w+", shape=(n, C))
        np.save(os.path.join(out_path, "image_ids.npy"),
                np.asarray(image_ids, np.int64))
        with open(os.path.join(out_path, "meta.json"), "w") as fh:
            json.dump({"grid_shape": [n, g, g, C], "pool5_dim": C}, fh)
        closer = lambda: (d_grid.flush(), d_pool.flush())
    else:
        import h5py

        os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                    exist_ok=True)
        f = h5py.File(out_path, "w")
        d_grid = f.create_dataset("grid", (n, g, g, C), dtype="f2",
                                  chunks=(1, g, g, C))
        d_pool = f.create_dataset("pool5", (n, C), dtype="f4")
        f.create_dataset("image_ids", data=np.asarray(image_ids, np.int64))
        closer = f.close

    try:
        for start in range(0, n, batch_size):
            stop = min(start + batch_size, n)
            imgs = np.stack([
                _resize_host(_load_image(image_paths[i], boxes[i]),
                             image_size) for i in range(start, stop)])
            pad = batch_size - imgs.shape[0]
            if pad:  # one shape for every forward
                imgs = np.concatenate([imgs, np.repeat(imgs[:1], pad, 0)])
            with torch.inference_mode():
                x = preprocess_images(torch.from_numpy(imgs).to(dev),
                                      image_size)
                out = model(x)
                grid = out["grid"].to(torch.float16).cpu().numpy()
                pool5 = out["pool5"].cpu().numpy()
            d_grid[start:stop] = grid[:stop - start]
            d_pool[start:stop] = pool5[:stop - start]
            if (start // batch_size) % 50 == 0:
                log.info("extracted %d/%d", stop, n)
    finally:
        closer()
    log.info("features written to %s", out_path)
    return out_path
