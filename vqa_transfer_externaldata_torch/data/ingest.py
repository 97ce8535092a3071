"""Raw-image ingest of the end-to-end model: COCO JPEGs and a preprocessed
question table -> uint8 image batches, decoded on host worker threads and
resized to the model's static input; normalization runs on the device
(``ops/resnet.py::preprocess_images``).

A batch decodes in one call of the native libjpeg library
(``data/native.py``: parallel C++ threads, PIL's triangle resize, within
one 8-bit step of PIL's pixels) where that is built; a file it rejects
(missing, CMYK, ...) decodes with PIL, and where the library cannot be
built every file does, on ``DECODE_WORKERS`` threads (``PIL`` is imported
only when a file is decoded).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Sequence

import numpy as np

from vqa_transfer_externaldata_torch.data import native
from vqa_transfer_externaldata_torch.data.datasets import ArrayDataset
from vqa_transfer_externaldata_torch.data.features import (
    _load_image, _resize_host)

DECODE_WORKERS = 8  # host threads decoding a batch's images with PIL


def _decode_pil(path: str, size: int) -> np.ndarray:
    """One image file -> [size, size, 3] uint8 RGB (PIL bilinear resize
    when its size differs): extraction's decoder, and :func:`_decode`'s
    for a file the native library rejects or where it is not built."""
    return _resize_host(_load_image(path), size)


def _decode(path: str, size: int) -> np.ndarray:
    """One image file -> [size, size, 3] uint8 RGB: the decoder of
    training, evaluation and serving (the native library where it is built
    and takes the file, PIL otherwise), so served pixels are the training
    distribution's."""
    decoded = native.decode_jpeg_batch([path], size)
    if decoded is not None:
        images, status = decoded
        if status[0] == 0:
            return images[0]
    return _decode_pil(path, size)


class ImageQuestionDataset(ArrayDataset):
    """Question table + on-the-fly JPEG decode, keyed by ``image_index``:
    row i of ``image_paths`` is the image of index i. Every batch that
    :meth:`take` makes (and so :meth:`batches` and the evaluator's padded
    batches) gets ``images`` [B, S, S, 3] uint8 (:meth:`_decode_batch`)."""

    def __init__(self, arrays: Dict[str, np.ndarray],
                 image_paths: Sequence[str], *, image_size: int = 448
                 ) -> None:
        super().__init__(arrays)
        self.image_paths = list(image_paths)
        self.image_size = image_size
        self._pool = ThreadPoolExecutor(max_workers=DECODE_WORKERS)

    def take(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        batch = super().take(idx)
        batch["images"] = self._decode_batch(
            [self.image_paths[i] for i in batch["image_index"]])
        return batch

    def _decode_batch(self, paths: Sequence[str]) -> np.ndarray:
        """One native call for the batch, PIL for each file it rejects;
        without the library, PIL on the pool's threads."""
        size = self.image_size
        decoded = native.decode_jpeg_batch(paths, size)
        if decoded is None:
            return np.stack(list(self._pool.map(
                lambda p: _decode_pil(p, size), paths)))
        images, status = decoded
        for i in np.flatnonzero(status):
            images[i] = _decode_pil(paths[i], size)
        return images

    def close(self) -> None:
        self._pool.shutdown(wait=False)


def coco_image_path(image_dir: str, split: str, image_id: int) -> str:
    """Official COCO-2014 naming: ``COCO_<split>_<id:012d>.jpg``."""
    return os.path.join(image_dir, f"COCO_{split}_{image_id:012d}.jpg")


def build_image_question_dataset(
        question_npz: str, image_dir: str, coco_split: str,
        image_ids: Sequence[int], *, image_size: int = 448
        ) -> ImageQuestionDataset:
    """The raw-image training set: a preprocessed question table (the
    output of ``cli.preprocess vqa_v2``, whose ``image_index`` indexes
    ``image_ids``) joined with the COCO JPEGs of ``image_dir``."""
    with np.load(question_npz) as f:
        arrays = {k: f[k] for k in f.files}
    paths = [coco_image_path(image_dir, coco_split, i) for i in image_ids]
    return ImageQuestionDataset(arrays, paths, image_size=image_size)
