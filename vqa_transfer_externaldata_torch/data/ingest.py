"""Raw-image ingest of the end-to-end model: COCO JPEGs and a preprocessed
question table -> uint8 image batches, decoded on host worker threads and
resized to the model's static input; normalization runs on the device
(``ops/resnet.py::preprocess_images``).

The decoder is PIL (``PIL`` is imported only when a file is decoded). The
JAX package decodes with its native libjpeg library where that is built
(within one 8-bit step of PIL's pixels) and with PIL otherwise; the port
has no native decoder (ROADMAP.md, section 1, item 14c).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Sequence

import numpy as np

from vqa_transfer_externaldata_torch.data.datasets import ArrayDataset
from vqa_transfer_externaldata_torch.data.features import (
    _load_image, _resize_host)

DECODE_WORKERS = 8  # host threads decoding a batch's images


def _decode_pil(path: str, size: int) -> np.ndarray:
    """One image file -> [size, size, 3] uint8 RGB (PIL bilinear resize
    when its size differs): the decoder of training, evaluation, serving
    and extraction, so served pixels are the training distribution's."""
    return _resize_host(_load_image(path), size)


class ImageQuestionDataset(ArrayDataset):
    """Question table + on-the-fly JPEG decode, keyed by ``image_index``:
    row i of ``image_paths`` is the image of index i. Every batch that
    :meth:`take` makes (and so :meth:`batches` and the evaluator's padded
    batches) gets ``images`` [B, S, S, 3] uint8, decoded by a pool of
    ``DECODE_WORKERS`` threads."""

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
        size = self.image_size
        return np.stack(list(self._pool.map(lambda p: _decode_pil(p, size),
                                            paths)))

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
