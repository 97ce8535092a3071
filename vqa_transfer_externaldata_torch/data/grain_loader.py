"""The grain input pipeline (``--data.input_pipeline grain``): the question
tables, feature-store joins and JPEG decodes of the other pipelines as a
``grain.MapDataset``, whose per-epoch shuffle is deterministic and whose
iterator state is a small JSON dict, so a resumed run continues on the
exact next sample (``GrainTrainIterator``; the Trainer saves the state
beside each checkpoint).

``grain`` is imported only where a pipeline is built, so the package
imports without it. grain itself imports JAX's tree utilities where JAX
is installed and falls back to ``dm-tree`` where it is not; the port needs
neither.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from vqa_transfer_externaldata_torch.data.ingest import _decode


class _QuestionImageSource:
    """Random-access grain source over (question row, JPEG path): each row
    decodes its image (``ingest._decode``) under ``images``."""

    def __init__(self, arrays: Dict[str, np.ndarray],
                 image_paths: Sequence[str], image_size: int) -> None:
        self.arrays = arrays
        self.image_paths = list(image_paths)
        self.image_size = image_size
        self._n = next(iter(arrays.values())).shape[0]

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        row = {k: v[i] for k, v in self.arrays.items()}
        row["images"] = _decode(
            self.image_paths[int(row["image_index"])], self.image_size)
        return row


def make_grain_dataset(arrays: Dict[str, np.ndarray],
                       image_paths: Sequence[str], *,
                       image_size: int = 448,
                       batch_size: int = 256,
                       seed: int = 0,
                       shuffle: bool = True,
                       num_epochs: Optional[int] = None):
    """A ``grain.MapDataset`` over a question table and its JPEGs: shuffle,
    decode, fixed-shape batches (the remainder dropped). Iterate it in
    process, or through ``to_iter_dataset()`` + ``mp_prefetch`` for decode
    in worker processes."""
    import grain

    ds = grain.MapDataset.source(
        _QuestionImageSource(arrays, image_paths, image_size))
    if shuffle:
        ds = ds.shuffle(seed=seed)
    if num_epochs is not None and num_epochs > 1:
        ds = ds.repeat(num_epochs)
    return ds.batch(batch_size, drop_remainder=True)


class _ArraySource:
    """Random-access grain source over a plain row table (no decode)."""

    def __init__(self, arrays: Dict[str, np.ndarray]) -> None:
        self.arrays = arrays
        self._n = next(iter(arrays.values())).shape[0]

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        return {k: v[i] for k, v in self.arrays.items()}


class _JoinedRowSource:
    """Random-access grain source over a feature-store dataset
    (``data/features.JoinedDataset``): each row comes from the dataset's
    own ``take`` of that one row, so the join (``features``/``pool5``/
    ``feature``) is the other pipelines'. With workers the store must
    pickle (npz and raw stores do; an open HDF5 file does not)."""

    def __init__(self, dataset) -> None:
        self.dataset = dataset
        self._n = len(dataset)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        row = self.dataset.take(np.array([int(i)]))
        return {k: v[0] for k, v in row.items()}


class GrainTrainIterator:
    """Checkpointable endless training iterator: source -> seeded
    per-epoch shuffle -> repeat -> batches, on grain's deterministic index
    iterator. The source follows the dataset: JPEGs decoded per row for an
    ``ImageQuestionDataset``, ``take`` per row for a ``JoinedDataset``, the
    row table otherwise. :meth:`get_state` is a JSON dict, saved beside
    each checkpoint (``CheckpointManager.save_data_iter``), and
    :meth:`set_state` resumes on the exact next sample.

    ``shard=(k, n)``: data rank k of n. Every rank shuffles the same
    seeded permutation, trims it to a multiple of n (unequal slices would
    put the ranks' epoch boundaries apart, and a sample could appear on
    two ranks in one global batch) and takes every n-th row from k, in
    batches of ``batch_size / n``; all ranks draw alike, so rank 0's state
    is every rank's position. ``workers`` > 0 runs the sources in that
    many grain worker processes (``mp_prefetch``), with the same state.

    ``read_ahead``: batches read ahead by as many threads (0: none; the
    Trainer's ``train.prefetch_batches``). grain's default, which the JAX
    package keeps, reads 500 batches ahead: 100 GB of float32 grids at
    batch 256 on the 14x14x2048 store. The batches and states are the
    same at any depth."""

    def __init__(self, dataset, *, batch_size: int, seed: int,
                 workers: int = 0, shard=(0, 1), read_ahead: int = 2
                 ) -> None:
        import grain

        if hasattr(dataset, "image_paths"):  # raw JPEGs (vqa_end2end)
            source = _QuestionImageSource(
                {k: np.asarray(v) for k, v in dataset.arrays.items()},
                dataset.image_paths, dataset.image_size)
        elif hasattr(dataset, "store"):  # a feature-store join
            source = _JoinedRowSource(dataset)
        else:
            source = _ArraySource(
                {k: np.asarray(v) for k, v in dataset.arrays.items()})
        pi, pc = shard
        if batch_size % pc:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{pc} data ranks")
        ds = grain.MapDataset.source(source).shuffle(seed=seed)
        if pc > 1:
            ds = ds[:(len(source) // pc) * pc][pi::pc]
        ds = ds.repeat(None).batch(batch_size // pc, drop_remainder=True)
        it_ds = ds.to_iter_dataset(grain.ReadOptions(
            num_threads=read_ahead, prefetch_buffer_size=read_ahead))
        if workers > 0:
            it_ds = it_ds.mp_prefetch(
                grain.MultiprocessingOptions(num_workers=workers))
        self._it = iter(it_ds)

    def __iter__(self) -> "GrainTrainIterator":
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        return {k: np.asarray(v) for k, v in next(self._it).items()}

    def get_state(self) -> dict:
        return self._it.get_state()

    def set_state(self, state: dict) -> None:
        self._it.set_state(state)
