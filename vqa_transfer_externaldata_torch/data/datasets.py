"""Datasets of the port: a dict-of-arrays dataset with the JAX package's
seeded index stream, the synthetic corpora of stage 1 (region-word and
description blank fill) and stage 2 (flat, and the deduplicated store),
the synthetic two-stage transfer corpus, the dense candidate counts,
``load_dataset`` for the synthetic corpora and for the preprocessed
artifacts (``cli/preprocess.py``), a prefetching batch iterator, and the
synthetic vocabularies. Arrays are numpy, equal to the JAX package's for
the same config, seed and artifacts; the trainer moves them to the device.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.utils.vocab import SPECIALS, Vocab


class ArrayDataset:
    """Dict-of-arrays dataset with seeded shuffling + drop-last batching.
    The index stream is the JAX package's, draw for draw."""

    def __init__(self, arrays: Dict[str, np.ndarray]) -> None:
        sizes = {k: v.shape[0] for k, v in arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"ragged arrays: {sizes}")
        self.arrays = arrays
        self.size = next(iter(sizes.values()))

    def __len__(self) -> int:
        return self.size

    def take(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        """The rows at ``idx`` as a batch dict (subclasses with lazy
        columns override this)."""
        return {k: v[idx] for k, v in self.arrays.items()}

    def batches(self, batch_size: int, *, shuffle: bool = True,
                seed: int = 0, epochs: Optional[int] = None,
                drop_last: bool = True,
                shard: Optional[Tuple[int, int]] = None
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Fixed-shape batches; infinite if ``epochs`` is None. With
        ``shard=(k, n)`` (data parallelism over n ranks) rank k's
        ``batch_size / n`` rows of each global batch
        (:meth:`index_batches`)."""
        for idx in self.index_batches(batch_size, shuffle=shuffle, seed=seed,
                                      epochs=epochs, drop_last=drop_last,
                                      shard=shard):
            yield self.take(idx)

    def index_batches(self, batch_size: int, *, shuffle: bool = True,
                      seed: int = 0, epochs: Optional[int] = None,
                      drop_last: bool = True,
                      shard: Optional[Tuple[int, int]] = None
                      ) -> Iterator[np.ndarray]:
        """The index stream behind :meth:`batches`: epoch ``e`` is the
        permutation of ``default_rng(SeedSequence([seed, e]))``, cut into
        int32 batches. The resident trainer consumes it directly.

        ``shard=(k, n)``: each epoch's permutation is trimmed to a multiple
        of n (so that every rank sees as many batches) and rank k takes
        every n-th entry from the k-th, in batches of ``batch_size / n``;
        ``batch_size`` stays the global batch (``ValueError`` unless n
        divides it)."""
        if drop_last and self.size < batch_size:
            raise ValueError(
                f"dataset has {self.size} rows < batch_size {batch_size} "
                f"with drop_last: no batch can ever be produced")
        local_bs = batch_size
        if shard is not None and shard[1] > 1:
            if batch_size % shard[1]:
                raise ValueError(f"global batch {batch_size} not divisible "
                                 f"by process count {shard[1]}")
            local_bs = batch_size // shard[1]
        epoch = 0
        while epochs is None or epoch < epochs:
            if shuffle:
                order = np.random.default_rng(
                    np.random.SeedSequence([seed, epoch])).permutation(
                        self.size)
            else:
                order = np.arange(self.size)
            if shard is not None and shard[1] > 1:
                k, n = shard
                order = order[:(order.size // n) * n][k::n]
            limit = (order.size // local_bs) * local_bs if drop_last \
                else order.size
            for start in range(0, limit, local_bs):
                yield order[start:start + local_bs].astype(np.int32)
            epoch += 1

    def save(self, path: str) -> None:
        np.savez_compressed(path, **self.arrays)

    @classmethod
    def load(cls, path: str) -> "ArrayDataset":
        """The arrays of an ``.npz`` file, or of an ``.h5``/``.hdf5`` file's
        top-level datasets (``h5py`` is imported only then)."""
        if path.endswith((".h5", ".hdf5")):
            import h5py

            with h5py.File(path, "r") as f:
                return cls({k: np.asarray(f[k]) for k in f.keys()})
        with np.load(path) as f:
            return cls({k: f[k] for k in f.files})


def attach_candidate_counts(arrays: Dict[str, np.ndarray],
                            vocab_size: int) -> Dict[str, np.ndarray]:
    """Inputs of the dense candidate loss (``model.dense_candidate_loss``):
    each row's candidate multiset as counts ``cand_counts`` [N, V] (uint8
    when K < 256, else uint16: K bounds every count), and the positive
    ``word`` column (= candidates[label]) unless present. Counts carry
    duplicate candidates, so the count-weighted dense CE is exactly the
    K-candidate CE (``models/vlmap._vlmap_dense_loss``)."""
    cand = np.asarray(arrays["candidates"])
    n, K = cand.shape
    if K > np.iinfo(np.uint16).max:
        raise ValueError(f"num_candidates={K} overflows uint16 counts")
    dtype = np.uint8 if K < 256 else np.uint16
    counts = np.zeros((n, vocab_size), dtype)
    # bincount over row-offset ids, in chunks whose int64 bins stay ~64 MB.
    chunk = max(1, (1 << 23) // max(vocab_size, 1))
    for i in range(0, n, chunk):
        c = cand[i:i + chunk]
        flat = c.astype(np.int64) + \
            np.arange(c.shape[0], dtype=np.int64)[:, None] * vocab_size
        counts[i:i + chunk] = np.bincount(
            flat.ravel(), minlength=c.shape[0] * vocab_size
        ).reshape(c.shape[0], vocab_size).astype(dtype)
    out = dict(arrays)
    out["cand_counts"] = counts
    if "word" not in out:
        out["word"] = cand[np.arange(n), np.asarray(arrays["label"])] \
            .astype(np.int32)
    return out


def synthetic_vlmap(cfg: Config, *, size: Optional[int] = None,
                    seed: int = 0) -> ArrayDataset:
    """Synthetic stage-1 data: the region feature determines the positive
    word through a fixed projection; the candidates are random words with
    the positive planted at a random index. With the dense candidate loss
    the rows carry their candidate counts."""
    d, m = cfg.data, cfg.model
    n = size or d.synthetic_size
    K = m.num_candidates
    rng = np.random.default_rng(seed)
    feature = rng.standard_normal((n, d.pool5_dim), dtype=np.float32)
    task = rng.integers(0, m.num_tasks, size=n).astype(np.int32)
    proj = np.random.default_rng(42).standard_normal(
        (d.pool5_dim, d.vocab_size), dtype=np.float32)
    positive = 4 + (np.argmax(feature @ proj, axis=1) % (d.vocab_size - 4))
    candidates = rng.integers(4, d.vocab_size, size=(n, K)).astype(np.int32)
    label = rng.integers(0, K, size=n).astype(np.int32)
    candidates[np.arange(n), label] = positive
    arrays = {"feature": feature, "task": task,
              "candidates": candidates, "label": label.astype(np.int32)}
    if m.dense_candidate_loss:
        arrays = attach_candidate_counts(arrays, d.vocab_size)
    return ArrayDataset(arrays)


def synthetic_vlmap_desc(cfg: Config, *, size: Optional[int] = None,
                         seed: int = 0) -> ArrayDataset:
    """Synthetic description blank fill: :func:`synthetic_vlmap` plus a
    phrase ``desc_ids`` [n, T] whose token after the blank (wrapping) is
    the positive word, a sequential cue for the description encoder."""
    base = synthetic_vlmap(cfg, size=size, seed=seed)
    d = cfg.data
    n = base.size
    rng = np.random.default_rng(seed + 7)
    T = d.max_question_len
    desc = rng.integers(4, d.vocab_size, size=(n, T)).astype(np.int32)
    blank_pos = rng.integers(0, T, size=n).astype(np.int32)
    word = base.arrays["word"] if "word" in base.arrays else \
        base.arrays["candidates"][np.arange(n), base.arrays["label"]]
    desc[np.arange(n), (blank_pos + 1) % T] = word
    desc[np.arange(n), blank_pos] = 1  # <unk> blank
    arrays = dict(base.arrays)
    arrays["desc_ids"] = desc
    arrays["blank_pos"] = blank_pos
    return ArrayDataset(arrays)


def synthetic_vqa(cfg: Config, *, size: Optional[int] = None,
                  seed: int = 0, with_scores: bool = False) -> ArrayDataset:
    """Synthetic stage-2 data in the flat layout: every question carries
    its own [N, C] float32 grid (``features``), or for ``vqa_end2end`` its
    own uint8 image (``images`` [S, S, 3]), and ``pool5``; the answer is
    a fixed projection of pool5, so the loss can be driven below chance.
    Given the same config and seed, the arrays equal the JAX package's
    (whose cache under ``~/.cache/vqa_synth`` is never read here: nothing is
    cached on disk)."""
    d = cfg.data
    n = size or d.synthetic_size
    rng = np.random.default_rng(seed)
    N = d.grid_h * d.grid_w
    q_len = rng.integers(3, d.max_question_len + 1, size=n)
    q_ids = np.zeros((n, d.max_question_len), np.int32)
    for i, L in enumerate(q_len):
        q_ids[i, :L] = rng.integers(4, d.vocab_size, size=L)
    pool5 = rng.standard_normal((n, d.pool5_dim), dtype=np.float32)
    arrays = {"q_ids": q_ids, "pool5": pool5}
    if cfg.model.model == "vqa_end2end":
        # Raw pixels in place of the grid, drawn where the JAX package
        # draws them, so the stream stays JAX's.
        arrays["images"] = rng.integers(
            0, 256, size=(n, d.image_size, d.image_size, 3)).astype(np.uint8)
    else:
        # Low-rank grid expansion: a thin random factor times a fixed
        # mixing matrix gives full-size grids in one BLAS call.
        rank = 32
        thin = rng.standard_normal((n * N, rank), dtype=np.float32)
        mix = np.random.default_rng(99).standard_normal(
            (rank, d.feature_dim), dtype=np.float32)
        mix /= np.float32(np.sqrt(rank))
        grid = (thin @ mix).reshape(n, N, d.feature_dim)
        grid += pool5[:, None, : d.feature_dim]
        arrays["features"] = grid
    proj = np.random.default_rng(1234).standard_normal(
        (d.pool5_dim, d.num_answers), dtype=np.float32)
    answer = 4 + (np.argmax(pool5 @ proj, axis=1) % (d.num_answers - 4))
    arrays["answer_id"] = answer.astype(np.int32)
    if with_scores:
        scores = np.zeros((n, d.num_answers), np.float32)
        scores[np.arange(n), answer] = 1.0
        arrays["answer_scores"] = scores
    return ArrayDataset(arrays)


def synthetic_vqa_joined(cfg: Config, *, n_questions: int = 4096,
                         n_images: int = 512, seed: int = 0,
                         with_scores: bool = False):
    """Deduplicated synthetic corpus in the production layout: a feature
    store of ``n_images`` grids (f16, like extraction output) plus a
    question table that references it by ``image_index``. The answer is a
    fixed projection of the image's pool5, so the loss can be driven below
    chance. Given the same config and seed, the arrays equal the JAX
    package's. Returns a :class:`~.features.JoinedDataset`; nothing is
    cached on disk."""
    from vqa_transfer_externaldata_torch.data.features import (
        InMemoryFeatureStore, JoinedDataset)

    d = cfg.data
    rng = np.random.default_rng(seed)
    N = d.grid_h * d.grid_w
    pool5 = rng.standard_normal((n_images, d.pool5_dim), dtype=np.float32)
    # Low-rank grid expansion: a thin random factor times a fixed mixing
    # matrix gives full-size grids in one BLAS call per chunk of images.
    rank = 32
    mix = np.random.default_rng(99).standard_normal(
        (rank, d.feature_dim), dtype=np.float32) / np.float32(np.sqrt(rank))
    grid = np.empty((n_images, N, d.feature_dim), np.float16)
    for lo in range(0, n_images, 256):
        hi = min(lo + 256, n_images)
        thin = rng.standard_normal(((hi - lo) * N, rank), dtype=np.float32)
        chunk = (thin @ mix).reshape(hi - lo, N, d.feature_dim)
        chunk += pool5[lo:hi, None, : d.feature_dim]
        grid[lo:hi] = chunk

    q_len = rng.integers(3, d.max_question_len + 1, size=n_questions)
    q_ids = np.zeros((n_questions, d.max_question_len), np.int32)
    for i, L in enumerate(q_len):
        q_ids[i, :L] = rng.integers(4, d.vocab_size, size=L)
    image_index = rng.integers(0, n_images,
                               size=n_questions).astype(np.int32)
    proj = np.random.default_rng(1234).standard_normal(
        (d.pool5_dim, d.num_answers), dtype=np.float32)
    answer = 4 + (np.argmax(pool5[image_index] @ proj, axis=1)
                  % (d.num_answers - 4))
    rows = {"q_ids": q_ids, "image_index": image_index,
            "answer_id": answer.astype(np.int32)}
    if with_scores:
        scores = np.zeros((n_questions, d.num_answers), np.float32)
        scores[np.arange(n_questions), answer] = 1.0
        rows["answer_scores"] = scores
    return JoinedDataset(rows, InMemoryFeatureStore(grid, pool5),
                         index_key="image_index",
                         feature_keys=("features", "pool5"))


def synthetic_transfer_corpus(cfg: Config, *, n_vlmap: int = 4096,
                              n_train: int = 4096, n_val: int = 1024,
                              oov_fraction: float = 0.25,
                              noise: float = 0.3, seed: int = 0):
    """The synthetic two-stage corpus of the paper's claim: answers never
    seen as stage-2 targets are answered through the transferred word
    space. Every answer word ``a`` owns a unit concept vector ``c_a``.
    Stage-1 (``vlmap``) rows cover ALL answer words, pairing noisy
    features ``c_a + eps`` with the word; stage-2 train rows use only the
    in-vocabulary answers, the val rows all of them. Equal to the JAX
    package's arrays for the same config and seed.

    Needs ``data.feature_dim == data.pool5_dim`` (one concept space for
    both stages). Returns ``(vlmap_ds, vqa_train_ds, vqa_val_ds,
    oov_answer_ids)``."""
    d, m = cfg.data, cfg.model
    if d.feature_dim != d.pool5_dim:
        raise ValueError(
            "synthetic_transfer_corpus shares one concept space: set "
            f"feature_dim == pool5_dim (got {d.feature_dim} vs "
            f"{d.pool5_dim})")
    A, D = d.num_answers, d.pool5_dim
    rng = np.random.default_rng(seed)
    answer_ids = np.arange(4, A, dtype=np.int32)  # skip specials
    n_oov = max(1, int(round(answer_ids.size * oov_fraction)))
    oov_ids = np.sort(rng.choice(answer_ids, size=n_oov, replace=False))
    in_ids = np.setdiff1d(answer_ids, oov_ids)

    concept = np.zeros((A, D), np.float32)
    concept[4:] = rng.standard_normal((A - 4, D)).astype(np.float32)
    concept /= np.maximum(
        np.linalg.norm(concept, axis=1, keepdims=True), 1e-6)

    # Stage 1: the external data covers every answer word.
    K = m.num_candidates
    w = rng.choice(answer_ids, size=n_vlmap).astype(np.int32)
    feature = (concept[w] + noise * rng.standard_normal(
        (n_vlmap, D)).astype(np.float32))
    task = ((w - 4) % m.num_tasks).astype(np.int32)
    candidates = rng.choice(answer_ids, size=(n_vlmap, K)).astype(np.int32)
    label = rng.integers(0, K, size=n_vlmap).astype(np.int32)
    candidates[np.arange(n_vlmap), label] = w
    vlmap_ds = ArrayDataset({"feature": feature, "task": task,
                             "candidates": candidates, "label": label})

    N = d.grid_h * d.grid_w
    T = d.max_question_len

    def vqa_rows(n: int, ids: np.ndarray) -> ArrayDataset:
        a = rng.choice(ids, size=n).astype(np.int32)
        grid = (concept[a][:, None, :] + noise * rng.standard_normal(
            (n, N, D)).astype(np.float32))
        # The questions are filler: the image determines the answer.
        q_ids = rng.integers(4, d.vocab_size, size=(n, T)).astype(np.int32)
        scores = np.zeros((n, A), np.float32)
        scores[np.arange(n), a] = 1.0
        return ArrayDataset({"features": grid, "q_ids": q_ids,
                             "answer_id": a, "answer_scores": scores})

    return vlmap_ds, vqa_rows(n_train, in_ids), vqa_rows(n_val, answer_ids), \
        oov_ids


def load_dataset(cfg: Config, split: str, stage: str = "vqa"
                 ) -> ArrayDataset:
    """The dataset of ``split`` for ``stage`` ("vqa", "vlmap" or
    "vlmap_desc").

    With ``data.synthetic``: the synthetic stage-1 corpora
    (``data.synthetic_size`` rows) or either stage-2 layout, ``flat`` (a
    grid per question) or ``joined`` (``data.synthetic_size`` questions
    over a store of 1/8 as many images), seeded by the split as in the
    JAX package.

    Otherwise the artifact ``<stage>_<split>.npz`` (or ``.hdf5``) of
    ``data.dataset_dir``, as the JAX package loads it:

    - a stage-1 train split with ``data.resample_negatives`` and a
      ``<stage>_meta.json`` is wrapped in a
      :class:`~.visualgenome.CandidateResampler` over its task pools;
    - with ``model.dense_candidate_loss`` a stage-1 train split gets its
      stored candidate counts where the stored candidate sets are what
      trains (device-resident, or no resampler), refused past 16 GB;
    - with ``data.feature_path`` the table is joined lazily against that
      feature store: stage 1 by ``region_index`` into ``feature`` (the
      region's pool5), stage 2 by ``image_index`` into ``features`` and
      ``pool5``.

    - ``vqa_end2end`` with ``data.image_dir`` joins the table against
      raw COCO JPEGs instead (:class:`~.ingest.ImageQuestionDataset`):
      row k of ``image_ids.npy`` in ``data.dataset_dir`` is the image of
      ``image_index`` k, named for the split's COCO split
      (``data.coco_split``, or train2014 / val2014 / test2015 from
      ``split``)."""
    d = cfg.data
    if not d.synthetic:
        return _load_artifacts(cfg, split, stage)
    if d.synthetic_layout not in ("flat", "joined"):
        raise ValueError(f"data.synthetic_layout={d.synthetic_layout!r}: "
                         "expected 'flat' or 'joined'")
    seed = {"train": 0, "val": 1, "test": 2}.get(split, 3)
    if stage == "vlmap":
        return synthetic_vlmap(cfg, seed=seed)
    if stage == "vlmap_desc":
        return synthetic_vlmap_desc(cfg, seed=seed)
    if stage != "vqa":
        raise ValueError(f"unknown stage {stage!r}: expected 'vqa', "
                         "'vlmap' or 'vlmap_desc'")
    if d.synthetic_layout == "flat":
        return synthetic_vqa(cfg, seed=seed, with_scores=(split != "train"))
    n_q = d.synthetic_size
    return synthetic_vqa_joined(cfg, n_questions=n_q,
                                n_images=max(1, n_q // 8), seed=seed,
                                with_scores=(split != "train"))


def _load_artifacts(cfg: Config, split: str, stage: str):
    """The artifact branch of :func:`load_dataset`."""
    d, m = cfg.data, cfg.model
    path = os.path.join(d.dataset_dir, f"{stage}_{split}.npz")
    if not os.path.exists(path):
        path_h5 = os.path.join(d.dataset_dir, f"{stage}_{split}.hdf5")
        if not os.path.exists(path_h5):
            raise FileNotFoundError(
                f"no preprocessed {stage}/{split} artifact under "
                f"{d.dataset_dir}; run cli.preprocess or set "
                "--data.synthetic true")
        path = path_h5
    ds = ArrayDataset.load(path)
    stage1_train = stage.startswith("vlmap") and split == "train"
    # Whether a CandidateResampler wraps this split is decided first: it
    # decides whether the stored candidate counts are needed.
    task_words = None
    if stage1_train and d.resample_negatives:
        meta_path = os.path.join(d.dataset_dir, f"{stage}_meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as fh:
                task_words = json.load(fh).get("task_words")
    if (stage1_train and m.dense_candidate_loss
            and "candidates" in ds.arrays
            and (cfg.train.device_data_cache or task_words is None)):
        # The stored candidate sets train here (resident, or streamed with
        # no resampler); a streamed resampler counts each fresh draw.
        itemsize = 1 if m.num_candidates < 256 else 2
        gb = ds.size * d.vocab_size * itemsize / 2 ** 30
        if gb > 16:
            raise ValueError(
                f"model.dense_candidate_loss needs a [N={ds.size}, "
                f"V={d.vocab_size}] candidate-count array ({gb:.1f} GB "
                "host-side) for stored candidate sets — beyond the "
                "supported scale. Use the gathered CE (drop the flag), or "
                "stream with resampled negatives (data.resample_negatives "
                "+ vlmap_meta.json), where counts are built per batch "
                "instead.")
        ds = ArrayDataset(attach_candidate_counts(ds.arrays, d.vocab_size))
    if stage == "vqa" and m.model == "vqa_end2end" and d.image_dir:
        return _image_question_dataset(cfg, split, ds)
    if d.feature_path:
        from vqa_transfer_externaldata_torch.data.features import (
            FeatureStore, JoinedDataset)

        store = FeatureStore(d.feature_path)
        if stage.startswith("vlmap"):
            ds = JoinedDataset(ds.arrays, store, index_key="region_index",
                               feature_keys=("feature",))
        else:
            ds = JoinedDataset(ds.arrays, store, index_key="image_index",
                               feature_keys=("features", "pool5"))
    if task_words is not None:
        from vqa_transfer_externaldata_torch.data.visualgenome import (
            CandidateResampler)

        ds = CandidateResampler(
            ds, {int(t): ids for t, ids in task_words.items()},
            num_candidates=m.num_candidates,
            count_vocab_size=d.vocab_size if m.dense_candidate_loss else 0)
    return ds


def _image_question_dataset(cfg: Config, split: str, ds: ArrayDataset):
    """The raw-image branch of :func:`_load_artifacts`: ``ds``'s table
    joined by ``image_index`` with the JPEGs of ``data.image_dir``."""
    from vqa_transfer_externaldata_torch.data.ingest import (
        ImageQuestionDataset, coco_image_path)

    d = cfg.data
    ids_path = os.path.join(d.dataset_dir, "image_ids.npy")
    if not os.path.exists(ids_path):
        raise FileNotFoundError(
            f"end2end with data.image_dir needs {ids_path} (store row -> "
            "COCO image id, written by the extraction tool)")
    image_ids = np.load(ids_path)
    # Official COCO names embed the split (COCO_val2014_... for VQA v2 val
    # questions): derived from the dataset split unless set.
    coco_split = d.coco_split or {
        "train": "train2014", "val": "val2014", "test": "test2015",
        "test-dev": "test2015"}.get(split, split)
    paths = [coco_image_path(d.image_dir, coco_split, int(i))
             for i in image_ids]
    return ImageQuestionDataset(dict(ds.arrays), paths,
                                image_size=d.image_size)


class PrefetchIterator:
    """Background-thread prefetch over a batch iterator: a worker thread
    prepares the next ``depth`` batches (feature gathers, file reads) while
    the device runs the current step. An exception in the worker is raised
    to the consumer at the batch where it happened."""

    def __init__(self, it: Iterator[Dict[str, np.ndarray]],
                 depth: int = 2) -> None:
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._done = object()
        self._exc: Optional[BaseException] = None

        def worker() -> None:
            try:
                for item in it:
                    self._q.put(item)
            except BaseException as e:  # handed to the consumer below
                self._exc = e
            finally:
                self._q.put(self._done)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        item = self._q.get()
        if item is self._done:
            self._q.put(self._done)  # later calls stop too
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item


def synthetic_vocabs(cfg: Config) -> Tuple[Vocab, Vocab]:
    """Deterministic word/answer vocabs for synthetic mode: every answer
    token is a word-vocab token, the same lists the JAX package builds."""
    d = cfg.data
    words = SPECIALS + [f"w{i}" for i in range(d.vocab_size - len(SPECIALS))]
    answers = SPECIALS + [f"w{i}"
                          for i in range(d.num_answers - len(SPECIALS))]
    return Vocab.from_tokens(words), Vocab.from_tokens(answers)
