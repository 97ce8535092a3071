"""Visual Genome preprocessing and unsupervised task discovery (the port's
own copy of the JAX package's numpy-only module): region descriptions ->
stage-1 training artifacts, bit-equal to the JAX package's for the same
files and the same WordNet answers.

Visual words (objects, attributes) are mined from the region phrases by
frequency, then grouped into *tasks*, word groups within which the stage-1
classifier discriminates: by WordNet lexicographer class (noun.animal,
adj.all, ...) when ``nltk`` and its WordNet corpus are there, else by
deterministic frequency buckets. Where ``nltk`` itself is missing the port
takes the buckets too, where the JAX package stops with an error.

- Word level (``vlmap_<split>.npz``): region_index [N] (the region's row in
  the region feature store), task [N], word [N] (the positive word id),
  candidates [N, K] (same-task words, the positive planted at label),
  label [N].
- Description blanks (``vlmap_desc_<split>.npz``): the same plus desc_ids
  [N, T] (the phrase, the target word replaced by <unk>), blank_pos [N]
  and pattern [N] (0 object, 1 attribute, 2 relationship blank).

``vlmap[_desc]_meta.json`` holds the task names and each task's word pool,
which :class:`CandidateResampler` draws fresh negatives from.
"""

from __future__ import annotations

import functools
import json
import os
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from vqa_transfer_externaldata_torch.data.datasets import (
    attach_candidate_counts)
from vqa_transfer_externaldata_torch.utils.logging import log
from vqa_transfer_externaldata_torch.utils.vocab import (
    PAD_ID, UNK_ID, Vocab, tokenize)


class CandidateResampler:
    """A stage-1 dataset whose training batches get fresh negatives: each
    batch's candidates are redrawn from the row's task pool, the positive
    planted at a random label, from one stream seeded by
    ``SeedSequence([seed, 0xC0FFEE])`` (the JAX package's, draw for draw).
    ``take`` (evaluation) keeps the stored candidate sets. With
    ``count_vocab_size`` > 0 each batch also carries its candidate counts
    (``model.dense_candidate_loss``), built from the fresh draw."""

    def __init__(self, base, task_words: Dict[int, Sequence[int]],
                 num_candidates: int, seed: int = 0,
                 count_vocab_size: int = 0) -> None:
        self.base = base
        self.arrays = base.arrays
        self.size = base.size
        self.pools = {int(t): np.asarray(ids, np.int32)
                      for t, ids in task_words.items()}
        self.K = num_candidates
        self.seed = seed
        self.count_vocab_size = count_vocab_size

    def __len__(self) -> int:
        return self.size

    def take(self, idx):
        return self.base.take(idx)

    def batches(self, batch_size: int, **kw):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, 0xC0FFEE]))
        for batch in self.base.batches(batch_size, **kw):
            n = batch["word"].shape[0]
            # A task without a pool (a stale vlmap_meta.json) would leave
            # its rows' np.empty values as negatives.
            unknown = set(np.unique(batch["task"]).tolist()) \
                - self.pools.keys()
            if unknown:
                raise ValueError(
                    f"CandidateResampler: batch tasks {sorted(unknown)} "
                    "have no candidate pool — task_words (vlmap_meta.json) "
                    "does not match this dataset's task table")
            cands = np.empty((n, self.K), np.int32)
            for t, pool in self.pools.items():
                sel = np.where(batch["task"] == t)[0]
                if sel.size:
                    cands[sel] = rng.choice(pool, size=(sel.size, self.K))
            label = rng.integers(0, self.K, size=n).astype(np.int32)
            cands[np.arange(n), label] = batch["word"]
            batch = dict(batch)
            batch["candidates"] = cands
            batch["label"] = label
            if self.count_vocab_size:
                batch = attach_candidate_counts(batch, self.count_vocab_size)
            yield batch


STOPWORDS = frozenset(
    "a an the of in on at is are was were be been being with and or to "
    "for from by as it its this that these those there here very his her "
    "their our your my he she they we you i".split())


def load_region_descriptions(path: str) -> List[dict]:
    """VG ``region_descriptions.json`` -> the flat region list
    [{"image_id", "region_id", "phrase", "x", "y", "width", "height"}]."""
    with open(path) as fh:
        data = json.load(fh)
    regions = []
    for image in data:
        image_id = image.get("id", image.get("image_id"))
        for r in image["regions"]:
            regions.append({
                "image_id": image_id, "region_id": r["region_id"],
                "phrase": r["phrase"], "x": r["x"], "y": r["y"],
                "width": r["width"], "height": r["height"]})
    return regions


def mine_visual_words(phrases: Sequence[str], *, min_count: int = 50,
                      max_words: int = 5000) -> List[str]:
    """Frequent non-stopword tokens, by count, then lexicographically."""
    counts: Counter = Counter()
    for p in phrases:
        counts.update(t for t in tokenize(p)
                      if t not in STOPWORDS and not t.isdigit())
    items = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    return [w for w, c in items[:max_words] if c >= min_count]


@functools.lru_cache(maxsize=1)
def _wordnet():
    """nltk's WordNet reader with its corpus loaded, or None (logged once)
    where ``nltk`` or the corpus is missing. Loaded once: a missing corpus
    costs nltk a search of its data paths on every lookup."""
    try:
        from nltk.corpus import wordnet as wn

        wn.synsets  # the first attribute read loads the corpus
    except (ImportError, LookupError) as e:
        log.warning("WordNet unavailable (%s: nltk or its wordnet corpus "
                    "is missing): task discovery takes frequency buckets",
                    type(e).__name__)
        return None
    return wn


def _wordnet_lexname(word: str) -> Optional[str]:
    """WordNet lexicographer class of the word's first noun/adj/verb sense;
    None without one, and without ``nltk`` or its WordNet corpus."""
    wn = _wordnet()
    if wn is None:
        return None
    for pos in ("n", "a", "s", "v"):
        synsets = wn.synsets(word, pos=pos)
        if synsets:
            return synsets[0].lexname()
    return None


def discover_tasks(words: Sequence[str], num_tasks: int,
                   *, min_task_size: int = 8
                   ) -> Tuple[Dict[str, int], List[str]]:
    """Group the visual words into tasks: (word -> task id, task names).

    By WordNet lexname when any word has one: the largest groups of at
    least ``min_task_size`` words become tasks, the rest merge into task 0
    ("misc"). Otherwise frequency-rank buckets (``words`` is ordered by
    frequency).
    """
    lexnames = {w: _wordnet_lexname(w) for w in words}
    if any(v is not None for v in lexnames.values()):
        groups: Dict[str, List[str]] = defaultdict(list)
        for w in words:
            groups[lexnames[w] or "misc"].append(w)
        ranked = sorted(groups.items(), key=lambda kv: (-len(kv[1]), kv[0]))
        task_names = ["misc"] + [name for name, members in ranked
                                 if name != "misc" and
                                 len(members) >= min_task_size]
        task_names = task_names[:num_tasks]
        index = {name: i for i, name in enumerate(task_names)}
        word_to_task = {
            w: index.get(lexnames[w] or "misc", 0) for w in words}
        log.info("task discovery via WordNet: %d tasks", len(task_names))
        return word_to_task, task_names
    task_names = [f"freq_bucket_{i}" for i in range(num_tasks)]
    word_to_task = {w: i % num_tasks for i, w in enumerate(words)}
    log.info("task discovery fallback: %d frequency buckets", num_tasks)
    return word_to_task, task_names


def _task_pools(regions: Sequence[dict], word_vocab: Vocab, num_tasks: int,
                min_word_count: int, max_words: int):
    """(phrases, visual words in the vocab, word -> task, task names,
    task -> word ids) of the regions."""
    phrases = [r["phrase"] for r in regions]
    words = mine_visual_words(phrases, min_count=min_word_count,
                              max_words=max_words)
    words = [w for w in words if w in word_vocab.token_to_id]
    word_to_task, task_names = discover_tasks(words, num_tasks)
    task_words: Dict[int, List[int]] = defaultdict(list)
    for w in words:
        task_words[word_to_task[w]].append(word_vocab.token_to_id[w])
    return phrases, words, word_to_task, task_names, task_words


def _candidates(rng: np.random.Generator, rows_arr: np.ndarray,
                task_words: Dict[int, List[int]], K: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(candidates [n, K], label [n]): same-task negatives drawn with
    replacement, the row's word planted at label."""
    n = rows_arr.shape[0]
    candidates = np.zeros((n, K), np.int32)
    label = rng.integers(0, K, size=n).astype(np.int32)
    for t, ids in task_words.items():
        sel = np.where(rows_arr[:, 1] == t)[0]
        if sel.size == 0:
            continue
        candidates[sel] = rng.choice(np.asarray(ids, np.int32),
                                     size=(sel.size, K))
    candidates[np.arange(n), label] = rows_arr[:, 2].astype(np.int32)
    return candidates, label


def _val_split(rng: np.random.Generator, n: int, val_fraction: float
               ) -> Dict[str, np.ndarray]:
    order = rng.permutation(n)
    n_val = max(1, int(n * val_fraction)) if n > 1 else 0
    return {"train": order[n_val:], "val": order[:n_val]}


def build_vlmap_artifacts(
    regions: Sequence[dict],
    word_vocab: Vocab,
    *,
    num_tasks: int = 32,
    num_candidates: int = 512,
    min_word_count: int = 50,
    max_words: int = 5000,
    seed: int = 0,
    out_dir: Optional[str] = None,
    val_fraction: float = 0.05,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Regions -> task-conditional word examples of both splits (one per
    distinct visual word of a phrase), written to ``out_dir`` with
    ``region_meta.npz`` (row r = region r: the image id and box from which
    a region feature store is extracted) and ``vlmap_meta.json``."""
    phrases, words, word_to_task, task_names, task_words = _task_pools(
        regions, word_vocab, num_tasks, min_word_count, max_words)
    rng = np.random.default_rng(seed)
    rows = []  # (region_index, task, word_id)
    wset = {w: word_vocab.token_to_id[w] for w in words}
    for idx, phrase in enumerate(phrases):
        for tok in set(tokenize(phrase)):
            if tok in wset:
                rows.append((idx, word_to_task[tok], wset[tok]))
    if not rows:
        raise ValueError("no visual-word occurrences found; lower "
                         "min_word_count or check the vocab")
    rows_arr = np.asarray(rows, np.int64)
    n = rows_arr.shape[0]
    candidates, label = _candidates(rng, rows_arr, task_words,
                                    num_candidates)
    out = {}
    for name, sel in _val_split(rng, n, val_fraction).items():
        if sel.size == 0:
            continue
        arrays = {
            "region_index": rows_arr[sel, 0].astype(np.int32),
            "task": rows_arr[sel, 1].astype(np.int32),
            "word": rows_arr[sel, 2].astype(np.int32),
            "candidates": candidates[sel],
            "label": label[sel],
        }
        out[name] = arrays
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            np.savez_compressed(
                os.path.join(out_dir, f"vlmap_{name}.npz"), **arrays)
    if out_dir is not None:
        np.savez_compressed(
            os.path.join(out_dir, "region_meta.npz"),
            image_id=np.asarray([r["image_id"] for r in regions], np.int64),
            bbox=np.asarray([[r["x"], r["y"], r["width"], r["height"]]
                             for r in regions], np.int32))
    meta = {"task_names": task_names,
            "num_examples": int(n), "num_words": len(words),
            "task_words": {str(t): [int(w) for w in ids]
                           for t, ids in task_words.items()}}
    if out_dir is not None:
        with open(os.path.join(out_dir, "vlmap_meta.json"), "w") as fh:
            json.dump(meta, fh)
    log.info("vlmap artifacts: %d examples, %d visual words, %d tasks",
             n, len(words), len(task_names))
    return out


PATTERN_NAMES = ("object", "attribute", "relationship")


def classify_blank_pattern(tokens: Sequence[str], pos: int,
                           visual: frozenset) -> int:
    """The blank kind of ``tokens[pos]`` (an index into
    :data:`PATTERN_NAMES`): an object blank sits at the phrase's content
    tail, an attribute blank directly precedes a visual word, anything
    else is a relationship blank."""
    content = [i for i, t in enumerate(tokens)
               if t not in STOPWORDS and not t.isdigit()]
    if not content or pos == content[-1]:
        return 0
    if pos + 1 < len(tokens) and tokens[pos + 1] in visual:
        return 1
    return 2


def build_vlmap_description_artifacts(
    regions: Sequence[dict],
    word_vocab: Vocab,
    *,
    num_tasks: int = 32,
    num_candidates: int = 512,
    min_word_count: int = 50,
    max_words: int = 5000,
    max_desc_len: int = 26,
    seed: int = 0,
    out_dir: Optional[str] = None,
    val_fraction: float = 0.05,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Description blank-fill examples (``vlmap_desc_<split>.npz``), one
    per (phrase, first occurrence of a visual word): the word is blanked
    out of the tokenized phrase (<unk> at ``blank_pos``) and is the
    positive among same-task candidates; ``vlmap_desc_meta.json`` adds the
    count of each blank pattern."""
    phrases, words, word_to_task, task_names, task_words = _task_pools(
        regions, word_vocab, num_tasks, min_word_count, max_words)
    visual = frozenset(words)
    T = max_desc_len
    rng = np.random.default_rng(seed)
    rows: List[Tuple[int, int, int, int, int]] = []
    desc_rows: List[np.ndarray] = []
    for idx, phrase in enumerate(phrases):
        tokens = tokenize(phrase)[:T]
        ids = np.full((T,), PAD_ID, np.int32)
        for j, t in enumerate(tokens):
            ids[j] = word_vocab.token_to_id.get(t, UNK_ID)
        seen = set()
        for pos, tok in enumerate(tokens):
            if tok not in visual or tok in seen:
                continue
            seen.add(tok)
            pattern = classify_blank_pattern(tokens, pos, visual)
            rows.append((idx, word_to_task[tok],
                         word_vocab.token_to_id[tok], pos, pattern))
            blanked = ids.copy()
            blanked[pos] = UNK_ID
            desc_rows.append(blanked)
    if not rows:
        raise ValueError("no blankable visual-word occurrences found; "
                         "lower min_word_count or check the vocab")
    rows_arr = np.asarray(rows, np.int64)
    desc_ids = np.stack(desc_rows)
    n = rows_arr.shape[0]
    candidates, label = _candidates(rng, rows_arr, task_words,
                                    num_candidates)
    out = {}
    for name, sel in _val_split(rng, n, val_fraction).items():
        if sel.size == 0:
            continue
        arrays = {
            "region_index": rows_arr[sel, 0].astype(np.int32),
            "task": rows_arr[sel, 1].astype(np.int32),
            "word": rows_arr[sel, 2].astype(np.int32),
            "desc_ids": desc_ids[sel],
            "blank_pos": rows_arr[sel, 3].astype(np.int32),
            "pattern": rows_arr[sel, 4].astype(np.int32),
            "candidates": candidates[sel],
            "label": label[sel],
        }
        out[name] = arrays
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            np.savez_compressed(
                os.path.join(out_dir, f"vlmap_desc_{name}.npz"), **arrays)
    counts = np.bincount(rows_arr[:, 4], minlength=3)
    meta = {"task_names": task_names,
            "pattern_names": list(PATTERN_NAMES),
            "pattern_counts": {PATTERN_NAMES[i]: int(c)
                               for i, c in enumerate(counts)},
            "num_examples": int(n), "num_words": len(words),
            "task_words": {str(t): [int(w) for w in ids_]
                           for t, ids_ in task_words.items()}}
    if out_dir is not None:
        with open(os.path.join(out_dir, "vlmap_desc_meta.json"), "w") as fh:
            json.dump(meta, fh)
    log.info("vlmap_desc artifacts: %d blanks (%s), %d words, %d tasks",
             n, dict(meta["pattern_counts"]), len(words), len(task_names))
    return out
