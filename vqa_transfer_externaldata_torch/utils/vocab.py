"""Vocabulary, tokenization and GloVe tooling (the port's own copy): the
question-word vocab, the top-K answer vocab over normalized answers, and
GloVe vectors filtered to a vocab as an embedding matrix.

Tokenizer: lowercase, punctuation to spaces, split on whitespace —
deterministic, so ids match the JAX package's bit for bit.
"""

from __future__ import annotations

import json
import re
from collections import Counter
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from vqa_transfer_externaldata_torch.utils.metrics import normalize_answer

# Special tokens. <pad>=0 so padded positions embed row 0 and can be masked
# by comparing ids against PAD_ID with no extra length plumbing.
PAD, UNK, BOS, EOS = "<pad>", "<unk>", "<s>", "</s>"
PAD_ID, UNK_ID, BOS_ID, EOS_ID = 0, 1, 2, 3
SPECIALS = [PAD, UNK, BOS, EOS]

_TOKEN_RE = re.compile(r"[^a-z0-9']+")


def tokenize(text: str) -> List[str]:
    """Deterministic question tokenizer: lowercase, punct→space, split."""
    return [t for t in _TOKEN_RE.sub(" ", text.lower()).split() if t]


@dataclass
class Vocab:
    """Token<->id mapping with fixed specials at the front."""

    tokens: List[str]
    token_to_id: Dict[str, int]

    @classmethod
    def build(cls, texts: Iterable[str], min_count: int = 1,
              max_size: Optional[int] = None) -> "Vocab":
        counts: Counter = Counter()
        for text in texts:
            counts.update(tokenize(text))
        # Deterministic order: by count desc, then lexicographic.
        items = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
        words = [w for w, c in items if c >= min_count and w not in SPECIALS]
        if max_size is not None:
            words = words[: max(0, max_size - len(SPECIALS))]
        tokens = SPECIALS + words
        return cls(tokens, {t: i for i, t in enumerate(tokens)})

    @classmethod
    def from_tokens(cls, tokens: Sequence[str]) -> "Vocab":
        tokens = list(tokens)
        if tokens[: len(SPECIALS)] != SPECIALS:
            raise ValueError(f"vocab must start with the specials {SPECIALS}")
        return cls(tokens, {t: i for i, t in enumerate(tokens)})

    def __len__(self) -> int:
        return len(self.tokens)

    def encode(self, text: str, max_len: int) -> Tuple[np.ndarray, int]:
        """Tokenize + map to ids, pad/truncate to ``max_len``.

        Returns (ids [max_len] int32, true length)."""
        ids = [self.token_to_id.get(t, UNK_ID) for t in tokenize(text)]
        ids = ids[:max_len]
        length = len(ids)
        out = np.full((max_len,), PAD_ID, dtype=np.int32)
        out[:length] = ids
        return out, length

    def decode(self, ids: Sequence[int]) -> List[str]:
        return [self.tokens[i] for i in ids if i != PAD_ID]

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump({"tokens": self.tokens}, fh)

    @classmethod
    def load(cls, path: str) -> "Vocab":
        with open(path) as fh:
            return cls.from_tokens(json.load(fh)["tokens"])


def build_answer_vocab(answers: Iterable[str], top_k: int) -> Vocab:
    """Top-K answer vocab over *normalized* answers, after the same
    specials as the word vocab (so <unk> absorbs the answers outside it),
    ordered by count, then lexicographically."""
    counts: Counter = Counter()
    for a in answers:
        norm = normalize_answer(a)
        if norm:
            counts[norm] += 1
    items = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    tokens = SPECIALS + [a for a, _ in items[:top_k]]
    return Vocab(tokens, {t: i for i, t in enumerate(tokens)})


# --- GloVe ------------------------------------------------------------------


def load_glove_txt(path: str, dim: int = 300,
                   vocab: Optional[Vocab] = None) -> Dict[str, np.ndarray]:
    """Parse a ``glove.*.300d.txt``-style file; optionally filter to a vocab."""
    keep = set(vocab.tokens) if vocab is not None else None
    vectors: Dict[str, np.ndarray] = {}
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            parts = line.rstrip("\n").split(" ")
            word = parts[0]
            if keep is not None and word not in keep:
                continue
            if len(parts) != dim + 1:
                continue
            vectors[word] = np.asarray(parts[1:], dtype=np.float32)
    return vectors


def glove_matrix(vocab: Vocab, vectors: Dict[str, np.ndarray],
                 dim: int = 300, seed: int = 0,
                 pad_to: Optional[int] = None) -> np.ndarray:
    """[V, dim] float32 embedding matrix: GloVe rows where available,
    N(0, 0.01) elsewhere, zeros for <pad>. ``pad_to`` rounds V up."""
    rng = np.random.default_rng(seed)
    size = len(vocab) if pad_to is None else max(pad_to, len(vocab))
    mat = rng.normal(0.0, 0.01, size=(size, dim)).astype(np.float32)
    for i, tok in enumerate(vocab.tokens):
        if tok in vectors:
            mat[i] = vectors[tok]
    mat[PAD_ID] = 0.0
    mat[len(vocab):] = 0.0  # padded rows are never valid ids
    return mat


def save_matrix(path: str, matrix: np.ndarray) -> None:
    np.savez_compressed(path, embedding=matrix)


def load_matrix(path: str) -> np.ndarray:
    return np.load(path)["embedding"]
