"""Dataset helpers of the port. Only the synthetic vocabularies are here so
far: they are all a synthetic run needs to serve."""

from __future__ import annotations

from typing import Tuple

from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.utils.vocab import SPECIALS, Vocab


def synthetic_vocabs(cfg: Config) -> Tuple[Vocab, Vocab]:
    """Deterministic word/answer vocabs for synthetic mode: every answer
    token is a word-vocab token, the same lists the JAX package builds."""
    d = cfg.data
    words = SPECIALS + [f"w{i}" for i in range(d.vocab_size - len(SPECIALS))]
    answers = SPECIALS + [f"w{i}"
                          for i in range(d.num_answers - len(SPECIALS))]
    return Vocab.from_tokens(words), Vocab.from_tokens(answers)
