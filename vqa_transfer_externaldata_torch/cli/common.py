"""Shared CLI assembly: config -> vocabs -> init matrices -> model spec, and
the run directory's name."""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.data.datasets import synthetic_vocabs
from vqa_transfer_externaldata_torch.models.zoo import ModelSpec, build_model
from vqa_transfer_externaldata_torch.utils.logging import log
from vqa_transfer_externaldata_torch.utils.vocab import (
    Vocab, glove_matrix, load_glove_txt, load_matrix)


def load_vocabs(cfg: Config) -> Tuple[Optional[Vocab], Optional[Vocab]]:
    """(word_vocab, answer_vocab) from config paths, or synthetic ones."""
    if cfg.data.synthetic:
        return synthetic_vocabs(cfg)
    wv = Vocab.load(cfg.data.vocab_path) if cfg.data.vocab_path else None
    av = (Vocab.load(cfg.data.answer_vocab_path)
          if cfg.data.answer_vocab_path else None)
    return wv, av


def load_word_init(cfg: Config,
                   word_vocab: Optional[Vocab]) -> Optional[np.ndarray]:
    """GloVe-initialized [vocab_size, word_dim] matrix, if configured."""
    path = cfg.data.glove_path
    if not path or word_vocab is None:
        return None
    if path.endswith(".npz"):
        mat = load_matrix(path)
    else:
        vectors = load_glove_txt(path, dim=cfg.model.word_dim,
                                 vocab=word_vocab)
        mat = glove_matrix(word_vocab, vectors, dim=cfg.model.word_dim,
                           pad_to=cfg.data.vocab_size)
    if mat.shape != (cfg.data.vocab_size, cfg.model.word_dim):
        raise ValueError(f"glove matrix {mat.shape} != "
                         f"({cfg.data.vocab_size}, {cfg.model.word_dim})")
    log.info("word embeddings initialized from %s", path)
    return mat


def build_spec(cfg: Config, generator: Optional[torch.Generator] = None
               ) -> Tuple[ModelSpec, Optional[Vocab], Optional[Vocab]]:
    """(spec, word_vocab, answer_vocab) of the configured run, the model
    initialized from ``generator``."""
    word_vocab, answer_vocab = load_vocabs(cfg)
    word_init = load_word_init(cfg, word_vocab)
    spec = build_model(cfg, word_init=word_init, generator=generator)
    return spec, word_vocab, answer_vocab


def resolve_train_dir(cfg: Config, stage: str) -> str:
    """``train.train_dir``, or a run directory inside it named after the
    stage (``ModelSpec.stage``) and the hyperparameters when it is the
    default ``train_dir``."""
    base = cfg.train.train_dir
    if os.path.basename(base.rstrip("/")) in ("train_dir", ""):
        return os.path.join(base, cfg.run_name(stage))
    return base
