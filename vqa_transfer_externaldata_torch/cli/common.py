"""Shared CLI assembly: config -> vocabs -> init matrices -> model spec, the
raw-image model's pretrained backbone, the run directory's name and this
rank's device."""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

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


def load_resnet_backbone(cfg: Config) -> Optional[Dict[str, torch.Tensor]]:
    """The raw-image model's backbone weights and BatchNorm statistics (the
    ``state_dict`` of its ``resnet``) from the torchvision-format resnet101
    state dict of ``model.resnet_checkpoint``; None when no checkpoint is
    configured. Without one the backbone stays random (synthetic runs,
    tests)."""
    path = cfg.model.resnet_checkpoint
    if not path:
        return None
    if cfg.model.model != "vqa_end2end":
        raise ValueError("--model.resnet_checkpoint only applies to the "
                         "raw-image model (vqa_end2end); use cli.extract "
                         "--torch_checkpoint for offline extraction")
    from vqa_transfer_externaldata_torch.models.end2end import (
        VQAEnd2EndModel)
    from vqa_transfer_externaldata_torch.models.zoo import resnet_stage_sizes
    from vqa_transfer_externaldata_torch.ops.resnet import (
        convert_torch_state_dict)

    sd = torch.load(path, map_location="cpu", weights_only=True)
    try:
        converted = convert_torch_state_dict(
            sd, stage_sizes=resnet_stage_sizes(cfg),
            stem=VQAEnd2EndModel.stem)
    except KeyError as e:
        raise ValueError(
            f"resnet checkpoint {path} does not match "
            f"model.resnet_stages={cfg.model.resnet_stages} "
            f"(missing key {e})") from e
    log.info("pretrained ResNet backbone loaded from %s", path)
    return converted


def rank_device(device: Optional[str]) -> torch.device:
    """The device of this process: ``device``, else ``cuda:<LOCAL_RANK>``
    (``serving.resolve_device``), made the current card so that NCCL and
    every unindexed CUDA tensor use it."""
    from vqa_transfer_externaldata_torch.serving import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    return dev


def resolve_train_dir(cfg: Config, stage: str) -> str:
    """``train.train_dir``, or a run directory inside it named after the
    stage (``ModelSpec.stage``) and the hyperparameters when it is the
    default ``train_dir``."""
    base = cfg.train.train_dir
    if os.path.basename(base.rstrip("/")) in ("train_dir", ""):
        return os.path.join(base, cfg.run_name(stage))
    return base
