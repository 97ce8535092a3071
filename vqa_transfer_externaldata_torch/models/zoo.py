"""Model registry: ``config.model.model`` -> a :class:`ModelSpec`, the
module with its batch adapter, its loss and its stage, so the trainer and
the CLI serve every ported family the same way.

Every family of the JAX package: the stage-2 families ``vqa_attention``
(``model.glimpses`` glimpses), ``vqa_attention2`` (two), ``vqa_baseline``
and the raw-image ``vqa_end2end`` (ResNet backbone + the attention head),
and the stage-1 families ``vlmap`` and ``vlmap_description``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.models.vlmap import (
    VLMapDescriptionModel, VLMapModel, vlmap_loss)
from vqa_transfer_externaldata_torch.models.vqa_attention import (
    VQAAttentionModel, vqa_loss)
from vqa_transfer_externaldata_torch.models.vqa_baseline import (
    VQABaselineModel)
from vqa_transfer_externaldata_torch.ops.layers import dtype_of

MODELS = ("vqa_attention", "vqa_attention2", "vqa_baseline", "vlmap",
          "vlmap_description", "vqa_end2end")


@dataclass(frozen=True)
class ModelSpec:
    """module: the model; inputs: batch -> positional arguments of its
    forward; loss: (outputs, batch) -> (scalar, metrics); stage: "vqa"
    (stage 2) or a stage-1 dataset prefix ("vlmap", "vlmap_desc");
    label_key: the batch column the loss needs (an evaluation split
    without it gets predictions only); visual_key: the batch column of the
    image features the model reads ("features" for a grid, "pool5" or
    "feature" for a vector)."""

    module: nn.Module
    inputs: Callable[[Dict[str, Any]], Tuple]
    loss: Callable[[Dict[str, torch.Tensor], Dict[str, Any]],
                   Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    stage: str
    label_key: str
    visual_key: str


def build_model(cfg: Config, word_init: Optional[np.ndarray] = None,
                generator: Optional[torch.Generator] = None) -> ModelSpec:
    """The configured model's spec, parameters on the CPU in float32,
    initialized from ``generator`` (or torch's default generator)."""
    m, d = cfg.model, cfg.data
    name = m.model
    dt = dtype_of(m.dtype)
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; known: {sorted(MODELS)}")
    if m.dense_candidate_loss and not name.startswith("vlmap"):
        raise ValueError(
            f"model.dense_candidate_loss is a vlmap-family training-loss "
            f"option; it does nothing for model.model={name!r}")
    if name == "vlmap":
        module = VLMapModel(
            d.vocab_size, num_tasks=m.num_tasks, feature_dim=d.pool5_dim,
            word_dim=m.word_dim, task_dim=m.task_dim, dropout=m.dropout,
            dtype=dt, dense_loss=m.dense_candidate_loss, word_init=word_init,
            generator=generator)
        return ModelSpec(module,
                         lambda b: (b["feature"], b["task"], b["candidates"]),
                         vlmap_loss, "vlmap", "label", "feature")
    if name == "vlmap_description":
        module = VLMapDescriptionModel(
            d.vocab_size, num_tasks=m.num_tasks, feature_dim=d.pool5_dim,
            word_dim=m.word_dim, rnn_dim=m.rnn_dim, task_dim=m.task_dim,
            dropout=m.dropout, dtype=dt, bidirectional=m.bidirectional_desc,
            dense_loss=m.dense_candidate_loss, use_pallas=m.use_pallas,
            word_init=word_init, generator=generator)
        return ModelSpec(module,
                         lambda b: (b["feature"], b["desc_ids"], b["task"],
                                    b["candidates"]),
                         vlmap_loss, "vlmap_desc", "label", "feature")
    if name == "vqa_baseline":
        module = VQABaselineModel(
            d.vocab_size, d.num_answers, feature_dim=d.pool5_dim,
            word_dim=m.word_dim, fusion_dim=m.fusion_dim, dropout=m.dropout,
            dtype=dt, word_init=word_init, generator=generator)
        return ModelSpec(module, lambda b: (b["pool5"], b["q_ids"]),
                         vqa_loss, "vqa", "answer_id", "pool5")
    if name == "vqa_end2end":
        from vqa_transfer_externaldata_torch.models.end2end import (
            VQAEnd2EndModel, end2end_loss)

        module = VQAEnd2EndModel(
            d.vocab_size, d.num_answers, word_dim=m.word_dim,
            rnn_dim=m.rnn_dim, fusion_dim=m.fusion_dim,
            att_hidden=m.att_hidden, answer_dim=m.answer_dim,
            dropout=m.dropout, dtype=dt, use_pallas=m.use_pallas,
            image_size=d.image_size, stage_sizes=resnet_stage_sizes(cfg),
            width=m.resnet_width, word_init=word_init, generator=generator)
        return ModelSpec(module, lambda b: (b["images"], b["q_ids"]),
                         end2end_loss, "vqa", "answer_id", "images")
    glimpses = 2 if name == "vqa_attention2" else max(1, m.glimpses)
    rnn_variant, use_pallas = m.rnn_variant, m.use_pallas
    if m.fidelity_mode:
        # The reference-convention assembly, as the JAX package's: the
        # TF1-exact GRU, float32, the plain gathered attention and one
        # glimpse; its forward is pinned to utils/fidelity.py's oracle.
        dt, rnn_variant, use_pallas, glimpses = torch.float32, "tf", False, 1
    module = VQAAttentionModel(
        d.vocab_size, d.num_answers, feature_dim=d.feature_dim,
        word_dim=m.word_dim, rnn_dim=m.rnn_dim, fusion_dim=m.fusion_dim,
        att_hidden=m.att_hidden, answer_dim=m.answer_dim, dropout=m.dropout,
        glimpses=glimpses, n_cells=d.grid_h * d.grid_w, dtype=dt,
        rnn_variant=rnn_variant, use_pallas=use_pallas,
        word_init=word_init, generator=generator)
    return ModelSpec(module, lambda b: (b["features"], b["q_ids"]), vqa_loss,
                     "vqa", "answer_id", "features")


def resnet_stage_sizes(cfg: Config) -> Tuple[int, ...]:
    """``model.resnet_stages`` ("3,4,23,3") as a tuple of block counts."""
    return tuple(int(s) for s in cfg.model.resnet_stages.split(","))


def example_batch(cfg: Config, batch_size: int = 1) -> Dict[str, np.ndarray]:
    """A zero-valued batch with the configured family's input columns and
    shapes (structure checks and shape-only builds, without data)."""
    d, m = cfg.data, cfg.model
    n = batch_size
    b: Dict[str, np.ndarray] = {
        "q_ids": np.zeros((n, d.max_question_len), np.int32),
        "answer_id": np.zeros((n,), np.int32),
    }
    name = m.model
    if name == "vqa_end2end":
        b["images"] = np.zeros((n, d.image_size, d.image_size, 3), np.uint8)
    elif name == "vqa_baseline":
        b["pool5"] = np.zeros((n, d.pool5_dim), np.float32)
    elif name.startswith("vlmap"):
        b["feature"] = np.zeros((n, d.pool5_dim), np.float32)
        b["task"] = np.zeros((n,), np.int32)
        b["candidates"] = np.zeros((n, m.num_candidates), np.int32)
        b["label"] = np.zeros((n,), np.int32)
        if name == "vlmap_description":
            b["desc_ids"] = np.zeros((n, d.max_question_len), np.int32)
    else:
        b["features"] = np.zeros((n, d.grid_h * d.grid_w, d.feature_dim),
                                 np.float32)
    return b
