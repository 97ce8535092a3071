"""Model registry: ``config.model.model`` -> module.

Only ``vqa_attention`` (one glimpse) is ported so far; every other family
raises ``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.models.vqa_attention import (
    VQAAttentionModel)
from vqa_transfer_externaldata_torch.ops.layers import dtype_of

MODELS = ("vqa_attention", "vqa_attention2", "vqa_baseline", "vlmap",
          "vlmap_description", "vqa_end2end")

# Where each family not yet ported stands in ROADMAP.md, section 1.
_NOT_PORTED = {
    "vqa_attention2": "item 11 (two glimpses)",
    "vqa_baseline": "item 11",
    "vlmap": "item 10",
    "vlmap_description": "item 10",
    "vqa_end2end": "item 13",
}


def build_model(cfg: Config, word_init: Optional[np.ndarray] = None,
                generator: Optional[torch.Generator] = None
                ) -> VQAAttentionModel:
    """The configured model, parameters on the CPU in float32, initialized
    from ``generator`` (or torch's default generator)."""
    m, d = cfg.model, cfg.data
    name = m.model
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP.md, section 1, "
            f"{_NOT_PORTED[name]})")
    if name != "vqa_attention":
        raise KeyError(f"unknown model {name!r}; known: {sorted(MODELS)}")
    if m.glimpses > 1:
        raise NotImplementedError(
            "model.glimpses > 1 is not ported yet (ROADMAP.md, section 1, "
            f"{_NOT_PORTED['vqa_attention2']})")
    if m.fidelity_mode or m.rnn_variant != "cudnn":
        raise NotImplementedError(
            "the TF1-exact GRU (model.rnn_variant tf, model.fidelity_mode) "
            "is not ported yet (ROADMAP.md, section 1, item 14)")
    return VQAAttentionModel(
        d.vocab_size, d.num_answers, feature_dim=d.feature_dim,
        word_dim=m.word_dim, rnn_dim=m.rnn_dim, fusion_dim=m.fusion_dim,
        att_hidden=m.att_hidden, answer_dim=m.answer_dim, dropout=m.dropout,
        n_cells=d.grid_h * d.grid_w, dtype=dtype_of(m.dtype),
        word_init=word_init, generator=generator)
