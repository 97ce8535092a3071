"""No-attention stage-2 baseline, ``vqa_baseline``: the image's pool5
vector and the mean of the question's word embeddings, concatenated, then
an MLP and a float32 answer classifier. It has no kernel of its own and
shares the batch format, the loss (``vqa_loss``) and every entry point with
the attention model.

Input: ``pool5`` [B, C] and ``q_ids`` [B, T] int (<pad>=0). Parameter names
follow the JAX package's tree (``word_emb``, ``mlp/fc0``, ``mlp/fc1``,
``classifier``), so ``utils/convert.py`` maps one to the other.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from vqa_transfer_externaldata_torch.ops.layers import (
    MLP, Dense, WordEmbedding, masked_mean)
from vqa_transfer_externaldata_torch.utils.vocab import PAD_ID


class VQABaselineModel(nn.Module):
    def __init__(self, vocab_size: int, num_answers: int, *,
                 feature_dim: int = 2048, word_dim: int = 300,
                 fusion_dim: int = 1024, dropout: float = 0.5,
                 dtype: torch.dtype = torch.bfloat16,
                 word_init: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.word_emb = WordEmbedding(vocab_size, word_dim,
                                      init_matrix=word_init, dtype=dtype,
                                      generator=generator)
        self.mlp = MLP(feature_dim + word_dim, [fusion_dim, fusion_dim],
                       dropout=dropout, dtype=dtype, final_activation=True,
                       generator=generator)
        self.classifier = Dense(fusion_dim, num_answers, dtype=torch.float32,
                                generator=generator)

    def forward(self, pool5: torch.Tensor, q_ids: torch.Tensor, *,
                train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """pool5 [B, C], q_ids [B, T] -> {"logits" [B, A] f32}. ``train``
        turns dropout on, drawn from ``generator``."""
        dt = self.dtype
        mask = (q_ids != PAD_ID).float()
        q_bag = masked_mean(self.word_emb(q_ids).float(), mask).to(dt)
        x = torch.cat([pool5.to(dt), q_bag], dim=-1)
        h = self.mlp(x, train=train, generator=generator)
        return {"logits": self.classifier(h.float())}
