"""Stage-1 pretraining models: task-conditional visual classifiers that
score candidate words by scaled cosine similarity in a trained word space.
After pretraining, the word table (``word_emb.embedding``, the same name as
in the stage-2 models) is what transfers into the stage-2 answer classifier
(``utils/checkpoint.transfer_init``).

- :class:`VLMapModel`: word level, from the region feature and the task.
- :class:`VLMapDescriptionModel`: description blank fill. A GRU in the same
  word space (bidirectional with ``bidirectional``) encodes the region
  phrase with the target blanked out; the visual feature, the encoding and
  the task together predict the blanked word.

Batch format: ``feature`` [B, C] region feature, ``task`` [B] int task id,
``candidates`` [B, K] int word ids (one positive), ``label`` [B] the index
of the positive within candidates; the description model adds ``desc_ids``
[B, T] (blank = <unk>). The dense-candidate loss reads ``cand_counts``
[B, V] and ``word`` [B] instead of the gathered columns. Parameter names
follow the JAX package's tree (``utils/convert.py``); dropout is drawn from
an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from vqa_transfer_externaldata_torch.ops.gru import BiGRUEncoder, GRUEncoder
from vqa_transfer_externaldata_torch.ops.layers import (
    MLP, WordEmbedding, l2_normalize, row_product)
from vqa_transfer_externaldata_torch.utils.vocab import PAD_ID

Tensors = Dict[str, torch.Tensor]


class _VLMapHead(nn.Module):
    """What both stage-1 models share: the word table, the task table, the
    ``visual_proj`` MLP over ``[inputs, task embedding]`` and the learned
    scale of the cosine scores."""

    def __init__(self, vocab_size: int, num_tasks: int, in_dim: int,
                 word_dim: int, task_dim: int, hidden_dim: int,
                 dropout: float, dtype: torch.dtype, dense_loss: bool,
                 word_init: Optional[np.ndarray],
                 generator: Optional[torch.Generator]) -> None:
        super().__init__()
        self.dtype = dtype
        self.dense_loss = dense_loss
        self.word_emb = WordEmbedding(vocab_size, word_dim,
                                      init_matrix=word_init, dtype=dtype,
                                      generator=generator)
        self.task_embedding = nn.Parameter(torch.empty(num_tasks, task_dim))
        self.visual_proj = MLP(in_dim + task_dim, [hidden_dim, word_dim],
                               dropout=dropout, dtype=dtype,
                               generator=generator)
        self.logit_scale = nn.Parameter(torch.tensor(10.0))
        with torch.no_grad():
            nn.init.normal_(self.task_embedding, 0.0, 0.02,
                            generator=generator)

    def _score(self, parts, task: torch.Tensor, candidates: torch.Tensor,
               train: bool, generator: Optional[torch.Generator]) -> Tensors:
        dt = self.dtype
        t_emb = F.embedding(task.long(), self.task_embedding).to(dt)
        x = torch.cat([p.to(dt) for p in parts] + [t_emb], dim=-1)
        z = self.visual_proj(x, train=train, generator=generator)
        proj = l2_normalize(z.float())
        table, scale = self.word_emb.embedding, self.logit_scale
        shard = self.word_emb.row_shards.get("embedding")
        if self.dense_loss and train:
            return {"logits_vocab": _score_vocab(z, table, scale, shard),
                    "projection": proj}
        return {"logits": _score_candidates(z, table, candidates, scale,
                                            shard),
                "projection": proj}


class VLMapModel(_VLMapHead):
    """Scores candidate words from the region feature and the task
    (``visual_proj`` over ``[feature, task embedding]``)."""

    def __init__(self, vocab_size: int, *, num_tasks: int = 32,
                 feature_dim: int = 2048, word_dim: int = 300,
                 task_dim: int = 64, hidden_dim: int = 1024,
                 dropout: float = 0.5, dtype: torch.dtype = torch.bfloat16,
                 dense_loss: bool = False,
                 word_init: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__(vocab_size, num_tasks, feature_dim, word_dim,
                         task_dim, hidden_dim, dropout, dtype, dense_loss,
                         word_init, generator)

    def forward(self, feature: torch.Tensor, task: torch.Tensor,
                candidates: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensors:
        """-> {"logits" [B, K] f32 (or, training with the dense loss,
        "logits_vocab" [B, V]), "projection" [B, word_dim] f32}."""
        return self._score([feature], task, candidates, train, generator)


class VLMapDescriptionModel(_VLMapHead):
    """Description blank fill: a GRU (``desc_gru``) or bidirectional GRU
    (``desc_bigru``) over the blanked phrase, looked up time-major from
    the shared word table, joins the feature and the task embedding
    ahead of ``visual_proj``."""

    def __init__(self, vocab_size: int, *, num_tasks: int = 32,
                 feature_dim: int = 2048, word_dim: int = 300,
                 rnn_dim: int = 256, task_dim: int = 64,
                 hidden_dim: int = 1024, dropout: float = 0.5,
                 dtype: torch.dtype = torch.bfloat16,
                 bidirectional: bool = False, dense_loss: bool = False,
                 use_pallas: bool = True,
                 word_init: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None) -> None:
        enc_dim = 2 * rnn_dim if bidirectional else rnn_dim
        super().__init__(vocab_size, num_tasks, feature_dim + enc_dim,
                         word_dim, task_dim, hidden_dim, dropout, dtype,
                         dense_loss, word_init, generator)
        self.bidirectional = bidirectional
        if bidirectional:
            self.desc_bigru = BiGRUEncoder(word_dim, rnn_dim, dtype=dtype,
                                           use_pallas=use_pallas,
                                           generator=generator)
        else:
            self.desc_gru = GRUEncoder(word_dim, rnn_dim, dtype=dtype,
                                       use_pallas=use_pallas,
                                       generator=generator)

    def forward(self, feature: torch.Tensor, desc_ids: torch.Tensor,
                task: torch.Tensor, candidates: torch.Tensor, *,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensors:
        """As :meth:`VLMapModel.forward`, with ``desc_ids`` [B, T]."""
        mask = (desc_ids != PAD_ID).float()
        # Look up the transposed ids: words are born time-major [T, B, D],
        # the layout both directions' recurrences consume.
        words = self.word_emb(desc_ids.t())
        enc = self.desc_bigru if self.bidirectional else self.desc_gru
        d = enc(words, mask)
        return self._score([feature, d], task, candidates, train, generator)


def _score_vocab(z: torch.Tensor, word_emb: torch.Tensor,
                 scale: torch.Tensor, shard=None) -> torch.Tensor:
    """Scaled cosine of the projection ``z`` [B, D] against every word row
    -> [B, V] f32. The candidates' logits are columns of it. With a
    ``RowShard`` ``word_emb`` holds this rank's rows of the table, and the
    product is the model group's (``layers.row_product``)."""
    zn = l2_normalize(z.float())
    en = l2_normalize(word_emb.float())
    return row_product(zn, en, shard) * scale


def _score_candidates(z: torch.Tensor, word_emb: torch.Tensor,
                      candidates: torch.Tensor, scale: torch.Tensor,
                      shard=None) -> torch.Tensor:
    """The candidate columns [B, K] of :func:`_score_vocab`: one dense
    product against the whole table, then a gather, so no [B, K, D] copy of
    the candidates' rows is ever made."""
    return torch.gather(_score_vocab(z, word_emb, scale, shard), 1,
                        candidates.long())


def vlmap_loss(outputs: Tensors, batch: Tensors) -> Tuple[torch.Tensor,
                                                          Tensors]:
    """Softmax CE over the K candidates at ``label``; ``example_mask``
    zeroes padded rows. With dense logits (``logits_vocab``) the same CE as
    a count-weighted logsumexp over the vocabulary."""
    if "logits_vocab" in outputs:
        return _vlmap_dense_loss(outputs, batch)
    logits = outputs["logits"].float()
    labels = batch["label"].long()
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels[:, None])[:, 0]
    w = (batch["example_mask"].float() if "example_mask" in batch
         else torch.ones_like(nll))
    denom = torch.clamp(w.sum(), min=1.0)
    loss = torch.sum(nll * w) / denom
    hit = (logits.argmax(dim=-1) == labels).float()
    acc = torch.sum(hit * w) / denom
    return loss, {"loss": loss, "accuracy": acc, "weight": w.sum()}


def _vlmap_dense_loss(outputs: Tensors, batch: Tensors
                      ) -> Tuple[torch.Tensor, Tensors]:
    """CE over the candidate multiset from dense scores s [B, V] and its
    counts ``cand_counts`` [B, V]:

        CE = log sum_v count[b, v] e^{s[b, v]} - s[b, word]

    exact, as counts carry duplicate candidates. Accuracy is the argmax of
    the candidate-masked scores against ``word``."""
    s = outputs["logits_vocab"].float()
    c = batch["cand_counts"].float()
    word = batch["word"].long()
    w = (batch["example_mask"].float() if "example_mask" in batch
         else torch.ones(s.shape[0], device=s.device))
    cand = c > 0
    masked = torch.where(cand, s, torch.full_like(s, -1e30))
    m = masked.max(dim=-1, keepdim=True).values.detach()
    # Both guards are needed: the inner where keeps exp's input finite for
    # non-candidates (which may sit far above the candidate max m); with
    # the outer one alone the backward still forms 0 * exp(inf) = NaN.
    e = torch.where(cand, c * torch.exp(torch.where(cand, s, m) - m),
                    torch.zeros_like(s))
    # The floor only bites rows with no candidate (padding), where log(0)
    # would send 0/0 through the backward.
    lse = torch.log(torch.clamp(e.sum(-1), min=1e-30)) + m[:, 0]
    pos = s.gather(1, word[:, None])[:, 0]
    nll = torch.where(w > 0, lse - pos, torch.zeros_like(lse))
    denom = torch.clamp(w.sum(), min=1.0)
    loss = torch.sum(nll * w) / denom
    hit = (masked.argmax(dim=-1) == word).float()
    acc = torch.sum(hit * w) / denom
    return loss, {"loss": loss, "accuracy": acc, "weight": w.sum()}
