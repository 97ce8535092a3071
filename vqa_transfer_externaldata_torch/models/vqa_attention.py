"""Stage-2 VQA model, ``vqa_attention`` (``vqa_attention2``: two
glimpses): GloVe-embedded GRU question encoder -> spatial attention over
the 14x14x2048 grid with G glimpses -> gated fusion -> answer classifier
whose logits are cosine similarities against an answer-embedding table
(the transfer vehicle), times a learned scale, plus a bias.

Input: ``q_ids`` [B, T] int (<pad>=0) and either gathered ``features``
[B, N, C] (the eval forward of serving) or a tuple ``(store [M, Np, C],
rows [B] int32)``: the gather-free resident path, where the attention reads
each question's grid straight out of a store held in device memory
(``ops/attention_resident``). An int8 store (the codes of a prenormalized
store, ``train.store_quantize int8``) comes with its dequantization scale
as the triple ``(store, rows, scale)``; as a pair its codes are the values
(scale 1, the JAX model's default ``store_scale``). Both inputs train:
``train=True`` turns dropout on, drawn from an explicit
``torch.Generator``. With
``glimpses`` G > 1 the score vector ``att_ws`` is a matrix [H, G] and
``fuse_v`` takes the G concatenated weighted sums; the resident input runs
the same op with its G-glimpse kernels, the gathered input normalizes the
grid and runs ``spatial_attention_multi``. Parameter names follow the JAX
package's tree (``utils/convert.py`` maps one to the other).

``rnn_variant`` picks the question encoder: ``"cudnn"`` (``GRUEncoder``,
the fused recurrence, ids looked up time-major) or ``"tf"``
(``TFGRUEncoder``, the TF1-exact cell of the checkpoint-fidelity path, ids
looked up batch-major as it consumes them). ``use_pallas`` is the JAX
package's switch of the same name, read where JAX reads it: the
``GRUEncoder`` and the gathered single-glimpse attention run their plain
versions on CUDA when it is off, while the resident op always runs its
kernels (JAX's resident op ignores it too).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from vqa_transfer_externaldata_torch.ops.attention import (
    spatial_attention, spatial_attention_multi)
from vqa_transfer_externaldata_torch.ops.attention_resident import (
    spatial_attention_resident)
from vqa_transfer_externaldata_torch.ops.gru import GRUEncoder, TFGRUEncoder
from vqa_transfer_externaldata_torch.ops.layers import (
    Dense, GatedTanh, WordEmbedding, dropout, glorot_uniform_, l2_normalize,
    row_product)
from vqa_transfer_externaldata_torch.utils.vocab import PAD_ID, UNK_ID

RNN_VARIANTS = ("cudnn", "tf")


class VQAAttentionModel(nn.Module):
    # Tables the trainer may row-shard under mesh.shard_params (the answer
    # logits are a row product; the word table is WordEmbedding's).
    ROW_SHARDABLE = ("answer_embedding",)

    def __init__(self, vocab_size: int, num_answers: int, *,
                 feature_dim: int = 2048, word_dim: int = 300,
                 rnn_dim: int = 512, fusion_dim: int = 1024,
                 att_hidden: int = 512, answer_dim: int = 300,
                 dropout: float = 0.5, glimpses: int = 1,
                 n_cells: Optional[int] = None,
                 store_prenormalized: bool = False,
                 feature_grad: bool = False,
                 dtype: torch.dtype = torch.bfloat16,
                 rnn_variant: str = "cudnn", use_pallas: bool = True,
                 word_init: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        if rnn_variant not in RNN_VARIANTS:
            raise ValueError(f"model.rnn_variant={rnn_variant!r}: one of "
                             f"{RNN_VARIANTS}")
        g = generator
        self.dtype = dtype
        self.rnn_variant = rnn_variant
        self.use_pallas = use_pallas
        self.dropout = dropout
        self.glimpses = glimpses
        # True grid-cell count of a (store, rows) input, whose cell axis is
        # padded (None: every cell of the store is valid).
        self.n_cells = n_cells
        # Set by the Trainer when it L2-normalizes the resident store once
        # at upload: the (store, rows) path then skips the per-cell norm.
        self.store_prenormalized = store_prenormalized
        # True only when the gathered grid needs a gradient (features that
        # are not data); False lets the attention backward skip dv.
        self.feature_grad = feature_grad
        self.row_shards: dict = {}
        self.word_emb = WordEmbedding(vocab_size, word_dim,
                                      init_matrix=word_init, dtype=dtype,
                                      generator=g)
        if rnn_variant == "tf":
            self.gru = TFGRUEncoder(word_dim, rnn_dim, dtype=dtype,
                                    generator=g)
        else:
            self.gru = GRUEncoder(word_dim, rnn_dim, dtype=dtype,
                                  use_pallas=use_pallas, generator=g)
        self.att_q = Dense(rnn_dim, att_hidden, dtype=dtype, generator=g)
        self.att_wv = nn.Parameter(torch.empty(feature_dim, att_hidden))
        self.att_ws = nn.Parameter(torch.empty(
            (att_hidden, glimpses) if glimpses > 1 else (att_hidden,)))
        self.fuse_q = GatedTanh(rnn_dim, fusion_dim, dtype=dtype,
                                generator=g)
        self.fuse_v = GatedTanh(glimpses * feature_dim, fusion_dim,
                                dtype=dtype, generator=g)
        self.ans_proj = Dense(fusion_dim, answer_dim, dtype=dtype,
                              generator=g)
        self.answer_embedding = nn.Parameter(
            torch.empty(num_answers, answer_dim))
        self.logit_scale = nn.Parameter(torch.tensor(10.0))
        self.logit_bias = nn.Parameter(torch.zeros(num_answers))
        with torch.no_grad():
            glorot_uniform_(self.att_wv, feature_dim, att_hidden, g)
            nn.init.normal_(self.att_ws, 0.0, 0.05, generator=g)
            nn.init.normal_(self.answer_embedding, 0.0, 0.01, generator=g)

    def forward(self, features, q_ids: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """features [B, N, C], (store [M, Np, C], rows [B]) or (int8 store,
        rows, scale), q_ids [B, T] -> {"logits" [B, A] f32, "alpha"
        [B, cells] f32 ([B, cells, G] with G > 1 glimpses)}. ``train``
        turns dropout on, drawn from ``generator``."""
        dt = self.dtype
        resident = isinstance(features, (tuple, list))
        mask = (q_ids != PAD_ID).float()
        if self.rnn_variant == "tf":  # the TF1 cell consumes [B, T, D]
            q = self.gru(self.word_emb(q_ids), mask)
        else:
            # Look up the transposed ids: words are born time-major
            # [T, B, D], the layout the recurrence consumes.
            q = self.gru(self.word_emb(q_ids.t()), mask)  # [B, H] dt
        qh = self.att_q(q)
        if resident:
            store, rows = features[:2]
            # int8 codes go to the op as they are, with their scale (each
            # store its own: the Trainer's train and val stores differ);
            # an int8 store is prenormalized by construction. A float32
            # model takes f16 rows as they are too: the kernels widen them
            # on load (exactly), so no f32 copy of the store is made.
            quant = store.dtype == torch.int8
            scale = features[2] if len(features) > 2 else 1.0
            as_is = quant or store.dtype == dt or (
                dt == torch.float32 and store.dtype == torch.float16)
            v_att, alpha = spatial_attention_resident(
                store if as_is else store.to(dt), rows, qh, self.att_wv,
                self.att_ws, n_valid=self.n_cells or store.shape[1],
                normalize=not (self.store_prenormalized or quant),
                store_scale=scale if quant else 1.0)
        elif self.glimpses > 1:
            # The grid is normalized before the score product here, in
            # training and at evaluation, as in the JAX package.
            v_att, alpha = spatial_attention_multi(
                l2_normalize(features.to(dt)), qh, self.att_wv, self.att_ws)
        else:
            # The per-cell L2 normalization of the grid is fused into the op.
            v_att, alpha = spatial_attention(
                features.to(dt), qh, self.att_wv, self.att_ws, normalize=True,
                feature_grad=self.feature_grad, use_kernels=self.use_pallas,
                train=train)
        fused = self.fuse_q(q) * self.fuse_v(v_att.to(dt))
        if train and self.dropout > 0.0:
            fused = dropout(fused, self.dropout, generator)
        z = l2_normalize(self.ans_proj(fused).float())
        e = l2_normalize(self.answer_embedding)
        logits = (row_product(z, e, self.row_shards.get("answer_embedding"))
                  * self.logit_scale + self.logit_bias)
        return {"logits": logits, "alpha": alpha}


def vqa_loss(outputs: Dict[str, torch.Tensor],
             batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Softmax CE on the target answer id. Questions whose answer fell out
    of the answer vocab (<unk>) carry zero weight; ``example_mask`` (0/1
    per row) also zeroes padded rows. ``weight`` in the metrics is the
    valid-row count."""
    logits = outputs["logits"].float()
    labels = batch["answer_id"].long()
    weight = (labels != UNK_ID).float()
    if "example_mask" in batch:
        weight = weight * batch["example_mask"].float()
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels[:, None])[:, 0]
    denom = torch.clamp(weight.sum(), min=1.0)
    loss = torch.sum(nll * weight) / denom
    pred = logits.argmax(dim=-1)
    acc = torch.sum((pred == labels).float() * weight) / denom
    metrics = {"loss": loss, "accuracy": acc, "weight": weight.sum()}
    if "answer_scores" in batch:
        rows = torch.arange(pred.shape[0], device=pred.device)
        metrics["vqa_accuracy"] = torch.sum(
            batch["answer_scores"][rows, pred] * weight) / denom
    return loss, metrics
