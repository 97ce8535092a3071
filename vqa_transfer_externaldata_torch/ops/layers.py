"""Shared building blocks: dtype names, L2 normalization, the masked mean,
the word embedding table, the gated-tanh unit, the MLP and dropout.

Parameters live in float32; compute runs in the configured dtype
(bfloat16 by default), as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from vqa_transfer_externaldata_torch.ops.row_shard import (
    sharded_lookup, sharded_row_product)


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """x / sqrt(sum x^2 + eps) — the eps sits inside the sqrt."""
    return x / torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True) + eps)


def masked_mean(x: torch.Tensor, mask: torch.Tensor,
                dim: int = 1) -> torch.Tensor:
    """Mean over ``dim`` of the entries where ``mask`` (broadcastable from
    the left) is true; an all-false row gives 0."""
    mask = mask.to(x.dtype)
    while mask.dim() < x.dim():
        mask = mask[..., None]
    count = torch.clamp(torch.sum(mask, dim=dim), min=1.0)
    return torch.sum(x * mask, dim=dim) / count


def _keep_mask(generator, shape, device: torch.device,
               keep_prob: float) -> torch.Tensor:
    """A dropout keep mask: from ``generator``'s own ``keep`` where it has
    one (:class:`DropoutTape`, :class:`DataShardDropout`), else drawn
    uniformly from the ``torch.Generator``."""
    if hasattr(generator, "keep"):
        return generator.keep(shape, device, keep_prob)
    return torch.rand(shape, generator=generator, device=device) < keep_prob


class DropoutTape:
    """The dropout masks of a rematerialized forward: passed where a model
    takes its dropout ``generator``, it draws each mask from ``generator``
    as :func:`dropout` would and records it; after :meth:`rewind` the same
    forward, run again in the backward pass, gets the recorded masks in
    order. The recompute so draws nothing: its masks are the first pass's
    and the generator ends where a step without remat leaves it. (Reading
    and resetting the generator's state instead would not work inside a
    CUDA graph's capture.)"""

    def __init__(self, generator) -> None:
        self.generator = generator
        self._masks: list = []
        self._next: Optional[int] = None  # None: drawing

    def rewind(self) -> None:
        self._next = 0

    def keep(self, shape, device: torch.device,
             keep_prob: float) -> torch.Tensor:
        if self._next is None:
            mask = _keep_mask(self.generator, shape, device, keep_prob)
            self._masks.append(mask)
            return mask
        mask = self._masks[self._next]
        self._next += 1
        return mask


class DataShardDropout:
    """The dropout masks of rank ``index`` of ``n`` data-parallel ranks:
    each mask is drawn for the global batch (``n`` times the local rows
    on the batch axis, axis 0 of every dropout the port's models apply:
    they act on [B, F] activations) from ``generator``, which every rank
    holds at the same state, and the rank keeps its own rows. The masks
    so do not depend on how the batch is split, as the JAX package's one
    global key gives."""

    def __init__(self, generator: torch.Generator, index: int,
                 n: int) -> None:
        self.generator, self.index, self.n = generator, index, n

    def keep(self, shape, device: torch.device,
             keep_prob: float) -> torch.Tensor:
        b = shape[0]
        mask = torch.rand((b * self.n, *shape[1:]),
                          generator=self.generator, device=device) < keep_prob
        return mask[self.index * b:(self.index + 1) * b]


def dropout(x: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """Inverted dropout with a mask drawn from ``generator`` (a
    ``torch.Generator``, or a :class:`DropoutTape` /
    :class:`DataShardDropout` over one): kept entries are scaled by
    1 / (1 - rate), as flax's ``nn.Dropout``."""
    keep_prob = 1.0 - rate
    keep = _keep_mask(generator, x.shape, x.device, keep_prob)
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's default Dense kernel init: truncated normal (±2 std) with
    variance 1/fan_in after truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


def glorot_uniform_(w: torch.Tensor, fan_in: int, fan_out: int,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return nn.init.uniform_(w, -limit, limit, generator=generator)


class Dense(nn.Linear):
    """``nn.Linear`` that computes in ``dtype`` (weights stay float32) and
    starts from flax's Dense init (lecun-normal kernel, zero bias)."""

    def __init__(self, in_features: int, out_features: int, *,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__(in_features, out_features)
        self.dtype = dtype
        with torch.no_grad():
            lecun_normal_(self.weight, in_features, generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class WordEmbedding(nn.Module):
    """Trainable word-embedding table, optionally GloVe-initialized. Row 0
    is <pad>; callers mask padded positions by id. Under ``mesh.shard_params``
    the trainer may leave this rank only rows of the table
    (``row_shards["embedding"]``, an ``ops.row_shard.RowShard``): the
    lookup is then the model group's ``ops.row_shard.sharded_lookup``."""

    ROW_SHARDABLE = ("embedding",)

    def __init__(self, vocab_size: int, dim: int = 300, *,
                 init_matrix: Optional[np.ndarray] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.row_shards: dict = {}
        self.embedding = nn.Parameter(torch.empty(vocab_size, dim))
        with torch.no_grad():
            if init_matrix is not None:
                self.embedding.copy_(torch.as_tensor(
                    np.asarray(init_matrix, np.float32)))
            else:
                nn.init.normal_(self.embedding, 0.0, 0.01,
                                generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        shard = self.row_shards.get("embedding")
        if shard is None:
            return F.embedding(ids, self.embedding).to(self.dtype)
        return sharded_lookup(ids, self.embedding, shard).to(self.dtype)


def row_product(z: torch.Tensor, table: torch.Tensor,
                shard=None) -> torch.Tensor:
    """``z @ table.T``: the logits of z against every row of a table, or,
    with an ``ops.row_shard.RowShard``, against the whole table from this
    rank's rows (``ops.row_shard.sharded_row_product``)."""
    if shard is None:
        return z @ table.t()
    return sharded_row_product(z, table, shard)


class GatedTanh(nn.Module):
    """tanh(W x) * sigmoid(G x), both projections computed in ``dtype``."""

    def __init__(self, in_features: int, features: int, *,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.w = Dense(in_features, features, dtype=dtype,
                       generator=generator)
        self.g = Dense(in_features, features, dtype=dtype,
                       generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.w(x)) * torch.sigmoid(self.g(x))


class MLP(nn.Module):
    """A stack of :class:`Dense` layers ``fc0``, ``fc1``, ... with ReLU and
    then dropout (when training) after every layer but the last, and after
    the last too with ``final_activation``."""

    def __init__(self, in_features: int, features: Sequence[int], *,
                 dropout: float = 0.0, dtype: torch.dtype = torch.bfloat16,
                 final_activation: bool = False,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.dropout = dropout
        self.final_activation = final_activation
        dims = [in_features, *features]
        for i in range(len(features)):
            self.add_module(f"fc{i}", Dense(dims[i], dims[i + 1], dtype=dtype,
                                            generator=generator))
        self.n_layers = len(features)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"fc{i}")(x)
            if i < self.n_layers - 1 or self.final_activation:
                x = torch.relu(x)
                if train and self.dropout > 0.0:
                    x = dropout(x, self.dropout, generator)
        return x
