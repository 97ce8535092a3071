"""Tables whose rows are split over a process group (``mesh.shard_params``):
the plain collectives the port uses, and the two differentiable reads of a
row-sharded table that the models make.

Each rank of a model group holds the rows [start, start + rows) of a table
(:class:`RowShard`) and the whole batch. :func:`sharded_lookup` is a masked
local lookup summed over the group; :func:`sharded_row_product` is the
local logits against the rank's rows, gathered along the rows. Both are
built from three ``torch.autograd.Function`` classes whose backward each
docstring states. ``parallel/mesh.py`` builds the groups and re-exports
these names.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist


def all_reduce_sum(t: torch.Tensor, group: Any) -> torch.Tensor:
    """``t`` summed over ``group``, in place."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group: Any, dim: int) -> torch.Tensor:
    """The ``t`` of every rank of ``group`` concatenated along ``dim`` in
    group-rank order."""
    parts = [torch.empty_like(t)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _SumOverGroup(torch.autograd.Function):
    """Forward: the input summed over the group (all-reduce). Backward:
    the identity. The ranks of a model group hold the same batch, so the
    summed output's cotangent is the same on each, and each passes it to
    its own rows' part of the sum."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToGroup(torch.autograd.Function):
    """Forward: the identity (every rank of the group holds the input).
    Backward: the cotangent summed over the group (all-reduce): each rank
    only sees the part of the output that its rows produced."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous().clone(), ctx.group), None


class _GatherOverGroup(torch.autograd.Function):
    """Forward: every rank's input concatenated along the last axis in
    group-rank order (all-gather). Backward: this rank's slice of the
    cotangent along that axis."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.index = dist.get_rank(group)
        ctx.width = x.shape[-1]
        return all_gather_cat(x, group, dim=-1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.width
        return g[..., lo:lo + ctx.width].contiguous(), None


@dataclasses.dataclass(frozen=True)
class RowShard:
    """The rows [start, start + rows) of a table, held by this rank of the
    model group ``group``."""

    group: Any
    start: int
    rows: int


def sharded_lookup(ids: torch.Tensor, table: torch.Tensor,
                   shard: RowShard) -> torch.Tensor:
    """``F.embedding(ids, full_table)`` from this rank's rows ``table``
    [rows, D]: a masked local lookup (ids outside the rows give zeros),
    summed over the model group. Every id is inside one rank's rows, so
    the sum adds zeros to one row and is exact."""
    inside = (ids >= shard.start) & (ids < shard.start + shard.rows)
    local = torch.where(inside, ids - shard.start, torch.zeros_like(ids))
    out = torch.nn.functional.embedding(local, table)
    out = torch.where(inside[..., None], out, torch.zeros_like(out))
    return _SumOverGroup.apply(out, shard.group)


def sharded_row_product(z: torch.Tensor, table: torch.Tensor,
                        shard: RowShard) -> torch.Tensor:
    """``z @ full_table.T`` [B, total] from this rank's rows ``table``
    [rows, D]: z's cotangent is summed over the model group, the local
    logits [B, rows] are gathered along the rows."""
    z = _CopyToGroup.apply(z, shard.group)
    return _GatherOverGroup.apply(z @ table.t(), shard.group)
