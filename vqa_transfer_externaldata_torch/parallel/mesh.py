"""The port's device mesh on ``torch.distributed``: the JAX package's
``parallel/mesh.py`` in PyTorch's idiom.

One process drives one device (``python -m torch.distributed.run
--nproc_per_node N ...``, or processes started by hand with an explicit
coordinator). Rank r sits at (data index, model index) = (r // num_model,
r % num_model) of a ``(data, model)`` grid, the order in which JAX's
``create_device_mesh`` lays a device list out. Ranks with the same model
index form a data group: they hold the same parameters and split the
global batch. Ranks with the same data index form a model group: they
share a batch and, under ``mesh.shard_params``, hold the rows of a table
between them (``ops/row_shard.py``'s ``RowShard``).

Without a process group the mesh is the one-rank mesh that every
single-device path runs (``Mesh.distributed`` false), and nothing here
makes a collective call. With one, the collectives run even on a one-rank
group, so a world of one exercises the distributed path.

The plain collectives and the tables' differentiable ones
(``sharded_lookup``, ``sharded_row_product``) live in ``ops/row_shard.py``,
where the models read them, and are re-exported here.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.ops.row_shard import (  # noqa: F401
    RowShard, all_gather_cat, all_reduce_sum, sharded_lookup,
    sharded_row_product)


def maybe_initialize_distributed(mode: str = "auto",
                                 coordinator_address: str = "",
                                 num_processes: int = -1,
                                 process_id: int = -1,
                                 backend: Optional[str] = None) -> bool:
    """Start the default process group for a multi-process run
    (``--mesh.distributed``), as JAX's ``jax.distributed.initialize``:

    - ``auto`` (default): start it when torchrun's environment shows more
      than one rank (``WORLD_SIZE`` > 1) or a ``coordinator_address`` is
      given; one process alone stays as it was;
    - ``on``: always start it (torchrun's environment, or the explicit
      coordinator);
    - ``off``: never.

    ``coordinator_address`` ("host:port"), ``num_processes`` and
    ``process_id`` become ``init_method="tcp://host:port"``, ``world_size``
    and ``rank``; left at their defaults (empty, -1) torchrun's
    environment (``env://``: ``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``)
    supplies them. ``backend`` None is NCCL where CUDA is available and
    gloo otherwise; a CPU run names gloo. Any other mode raises
    ``ValueError``; a call while a group is running does nothing. Returns
    whether this call started the group."""
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"mesh.distributed must be auto|on|off, "
                         f"got {mode!r}")
    if mode == "off" or dist.is_initialized():
        return False
    world_env = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if mode == "auto" and not (world_env > 1 or coordinator_address):
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs: dict = {"backend": backend}
    if coordinator_address:
        kwargs["init_method"] = f"tcp://{coordinator_address}"
        kwargs["world_size"] = (num_processes if num_processes >= 0
                                else world_env)
        kwargs["rank"] = (process_id if process_id >= 0
                          else int(os.environ.get("RANK", "0")))
    else:
        kwargs["init_method"] = "env://"
        if num_processes >= 0:
            kwargs["world_size"] = num_processes
        if process_id >= 0:
            kwargs["rank"] = process_id
    dist.init_process_group(**kwargs)
    return True


def initialize_distributed_from(cfg: Config,
                                backend: Optional[str] = None) -> bool:
    """CLI glue: :func:`maybe_initialize_distributed` with the
    ``--mesh.*`` coordinator settings."""
    m = cfg.mesh
    return maybe_initialize_distributed(
        m.distributed, coordinator_address=m.coordinator_address,
        num_processes=m.num_processes, process_id=m.process_id,
        backend=backend)


def mesh_shape(cfg: Config, world: int) -> Tuple[int, int]:
    """(num_data, num_model) of ``world`` ranks: ``mesh.num_data`` -1 is
    ``world // num_model``. A grid that does not use exactly ``world``
    ranks raises ``ValueError`` (one process per device: a rank outside
    the grid would have no part)."""
    num_model = max(1, cfg.mesh.num_model)
    num_data = cfg.mesh.num_data
    if num_data <= 0:
        num_data = max(1, world // num_model)
    if num_data * num_model != world:
        raise ValueError(f"mesh {num_data}x{num_model} needs "
                         f"{num_data * num_model} ranks, have {world}")
    return num_data, num_model


def rank_coords(rank: int, num_model: int) -> Tuple[int, int]:
    """(data index, model index) of ``rank``: row-major over (data,
    model), as JAX's ``create_device_mesh`` lays devices out."""
    return rank // num_model, rank % num_model


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data, model) grid, its groups and its
    device. ``data_group`` / ``model_group`` are process groups (None: the
    world group); they are used only when ``distributed``."""

    num_data: int
    num_model: int
    data_index: int
    model_index: int
    device: torch.device
    distributed: bool = False
    data_group: Any = None
    model_group: Any = None

    @property
    def rank(self) -> int:
        return self.data_index * self.num_model + self.model_index

    @property
    def is_writer(self) -> bool:
        """Rank 0 writes the run's files (checkpoints, metrics, config)."""
        return self.rank == 0

    @property
    def backend(self) -> Optional[str]:
        return dist.get_backend() if self.distributed else None

    def barrier(self) -> None:
        if self.distributed:
            dist.barrier()

    def from_writer(self, value: int) -> int:
        """Rank 0's ``value`` on every rank (a broadcast: collective)."""
        t = torch.tensor([value], dtype=torch.int64, device=self.device)
        dist.broadcast(t, src=0)
        return int(t.item())

    def __str__(self) -> str:
        return (f"Mesh(data={self.num_data}, model={self.num_model}, "
                f"rank {self.rank} at ({self.data_index}, "
                f"{self.model_index}), {self.device})")


def create_mesh(cfg: Optional[Config], device: torch.device) -> Mesh:
    """The mesh of this process: without a process group the one-rank
    mesh (which a config asking for more ranks refuses, as JAX's does for
    too few devices); with one, this rank's coordinates and the groups
    of its row and column. Every rank must call it, in the same order
    (``new_group`` is collective)."""
    cfg = cfg or Config()
    device = torch.device(device)
    if not dist.is_initialized():
        num_data, num_model = mesh_shape(cfg, 1)
        return Mesh(num_data, num_model, 0, 0, device)
    world, rank = dist.get_world_size(), dist.get_rank()
    num_data, num_model = mesh_shape(cfg, world)
    d, m = rank_coords(rank, num_model)
    # With one model rank the data group is the world (None) and there is
    # no model group: nothing is row-sharded over one rank.
    data_group = model_group = None
    if num_model > 1:
        for mi in range(num_model):
            g = dist.new_group([di * num_model + mi
                                for di in range(num_data)])
            if mi == m:
                data_group = g
        for di in range(num_data):
            g = dist.new_group([di * num_model + mi
                                for mi in range(num_model)])
            if di == d:
                model_group = g
    return Mesh(num_data, num_model, d, m, device, True, data_group,
                model_group)


def broadcast_(t: torch.Tensor, src: int = 0, group: Any = None) -> None:
    """``t`` replaced by that of ``src`` (a global rank), in place."""
    dist.broadcast(t.detach(), src=src, group=group)
