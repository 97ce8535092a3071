"""Trainer of the port, for any :class:`~..models.zoo.ModelSpec` (stage 1
and stage 2): the JAX package's ``parallel/trainer.py``, on one card or on
a ``parallel.mesh.Mesh`` of one process per card.

Two loops. :meth:`Trainer.fit_resident` uploads the dataset once and stages
the seeded index stream on the device in segments; each step takes its
batch by index. A stage-2 ``JoinedDataset`` uploads its question table and
its deduplicated feature store: by default L2-normalized and padded to a
multiple of 8 cells, and the model gets ``(store, rows)`` so the attention
kernels read the grids straight out of the store; with
``train.resident_fused_attention`` false the store stays as it is and each
step gathers its [B, N, C] grid on the device (the gathered attention).
:meth:`Trainer.fit` streams host batches instead, through pinned staging
buffers. One step is: forward with dropout, the spec's loss, backward, then
the optax chain of the JAX package (frozen leaves zeroed, global-norm clip,
AdamW with warmup and a staircase decay), written here as a few tensor
operations with optax's exact semantics (:class:`AdamW`). With
``train.steps_per_call`` k > 1 both loops run k steps a call, as the JAX
package's ``lax.scan`` does in one dispatch: on CUDA one replay of a CUDA
graph that captured the k steps (:class:`_StepGraph`), on the CPU the same
k steps eagerly.

Evaluation: :meth:`Trainer.evaluate` over host batches, and the resident
evaluator (:meth:`Trainer.evaluate_resident`), which uploads a split once
and runs its padded index epoch without a host round trip per batch; both
loops evaluate in the loop every ``eval_every`` steps, ``fit_resident``
one log window late. Both loops write periodic checkpoints
(``utils/checkpoint.py::CheckpointManager``).

On a mesh with a process group (data parallelism over ``num_data`` ranks,
``mesh.shard_params`` tables over ``num_model``): each rank trains on its
``batch_size / num_data`` rows of the global batch (its contiguous columns
of the resident index stream, or, with ``train.store_sharded``, its slot
of :func:`sharded_index_batches` against its row shard of the store; its
shard of the host stream in ``fit``). The loss is the global batch's
weighted mean: the step's weight is summed over the data group and each
rank backpropagates ``loss_r * max(W_r, 1) / max(W, 1)``; the gradients and
those scaled metrics are then summed over the data group in one flat
bucket before the clip, so every rank applies the same update and reports
the global metrics. Dropout masks are drawn for the global batch from a
generator every rank holds alike (``ops.layers.DataShardDropout``). Both
evaluators split each batch the same way, sum the metrics over the data
group and gather the predictions back into split order. Rank 0 writes the
checkpoints and ``metrics.jsonl``. Without a process group (the one-rank
mesh) none of this runs and no collective is called.
"""

from __future__ import annotations

import collections
import dataclasses
import os
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.data.datasets import PrefetchIterator
from vqa_transfer_externaldata_torch.models.zoo import ModelSpec
from vqa_transfer_externaldata_torch.ops import kernels
from vqa_transfer_externaldata_torch.ops.attention_resident import (
    pad_store_rows, prenormalize_store)
from vqa_transfer_externaldata_torch.ops.layers import (
    DataShardDropout, DropoutTape, dtype_of)
from vqa_transfer_externaldata_torch.parallel.mesh import (
    Mesh, RowShard, all_gather_cat, all_reduce_sum, broadcast_, create_mesh)
from vqa_transfer_externaldata_torch.serving import resolve_device
from vqa_transfer_externaldata_torch.utils.checkpoint import CheckpointManager
from vqa_transfer_externaldata_torch.utils.logging import (
    MetricWriter, Timer, log)
from vqa_transfer_externaldata_torch.utils.tracing import (
    TraceWindow, write_trace)

Tensors = Dict[str, torch.Tensor]


def make_lr_schedule(cfg: Config) -> Callable[[int], float]:
    """Linear warmup into staircase exponential decay, in float32 as the
    JAX package computes it: ``lr * min(1, (step+1)/warmup) *
    rate**floor(step/decay_steps)``."""
    t = cfg.train
    f32 = np.float32

    def schedule(step: int) -> float:
        s = f32(step)
        warm = min(f32(1.0), (s + f32(1.0)) / f32(max(1, t.warmup_steps)))
        decay = f32(t.lr_decay_rate) ** np.floor(s / f32(t.lr_decay_steps))
        return float(f32(t.learning_rate) * warm * decay)

    return schedule


def _next_multiple(step: int, every: int) -> int:
    """Smallest multiple of ``every`` strictly greater than ``step``."""
    every = max(1, every)
    return (step // every + 1) * every


def _eval_metrics(spec: ModelSpec, outputs: Tensors,
                  batch: Dict[str, Any]) -> Tensors:
    """An evaluation batch's metrics: the spec's loss metrics when the batch
    carries its target column (``spec.label_key``), else only the weight
    (valid rows) of a predictions-only pass. Shared by the streamed and the
    resident evaluators."""
    if spec.label_key in batch:
        _, metrics = spec.loss(outputs, batch)
        return metrics
    mask = batch.get("example_mask")
    if mask is not None:
        return {"weight": mask.float().sum()}
    b = outputs["logits"].shape[0]
    return {"weight": torch.full((), float(b),
                                 device=outputs["logits"].device)}


def sharded_index_batches(owner: np.ndarray, n_shards: int,
                          per_shard: int, seed: int) -> Iterator[np.ndarray]:
    """The seeded index stream of ``train.store_sharded``, the JAX
    package's draw for draw. ``owner[i]`` is the store shard (0..n_shards-1)
    holding row i's image. Yields [n_shards * per_shard] int64 batches
    whose slot d (positions ``d*per_shard:(d+1)*per_shard``) holds only
    rows that shard d owns: data rank d trains on slot d against its own
    rows of the store. Each shard walks its own seeded permutation epochs
    (``SeedSequence([seed, 0x5A7D, d])``) at its own rate. A shard that
    owns no row raises ``ValueError``; one that owns fewer rows than a
    slot logs a warning (its questions repeat within a batch)."""
    lists = [np.flatnonzero(owner == d) for d in range(n_shards)]
    empty = [d for d, rows in enumerate(lists) if rows.size == 0]
    if empty:
        raise ValueError(
            f"store_sharded: store shard(s) {empty} own no dataset rows — "
            "every shard needs at least one question (rebalance the store "
            "or reduce the data-axis size)")
    smallest = min(rows.size for rows in lists)
    if smallest < per_shard:
        log.warning(
            "store_sharded: smallest shard owns %d questions < per-shard "
            "batch %d — its questions are ~%.1fx oversampled every step",
            smallest, per_shard, per_shard / smallest)
    rngs = [np.random.default_rng(
        np.random.SeedSequence([seed, 0x5A7D, d])) for d in range(n_shards)]
    pools = [rng.permutation(rows) for rng, rows in zip(rngs, lists)]
    offs = [0] * n_shards
    while True:
        parts = []
        for d in range(n_shards):
            take = []
            need = per_shard
            while need:
                avail = pools[d][offs[d]:offs[d] + need]
                if avail.size == 0:  # epoch exhausted: reshuffle
                    pools[d] = rngs[d].permutation(lists[d])
                    offs[d] = 0
                    continue
                take.append(avail)
                offs[d] += avail.size
                need -= avail.size
            parts.append(np.concatenate(take) if len(take) > 1
                         else take[0])
        yield np.concatenate(parts)


# Float feature columns that travel in the compute dtype (the JAX package's
# _cast_features_host): the same values the model casts to, half the bytes.
_FEATURE_KEYS = ("features", "feature", "pool5")


def _host_tensor(key: str, v: np.ndarray, dt: torch.dtype
                 ) -> Tuple[torch.Tensor, torch.dtype]:
    """A host column as a CPU tensor and the dtype it travels in. uint16
    (the candidate counts, each at most num_candidates) becomes int16,
    which torch's kernels take: uint16 has few of them."""
    v = np.ascontiguousarray(v)
    if v.dtype == np.uint16:
        if v.size and int(v.max()) > np.iinfo(np.int16).max:
            raise ValueError(f"{key}: uint16 values past the int16 range")
        v = v.astype(np.int16)
    t = torch.from_numpy(v)
    if key in _FEATURE_KEYS and t.dtype == torch.float32:
        return t, dt
    return t, t.dtype


def _on_device(a: np.ndarray, device: torch.device,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A small host array on ``device`` (copied into ``out`` when given)
    without waiting for the device: on CUDA through pinned memory and an
    asynchronous copy (a pageable copy waits for the queue to drain, and
    cannot be captured). The pinned block is not reused before its copy
    has run."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        t = t.pin_memory()
    if out is None:
        return t.to(device, non_blocking=True)
    return out.copy_(t, non_blocking=True)


class _Uploader:
    """Host batches (dicts of numpy arrays) to the device: one batch, or a
    list of k batches stacked on a new leading axis. On CUDA a batch
    passes through one of two sets of pinned staging buffers: float
    features are cast to the compute dtype as they are copied in (a list's
    batches row by row, never stacked on the host), then the copy to the
    card is asynchronous; a set is refilled only once its last copy has
    finished (an event per set), so a step's copy overlaps the previous
    step's work. With ``out`` (device tensors by key: a captured graph's
    static inputs) the batch is copied into those."""

    def __init__(self, device: torch.device, dtype: torch.dtype) -> None:
        self.device, self.dtype = device, dtype
        self._slots: List[Tuple[Dict[str, torch.Tensor], Any]] = [
            ({}, None), ({}, None)]
        self._turn = 0

    def __call__(self, batch: Any,
                 out: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Dict[str, Any]:
        group = isinstance(batch, list)
        rows = batch if group else [batch]
        if self.device.type != "cuda":
            out = {}
            for k in rows[0]:
                ts = [_host_tensor(k, r[k], self.dtype) for r in rows]
                t = torch.stack([t for t, _ in ts]) if group else ts[0][0]
                out[k] = t.to(self.device, ts[0][1])
            return out
        bufs, done = self._slots[self._turn]
        if done is not None:
            done.synchronize()
        dst = {} if out is None else out
        for k in rows[0]:
            ts = [_host_tensor(k, r[k], self.dtype) for r in rows]
            dt = ts[0][1]
            shape = (len(rows),) * group + tuple(ts[0][0].shape)
            buf = bufs.get(k)
            if buf is None or tuple(buf.shape) != shape or buf.dtype != dt:
                buf = bufs[k] = torch.empty(shape, dtype=dt,
                                            pin_memory=True)
            for i, (t, _) in enumerate(ts):
                (buf[i] if group else buf).copy_(t)
            if out is None:
                dst[k] = buf.to(self.device, non_blocking=True)
            else:
                dst[k].copy_(buf, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        self._slots[self._turn] = (bufs, done)
        self._turn ^= 1
        return dst


def _row(inputs: Dict[str, torch.Tensor], i: int) -> Dict[str, Any]:
    """Step i's batch of [k, ...]-stacked device batches."""
    return {name: v[i] for name, v in inputs.items()}


def _freeze_mask_fn(names_csv: str) -> Callable[[str], bool]:
    """True (frozen) for a parameter when any component of its dotted name
    is in the comma-separated list (the JAX package's path rule)."""
    names = {n.strip() for n in names_csv.split(",") if n.strip()}
    return lambda name: any(p in names for p in name.split("."))


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The 2-norm over every tensor (optax.global_norm), from one norm per
    tensor: one fused launch for the list, then one for the stack."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def sharded_global_norm(replicated: List[torch.Tensor],
                        sharded: List[torch.Tensor], mesh: Mesh
                        ) -> torch.Tensor:
    """The 2-norm over whole tensors of which ``sharded`` are this rank's
    rows of tables row-sharded over ``mesh``'s model group: their squared
    sums are summed over the group, each replicated tensor counted once."""
    sq = lambda ts: torch.stack(torch._foreach_norm(ts)).square().sum()
    total = (sq(sharded) if sharded else
             torch.zeros((), device=replicated[0].device))
    total = all_reduce_sum(total, mesh.model_group)
    if replicated:
        total = total + sq(replicated)
    return torch.sqrt(total)


@dataclasses.dataclass
class AdamState:
    count: int  # optax's step counter: the schedule reads it, then += 1
    mu: Tensors  # trainable leaves only, in mu_dtype
    nu: Tensors


class AdamW:
    """optax.chain(masked(set_to_zero, frozen), clip_by_global_norm(
    max_norm), masked(adamw(lr_fn, b1, b2, eps, weight_decay, mu_dtype),
    trainable)):

    - frozen leaves get a zero update and carry no moments;
    - the clip scales by ``max_norm / g_norm`` only when ``g_norm >=
      max_norm``, with no epsilon, over all leaves (frozen ones zeroed);
    - Adam: mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu, bias-corrected
      by ``1 - b^count`` (float32) after the increment, update
      mu_hat / (sqrt(nu_hat) + eps); mu is stored in ``mu_dtype`` after the
      update used it;
    - then ``+ weight_decay * param`` and ``* -lr_fn(count)``, count taken
      before its increment.

    No step synchronizes with the device: every reduction stays a tensor.
    ``norm(tensors, names)`` is the clip's global norm: :func:`global_norm`
    unless given (the trainer's, when it row-shards tables, sums their
    rows' squared sums over the model group).
    """

    def __init__(self, lr_fn: Callable[[int], float], *, b1: float,
                 b2: float, eps: float, weight_decay: float,
                 mu_dtype: torch.dtype, max_norm: float,
                 frozen: Callable[[str], bool],
                 norm: Optional[Callable[[List[torch.Tensor], List[str]],
                                         torch.Tensor]] = None) -> None:
        self.lr_fn = lr_fn
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.mu_dtype = mu_dtype
        # optax scales the stored mu by b1 in mu's own dtype (a weakly typed
        # scalar): b1 rounded to bf16 for a bf16 mu.
        self._b1_mu = torch.tensor(b1, dtype=mu_dtype).item()
        self.max_norm = max_norm
        self.frozen = frozen
        self.norm = norm or (lambda tensors, names: global_norm(tensors))

    def init(self, params: Tensors) -> AdamState:
        live = [k for k in params if not self.frozen(k)]
        return AdamState(
            0, {k: torch.zeros_like(params[k], dtype=self.mu_dtype)
                for k in live},
            {k: torch.zeros_like(params[k]) for k in live})

    def scalars(self, count: int, n: int) -> np.ndarray:
        """The host numbers of the ``n`` updates that start at optax's
        count ``count``: rows (1 - b1**c, 1 - b2**c, lr_fn(c - 1)) for c =
        count + 1, ..., count + n, [n, 3] float32: the powers of the
        float32 b, as optax takes them (1 - 0.999 is 1.3e-5 away from
        1 - float32(0.999)), rounded to float32 as the update's float32
        operations take them. A step reads its row as device scalars, so a
        captured step reads each replay's row."""
        f32 = np.float32
        out = np.empty((n, 3), f32)
        for i in range(n):
            c = count + 1 + i
            out[i] = (f32(1.0) - f32(self.b1) ** np.int32(c),
                      f32(1.0) - f32(self.b2) ** np.int32(c),
                      self.lr_fn(c - 1))
        return out

    def update(self, grads: Tensors, state: AdamState, params: Tensors,
               scalars: torch.Tensor) -> Tuple[Tensors, AdamState]:
        """The updates of ``grads``; ``state``'s moments are written in
        place and the returned state's count is one more. ``scalars``: this
        update's row of :meth:`scalars` (a [3] tensor on the parameters'
        device)."""
        names = list(grads)
        bc1, bc2, lr = scalars[0], scalars[1], scalars[2]
        g = [torch.zeros_like(grads[k]) if self.frozen(k) else grads[k]
             for k in names]
        g_norm = self.norm(g, names)
        # g if g_norm < max_norm else (g / g_norm) * max_norm, as t / d * s
        # with d = s = 1 in the first case: the same roundings, no branch.
        trigger = g_norm < self.max_norm
        d = torch.where(trigger, torch.ones_like(g_norm), g_norm)
        scale = torch.where(trigger, torch.ones_like(g_norm),
                            torch.full_like(g_norm, self.max_norm))
        g = torch._foreach_div(g, d)
        torch._foreach_mul_(g, scale)
        live = [i for i, k in enumerate(names) if k in state.mu]
        gl = [g[i] for i in live]
        mu = [state.mu[names[i]] for i in live]
        nu = [state.nu[names[i]] for i in live]
        m = torch._foreach_mul(gl, 1.0 - self.b1)
        torch._foreach_add_(m, torch._foreach_mul(mu, self._b1_mu))
        v = torch._foreach_mul(gl, gl)
        torch._foreach_mul_(v, 1.0 - self.b2)
        torch._foreach_add_(v, torch._foreach_mul(nu, self.b2))
        u = torch._foreach_div(m, bc1)
        den = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(u, den)
        if self.weight_decay:
            torch._foreach_add_(u, torch._foreach_mul(
                [params[names[i]] for i in live], self.weight_decay))
        torch._foreach_mul_(u, torch.neg(lr))
        # In place, so that a captured step writes where the next replay
        # reads; mu is rounded to mu_dtype after the update used it.
        torch._foreach_copy_(mu, m)
        torch._foreach_copy_(nu, v)
        # Frozen leaves keep their (zeroed) clipped gradient as the update.
        updates = dict(zip(names, g))
        for i, ui in zip(live, u):
            updates[names[i]] = ui
        return updates, dataclasses.replace(state, count=state.count + 1)


def make_optimizer(cfg: Config, extra_frozen: str = "", norm=None
                   ) -> Tuple[AdamW, Callable[[int], float]]:
    """The configured :class:`AdamW` and its learning-rate schedule.
    ``extra_frozen``: names the model freezes itself, added to
    ``train.freeze_params`` (the Trainer adds ``resnet`` for a model that
    declares ``freeze_backbone``: a ResNet-101 carries no Adam moments).
    ``norm``: the clip's global norm (:class:`AdamW`)."""
    t = cfg.train
    if t.adam_mu_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"train.adam_mu_dtype={t.adam_mu_dtype!r}: "
                         "'float32' or 'bfloat16'")
    lr = make_lr_schedule(cfg)
    frozen_csv = ",".join(s for s in (t.freeze_params, extra_frozen) if s)
    return AdamW(lr, b1=t.adam_beta1, b2=t.adam_beta2, eps=t.adam_eps,
                 weight_decay=t.weight_decay,
                 mu_dtype=dtype_of(t.adam_mu_dtype),
                 max_norm=t.grad_clip_norm,
                 frozen=_freeze_mask_fn(frozen_csv), norm=norm), lr


@dataclasses.dataclass
class TrainState:
    """``params`` are the model's own parameters, updated in place;
    ``rng`` draws the dropout masks; ``buffers`` are the model's own
    buffers (a backbone's BatchNorm statistics), which no step changes
    and checkpoints carry."""

    step: int
    params: Dict[str, torch.nn.Parameter]
    opt_state: AdamState
    rng: torch.Generator
    buffers: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


def _advance(state: TrainState, n: int) -> TrainState:
    """``state`` after ``n`` steps ran on the device: the host counters
    (the step and AdamW's count) move on by ``n``."""
    opt = state.opt_state
    return dataclasses.replace(
        state, step=state.step + n,
        opt_state=dataclasses.replace(opt, count=opt.count + n))


def _state_tensors(state: TrainState) -> List[torch.Tensor]:
    """The tensors a step writes: the parameters and AdamW's moments."""
    opt = state.opt_state
    return [*state.params.values(), *opt.mu.values(), *opt.nu.values()]


class _StepGraph:
    """``k`` training steps captured in one CUDA graph and replayed once a
    call: the card's counterpart of the JAX package's ``lax.scan`` over k
    steps in one dispatch.

    The graph's inputs are the state's tensors, its static ``inputs``
    (device tensors of ``shapes``, name -> (shape, dtype), that the caller
    fills before each call; ``batch_of
    (inputs, i)`` makes step i's batch from them inside the graph) and a
    [k, 3] table of AdamW's host numbers, uploaded before each replay. The
    first call warms up on a side stream (the kernels are built and their
    attributes set, cuBLAS gets its workspace) by running the k steps
    eagerly, puts back the parameters, the moments and the generator's
    state, captures the same steps on that stream with the dropout
    generator registered, and replays: the warm-up is undone and the
    capture runs nothing, so the first k steps are the first replay's.
    Each replay draws fresh dropout masks and moves the generator on as k
    eager steps do. The metrics returned are the last step's, in the
    graph's memory: the next replay overwrites them, so the caller copies
    them before its next call, on the same stream. A capture or a replay
    that fails raises; nothing falls back to eager steps."""

    def __init__(self, trainer: "Trainer", k: int,
                 shapes: Dict[str, Tuple[Tuple[int, ...], torch.dtype]],
                 batch_of: Callable[[Dict[str, torch.Tensor], int], Any]
                 ) -> None:
        dev = trainer.device
        self.trainer, self.k = trainer, k
        self.inputs = {name: torch.empty(shape, dtype=dt, device=dev)
                       for name, (shape, dt) in shapes.items()}
        self._batch_of = batch_of
        self._table = torch.empty(k, 3, dtype=torch.float32, device=dev)
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._metrics: Tensors = {}

    def _body(self, state: TrainState) -> Tensors:
        return self.trainer._steps(
            state, lambda i: self._batch_of(self.inputs, i), self._table)

    def _capture(self, state: TrainState) -> None:
        tensors = _state_tensors(state)
        side = torch.cuda.Stream(self.trainer.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            saved = [t.detach().clone() for t in tensors]
            rng = state.rng.get_state()
            self._body(state)
            with torch.no_grad():
                torch._foreach_copy_(tensors, saved)
            state.rng.set_state(rng)
        torch.cuda.current_stream().wait_stream(side)
        del saved
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.rng)
        with torch.cuda.graph(graph, stream=side):
            self._metrics = self._body(state)
        self._graph = graph
        self.trainer.graph_captures[self.k] += 1

    def __call__(self, state: TrainState) -> Tensors:
        """The k steps from ``state`` (its counters not yet advanced) on
        the inputs as the caller filled them; the last step's metrics."""
        self.trainer._table(state, self.k, out=self._table)
        if self._graph is None:
            self._capture(state)
        self._graph.replay()
        self.trainer.graph_replays[self.k] += 1
        return self._metrics


class _GraphCache:
    """The captured k-step graphs of a loop, by (k, the static inputs'
    shapes and dtypes), as jit keeps a compiled step per k. They belong to
    one set of state tensors: when the parameters, the moments or the
    generator are other tensors (``init_state``, ``restore``), every graph
    is dropped and the next call captures anew."""

    def __init__(self) -> None:
        self._graphs: Dict[Any, _StepGraph] = {}
        self._owner: List[Tuple[Any, int]] = []

    def get(self, state: TrainState, key: Any,
            build: Callable[[], _StepGraph]) -> _StepGraph:
        owner = [(state.rng, 0)] + [(t, t.data_ptr())
                                    for t in _state_tensors(state)]
        if len(owner) != len(self._owner) or any(
                a is not b or p != q
                for (a, p), (b, q) in zip(owner, self._owner)):
            self._graphs.clear()
            self._owner = owner
        if key not in self._graphs:
            self._graphs[key] = build()
        return self._graphs[key]


class _ProfilerWindow:
    """``train.profile_start`` / ``train.profile_steps`` in a training
    loop: a ``utils.tracing.TraceWindow`` (host ops and, on CUDA, the
    card's kernels and copies, the device drained before it opens, CUDA
    events around it) opened at the first dispatch boundary at or past
    ``profile_start`` (a start between two k-step boundaries still
    traces), open for at least one dispatch, closed at the first boundary
    at or past its end after the device has finished, or at the end of
    training when the window runs past it; it never opens twice in a run.
    Writes ``<train_dir>/profile/trace_<first>_<last>.pt.trace.json.gz``
    (a gzip'd Chrome trace) and ``trace_<first>_<last>.window.json`` (the
    steps it spans and its CUDA-event ms), which ``tools/trace_summary``
    reads."""

    def __init__(self, trainer: "Trainer") -> None:
        t = trainer.cfg.train
        self.trainer = trainer
        self.start = t.profile_start
        self.until = (t.profile_start + t.profile_steps
                      if t.profile_steps > 0 else -1)
        self.first = -1
        self._window = None

    def open_at(self, step: int) -> None:
        if self._window is not None or self.until < 0 or step < self.start:
            return
        self._window = TraceWindow(self.trainer.device)
        self._window.open()
        self.first = step
        self.until = max(self.until, step + 1)
        log.info("profiler trace started (steps %d..%d)", step, self.until)

    def close_at(self, step: int, final: bool = False) -> None:
        if self._window is None or (step < self.until and not final):
            return
        event_ms = self._window.close()
        truncated = step < self.until
        path = write_trace(self._window.prof, os.path.join(
            self.trainer.train_dir, "profile"), f"trace_{self.first}_{step}",
            {"first_step": self.first, "last_step": step,
             "steps": step - self.first, "cuda_event_ms": event_ms})
        self._window = None
        self.until = -1  # latched: never again in this run
        log.info("profiler trace%s written to %s",
                 " (truncated at the last step)" if truncated else "", path)


class Trainer:
    """Build once from a :class:`ModelSpec`, then :meth:`init_state` (and
    :meth:`restore`), :meth:`fit_resident` or :meth:`fit`, :meth:`evaluate`
    or :meth:`evaluate_resident`.

    Runs on ``mesh``'s device, by default the one-rank mesh of ``device``
    (CUDA unless ``device`` says otherwise: the tests pass "cpu"; without a
    card and without ``device`` it raises), or of this rank where a process
    group is running (``parallel.mesh.create_mesh``). Every option of the
    JAX Trainer is ported: ``train.steps_per_call`` (k steps a dispatch: a
    captured CUDA graph of the k steps on the card, the same k steps
    eagerly on the CPU; on CUDA under a process group only with NCCL,
    whose collectives a graph captures), the profiler window
    (``train.profile_start`` / ``train.profile_steps``), ``train.remat``,
    ``train.sort_batch_by_image``, ``train.store_sharded`` and
    ``mesh.shard_params``.

    A global batch that the data axis does not divide raises
    ``ValueError``, as does ``train.store_sharded`` without
    ``train.device_data_cache`` and a ``mesh.shard_params`` rule that
    matches a parameter neither row-sharded read takes (the word tables'
    lookup and the answer / word row products)."""

    # fit_resident stages its seeded index table in segments of this many
    # steps (rounded down to whole k-step calls); shrink in tests to
    # exercise re-staging.
    resident_segment_steps = 2048

    def __init__(self, cfg: Config, spec: ModelSpec,
                 mesh: Optional[Mesh] = None,
                 train_dir: Optional[str] = None,
                 device: Optional[str] = None) -> None:
        t = cfg.train
        if mesh is None:
            mesh = create_mesh(cfg, resolve_device(device))
        elif device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        self.mesh = mesh
        if t.batch_size % mesh.num_data:
            raise ValueError(
                f"global batch_size={t.batch_size} must be divisible by the "
                f"data-axis size {mesh.num_data} of {mesh}")
        if t.store_sharded and not t.device_data_cache:
            raise ValueError(
                "train.store_sharded needs train.device_data_cache — the "
                "feature store only exists device-resident")
        self.cfg = cfg
        self.spec = spec
        self.device = mesh.device
        self.model = model = spec.module.to(self.device)
        if (t.resident_fused_attention and t.device_data_cache
                and getattr(model, "store_prenormalized", None) is False):
            # The store is L2-normalized once at upload (_prepare_resident),
            # so the (store, rows) path skips the per-cell norm.
            model.store_prenormalized = True
        self._row_shards = self._plan_row_shards()
        self._tables_sharded = False
        self.tx, self.lr_fn = make_optimizer(
            cfg, extra_frozen=("resnet" if getattr(
                model, "freeze_backbone", False) else ""), norm=self._norm)
        self.train_dir = train_dir or t.train_dir
        self.ckpt = CheckpointManager(self.train_dir,
                                      keep=t.keep_checkpoints,
                                      save_every=t.checkpoint_every,
                                      mesh=mesh, full=self._full_rows,
                                      local=self._local_rows)
        self.metrics = MetricWriter(self.train_dir, enabled=mesh.is_writer)
        # The streamed loop's graphs (fit_resident keeps its own for a
        # run: they read that run's uploaded dataset), and how many graphs
        # were captured and replays run, by k.
        self._fit_graphs = _GraphCache()
        self.graph_captures: collections.Counter = collections.Counter()
        self.graph_replays: collections.Counter = collections.Counter()

    # -- tensor-parallel tables ------------------------------------------------

    def _plan_row_shards(self) -> Dict[str, Tuple[torch.nn.Module, str,
                                                  RowShard]]:
        """The parameters that ``mesh.shard_params`` row-shards over the
        model axis, by name: (owning module, attribute, this rank's
        :class:`RowShard`). A parameter is matched as the JAX package's
        ``_tree_shardings`` matches a leaf: its name contains a rule, it
        has rows, at least ``num_model`` of them, and ``num_model`` divides
        them. A matched parameter that its module does not read through
        the row-sharded lookup or row product (``ROW_SHARDABLE``) raises
        ``ValueError``; on a one-rank model axis nothing is sharded."""
        rules = [r.strip() for r in self.cfg.mesh.shard_params.split(",")
                 if r.strip()]
        m = self.mesh.num_model
        plan = {}
        for name, p in self.model.named_parameters():
            if not (any(r in name for r in rules) and p.dim() >= 1
                    and p.shape[0] >= m and p.shape[0] % m == 0):
                continue
            owner, _, attr = name.rpartition(".")
            module = self.model.get_submodule(owner)
            if attr not in getattr(module, "ROW_SHARDABLE", ()):
                raise ValueError(
                    f"mesh.shard_params={self.cfg.mesh.shard_params!r} "
                    f"matches {name}, which is read by neither row-sharded "
                    "read of the port (the word tables' lookup, the answer "
                    "and word row products)")
            if m > 1:
                rows = p.shape[0] // m
                plan[name] = (module, attr, RowShard(
                    self.mesh.model_group, self.mesh.model_index * rows,
                    rows))
        return plan

    def _shard_tables(self) -> None:
        """Replace each planned table by this rank's rows (once)."""
        if self._tables_sharded:
            return
        for module, attr, shard in self._row_shards.values():
            full = getattr(module, attr)
            setattr(module, attr, torch.nn.Parameter(
                full.detach()[shard.start:shard.start + shard.rows].clone()))
            module.row_shards[attr] = shard
        self._tables_sharded = bool(self._row_shards)

    def _local_rows(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole table ``t`` (a parameter or one of
        its moments) when ``name`` is row-sharded, else ``t``."""
        if name not in self._row_shards or not self._tables_sharded:
            return t
        shard = self._row_shards[name][2]
        return t[shard.start:shard.start + shard.rows]

    def _full_rows(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole table of this rank's rows ``t`` when ``name`` is
        row-sharded (gathered over the model group), else ``t``."""
        if name not in self._row_shards or not self._tables_sharded:
            return t
        return all_gather_cat(t.detach(), self.mesh.model_group, dim=0)

    def _norm(self, tensors: List[torch.Tensor],
              names: List[str]) -> torch.Tensor:
        """The global norm of whole tensors, tables row-sharded or not."""
        if not self._tables_sharded:
            return global_norm(tensors)
        shd = [t for t, n in zip(tensors, names) if n in self._row_shards]
        rep = [t for t, n in zip(tensors, names) if n not in self._row_shards]
        return sharded_global_norm(rep, shd, self.mesh)

    def full_state_dict(self) -> Tensors:
        """The model's ``state_dict`` with every row-sharded table whole
        (collective: every rank calls it)."""
        return {k: self._full_rows(k, v)
                for k, v in self.model.state_dict().items()}

    # -- state ---------------------------------------------------------------

    def init_state(self, params: Optional[Tensors] = None) -> TrainState:
        """Adopt ``params`` (a ``state_dict``, tables whole) if given, else
        keep the model's initialization; fresh optimizer state and dropout
        stream. Under a process group every rank then holds rank 0's
        parameters and buffers (broadcast), and under ``mesh.shard_params``
        only its rows of the sharded tables."""
        if params is not None:
            self.model.load_state_dict(
                {k: self._local_rows(k, v) for k, v in params.items()})
        if self.mesh.distributed:
            self._broadcast_params()
        self._shard_tables()
        live = dict(self.model.named_parameters())
        rng = torch.Generator(device=self.device)
        rng.manual_seed(self.cfg.train.seed + 1)
        return TrainState(0, live, self.tx.init(live), rng,
                          dict(self.model.named_buffers()))

    def _broadcast_params(self) -> None:
        """Rank 0's parameters and buffers on every rank; a sharded
        table's rows from the data group's first rank (rank = model
        index)."""
        with torch.no_grad():
            for name, t in [*self.model.named_parameters(),
                            *self.model.named_buffers()]:
                if self._tables_sharded and name in self._row_shards:
                    broadcast_(t, src=self.mesh.model_index,
                               group=self.mesh.data_group)
                else:
                    broadcast_(t, src=0)

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        """``state`` with the checkpoint of ``step`` (default: the latest)
        of this run directory loaded into it."""
        return self.ckpt.restore(state, step)

    # -- the step ------------------------------------------------------------

    def _forward(self, batch: Dict[str, object],
                 rng: torch.Generator) -> Tensors:
        """The model's training forward on ``batch``, dropout drawn from
        ``rng``. Under ``train.remat`` (the JAX package's
        ``jax.checkpoint``) it is rematerialized with
        ``torch.utils.checkpoint``: its activations are recomputed in the
        backward pass instead of kept, and the recompute replays the first
        pass's dropout masks (:class:`DropoutTape`), so the gradients and
        the generator are those of a step without remat. On a data axis of
        n > 1 ranks each mask is drawn for the global batch and the rank
        keeps its rows (:class:`DataShardDropout`)."""
        inputs = self.spec.inputs(batch)
        gen = rng
        if self.mesh.num_data > 1:
            gen = DataShardDropout(rng, self.mesh.data_index,
                                   self.mesh.num_data)
        if not self.cfg.train.remat:
            return self.model(*inputs, train=True, generator=gen)
        tape = DropoutTape(gen)
        passes: List[None] = []

        def run(*args):
            if passes:
                tape.rewind()
            passes.append(None)
            return self.model(*args, train=True, generator=tape)

        return torch.utils.checkpoint.checkpoint(
            run, *inputs, use_reentrant=False, preserve_rng_state=False)

    def _step(self, state: TrainState, batch: Dict[str, object],
              scalars: torch.Tensor) -> Tensors:
        """One optimizer step on a device batch with its row of
        :meth:`AdamW.scalars`: forward with dropout, the spec's loss, the
        gradients, AdamW. Writes the parameters and moments in place and
        moves no host counter; returns the metrics as device tensors.

        Under a process group the loss and metrics are the global batch's
        (the class docstring): the weight is summed over the data group
        first, then the gradients and the scaled metrics
        (:meth:`_sum_over_data`)."""
        outputs = self._forward(batch, state.rng)
        loss, metrics = self.spec.loss(outputs, batch)
        if self.mesh.distributed:
            w = metrics.pop("weight").detach().float()
            total = all_reduce_sum(w.clone(), self.mesh.data_group)
            # 1.0 exactly on one rank: its numbers are those of no group.
            c = w.clamp(min=1.0) / total.clamp(min=1.0)
            loss = loss * c
            metrics = {k: v.detach().float() * c for k, v in metrics.items()}
        # A frozen parameter the loss cannot reach (a backbone run under
        # no_grad) gets no gradient and no update, as its zeroed one would
        # give; it adds nothing to the clip norm. A live one the loss
        # cannot reach is a fault of the model, and raises (in a graph's
        # warm-up, before its capture).
        every = list(state.params)
        raw = torch.autograd.grad(loss, [state.params[k] for k in every],
                                  allow_unused=True)
        unreached = [k for k, g in zip(every, raw)
                     if g is None and not self.tx.frozen(k)]
        if unreached:
            raise RuntimeError(
                f"the loss does not reach the live parameters {unreached}")
        grads = {k: g for k, g in zip(every, raw) if g is not None}
        names = list(grads)
        if self.mesh.distributed:
            grads, metrics = self._sum_over_data(grads, metrics)
        metrics.pop("weight", None)  # eval-weighting aid, not a metric
        metrics["grad_norm"] = self._norm(list(grads.values()), names)
        # The step's learning rate from its row (state.step is AdamW's
        # count): a host number would be baked into a captured graph.
        metrics["lr"] = scalars[2].clone()
        with torch.no_grad():
            updates, _ = self.tx.update(grads, state.opt_state, state.params,
                                        scalars)
            torch._foreach_add_([state.params[k] for k in names],
                                [updates[k] for k in names])
        return metrics

    def _sum_over_data(self, grads: Tensors, metrics: Tensors
                       ) -> Tuple[Tensors, Tensors]:
        """The gradients and metrics summed over the data group in one flat
        bucket (one all-reduce a step). The sums are copied back into the
        gradients' own tensors, so what follows reads the same tensors as
        a step without a group (a view into the bucket may be misaligned
        for a vectorized kernel, which would sum in another order)."""
        keys = sorted(metrics)
        g = list(grads.values())
        flat = torch.cat([t.reshape(-1) for t in g]
                         + [torch.stack([metrics[k] for k in keys])])
        all_reduce_sum(flat, self.mesh.data_group)
        parts = torch.split(flat, [t.numel() for t in g] + [len(keys)])
        torch._foreach_copy_(g, [p.view_as(t) for t, p in zip(g, parts)])
        return grads, dict(zip(keys, parts[-1].unbind()))

    def _steps(self, state: TrainState,
               batch_of: Callable[[int], Dict[str, object]],
               table: torch.Tensor) -> Tensors:
        """``len(table)`` steps in a row, step i on ``batch_of(i)`` with
        row i of ``table`` (:meth:`AdamW.scalars`); the last step's
        metrics. It runs eagerly for one step and on the CPU, and is what
        a :class:`_StepGraph` captures on CUDA."""
        for i in range(table.shape[0]):
            metrics = self._step(state, batch_of(i), table[i])
        return metrics

    def _table(self, state: TrainState, n: int,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The [n, 3] :meth:`AdamW.scalars` of the next ``n`` steps on the
        device (in ``out`` when given), one pinned upload."""
        return _on_device(self.tx.scalars(state.opt_state.count, n),
                          self.device, out)

    def train_step(self, state: TrainState, batch: Dict[str, object]
                   ) -> Tuple[TrainState, Tensors]:
        """One optimizer step on a device batch, eagerly; returns the new
        state and the step's metrics as device tensors (no host
        synchronization)."""
        metrics = self._steps(state, lambda i: batch, self._table(state, 1))
        return _advance(state, 1), metrics

    def _run(self, graphs: _GraphCache, state: TrainState, k: int,
             shapes: Dict[str, Tuple[Tuple[int, ...], torch.dtype]],
             fill: Callable[[Optional[Dict[str, torch.Tensor]]],
                            Dict[str, torch.Tensor]],
             batch_of: Callable[[Dict[str, torch.Tensor], int], Any]
             ) -> Tuple[TrainState, Tensors]:
        """One call of both loops: ``k`` steps from ``state``, step i on
        ``batch_of(inputs, i)``. ``inputs`` are device tensors of
        ``shapes`` (name -> (shape, dtype)) that ``fill(dst)`` gives:
        copied into ``dst`` when it is given, else new. Eager on the CPU
        and for one step; on CUDA at k > 1 ``fill`` fills the static
        inputs of the graph for this k and these shapes, which is replayed
        once. Under a process group the graph holds the step's
        collectives, which only NCCL's can join: with another backend on
        CUDA, k > 1 raises ``ValueError``."""
        if (k > 1 and self.device.type == "cuda" and self.mesh.distributed
                and self.mesh.backend != "nccl"):
            raise ValueError(
                f"train.steps_per_call={k} on CUDA captures the step's "
                f"collectives in a CUDA graph, which the "
                f"{self.mesh.backend!r} backend cannot join: use the NCCL "
                "backend (one process per card) or train.steps_per_call 1")
        if self.device.type != "cuda" or k == 1:
            inputs = fill(None)
            return _advance(state, k), self._steps(
                state, lambda i: batch_of(inputs, i), self._table(state, k))
        key = (k, tuple(sorted((n, s, str(dt))
                               for n, (s, dt) in shapes.items())))
        graph = graphs.get(state, key,
                           lambda: _StepGraph(self, k, shapes, batch_of))
        fill(graph.inputs)
        return _advance(state, k), graph(state)

    def _eval_step(self, batch: Dict[str, Any]
                   ) -> Tuple[torch.Tensor, Tensors]:
        """Predictions [B] and metrics of an evaluation forward (no
        dropout, no gradient) on a device batch."""
        with torch.no_grad():
            outputs = self.model(*self.spec.inputs(batch), train=False)
            preds = outputs["logits"].float().argmax(-1)
            return preds, _eval_metrics(self.spec, outputs, batch)

    def _uploader(self) -> _Uploader:
        return _Uploader(self.device, self.model.dtype)

    # -- the streamed loop ---------------------------------------------------

    def fit(self, train_batches: Iterator[Dict[str, np.ndarray]],
            state: TrainState,
            eval_batches_fn: Optional[Callable[[], Iterator]] = None,
            max_steps: Optional[int] = None) -> TrainState:
        """Training on host batches (dicts of numpy arrays): a background
        thread prepares the next ``prefetch_batches`` of them, each goes to
        the card through a pinned staging buffer, and the metrics are read
        at every ``log_every``-th step. With ``train.steps_per_call`` k > 1
        each call takes k batches, staged row by row into [k, ...] inputs
        (on CUDA the static inputs of a captured graph, replayed once), and
        runs k steps; the last call is cut to the steps left
        (a second graph at most), and logging, evaluation and checkpoints
        fire at the first call boundary at or past their multiples. Every
        ``eval_every`` steps the split of ``eval_batches_fn()`` is
        evaluated (:meth:`evaluate`); the checkpoint policy runs after
        every call and the last step is always saved. An input with
        ``get_state`` (``data/grain_loader.GrainTrainIterator``) is not
        prefetched, and its state, taken at the call boundary after the
        call's k batches, is saved beside every checkpoint
        (``CheckpointManager.save_data_iter``). The profiler window
        (``train.profile_steps``) is :class:`_ProfilerWindow`'s. On a data
        axis of n ranks ``train_batches`` are this rank's
        ``batch_size / n`` rows of each global batch
        (``ArrayDataset.batches(shard=(data index, n))``), and
        ``eval_batches_fn`` gives global batches, which :meth:`evaluate`
        splits."""
        t = self.cfg.train
        max_steps = max_steps if max_steps is not None else t.max_steps
        # A checkpointable input (grain) saves its state beside each
        # checkpoint; a prefetch thread would draw ahead of the steps and
        # make that state overshoot, so such an input is not wrapped.
        stateful = hasattr(train_batches, "get_state")
        if t.prefetch_batches > 0 and not stateful:
            train_batches = PrefetchIterator(train_batches,
                                             depth=t.prefetch_batches)
        upload = self._uploader()
        timer = Timer()
        window = _ProfilerWindow(self)
        step = last_log = state.step
        next_log = _next_multiple(step, t.log_every)
        next_eval = _next_multiple(step, t.eval_every)
        log.info("training (streamed) from step %d to %d on %s", step,
                 max_steps, self.device)
        while step < max_steps:
            window.open_at(step)
            k = min(max(1, t.steps_per_call), max_steps - step)
            group = [next(train_batches) for _ in range(k)]
            shapes = {key: ((k, *np.shape(v)), _host_tensor(
                key, np.asarray(v)[:0], self.model.dtype)[1])
                for key, v in group[0].items()}
            state, pending = self._run(
                self._fit_graphs, state, k, shapes,
                lambda dst: upload(group, out=dst), _row)
            step = state.step
            window.close_at(step)
            if step >= next_log or step >= max_steps:
                next_log = _next_multiple(step, t.log_every)
                m = self._fetch_later(pending)()
                dt = timer.reset()
                m["steps_per_sec"] = (step - last_log) / max(dt, 1e-9)
                m["questions_per_sec"] = m["steps_per_sec"] * t.batch_size
                last_log = step
                self.metrics.write(step, m, prefix="train")
                log.info("step %6d  loss %.4f  acc %.4f  %.1f q/s", step,
                         m.get("loss", float("nan")),
                         m.get("accuracy", float("nan")),
                         m["questions_per_sec"])
            if eval_batches_fn is not None and step >= next_eval:
                next_eval = _next_multiple(step, t.eval_every)
                eval_metrics, _ = self.evaluate(state, eval_batches_fn())
                self._write_eval(step, eval_metrics)
            if self.ckpt.save(step, state) and stateful:
                self.ckpt.save_data_iter(step, train_batches.get_state())
        window.close_at(step, final=True)
        if self.ckpt.latest_step() != state.step:
            self.ckpt.save(state.step, state, force=True)
            if stateful:
                self.ckpt.save_data_iter(state.step,
                                         train_batches.get_state())
        return state

    # -- the resident loop -----------------------------------------------------

    def fit_resident(self, ds, state: TrainState,
                     max_steps: Optional[int] = None,
                     eval_ds=None) -> TrainState:
        """Device-resident training over a ``JoinedDataset`` (stage 2) or
        an ``ArrayDataset`` (either stage): the dataset is uploaded once,
        and each step's only input is a [batch] slice of the index table
        staged on the device. Metrics are logged every ``log_every`` steps
        one window late (a window's values are copied to the host
        asynchronously and read at the next boundary, so logging never
        drains the device's queue); each record's ``questions_per_sec``
        spans the steps since the previous record.

        With ``eval_ds`` the resident evaluator runs every ``eval_every``
        steps, lagged the same way: it is dispatched at its boundary on the
        training stream, so it reads that boundary's parameters before the
        next step updates them in place, and its values are collected one
        log window later. The checkpoint policy runs after every call and
        the last step is always saved.

        With ``train.steps_per_call`` k > 1 a call runs k steps (one replay
        of a captured graph on CUDA, whose steps take their batches from a
        static [k, B] index buffer that k rows of the segment are copied
        into on the device); a segment is whole calls, the last one the
        steps left, and the last call is cut to them.
        ``train.sort_batch_by_image`` orders each staged batch of a
        ``JoinedDataset`` by its store row (a stable sort on the host):
        every reduction over a batch is order-invariant, so training is
        the same up to float summation order. The profiler window is
        :class:`_ProfilerWindow`'s.

        On a data axis of n ranks every rank draws the same global index
        batches and stages its contiguous ``batch_size / n`` columns of
        them. Under ``train.store_sharded`` rank d uploads only its rows of
        the store (owner = row % n) and the stream is
        :func:`sharded_index_batches`, whose slot d is rank d's; the sort
        by image runs within each slot."""
        from vqa_transfer_externaldata_torch.data.features import (
            JoinedDataset)

        t = self.cfg.train
        max_steps = max_steps if max_steps is not None else t.max_steps
        rows, make_batch, nbytes = self._prepare_resident(ds)
        shard_info = self._store_shard(ds)
        store_rows = next((rows[k].shape[0] for k in ("grid", "store_pool5")
                           if k in rows), None)
        log.info("device-resident dataset: %d rows%s, %.2f GB uploaded "
                 "once%s", ds.size, (f" + {store_rows}-row feature store"
                                     if store_rows is not None else ""),
                 nbytes / 1e9, (f" (store row-sharded {shard_info[0]}-way)"
                                if shard_info else ""))
        if shard_info is not None:
            # Each data rank trains on the questions whose image its shard
            # holds (owner = row % n): its slot of the per-shard stream.
            n_sh = shard_info[0]
            owner = np.asarray(ds.arrays[ds.index_key]) % n_sh
            indices = sharded_index_batches(owner, n_sh,
                                            t.batch_size // n_sh, t.seed)
        else:
            indices = ds.index_batches(t.batch_size, seed=t.seed)
        # Every rank draws the same global batches and takes its contiguous
        # columns (its slot of a sharded stream).
        n_data, d = self.mesh.num_data, self.mesh.data_index
        local = t.batch_size // n_data
        timer = Timer()
        stepno = state.step
        last_log = stepno
        lagged: list = []  # [(boundary step, fetch of its metrics)]

        def log_window(pending: Tensors, final: bool) -> None:
            nonlocal last_log
            lagged.append((stepno, self._fetch_later(pending)))
            drain = []
            while len(lagged) > (0 if final else 1):
                drain.append(lagged.pop(0))
            if not drain:
                return
            values = [fetch() for _, fetch in drain]
            dt = timer.reset()
            span = drain[-1][0] - last_log
            for (at, _), m in zip(drain, values):
                if at == drain[-1][0]:
                    m["steps_per_sec"] = span / max(dt, 1e-9)
                    m["questions_per_sec"] = m["steps_per_sec"] * t.batch_size
                log.info("step %6d  loss %.4f  acc %.4f%s", at, m["loss"],
                         m["accuracy"],
                         (f"  {m['questions_per_sec']:.1f} q/s"
                          if "questions_per_sec" in m else ""))
                self.metrics.write(at, m, prefix="train")
            last_log = drain[-1][0]

        # The evaluator uploads its split at the first eval boundary.
        evaluator: list = []
        pending_eval: list = []  # [(boundary step, dispatch handle)]

        def collect_eval() -> None:
            at, handle = pending_eval.pop(0)
            self._write_eval(at, evaluator[0].collect(handle)[0])

        log.info("training (device-resident) from step %d to %d on %s",
                 stepno, max_steps, self.device)
        sort_rows = (np.asarray(ds.arrays[ds.index_key])
                     if t.sort_batch_by_image and isinstance(ds, JoinedDataset)
                     else None)
        k = max(1, t.steps_per_call)
        seg_steps = max(k, (self.resident_segment_steps // k) * k)
        seg, seg_off = None, seg_steps
        graphs = _GraphCache()  # this run's: they read its uploaded data
        window = _ProfilerWindow(self)
        next_log = _next_multiple(stepno, t.log_every)
        next_eval = _next_multiple(stepno, t.eval_every)
        while stepno < max_steps:
            if seg_off >= seg_steps:
                # One host->device copy of the next index-table segment:
                # whole k-step calls, then the steps left.
                part = [next(indices) for _ in range(
                    min(seg_steps, max_steps - stepno))]
                if sort_rows is not None:
                    # Within each slot of a sharded stream: a whole-batch
                    # sort would send questions to ranks without their
                    # images.
                    slots = shard_info[0] if shard_info else 1
                    part = [np.concatenate([
                        p[np.argsort(sort_rows[p], kind="stable")]
                        for p in r.reshape(slots, -1)]) for r in part]
                seg = np.stack(part)[:, d * local:(d + 1) * local]
                seg = torch.from_numpy(np.ascontiguousarray(seg)).to(
                    self.device)
                seg_off = 0
            window.open_at(stepno)
            kk = min(k, max_steps - stepno)
            idx = seg[seg_off:seg_off + kk]
            state, pending = self._run(
                graphs, state, kk, {"idx": (tuple(idx.shape), idx.dtype)},
                lambda dst: ({"idx": idx} if dst is None
                             else dst["idx"].copy_(idx)),
                lambda inputs, i: make_batch(inputs["idx"][i]))
            seg_off += kk
            stepno += kk
            window.close_at(stepno)
            if stepno >= next_log or stepno >= max_steps:
                next_log = _next_multiple(stepno, t.log_every)
                log_window(pending, final=stepno >= max_steps)
            if eval_ds is not None and stepno >= next_eval:
                next_eval = _next_multiple(stepno, t.eval_every)
                if not evaluator:
                    evaluator.append(self._make_resident_evaluator(eval_ds))
                if pending_eval:  # at most one in flight, in order
                    collect_eval()
                pending_eval.append((stepno,
                                     evaluator[0].dispatch(state)))
            if pending_eval and (stepno >= pending_eval[0][0] + t.log_every
                                 or stepno >= max_steps):
                collect_eval()
            self.ckpt.save(stepno, state)
        window.close_at(stepno, final=True)
        while pending_eval:
            collect_eval()
        if self.ckpt.latest_step() != state.step:
            self.ckpt.save(state.step, state, force=True)
        return state

    def _write_eval(self, step: int, metrics: Dict[str, float]) -> None:
        self.metrics.write(step, metrics, prefix="val")
        log.info("eval @ %d: %s", step,
                 {k: round(v, 4) for k, v in metrics.items()})

    def _fetch_later(self, metrics: Tensors) -> Callable[[], Dict[str, float]]:
        """Start copying ``metrics`` to the host without waiting; the
        returned callable waits for that copy only and returns floats."""
        keys = sorted(metrics)
        vals = torch.stack([metrics[k].detach().float() for k in keys])
        if self.device.type != "cuda":
            host = vals.cpu()
            return lambda: dict(zip(keys, host.tolist()))
        host = vals.to("cpu", non_blocking=True)
        done = torch.cuda.Event()
        done.record()

        def fetch() -> Dict[str, float]:
            done.synchronize()
            return dict(zip(keys, host.tolist()))

        return fetch

    def _store_shard(self, ds) -> Optional[Tuple[int, int]]:
        """(n_shards, rows a shard) of ``ds``'s store as
        :meth:`_prepare_resident` uploads it under ``train.store_sharded``
        (owner = row % n, ceil(M / n) rows a rank), else None: a split
        without a store, or a model that reads no grid, is not sharded."""
        from vqa_transfer_externaldata_torch.data.features import (
            JoinedDataset)

        if not (self.cfg.train.store_sharded and isinstance(ds, JoinedDataset)
                and self.spec.visual_key == "features"):
            return None
        n = self.mesh.num_data
        return n, -(-ds.store.pool5.shape[0] // n)

    def _prepare_resident(self, ds, drop_keys: Tuple[str, ...] = ()
                          ) -> Tuple[Dict[str, torch.Tensor], Callable, int]:
        """Upload ``ds`` for resident training or evaluation, leaving the
        row arrays named in ``drop_keys`` on the host. Returns ``(device
        tensors, make_batch, bytes uploaded)``; ``make_batch(idx)`` takes a
        batch by index on the device. The row arrays upload as they are,
        float features cast to the compute dtype on the host first (as the
        JAX package's ``_cast_features_host``: the same values, half the
        bytes). A ``JoinedDataset`` also uploads its store: its pool5 as
        ``store_pool5`` when its ``feature_keys`` hold "pool5" or stage 1's
        "feature" (``make_batch`` takes each row's store row into that
        key), and its grid as ``grid``
        when the model reads one (``spec.visual_key`` "features"; a model
        that reads pool5 only gets no grid on the device):

        - on the gather-free path, padded to a multiple of 8 cells and
          L2-normalized at upload when the model skips the per-cell norm
          (with ``train.store_quantize`` int8: then quantized to int8 codes
          with one global scale); ``make_batch`` hands the model ``(grid,
          rows)``, or ``(grid, rows, scale)`` for int8 codes. It is taken
          when
          ``train.resident_fused_attention`` is on (the default) and the
          model has a grid (``n_cells``), at most 8 glimpses and a batch
          that is a multiple of 8, as in the JAX package; otherwise, with
          the flag on, the gathered path below runs and says so in the log
          (a warning for a grid model, info for one without a grid);
        - on the gathered path, [M, N, C] as it is (no padding, no
          normalization, bf16 for a bf16 model), and ``make_batch`` gathers
          the batch's [B, N, C] grid on the device. (The JAX package splits
          this store into planes of at most 1024 channels for its TPU
          gather; one index_select needs no such split.)"""
        from vqa_transfer_externaldata_torch.data.features import (
            POOL5_KEYS, JoinedDataset)

        sharded = self.cfg.train.store_sharded
        n_data = self.mesh.num_data
        data = {k: self._upload_rows(k, v) for k, v in ds.arrays.items()
                if k not in drop_keys}
        if not isinstance(ds, JoinedDataset):
            if sharded:
                # No store to shard: an in-loop evaluation of such a split
                # runs on, as in the JAX package.
                log.warning("train.store_sharded has no effect on %s: no "
                            "feature store to shard (JoinedDataset "
                            "required)", type(ds).__name__)

            def make_rows(idx: torch.Tensor) -> Dict[str, object]:
                return {k: v.index_select(0, idx) for k, v in data.items()}

            nbytes = sum(v.numel() * v.element_size() for v in data.values())
            return data, make_rows, nbytes
        wanted = self.cfg.train.resident_fused_attention
        model_ok = bool(getattr(self.model, "n_cells", None))
        # Each data rank runs the op on its batch_size / n questions.
        fused = (wanted and model_ok
                 and getattr(self.model, "glimpses", 1) <= 8
                 and self.cfg.train.batch_size % (8 * n_data) == 0)
        if wanted and not fused:
            (log.warning if model_ok else log.info)(
                "resident_fused_attention unavailable (needs a spatial-"
                "attention model with glimpses <= 8 and batch % (8 * "
                "data-axis ranks) == 0): using the gathered resident path")
        if sharded and not fused:
            # The flag exists not to hold the whole store on each card.
            raise ValueError(
                "train.store_sharded requires the fused resident attention "
                "path (a spatial-attention model, resident_fused_attention "
                "on, batch % (8 * data-axis ranks) == 0)")
        key = ds.index_key
        M = ds.store.pool5.shape[0]
        index = np.asarray(ds.arrays[key])
        if index.size and (index.min() < 0 or index.max() >= M):
            raise IndexError(f"{key} outside the {M}-row store")
        store: Dict[str, torch.Tensor] = {}
        pool5_keys = [k for k in ds.feature_keys if k in POOL5_KEYS]
        if pool5_keys:
            store["store_pool5"] = self._upload_rows(
                "pool5", np.asarray(ds.store.pool5, np.float32))
        scale = 1.0
        # Row-sharded store: rank d holds rows d, d + n, ... (owner = row %
        # n); a question's row is row // n there.
        shard = self._store_shard(ds)
        shard_n = shard[0] if shard else 0
        if self.spec.visual_key == "features":
            store["grid"], scale = self._upload_grid(
                ds.store.grid, fused,
                (self.mesh.data_index, shard_n) if shard else None)
        pool5, grid = store.get("store_pool5"), store.get("grid")
        # int8 codes travel with their own scale (a val store's differs).
        codes_scale = ((scale,) if grid is not None
                       and grid.dtype == torch.int8 else ())

        def make_batch(idx: torch.Tensor) -> Dict[str, object]:
            batch = {k: v.index_select(0, idx) for k, v in data.items()}
            rows = batch[key]
            for k in pool5_keys:
                batch[k] = pool5.index_select(0, rows.long())
            if grid is not None:
                batch["features"] = (
                    (grid, rows // shard_n if shard_n else rows,
                     *codes_scale) if fused
                    else grid.index_select(0, rows.long()))
            return batch

        nbytes = sum(v.numel() * v.element_size()
                     for v in (*data.values(), *store.values()))
        return dict(data, **store), make_batch, nbytes

    def _upload_grid(self, grid, fused: bool,
                     shard: Optional[Tuple[int, int]] = None
                     ) -> Tuple[torch.Tensor, float]:
        """A store's grids on the device and their dequantization scale
        (1.0 unless int8): padded to a multiple of 8 cells and, on the
        card in bf16 or float16, of ``kernels.STORE_CHANNELS`` channels
        (L2-normalized
        when the model skips the per-cell norm, and then quantized to int8
        under ``train.store_quantize`` int8) for the gather-free path, else
        [M, N, C] as they are. ``train.store_quantize`` other than "" or
        "int8" raises ``ValueError``; int8 where the store is not
        prenormalized logs a warning and keeps the float store, as the JAX
        package does. ``shard=(d, n)`` (gather-free only): only rows d, d +
        n, ... are uploaded, as a [ceil(M / n), Np, C] block whose tail rows
        are zeros; an int8 scale is the whole store's."""
        quantize = self.cfg.train.store_quantize
        if quantize not in ("", "int8"):
            # A float store measured under a quantized run's name would
            # corrupt any comparison of the two.
            raise ValueError(f"train.store_quantize={quantize!r}: only "
                             "'int8' is supported (or '' for the float "
                             "store)")
        dt = self.model.dtype
        grid = np.asarray(grid)
        if grid.ndim == 4:  # [M, g, g, C] -> [M, N, C]
            grid = grid.reshape(grid.shape[0], -1, grid.shape[-1])
        # The JAX package casts float stores to the model's dtype when it
        # computes in bf16 or float16 (an f32 grid on the host first,
        # ``_cast_features_host``) and keeps their own dtype in float32; the
        # same values arrive here.
        half = dt in (torch.bfloat16, torch.float16)
        store_dt = dt if half else torch.from_numpy(grid[:0]).dtype
        if quantize and not (fused and self.model.store_prenormalized):
            log.warning("train.store_quantize=%r needs the prenormalized "
                        "gather-free resident path (device_data_cache and "
                        "resident_fused_attention): keeping the float store",
                        quantize)
            quantize = ""
        if not fused:
            return torch.from_numpy(np.ascontiguousarray(grid)).to(
                self.device).to(store_dt), 1.0
        if half and grid.dtype == np.float32:
            # f32 sources are rounded to the compute dtype before they are
            # normalized (or quantized)
            grid = torch.from_numpy(grid).to(dt).float().numpy()
        # The 16-bit kernels' channel multiple, padded once here rather
        # than at every call (zero channels, sliced off by the op).
        channels = kernels.store_channel_multiple(self.device, dt)
        if self.model.store_prenormalized:
            return prenormalize_store(grid, out_dtype=store_dt,
                                      quantize=quantize, device=self.device,
                                      shard=shard, channels=channels)
        padded = pad_store_rows(grid, channels=channels)
        if shard is not None:
            d, n = shard
            block = np.zeros((-(-padded.shape[0] // n),) + padded.shape[1:],
                             padded.dtype)
            part = padded[d::n]
            block[:part.shape[0]] = part
            padded = block
        return torch.from_numpy(padded).to(self.device, store_dt), 1.0

    def _upload_rows(self, key: str, v: np.ndarray) -> torch.Tensor:
        """One row array on the device, float feature columns in the
        compute dtype (``_host_tensor``)."""
        t, dt = _host_tensor(key, v, self.model.dtype)
        return t.to(dt).to(self.device)

    # -- evaluation ------------------------------------------------------------

    def evaluate(self, state: TrainState,
                 batches: Iterator[Dict[str, np.ndarray]]
                 ) -> Tuple[Dict[str, float], np.ndarray]:
        """Evaluation over host batches (``parallel/evaler.padded_batches``):
        valid-row-weighted mean metrics and the concatenated predicted ids.
        Each batch's means are weighted by its valid-row count (the loss's
        ``weight``), so a padded final batch cannot dilute them. ``state``
        names the parameters, which are the model's own. Each data rank
        evaluates its contiguous rows of every batch (one rank: the whole
        batch); under a process group every rank gets the same global
        batches and returns the split's numbers (:meth:`_combine_eval`)."""
        del state
        upload = self._uploader()
        n, d = self.mesh.num_data, self.mesh.data_index
        preds, vals, keys = [], [], None
        for batch in batches:
            rows = next(iter(batch.values())).shape[0]
            if rows % n:
                raise ValueError(f"an evaluation batch of {rows} rows does "
                                 f"not split over {n} data ranks")
            b = rows // n
            p, m = self._eval_step(upload(
                {k: v[d * b:(d + 1) * b] for k, v in batch.items()}))
            keys = sorted(m)
            preds.append(p.float())
            vals.append(torch.stack([m[k].float() for k in keys]))
        if not preds:
            return {}, np.zeros((0,), np.int64)
        v = torch.stack(vals)
        if self.mesh.distributed:
            p, v = self._combine_eval(keys, torch.stack(preds), v)
        else:  # the last batch may be shorter
            p = torch.cat(preds)
        return self._weighted_means(keys, v.double().cpu().numpy()), \
            p.cpu().numpy().reshape(-1).astype(np.int64)

    def _combine_eval(self, keys: List[str], preds: torch.Tensor,
                      vals: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every data rank's per-batch evaluation numbers as the global
        batches': ``preds`` [n_batches, b] gathered along the rows in rank
        order ([n_batches, n * b]), ``vals`` [n_batches, len(keys)] (each a
        batch mean over its ``weight``) as the global batch's means, the
        weights summed: each rank's mean counts by max(W_r, 1) / max(W, 1),
        as the training step's loss does."""
        g = self.mesh.data_group
        wi = keys.index("weight")
        w = vals[:, wi]
        total = all_reduce_sum(w.clone(), g)
        out = vals * (w.clamp(min=1.0) / total.clamp(min=1.0))[:, None]
        out[:, wi] = 0.0
        all_reduce_sum(out, g)
        out[:, wi] = total
        return all_gather_cat(preds, g, dim=1), out

    @staticmethod
    def _weighted_means(keys: List[str], vals: np.ndarray
                        ) -> Dict[str, float]:
        """The split's metrics from per-batch means [n_batches, len(keys)]:
        each batch weighted by its ``weight`` column (1 without one)."""
        m = {k: vals[:, i] for i, k in enumerate(keys)}
        w = m.pop("weight", np.ones(vals.shape[0]))
        total_w = max(float(w.sum()), 1e-9)
        return {k: float((v * w).sum() / total_w) for k, v in m.items()}

    def _make_resident_evaluator(self, ds):
        """Resident evaluator over ``ds``: the split uploads once (its
        ``answer_scores`` and ``cand_counts`` stay on the host) and the
        whole padded index epoch is enqueued with no host round trip.
        Returns ``run(state) -> (metrics, preds)`` with ``run.dispatch``
        (enqueue, returns a handle) and ``run.collect`` (wait for the
        handle, finish on the host: weighted means, and ``vqa_accuracy``
        from the host's score table).

        Under a process group each data rank evaluates its columns of the
        padded epoch and the numbers are combined as :meth:`evaluate`'s.
        With a row-sharded store (``train.store_sharded``) a rank can only
        evaluate questions whose image its shard holds, so the epoch is
        laid out per shard, as the JAX package lays it: [n_batches, n,
        B / n], shard d's questions in order in slot d, padded (mask 0) to
        the longest shard's batch count; a padded slot reads question row
        0, whose local store row ``row // n`` is inside every shard's
        block. The predictions go back to split order by position."""
        data, make_batch, nbytes = self._prepare_resident(
            ds, drop_keys=("answer_scores", "cand_counts"))
        shard = self._store_shard(ds)
        log.info("device-resident eval split: %d rows, %.2f GB uploaded "
                 "once%s", ds.size, nbytes / 1e9,
                 f" (store row-sharded {shard[0]}-way)" if shard else "")
        B = self.cfg.train.batch_size
        n = len(ds)
        positions = None
        if shard is None:
            starts = list(range(0, n, B))
            idxs = np.zeros((len(starts), B), np.int32)
            masks = np.zeros((len(starts), B), np.float32)
            for r, start in enumerate(starts):
                stop = min(start + B, n)
                idxs[r, :stop - start] = np.arange(start, stop)
                masks[r, :stop - start] = 1.0
        else:
            n_sh = shard[0]
            per_dev = B // n_sh
            owner = np.asarray(ds.arrays[ds.index_key]) % n_sh
            lists = [np.flatnonzero(owner == d) for d in range(n_sh)]
            n_batches = max(1, max(-(-rows.size // per_dev)
                                   for rows in lists))
            idxs = np.zeros((n_batches, n_sh, per_dev), np.int32)
            masks = np.zeros((n_batches, n_sh, per_dev), np.float32)
            positions = np.full((n_batches, n_sh, per_dev), -1, np.int64)
            for d, rows_d in enumerate(lists):
                for r in range(n_batches):
                    seg = rows_d[r * per_dev:(r + 1) * per_dev]
                    idxs[r, d, :seg.size] = seg
                    masks[r, d, :seg.size] = 1.0
                    positions[r, d, :seg.size] = seg
            idxs = idxs.reshape(n_batches, B)
            masks = masks.reshape(n_batches, B)
            positions = positions.reshape(-1)
        # This data rank's columns: its contiguous rows, or its slot.
        local = B // self.mesh.num_data
        cols = slice(self.mesh.data_index * local,
                     (self.mesh.data_index + 1) * local)
        dev_idxs = torch.from_numpy(
            np.ascontiguousarray(idxs[:, cols])).to(self.device)
        dev_masks = torch.from_numpy(
            np.ascontiguousarray(masks[:, cols])).to(self.device)
        n_batches = idxs.shape[0]
        scores_host = (np.asarray(ds.arrays["answer_scores"], np.float64)
                       if "answer_scores" in ds.arrays else None)
        labels_host = (np.asarray(ds.arrays["answer_id"])
                       if "answer_id" in ds.arrays else None)

        def dispatch(state: TrainState):
            """Enqueue the whole split on the current stream; the handle's
            copies to the host are in flight when it returns."""
            del state  # the parameters are the model's own
            preds, ms = [], []
            for r in range(n_batches):
                batch = make_batch(dev_idxs[r])
                batch["example_mask"] = dev_masks[r]
                p, m = self._eval_step(batch)
                preds.append(p)
                ms.append(m)
            keys = sorted(ms[0])
            vals = torch.stack([torch.stack([m[k].float() for k in keys])
                                for m in ms])  # [n_batches, len(keys)]
            p = torch.stack(preds).float()
            if self.mesh.distributed:
                p, vals = self._combine_eval(keys, p, vals)
            both = torch.cat([p, vals], dim=1)
            if self.device.type != "cuda":
                return keys, both, None
            host = both.to("cpu", non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            return keys, host, done

        def collect(handle) -> Tuple[Dict[str, float], np.ndarray]:
            keys, both, done = handle
            if done is not None:
                done.synchronize()
            both = both.double().numpy()
            p, vals = both[:, :B], both[:, B:]
            means = self._weighted_means(keys, vals)
            flat = p.reshape(-1).astype(np.int64)
            if positions is None:
                preds = flat[:n]
            else:
                sel = positions >= 0
                preds = np.zeros((n,), np.int64)
                preds[positions[sel]] = flat[sel]
            if scores_host is not None and labels_host is not None:
                from vqa_transfer_externaldata_torch.utils.vocab import UNK_ID

                wv = (labels_host[:n] != UNK_ID).astype(np.float64)
                means["vqa_accuracy"] = float(
                    (scores_host[np.arange(n), preds] * wv).sum()
                    / max(wv.sum(), 1e-9))
            return means, preds

        def run(state: TrainState) -> Tuple[Dict[str, float], np.ndarray]:
            return collect(dispatch(state))

        run.dispatch = dispatch
        run.collect = collect
        return run

    def evaluate_resident(self, state: TrainState, ds
                          ) -> Tuple[Dict[str, float], np.ndarray]:
        """One-shot :meth:`_make_resident_evaluator` (upload + run)."""
        return self._make_resident_evaluator(ds)(state)

    def close(self) -> None:
        self._fit_graphs = _GraphCache()  # their memory goes with them
        self.metrics.close()
