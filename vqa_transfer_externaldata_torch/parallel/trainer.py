"""Single-device trainer of the port, for any
:class:`~..models.zoo.ModelSpec` (stage 1 and stage 2): the JAX package's
``parallel/trainer.py`` on one card.

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
operations with optax's exact semantics (:class:`AdamW`).

Evaluation: :meth:`Trainer.evaluate` over host batches, and the resident
evaluator (:meth:`Trainer.evaluate_resident`), which uploads a split once
and runs its padded index epoch without a host round trip per batch; both
loops evaluate in the loop every ``eval_every`` steps, ``fit_resident``
one log window late. Both loops write periodic checkpoints
(``utils/checkpoint.py::CheckpointManager``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.data.datasets import PrefetchIterator
from vqa_transfer_externaldata_torch.models.zoo import ModelSpec
from vqa_transfer_externaldata_torch.ops.attention_resident import (
    pad_store_rows, prenormalize_store)
from vqa_transfer_externaldata_torch.ops.layers import dtype_of
from vqa_transfer_externaldata_torch.serving import resolve_device
from vqa_transfer_externaldata_torch.utils.checkpoint import CheckpointManager
from vqa_transfer_externaldata_torch.utils.logging import (
    MetricWriter, Timer, log)

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


class _Uploader:
    """Host batches (dicts of numpy arrays) to the device. On CUDA a batch
    passes through one of two sets of pinned staging buffers: float
    features are cast to the compute dtype as they are copied in, then the
    copy to the card is asynchronous; a set is refilled only once its last
    copy has finished (an event per set), so a step's copy overlaps the
    previous step's work."""

    def __init__(self, device: torch.device, dtype: torch.dtype) -> None:
        self.device, self.dtype = device, dtype
        self._slots: List[Tuple[Dict[str, torch.Tensor], Any]] = [
            ({}, None), ({}, None)]
        self._turn = 0

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        if self.device.type != "cuda":
            out = {}
            for k, v in batch.items():
                t, dt = _host_tensor(k, v, self.dtype)
                out[k] = t.to(self.device, dt)
            return out
        bufs, done = self._slots[self._turn]
        if done is not None:
            done.synchronize()
        out = {}
        for k, v in batch.items():
            t, dt = _host_tensor(k, v, self.dtype)
            buf = bufs.get(k)
            if buf is None or buf.shape != t.shape or buf.dtype != dt:
                buf = bufs[k] = torch.empty(t.shape, dtype=dt,
                                            pin_memory=True)
            buf.copy_(t)
            out[k] = buf.to(self.device, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        self._slots[self._turn] = (bufs, done)
        self._turn ^= 1
        return out


def _freeze_mask_fn(names_csv: str) -> Callable[[str], bool]:
    """True (frozen) for a parameter when any component of its dotted name
    is in the comma-separated list (the JAX package's path rule)."""
    names = {n.strip() for n in names_csv.split(",") if n.strip()}
    return lambda name: any(p in names for p in name.split("."))


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The 2-norm over every tensor (optax.global_norm), from one norm per
    tensor: one fused launch for the list, then one for the stack."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


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
    """

    def __init__(self, lr_fn: Callable[[int], float], *, b1: float,
                 b2: float, eps: float, weight_decay: float,
                 mu_dtype: torch.dtype, max_norm: float,
                 frozen: Callable[[str], bool]) -> None:
        self.lr_fn = lr_fn
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.mu_dtype = mu_dtype
        # optax scales the stored mu by b1 in mu's own dtype (a weakly typed
        # scalar): b1 rounded to bf16 for a bf16 mu.
        self._b1_mu = torch.tensor(b1, dtype=mu_dtype).item()
        self.max_norm = max_norm
        self.frozen = frozen

    def init(self, params: Tensors) -> AdamState:
        live = [k for k in params if not self.frozen(k)]
        return AdamState(
            0, {k: torch.zeros_like(params[k], dtype=self.mu_dtype)
                for k in live},
            {k: torch.zeros_like(params[k]) for k in live})

    def update(self, grads: Tensors, state: AdamState, params: Tensors
               ) -> Tuple[Tensors, AdamState]:
        names = list(grads)
        g = [torch.zeros_like(grads[k]) if self.frozen(k) else grads[k]
             for k in names]
        g_norm = global_norm(g)
        # g if g_norm < max_norm else (g / g_norm) * max_norm, as t / d * s
        # with d = s = 1 in the first case: the same roundings, no branch.
        trigger = g_norm < self.max_norm
        d = torch.where(trigger, torch.ones_like(g_norm), g_norm)
        scale = torch.where(trigger, torch.ones_like(g_norm),
                            torch.full_like(g_norm, self.max_norm))
        g = torch._foreach_div(g, d)
        torch._foreach_mul_(g, scale)
        count = state.count + 1
        # 1 - b**count in float32 from the float32 b, as optax computes it
        # (1 - 0.999 is 1.3e-5 away from 1 - float32(0.999)).
        f32 = np.float32
        bc1 = float(f32(1.0) - f32(self.b1) ** np.int32(count))
        bc2 = float(f32(1.0) - f32(self.b2) ** np.int32(count))
        lr = self.lr_fn(state.count)
        live = [i for i, k in enumerate(names) if k in state.mu]
        gl = [g[i] for i in live]
        m = torch._foreach_mul(gl, 1.0 - self.b1)
        torch._foreach_add_(m, torch._foreach_mul(
            [state.mu[names[i]] for i in live], self._b1_mu))
        v = torch._foreach_mul(gl, gl)
        torch._foreach_mul_(v, 1.0 - self.b2)
        torch._foreach_add_(v, torch._foreach_mul(
            [state.nu[names[i]] for i in live], self.b2))
        u = torch._foreach_div(m, bc1)
        den = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(u, den)
        if self.weight_decay:
            torch._foreach_add_(u, torch._foreach_mul(
                [params[names[i]] for i in live], self.weight_decay))
        torch._foreach_mul_(u, -lr)
        # Frozen leaves keep their (zeroed) clipped gradient as the update.
        updates = dict(zip(names, g))
        mu, nu = {}, {}
        for i, ui, mi, vi in zip(live, u, m, v):
            k = names[i]
            updates[k] = ui
            mu[k], nu[k] = mi.to(self.mu_dtype), vi
        return updates, AdamState(count, mu, nu)


def make_optimizer(cfg: Config) -> Tuple[AdamW, Callable[[int], float]]:
    """The configured :class:`AdamW` and its learning-rate schedule."""
    t = cfg.train
    if t.adam_mu_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"train.adam_mu_dtype={t.adam_mu_dtype!r}: "
                         "'float32' or 'bfloat16'")
    lr = make_lr_schedule(cfg)
    return AdamW(lr, b1=t.adam_beta1, b2=t.adam_beta2, eps=t.adam_eps,
                 weight_decay=t.weight_decay,
                 mu_dtype=dtype_of(t.adam_mu_dtype),
                 max_norm=t.grad_clip_norm,
                 frozen=_freeze_mask_fn(t.freeze_params)), lr


@dataclasses.dataclass
class TrainState:
    """``params`` are the model's own parameters, updated in place;
    ``rng`` draws the dropout masks."""

    step: int
    params: Dict[str, torch.nn.Parameter]
    opt_state: AdamState
    rng: torch.Generator


def _todo(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, section 1, {item})")


class Trainer:
    """Build once from a :class:`ModelSpec`, then :meth:`init_state` (and
    :meth:`restore`), :meth:`fit_resident` or :meth:`fit`, :meth:`evaluate`
    or :meth:`evaluate_resident`.

    Runs on CUDA unless ``device`` says otherwise (the tests pass "cpu");
    without a card and without ``device`` it raises. Not ported, and
    raising ``NotImplementedError`` with their ROADMAP item when asked for:
    the profiler window (item 14), ``steps_per_call > 1`` (item 15),
    ``store_sharded`` (item 12), ``sort_batch_by_image`` (item 14) and
    ``remat`` (item 14)."""

    # fit_resident stages its seeded index table in segments of this many
    # steps; shrink in tests to exercise re-staging.
    resident_segment_steps = 2048

    def __init__(self, cfg: Config, spec: ModelSpec,
                 train_dir: Optional[str] = None,
                 device: Optional[str] = None) -> None:
        t = cfg.train
        for on, what, item in (
                (t.store_sharded, "train.store_sharded", "item 12"),
                (t.steps_per_call > 1, "train.steps_per_call > 1",
                 "item 15"),
                (t.sort_batch_by_image, "train.sort_batch_by_image",
                 "item 14"),
                (t.remat, "train.remat", "item 14"),
                (t.profile_steps > 0, "the profiler window "
                 "(train.profile_steps)", "item 14")):
            if on:
                raise _todo(what, item)
        self.cfg = cfg
        self.spec = spec
        self.device = resolve_device(device)
        self.model = model = spec.module.to(self.device)
        if (t.resident_fused_attention and t.device_data_cache
                and getattr(model, "store_prenormalized", None) is False):
            # The store is L2-normalized once at upload (_prepare_resident),
            # so the (store, rows) path skips the per-cell norm.
            model.store_prenormalized = True
        self.tx, self.lr_fn = make_optimizer(cfg)
        self.train_dir = train_dir or t.train_dir
        self.ckpt = CheckpointManager(self.train_dir,
                                      keep=t.keep_checkpoints,
                                      save_every=t.checkpoint_every)
        self.metrics = MetricWriter(self.train_dir)

    # -- state ---------------------------------------------------------------

    def init_state(self, params: Optional[Tensors] = None) -> TrainState:
        """Adopt ``params`` (a ``state_dict``) if given, else keep the
        model's initialization; fresh optimizer state and dropout stream."""
        if params is not None:
            self.model.load_state_dict(params)
        live = dict(self.model.named_parameters())
        rng = torch.Generator(device=self.device)
        rng.manual_seed(self.cfg.train.seed + 1)
        return TrainState(0, live, self.tx.init(live), rng)

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        """``state`` with the checkpoint of ``step`` (default: the latest)
        of this run directory loaded into it."""
        return self.ckpt.restore(state, step)

    def train_step(self, state: TrainState, batch: Dict[str, object]
                   ) -> Tuple[TrainState, Tensors]:
        """One optimizer step on a device batch; returns the new state and
        the step's metrics as device tensors (no host synchronization)."""
        names = list(state.params)
        outputs = self.model(*self.spec.inputs(batch), train=True,
                             generator=state.rng)
        loss, metrics = self.spec.loss(outputs, batch)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [state.params[k] for k in names])))
        metrics.pop("weight", None)  # eval-weighting aid, not a metric
        metrics["grad_norm"] = global_norm(list(grads.values()))
        # Filled on the device: a host scalar copied up would wait for the
        # queue to drain (pageable copies synchronize the stream).
        metrics["lr"] = torch.full((), self.lr_fn(state.step),
                                   device=loss.device)
        with torch.no_grad():
            updates, opt_state = self.tx.update(grads, state.opt_state,
                                                state.params)
            torch._foreach_add_([state.params[k] for k in names],
                                [updates[k] for k in names])
        return (TrainState(state.step + 1, state.params, opt_state,
                           state.rng), metrics)

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
        at every ``log_every``-th step. Every ``eval_every`` steps the split
        of ``eval_batches_fn()`` is evaluated (:meth:`evaluate`); the
        checkpoint policy runs after every step and the last step is always
        saved."""
        t = self.cfg.train
        max_steps = max_steps if max_steps is not None else t.max_steps
        if t.prefetch_batches > 0:
            train_batches = PrefetchIterator(train_batches,
                                             depth=t.prefetch_batches)
        upload = self._uploader()
        timer = Timer()
        step = last_log = state.step
        next_log = _next_multiple(step, t.log_every)
        next_eval = _next_multiple(step, t.eval_every)
        log.info("training (streamed) from step %d to %d on %s", step,
                 max_steps, self.device)
        while step < max_steps:
            state, pending = self.train_step(state,
                                             upload(next(train_batches)))
            step = state.step
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
            self.ckpt.save(step, state)
        if self.ckpt.latest_step() != state.step:
            self.ckpt.save(state.step, state, force=True)
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
        log window later. The checkpoint policy runs after every step and
        the last step is always saved."""
        t = self.cfg.train
        max_steps = max_steps if max_steps is not None else t.max_steps
        rows, make_batch, nbytes = self._prepare_resident(ds)
        store_rows = next((rows[k].shape[0] for k in ("grid", "store_pool5")
                           if k in rows), None)
        log.info("device-resident dataset: %d rows%s, %.2f GB uploaded once",
                 ds.size, (f" + {store_rows}-row feature store"
                           if store_rows is not None else ""), nbytes / 1e9)
        indices = ds.index_batches(t.batch_size, seed=t.seed)
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
        seg_steps = max(1, self.resident_segment_steps)
        seg, seg_off = None, seg_steps
        next_log = _next_multiple(stepno, t.log_every)
        next_eval = _next_multiple(stepno, t.eval_every)
        while stepno < max_steps:
            if seg_off >= seg_steps:
                # One host->device copy of the next index-table segment.
                n = min(seg_steps, max_steps - stepno)
                seg = torch.from_numpy(np.stack(
                    [next(indices) for _ in range(n)])).to(self.device)
                seg_off = 0
            state, pending = self.train_step(state, make_batch(seg[seg_off]))
            seg_off += 1
            stepno += 1
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

        data = {k: self._upload_rows(k, v) for k, v in ds.arrays.items()
                if k not in drop_keys}
        if not isinstance(ds, JoinedDataset):
            def make_rows(idx: torch.Tensor) -> Dict[str, object]:
                return {k: v.index_select(0, idx) for k, v in data.items()}

            nbytes = sum(v.numel() * v.element_size() for v in data.values())
            return data, make_rows, nbytes
        wanted = self.cfg.train.resident_fused_attention
        model_ok = bool(getattr(self.model, "n_cells", None))
        fused = (wanted and model_ok
                 and getattr(self.model, "glimpses", 1) <= 8
                 and self.cfg.train.batch_size % 8 == 0)
        if wanted and not fused:
            (log.warning if model_ok else log.info)(
                "resident_fused_attention unavailable (needs a spatial-"
                "attention model with glimpses <= 8 and batch % 8 == 0): "
                "using the gathered resident path")
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
        if self.spec.visual_key == "features":
            store["grid"], scale = self._upload_grid(ds.store.grid, fused)
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
                batch["features"] = ((grid, rows, *codes_scale) if fused
                                     else grid.index_select(0, rows.long()))
            return batch

        nbytes = sum(v.numel() * v.element_size()
                     for v in (*data.values(), *store.values()))
        return dict(data, **store), make_batch, nbytes

    def _upload_grid(self, grid, fused: bool) -> Tuple[torch.Tensor, float]:
        """A store's grids on the device and their dequantization scale
        (1.0 unless int8): padded to a multiple of 8 cells (L2-normalized
        when the model skips the per-cell norm, and then quantized to int8
        under ``train.store_quantize`` int8) for the gather-free path, else
        [M, N, C] as they are. ``train.store_quantize`` other than "" or
        "int8" raises ``ValueError``; int8 where the store is not
        prenormalized logs a warning and keeps the float store, as the JAX
        package does."""
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
        # The JAX package casts float stores to bf16 when it computes in
        # bf16 and keeps their own dtype otherwise; the same values arrive
        # here.
        store_dt = (torch.bfloat16 if dt == torch.bfloat16
                    else torch.from_numpy(grid[:0]).dtype)
        if quantize and not (fused and self.model.store_prenormalized):
            log.warning("train.store_quantize=%r needs the prenormalized "
                        "gather-free resident path (device_data_cache and "
                        "resident_fused_attention): keeping the float store",
                        quantize)
            quantize = ""
        if not fused:
            return torch.from_numpy(np.ascontiguousarray(grid)).to(
                self.device).to(store_dt), 1.0
        if dt == torch.bfloat16 and grid.dtype == np.float32:
            # f32 sources are rounded to bf16 before they are normalized
            grid = torch.from_numpy(grid).to(dt).float().numpy()
        if self.model.store_prenormalized:
            return prenormalize_store(grid, out_dtype=store_dt,
                                      quantize=quantize, device=self.device)
        return torch.from_numpy(pad_store_rows(grid)).to(self.device,
                                                         store_dt), 1.0

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
        names the parameters, which are the model's own."""
        del state
        upload = self._uploader()
        sums: Dict[str, float] = {}
        total_w = 0.0
        preds = []
        for batch in batches:
            p, m = self._eval_step(upload(batch))
            m = self._fetch_later(m)()  # one wait for the batch
            preds.append(p.cpu().numpy())
            w = m.pop("weight", 1.0)
            total_w += w
            for k, v in m.items():
                sums[k] = sums.get(k, 0.0) + v * w
        means = {k: v / max(total_w, 1e-9) for k, v in sums.items()}
        return means, (np.concatenate(preds) if preds
                       else np.zeros((0,), np.int64))

    def _make_resident_evaluator(self, ds):
        """Resident evaluator over ``ds``: the split uploads once (its
        ``answer_scores`` and ``cand_counts`` stay on the host) and the
        whole padded index epoch is enqueued with no host round trip.
        Returns ``run(state) -> (metrics, preds)`` with ``run.dispatch``
        (enqueue, returns a handle) and ``run.collect`` (wait for the
        handle, finish on the host: weighted means, and ``vqa_accuracy``
        from the host's score table)."""
        data, make_batch, nbytes = self._prepare_resident(
            ds, drop_keys=("answer_scores", "cand_counts"))
        log.info("device-resident eval split: %d rows, %.2f GB uploaded once",
                 ds.size, nbytes / 1e9)
        B = self.cfg.train.batch_size
        n = len(ds)
        starts = list(range(0, n, B))
        idxs = np.zeros((len(starts), B), np.int32)
        masks = np.zeros((len(starts), B), np.float32)
        for r, start in enumerate(starts):
            stop = min(start + B, n)
            idxs[r, :stop - start] = np.arange(start, stop)
            masks[r, :stop - start] = 1.0
        dev_idxs = torch.from_numpy(idxs).to(self.device)
        dev_masks = torch.from_numpy(masks).to(self.device)
        scores_host = (np.asarray(ds.arrays["answer_scores"], np.float64)
                       if "answer_scores" in ds.arrays else None)
        labels_host = (np.asarray(ds.arrays["answer_id"])
                       if "answer_id" in ds.arrays else None)

        def dispatch(state: TrainState):
            """Enqueue the whole split on the current stream; the handle's
            copies to the host are in flight when it returns."""
            del state  # the parameters are the model's own
            preds, ms = [], []
            for r in range(len(starts)):
                batch = make_batch(dev_idxs[r])
                batch["example_mask"] = dev_masks[r]
                p, m = self._eval_step(batch)
                preds.append(p)
                ms.append(m)
            keys = sorted(ms[0])
            vals = torch.stack([torch.stack([m[k].float() for k in keys])
                                for m in ms])  # [n_batches, len(keys)]
            both = torch.cat([torch.stack(preds).float(), vals], dim=1)
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
            m = {k: vals[:, i] for i, k in enumerate(keys)}
            w = m.pop("weight", np.ones(len(starts)))
            total_w = max(float(w.sum()), 1e-9)
            means = {k: float((v * w).sum() / total_w) for k, v in m.items()}
            preds = p.reshape(-1)[:n].astype(np.int64)
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
        self.metrics.close()
