"""Single-device trainer of the port: the device-resident path of the JAX
package's ``parallel/trainer.py``, for any :class:`~..models.zoo.ModelSpec`
(stage 1 and stage 2).

The dataset is uploaded once and the seeded index stream is staged on the
device in segments; each step takes its batch by index. A stage-2
``JoinedDataset`` uploads its question table and its deduplicated feature
store (L2-normalized and padded to a multiple of 8 cells), and the model
gets ``(store, rows)``, so the attention kernels read the grids straight
out of the store. A stage-1 ``ArrayDataset`` uploads its rows, float
features cast to the compute dtype on the host. One step is: forward with
dropout, the spec's loss, backward, then the optax chain of the JAX
package (frozen leaves zeroed, global-norm clip, AdamW with warmup and a
staircase decay), written here as a few tensor operations with optax's
exact semantics (:class:`AdamW`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.models.zoo import ModelSpec
from vqa_transfer_externaldata_torch.ops.attention_resident import (
    pad_store_rows, prenormalize_store)
from vqa_transfer_externaldata_torch.ops.layers import dtype_of
from vqa_transfer_externaldata_torch.serving import resolve_device
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
    """Build once from a :class:`ModelSpec`, then :meth:`init_state` and
    :meth:`fit_resident`.

    Runs on CUDA unless ``device`` says otherwise (the tests pass "cpu");
    without a card and without ``device`` it raises. Not ported, and
    raising ``NotImplementedError`` with their ROADMAP item when asked for:
    in-loop evaluation (item 7), the profiler window (item 14),
    ``steps_per_call > 1`` (item 15), ``store_sharded`` (item 12), an int8
    store (item 14), ``sort_batch_by_image`` (item 14), ``remat`` (item 14),
    and training on gathered features (item 9). Periodic checkpoints and
    resume (item 8) are not written: ``checkpoint_every``, ``resume`` and
    ``keep_checkpoints`` are ignored, and the CLI saves the final
    parameters."""

    # fit_resident stages its seeded index table in segments of this many
    # steps; shrink in tests to exercise re-staging.
    resident_segment_steps = 2048

    def __init__(self, cfg: Config, spec: ModelSpec,
                 train_dir: Optional[str] = None,
                 device: Optional[str] = None) -> None:
        t = cfg.train
        for on, what, item in (
                (t.store_sharded, "train.store_sharded", "item 12"),
                (bool(t.store_quantize), "train.store_quantize", "item 14"),
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

    # -- the resident loop -----------------------------------------------------

    def fit_resident(self, ds, state: TrainState,
                     max_steps: Optional[int] = None,
                     eval_ds=None) -> TrainState:
        """Device-resident training over a ``JoinedDataset`` (stage 2) or
        an ``ArrayDataset`` (stage 1): the dataset is uploaded once, and
        each step's only input is a [batch] slice of the index table staged
        on the device. Metrics are logged every ``log_every`` steps one window
        late (a window's values are copied to the host asynchronously and
        read at the next boundary, so logging never drains the device's
        queue); each record's ``questions_per_sec`` spans the steps since
        the previous record."""
        if eval_ds is not None:
            raise _todo("in-loop evaluation", "item 7")
        t = self.cfg.train
        max_steps = max_steps if max_steps is not None else t.max_steps
        rows, make_batch, nbytes = self._prepare_resident(ds)
        log.info("device-resident dataset: %d rows%s, %.2f GB uploaded once",
                 ds.size, (f" + {rows['grid_pad'].shape[0]}-row feature "
                           "store" if "grid_pad" in rows else ""),
                 nbytes / 1e9)
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

        log.info("training (device-resident) from step %d to %d on %s",
                 stepno, max_steps, self.device)
        seg_steps = max(1, self.resident_segment_steps)
        seg, seg_off = None, seg_steps
        next_log = (stepno // max(1, t.log_every) + 1) * max(1, t.log_every)
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
                next_log = (stepno // max(1, t.log_every) + 1) * max(
                    1, t.log_every)
                log_window(pending, final=stepno >= max_steps)
        return state

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

    def _prepare_resident(self, ds) -> Tuple[Dict[str, torch.Tensor],
                                             Callable, int]:
        """Upload ``ds`` for resident training. Returns ``(device tensors,
        make_batch, bytes uploaded)``; ``make_batch(idx)`` takes a batch by
        index on the device. The row arrays upload as they are, float
        features cast to the compute dtype on the host first (as the JAX
        package's ``_cast_features_host``: the same values, half the
        bytes). A ``JoinedDataset`` also uploads its store as ``grid_pad``
        [M, Np, C] (L2-normalized at upload when the model skips the
        per-cell norm), and ``make_batch`` hands the model ``(grid_pad,
        rows)``; the store's pool5 is left on the host: no ported model
        reads it."""
        from vqa_transfer_externaldata_torch.data.features import (
            JoinedDataset)

        dt = self.model.dtype
        data = {k: self._upload_rows(k, v) for k, v in ds.arrays.items()}
        if not isinstance(ds, JoinedDataset):
            def make_rows(idx: torch.Tensor) -> Dict[str, object]:
                return {k: v.index_select(0, idx) for k, v in data.items()}

            nbytes = sum(v.numel() * v.element_size() for v in data.values())
            return data, make_rows, nbytes
        if not self.cfg.train.resident_fused_attention:
            raise _todo("the gathered resident path "
                        "(train.resident_fused_attention false)", "item 9")
        if not getattr(self.model, "n_cells", None):
            raise ValueError("the gather-free path needs the model's n_cells")
        grid = np.asarray(ds.store.grid)
        if grid.ndim == 4:  # [M, g, g, C] -> [M, N, C]
            grid = grid.reshape(grid.shape[0], -1, grid.shape[-1])
        M = grid.shape[0]
        index = np.asarray(ds.arrays[ds.index_key])
        if index.size and (index.min() < 0 or index.max() >= M):
            raise IndexError(f"{ds.index_key} outside the {M}-row store")
        # The JAX package casts float stores to bf16 when it computes in
        # bf16 (f32 sources before they are normalized) and keeps their
        # own dtype otherwise; the same values arrive here.
        if dt == torch.bfloat16 and grid.dtype == np.float32:
            grid = torch.from_numpy(grid).to(dt).float().numpy()
        store_dt = (torch.bfloat16 if dt == torch.bfloat16
                    else torch.from_numpy(grid[:0]).dtype)
        if self.model.store_prenormalized:
            grid_pad, _ = prenormalize_store(grid, out_dtype=store_dt,
                                             device=self.device)
        else:
            grid_pad = torch.from_numpy(pad_store_rows(grid)).to(
                self.device, store_dt)
        key = ds.index_key

        def make_batch(idx: torch.Tensor) -> Dict[str, object]:
            batch = {k: v.index_select(0, idx) for k, v in data.items()}
            batch["features"] = (grid_pad, batch[key])
            return batch

        nbytes = grid_pad.numel() * grid_pad.element_size() + sum(
            v.numel() * v.element_size() for v in data.values())
        return dict(data, grid_pad=grid_pad), make_batch, nbytes

    def _upload_rows(self, key: str, v: np.ndarray) -> torch.Tensor:
        """One row array on the device. Float32 region features
        (``feature``, stage 1) travel in the compute dtype. uint16 (the
        candidate counts, each at most num_candidates) travels as int16,
        which torch's kernels take: uint16 has few of them."""
        v = np.ascontiguousarray(v)
        if v.dtype == np.uint16:
            if v.size and int(v.max()) > np.iinfo(np.int16).max:
                raise ValueError(f"{key}: uint16 values past the int16 range")
            v = v.astype(np.int16)
        t = torch.from_numpy(v)
        if key == "feature" and t.dtype == torch.float32:
            t = t.to(self.model.dtype)
        return t.to(self.device)

    def close(self) -> None:
        self.metrics.close()
