"""Port parity: the optimizer and LR schedule of parallel/trainer.py against
the JAX package's optax chain (``make_optimizer``, ``make_lr_schedule``),
step for step on random gradients.

Tolerance rtol 1e-5 / atol 1e-8: the same float32 arithmetic in the same
order, except the powers ``b**count`` and ``rate**k``, which numpy and XLA
may round one ulp apart; over 8 steps that moves an update by a few ulps.
The bf16 first moment is rounded where optax rounds it, so it needs no
looser limit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_transfer_externaldata_tpu.config import Config as JaxConfig
from vqa_transfer_externaldata_tpu.parallel import trainer as jt
from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.parallel import trainer as tt

torch.set_num_threads(2)  # xdist runs several workers on the same cores

TOL = dict(rtol=1e-5, atol=1e-8)
SHAPES = {"gru.uh": (6, 9), "gru.bhn": (3,), "answer_embedding": (5, 4),
          "fuse_q.w.weight": (4, 6), "logit_scale": ()}


def _nest(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        parts = k.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


@pytest.mark.parametrize("clip,mu_dtype,frozen,wd", [
    (1e6, "float32", "", 0.0),  # clip inactive
    (0.5, "float32", "", 0.0),  # clip active every step
    (2.0, "bfloat16", "answer_embedding", 0.0),  # bf16 mu, a frozen leaf
    (0.5, "float32", "gru", 1e-2),  # a frozen subtree, weight decay
])
def test_optimizer_matches_optax(clip, mu_dtype, frozen, wd):
    over = {"train.grad_clip_norm": clip, "train.adam_mu_dtype": mu_dtype,
            "train.freeze_params": frozen, "train.weight_decay": wd,
            "train.warmup_steps": 3, "train.lr_decay_steps": 4,
            "train.lr_decay_rate": 0.5, "train.learning_rate": 0.01}
    tx_j, _ = jt.make_optimizer(JaxConfig().replace_flat(over))
    tx_t, _ = tt.make_optimizer(Config().replace_flat(over))
    rng = np.random.default_rng(0)
    p0 = {k: np.asarray(rng.normal(size=s), np.float32)
          for k, s in SHAPES.items()}
    pj = jax.tree_util.tree_map(jnp.asarray, _nest(p0))
    pt = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    sj, st = tx_j.init(pj), tx_t.init(pt)
    assert all(v.dtype == tt.dtype_of(mu_dtype) for v in st.mu.values())
    for step in range(8):
        g = {k: np.asarray(rng.normal(size=s) * 3, np.float32)
             for k, s in SHAPES.items()}
        uj, sj = tx_j.update(jax.tree_util.tree_map(jnp.asarray, _nest(g)),
                             sj, pj)
        pj = jax.tree_util.tree_map(lambda p, u: p + u, pj, uj)
        ut, st = tx_t.update({k: torch.from_numpy(v) for k, v in g.items()},
                             st, pt, torch.from_numpy(
                                 tx_t.scalars(st.count, 1)[0]))
        pt = {k: pt[k] + ut[k] for k in pt}
        want = _flat(jax.device_get(uj))
        for k in SHAPES:
            np.testing.assert_allclose(ut[k].numpy(), want[k], **TOL,
                                       err_msg=f"step {step} {k}")
    want = _flat(jax.device_get(pj))
    for k in SHAPES:
        np.testing.assert_allclose(pt[k].numpy(), want[k], **TOL, err_msg=k)
        if frozen and frozen in k.split("."):
            np.testing.assert_array_equal(pt[k].numpy(), p0[k])
            assert k not in st.mu and k not in st.nu


def test_lr_schedule_matches_jax():
    over = {"train.warmup_steps": 5, "train.lr_decay_steps": 7,
            "train.lr_decay_rate": 0.9, "train.learning_rate": 3e-3}
    fj = jt.make_lr_schedule(JaxConfig().replace_flat(over))
    ft = tt.make_lr_schedule(Config().replace_flat(over))
    for step in range(40):
        np.testing.assert_allclose(ft(step), float(fj(step)), rtol=1e-6,
                                   err_msg=f"step {step}")


def test_clip_uses_no_epsilon():
    """At g_norm == max_norm the gradient passes unscaled (optax's
    ``g_norm < max_norm`` else ``g / g_norm * max_norm``), where
    ``clip_grad_norm_`` would scale by max_norm / (g_norm + 1e-6)."""
    cfg = Config().replace_flat({"train.grad_clip_norm": 5.0,
                                 "train.warmup_steps": 1})
    tx, _ = tt.make_optimizer(cfg)
    p = {"w": torch.zeros(2)}
    g = {"w": torch.tensor([3.0, 4.0])}  # norm exactly 5
    row = torch.from_numpy(tx.scalars(0, 1)[0])
    u1, _ = tx.update(g, tx.init(p), p, row)
    u2, _ = tx.update({"w": g["w"] * 2}, tx.init(p), p, row)
    # Adam normalizes the first step: a clipped (scaled) gradient and an
    # unclipped one give the same update when the scale is exactly 1.
    torch.testing.assert_close(u1["w"], u2["w"], rtol=0, atol=0)


def _adamw_as_before(tx, grads, state, params):
    """The update as the port computed it before its steps could be
    captured: the host numbers as Python floats, new moment tensors."""
    names = list(grads)
    g = [torch.zeros_like(grads[k]) if tx.frozen(k) else grads[k]
         for k in names]
    g_norm = tt.global_norm(g)
    trigger = g_norm < tx.max_norm
    d = torch.where(trigger, torch.ones_like(g_norm), g_norm)
    scale = torch.where(trigger, torch.ones_like(g_norm),
                        torch.full_like(g_norm, tx.max_norm))
    g = torch._foreach_div(g, d)
    torch._foreach_mul_(g, scale)
    count = state.count + 1
    f32 = np.float32
    bc1 = float(f32(1.0) - f32(tx.b1) ** np.int32(count))
    bc2 = float(f32(1.0) - f32(tx.b2) ** np.int32(count))
    lr = tx.lr_fn(state.count)
    live = [i for i, k in enumerate(names) if k in state.mu]
    gl = [g[i] for i in live]
    m = torch._foreach_mul(gl, 1.0 - tx.b1)
    torch._foreach_add_(m, torch._foreach_mul(
        [state.mu[names[i]] for i in live], tx._b1_mu))
    v = torch._foreach_mul(gl, gl)
    torch._foreach_mul_(v, 1.0 - tx.b2)
    torch._foreach_add_(v, torch._foreach_mul(
        [state.nu[names[i]] for i in live], tx.b2))
    u = torch._foreach_div(m, bc1)
    den = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, tx.eps)
    torch._foreach_div_(u, den)
    if tx.weight_decay:
        torch._foreach_add_(u, torch._foreach_mul(
            [params[names[i]] for i in live], tx.weight_decay))
    torch._foreach_mul_(u, -lr)
    updates = dict(zip(names, g))
    mu, nu = {}, {}
    for i, ui, mi, vi in zip(live, u, m, v):
        updates[names[i]] = ui
        mu[names[i]], nu[names[i]] = mi.to(tx.mu_dtype), vi
    return updates, tt.AdamState(count, mu, nu)


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("table", ["per_step", "whole_run"])
def test_device_scalar_adamw_is_bit_equal_to_host_float_form(mu_dtype,
                                                             table):
    """50 updates through warmup (5 steps) and three staircase decays (every
    12): AdamW reading its host numbers as 0-d tensors (a row of
    ``AdamW.scalars``, as a captured step reads them) and writing the
    moments in place gives the bits of the host-float form with new
    moment tensors, for a float32 and a bf16 first moment, with a frozen
    leaf, the clip active and weight decay. The rows are taken one update
    at a time or from one [50, 3] table, as k steps of a call take theirs."""
    over = {"train.grad_clip_norm": 1.0, "train.adam_mu_dtype": mu_dtype,
            "train.freeze_params": "answer_embedding",
            "train.weight_decay": 1e-2, "train.warmup_steps": 5,
            "train.lr_decay_steps": 12, "train.lr_decay_rate": 0.5,
            "train.learning_rate": 0.01}
    tx, _ = tt.make_optimizer(Config().replace_flat(over))
    rng = np.random.default_rng(1)
    p0 = {k: np.asarray(rng.normal(size=s), np.float32)
          for k, s in SHAPES.items()}
    pa = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    pb = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    sa, sb = tx.init(pa), tx.init(pb)
    mu_ids = {k: id(v) for k, v in sb.mu.items()}
    rows = torch.from_numpy(tx.scalars(0, 50))
    for step in range(50):
        g = {k: torch.from_numpy(np.asarray(rng.normal(size=s) * 3,
                                            np.float32))
             for k, s in SHAPES.items()}
        ua, sa = _adamw_as_before(tx, g, sa, pa)
        row = (rows[step] if table == "whole_run"
               else torch.from_numpy(tx.scalars(sb.count, 1)[0]))
        ub, sb = tx.update(g, sb, pb, row)
        for k in SHAPES:
            assert torch.equal(ua[k], ub[k]), (step, k)
            pa[k] = pa[k] + ua[k]
            pb[k] += ub[k]
        assert sa.count == sb.count == step + 1
    assert {k: id(v) for k, v in sb.mu.items()} == mu_ids
    for k in sa.mu:
        assert sb.mu[k].dtype == tt.dtype_of(mu_dtype)
        assert torch.equal(sa.mu[k], sb.mu[k]), k
        assert torch.equal(sa.nu[k], sb.nu[k]), k
    for k in SHAPES:
        assert torch.equal(pa[k], pb[k]), k
    np.testing.assert_array_equal(pb["answer_embedding"].numpy(),
                                  p0["answer_embedding"])


def test_scalars_are_the_host_floats_of_each_count():
    """``AdamW.scalars(count, n)``: row i is (1 - b1**c, 1 - b2**c,
    lr_fn(c - 1)) for c = count + 1 + i, as the host computed them for
    each update, rounded to float32 (as the kernels took them), so a table
    for k steps equals k one-row tables."""
    cfg = Config().replace_flat({"train.warmup_steps": 3,
                                 "train.lr_decay_steps": 4,
                                 "train.lr_decay_rate": 0.5})
    tx, lr = tt.make_optimizer(cfg)
    table = tx.scalars(7, 9)
    assert table.shape == (9, 3) and table.dtype == np.float32
    for i in range(9):
        c = 8 + i
        np.testing.assert_array_equal(table[i], tx.scalars(7 + i, 1)[0])
        f32 = np.float32
        assert table[i, 0] == f32(f32(1) - f32(0.9) ** np.int32(c))
        assert table[i, 1] == f32(f32(1) - f32(0.999) ** np.int32(c))
        assert table[i, 2] == f32(lr(c - 1))
