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
                             st, pt)
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
    u1, _ = tx.update(g, tx.init(p), p)
    u2, _ = tx.update({"w": g["w"] * 2}, tx.init(p), p)
    # Adam normalizes the first step: a clipped (scaled) gradient and an
    # unclipped one give the same update when the scale is exactly 1.
    torch.testing.assert_close(u1["w"], u2["w"], rtol=0, atol=0)
