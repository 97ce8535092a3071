"""Port parity of the G-glimpse attention (``vqa_attention2`` and
``model.glimpses``) against the JAX package:

- the plain versions of K4/K5 at G=2 against JAX's ``_resident_fwd_multi``
  / ``_resident_bwd_multi`` (the Pallas kernels B3/B4 in interpret mode);
- ``spatial_attention_resident`` with a 2-D ``w_score`` (outputs and the
  grads of qh, W_v, ws) against JAX's;
- ``spatial_attention_multi`` and its autograd against ``jax.vjp``;
- ``VQAAttentionModel`` at G=2 on both inputs (logits, alpha, every
  gradient) and 6 ``fit_resident`` steps, gather-free and gathered, against
  JAX's (``tests/test_trainer.py::test_resident_fused_multi_glimpse_matches_
  gather`` is JAX's own version of the last);
- the gate above 8 glimpses: the trainer takes the gathered path, the op
  raises.

float32 at tiny widths, torch at 2 threads. Tolerances: ops 1e-5 (the same
f32 math, sums in another order); the model's logits 1e-5 and gradients by
cosine >= 0.99999 and mean error <= 1e-5 of the mean magnitude (a ReLU unit
at z = 0 may take the other side); training as ``test_torch_trainer.py``:
params rtol 2e-4 / atol 2e-5, logged losses rtol 1e-5.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_transfer_externaldata_tpu.config import Config as JaxConfig
from vqa_transfer_externaldata_tpu.data import datasets as jds
from vqa_transfer_externaldata_tpu.models.vqa_attention import (
    VQAAttentionModel as JaxModel, vqa_loss as jax_vqa_loss)
from vqa_transfer_externaldata_tpu.models.zoo import build_model as jax_build
from vqa_transfer_externaldata_tpu.ops import attention as jatt
from vqa_transfer_externaldata_tpu.ops import attention_resident as jar
from vqa_transfer_externaldata_tpu.parallel.mesh import create_mesh
from vqa_transfer_externaldata_tpu.parallel.trainer import Trainer as JaxTrainer
from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.data import datasets as tds
from vqa_transfer_externaldata_torch.models.vqa_attention import (
    VQAAttentionModel, vqa_loss)
from vqa_transfer_externaldata_torch.models.zoo import build_model
from vqa_transfer_externaldata_torch.ops import attention as tatt
from vqa_transfer_externaldata_torch.ops import attention_resident as tar
from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
from vqa_transfer_externaldata_torch.utils.convert import (
    params_from_flax, params_to_flax)

torch.set_num_threads(2)  # xdist runs several workers on the same cores

M, N, C, H, B, G = 6, 13, 24, 16, 8, 2  # Np = 16 > n_valid = 13
TOL = dict(rtol=1e-5, atol=1e-5)
TINY = {
    "data.synthetic": True, "data.synthetic_layout": "joined",
    "data.synthetic_size": 128, "data.vocab_size": 64,
    "data.num_answers": 16, "data.grid_h": 3, "data.grid_w": 3,
    "data.feature_dim": 16, "data.pool5_dim": 16,
    "data.max_question_len": 6, "model.word_dim": 8, "model.rnn_dim": 8,
    "model.fusion_dim": 16, "model.att_hidden": 8, "model.answer_dim": 8,
    "model.dtype": "float32", "model.dropout": 0.0,
    "model.model": "vqa_attention2",
    "train.batch_size": 16, "train.device_data_cache": True,
    "train.log_every": 2, "train.warmup_steps": 2,
    "train.learning_rate": 3e-3,
}


def _op_inputs(seed=0):
    rng = np.random.default_rng(seed)
    grid = np.abs(rng.normal(size=(M, N, C))).astype(np.float32)
    grid *= np.exp2(rng.uniform(-2, 2, size=(M, N, 1))).astype(np.float32)
    store = jar.pad_store_rows(grid)
    rows = rng.integers(0, M, size=B).astype(np.int32)
    rows[1] = rows[0]  # two questions about one image
    qh = rng.normal(size=(B, H)).astype(np.float32) * 0.5
    wv = rng.normal(size=(C, H)).astype(np.float32) * 0.3
    ws = rng.normal(size=(H, G)).astype(np.float32) * 0.3
    g = rng.normal(size=(B, G * C)).astype(np.float32)
    ga = rng.normal(size=(B, N, G)).astype(np.float32)
    return store, rows, qh, wv, ws, g, ga


@pytest.mark.parametrize("normalize", [True, False])
def test_plain_k4_k5_match_jax_multi_kernels(normalize):
    """K4's and K5's plain versions at G=2 against the Pallas bodies B3/B4
    (interpreted) on the same inputs, K5 fed JAX's saved h and alpha."""
    store, rows, qh, wv, ws, g, _ = _op_inputs(1)
    Np = store.shape[1]
    rng = np.random.default_rng(2)
    sga = rng.normal(size=(B, Np, G)).astype(np.float32)
    kw = dict(n_valid=N, normalize=normalize)
    jv, ja, jh = jar._resident_fwd_multi(
        jnp.asarray(store), jnp.asarray(rows), jnp.asarray(qh),
        jnp.asarray(wv), jnp.asarray(ws), interpret=True, save_h=True, **kw)
    t = torch.from_numpy
    v, a, h = tar.attention_resident_fwd_reference(
        t(store), t(rows), t(qh), t(wv), t(ws), save_h=True, **kw)
    assert v.shape == (B, G * C) and a.shape == (B, Np, G)
    for name, got, want in (("v_att", v, jv), ("alpha", a, ja), ("h", h, jh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=name)
    want = jar._resident_bwd_multi(
        jnp.asarray(store), jnp.asarray(rows), jh, jnp.asarray(ws), ja,
        jnp.asarray(g).reshape(B, G, C), jnp.asarray(sga), interpret=True,
        **kw)
    got = tar.attention_resident_bwd_reference(
        t(store), t(rows), t(np.array(jh)), t(ws), t(np.array(ja)), t(g),
        t(sga), **kw)
    assert got[2].shape == (H, G)
    for name, x, y in zip(("dqh", "dwv", "dws"), got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("normalize", [True, False])
def test_resident_op_g2_matches_jax(normalize):
    store, rows, qh, wv, ws, g, ga = _op_inputs()

    def f(qh, wv, ws):
        return jar.spatial_attention_resident(
            jnp.asarray(store), jnp.asarray(rows), qh, wv, ws, n_valid=N,
            normalize=normalize, interpret=True)

    (va_j, al_j), vjp = jax.vjp(f, jnp.asarray(qh), jnp.asarray(wv),
                                jnp.asarray(ws))
    want = vjp((jnp.asarray(g), jnp.asarray(ga)))
    ins = [torch.from_numpy(a).requires_grad_() for a in (qh, wv, ws)]
    va, al = tar.spatial_attention_resident(
        torch.from_numpy(store), torch.from_numpy(rows), *ins, n_valid=N,
        normalize=normalize)
    assert va.shape == (B, G * C) and al.shape == (B, N, G)
    np.testing.assert_allclose(va.detach().numpy(), np.asarray(va_j), **TOL)
    np.testing.assert_allclose(al.detach().numpy(), np.asarray(al_j), **TOL)
    (va * torch.from_numpy(g)).sum().add(
        (al * torch.from_numpy(ga)).sum()).backward()
    for name, t, w in zip(("dqh", "dwv", "dws"), ins, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)


def test_one_glimpse_matrix_equals_the_vector():
    """w_score [H, 1] is the single glimpse: the same v_att, alpha and
    gradients as w_score [H], alpha and dws with a glimpse axis."""
    store, rows, qh, wv, ws, _, _ = _op_inputs(3)
    outs = []
    for w in (ws[:, 0], ws[:, :1]):
        ins = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
               for a in (qh, wv, w)]
        va, al = tar.spatial_attention_resident(
            torch.from_numpy(store), torch.from_numpy(rows), *ins, n_valid=N,
            normalize=True)
        (va.square().sum() + al.reshape(B, N)[:, 0].sum()).backward()
        outs.append((va, al.reshape(B, N), *(t.grad.reshape(t.shape[0], -1)
                                            for t in ins)))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_spatial_attention_multi_matches_jax():
    rng = np.random.default_rng(4)
    v = np.abs(rng.normal(size=(B, N, C))).astype(np.float32)
    qh = rng.normal(size=(B, H)).astype(np.float32) * 0.5
    wv = rng.normal(size=(C, H)).astype(np.float32) * 0.3
    ws = rng.normal(size=(H, 3)).astype(np.float32) * 0.3
    g = rng.normal(size=(B, 3 * C)).astype(np.float32)
    ga = rng.normal(size=(B, N, 3)).astype(np.float32)
    (va_j, al_j), vjp = jax.vjp(jatt.spatial_attention_multi,
                                *map(jnp.asarray, (v, qh, wv, ws)))
    want = vjp((jnp.asarray(g), jnp.asarray(ga)))
    ins = [torch.from_numpy(a).requires_grad_() for a in (v, qh, wv, ws)]
    va, al = tatt.spatial_attention_multi(*ins)
    assert va.shape == (B, 3 * C) and al.shape == (B, N, 3)
    np.testing.assert_allclose(va.detach().numpy(), np.asarray(va_j), **TOL)
    np.testing.assert_allclose(al.detach().numpy(), np.asarray(al_j), **TOL)
    (va * torch.from_numpy(g)).sum().add(
        (al * torch.from_numpy(ga)).sum()).backward()
    for name, t, w in zip(("dv", "dqh", "dwv", "dws"), ins, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)


def test_gathered_op_takes_one_glimpse():
    with pytest.raises(ValueError, match="spatial_attention_multi"):
        tatt.spatial_attention(torch.zeros(B, N, C), torch.zeros(B, 8),
                               torch.zeros(C, 8), torch.zeros(8, 2))


@pytest.mark.parametrize("glimpses", [0, 9])
def test_resident_op_refuses_glimpses_out_of_range(glimpses):
    store, rows, qh, wv, _, _, _ = _op_inputs()
    with pytest.raises(ValueError, match="1 <= G <= 8"):
        tar.spatial_attention_resident(
            torch.from_numpy(store), torch.from_numpy(rows),
            torch.from_numpy(qh), torch.from_numpy(wv),
            torch.zeros(H, glimpses), n_valid=N)


DIMS = dict(word_dim=8, rnn_dim=8, fusion_dim=16, att_hidden=8,
            answer_dim=8)
V, A, T = 64, 16, 6


def _model_inputs(rng):
    """A padded store (zeros past n_valid), rows that repeat an image,
    padded questions (one empty) and labels."""
    store = np.zeros((M, N + (-N) % 8, C), np.float32)
    store[:, :N] = np.abs(rng.normal(size=(M, N, C)))
    rows = rng.integers(0, M, size=B).astype(np.int32)
    rows[1] = rows[0]
    q = rng.integers(4, V, size=(B, T)).astype(np.int32)
    for i, n in enumerate([6, 1, 3, 0, 5, 2, 6, 4]):
        q[i, n:] = 0
    labels = rng.integers(4, A, size=B).astype(np.int32)
    return store, rows, q, labels


@pytest.mark.parametrize("resident", [True, False])
def test_model_g2_matches_jax(resident):
    """VQAAttentionModel at G=2 on the (store, rows) input (the op with its
    G-glimpse kernels' plain versions against B3/B4 interpreted) and on
    gathered features (l2_normalize, then spatial_attention_multi, as in
    JAX): logits and alpha at eval, every gradient of the training loss."""
    rng = np.random.default_rng(5)
    store, rows, q, labels = _model_inputs(rng)
    mod = JaxModel(vocab_size=V, num_answers=A, dtype=jnp.float32,
                   dropout=0.0, glimpses=G, n_cells=N, **DIMS)
    tree = jax.device_get(mod.init(
        jax.random.PRNGKey(0), jnp.zeros((B, N, C)),
        jnp.ones((B, T), jnp.int32), train=False)["params"])
    tree = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=np.shape(a)) * 0.3).astype(np.float32),
        tree)
    tree["logit_scale"] = np.float32(10.0)
    assert tree["att_ws"].shape == (8, G)
    feats_j = ((jnp.asarray(store), jnp.asarray(rows)) if resident
               else jnp.asarray(store[rows, :N]))
    batch = {"answer_id": jnp.asarray(labels)}

    def jloss(params):
        out = mod.apply({"params": params}, feats_j, jnp.asarray(q),
                        train=True, rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_vqa_loss(out, batch)[0]

    want_eval = mod.apply({"params": tree}, feats_j, jnp.asarray(q),
                          train=False)
    want = params_from_flax(jax.device_get(jax.grad(jloss)(tree)))
    model = VQAAttentionModel(V, A, feature_dim=C, dtype=torch.float32,
                              glimpses=G, n_cells=N, dropout=0.0, **DIMS)
    model.load_state_dict(params_from_flax(tree))
    feats = ((torch.from_numpy(store), torch.from_numpy(rows)) if resident
             else torch.from_numpy(store[rows, :N]))
    with torch.no_grad():
        got = model(feats, torch.from_numpy(q))
    assert got["alpha"].shape == (B, N, G)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want_eval["logits"]), **TOL)
    np.testing.assert_allclose(got["alpha"].numpy(),
                               np.asarray(want_eval["alpha"]),
                               rtol=1e-5, atol=1e-6)
    out = model(feats, torch.from_numpy(q), train=True)
    vqa_loss(out, {"answer_id": torch.from_numpy(labels)})[0].backward()
    for name, p in model.named_parameters():
        a, b = p.grad.flatten(), want[name].flatten()
        cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
        mean_err = (a - b).abs().mean().item()
        assert cos >= 0.99999, (name, cos)
        assert mean_err <= 1e-5 * b.abs().mean().item() + 1e-12, (
            name, mean_err)


@pytest.mark.parametrize("glimpses", range(2, 9))
def test_build_model_takes_glimpses(glimpses):
    over = {"model.model": "vqa_attention", "model.glimpses": glimpses}
    spec = build_model(Config().replace_flat(dict(TINY, **over)))
    sd = spec.module.state_dict()
    assert spec.module.glimpses == glimpses
    assert sd["att_ws"].shape == (8, glimpses)
    assert sd["fuse_v.w.weight"].shape == (16, glimpses * 16)
    assert spec.visual_key == "features"
    tree = params_to_flax(sd)  # the score matrix crosses the bridge as is
    assert tree["att_ws"].shape == (8, glimpses)
    for k, v in params_from_flax(tree).items():
        assert torch.equal(v, sd[k]), k


def _losses(train_dir):
    with open(os.path.join(train_dir, "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    return {r["step"]: r["train/loss"] for r in recs if "train/loss" in r}


@pytest.mark.parametrize("fused", [True, False])
def test_fit_resident_g2_matches_jax(tmp_path, fused):
    """6 steps of vqa_attention2 through fit_resident from the same
    bridged parameters as JAX's: gather-free (the G-glimpse kernels' plain
    versions against B3/B4 interpreted) and gathered (the store gathered
    on the device, spatial_attention_multi on both sides)."""
    over = {"train.resident_fused_attention": fused}
    jcfg = JaxConfig().replace_flat(dict(TINY, **over))
    jtr = JaxTrainer(jcfg, jax_build(jcfg), mesh=create_mesh(
        jcfg, devices=jax.devices()[:1]), train_dir=str(tmp_path / "jax"))
    jtrain = jds.load_dataset(jcfg, "train")
    js = jtr.init_state(next(jtrain.batches(1, epochs=1, shuffle=False)))
    params = params_from_flax(jax.device_get(js.params))
    js = jtr.fit_resident(jtrain, js, max_steps=6)
    want = params_from_flax(jax.device_get(js.params))
    jtr.close()

    cfg = Config().replace_flat(dict(TINY, **over))
    tr = Trainer(cfg, build_model(cfg), train_dir=str(tmp_path / "torch"),
                 device="cpu")
    ds = tds.load_dataset(cfg, "train")
    _, make_batch, _ = tr._prepare_resident(ds)
    feats = make_batch(torch.arange(4))["features"]
    assert isinstance(feats, tuple) == fused  # (store, rows): gather-free
    s = tr.fit_resident(ds, tr.init_state(params), max_steps=6)
    tr.close()
    got = tr.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
    lj, lt = _losses(tmp_path / "jax"), _losses(tmp_path / "torch")
    assert s.step == 6 and sorted(lt) == sorted(lj) == [2, 4, 6]
    for step in lj:
        np.testing.assert_allclose(lt[step], lj[step], rtol=1e-5)


def test_nine_glimpses_take_the_gathered_path(tmp_path):
    """Above 8 glimpses (the kernels' limit) the trainer takes the gathered
    resident path, as JAX's gate does (tests/test_trainer.py::
    test_resident_fused_gate_falls_back_above_glimpse_limit), and trains;
    the op itself refuses the score matrix."""
    over = {"model.model": "vqa_attention", "model.glimpses": 9}
    cfg = Config().replace_flat(dict(TINY, **over))
    tr = Trainer(cfg, build_model(cfg), train_dir=str(tmp_path),
                 device="cpu")
    ds = tds.load_dataset(cfg, "train")
    data, make_batch, _ = tr._prepare_resident(ds)
    batch = make_batch(torch.arange(16))
    assert tuple(batch["features"].shape) == (16, 9, 16)  # gathered
    assert tuple(data["grid"].shape) == (len(ds.store.pool5), 9, 16)
    s = tr.fit_resident(ds, tr.init_state(), max_steps=2)
    tr.close()
    assert s.step == 2
    store, rows = data["grid"], batch["image_index"]
    with pytest.raises(ValueError, match="1 <= G <= 8"):
        tar.spatial_attention_resident(
            store, rows, torch.zeros(16, 8), torch.zeros(16, 8),
            torch.zeros(8, 9), n_valid=9)
