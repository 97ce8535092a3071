"""Port parity: ``model.dtype float16`` on the paths that run the gathered
attention (K2h/K8h on the card) and the bidirectional GRU (K6h/K7h)
against the JAX package on the CPU, whose Pallas bodies B5/B6 and B7/B8
run in interpret mode with float16 operands (or its XLA paths where JAX
takes them).

Tolerances, as ``tests/test_torch_float16.py`` reasons them: float16 keeps
11 significant bits, both sides round at the same places (the squares of
the norm, the weights p * r, dz * r, the BiGRU's state ahead of U_h and
its gate cotangents) and sum in f32 in another order, so where two f32
results differ in their last bits a float16 rounding of them may land on
the neighbouring value, moving one term by 2^-11 of itself.

* The plain versions of K2h and K8h against B5 and B6 interpreted in
  float16 (the grid and W_v in float16), normalize on and off: every
  output to 2^-11 of its largest |value| (measured at these shapes: at
  most 5e-7). One cell holds 300: its square overflows float16 (past
  65504) on both sides, so its norm r is 0 and it takes no part in
  v_att; an f32 square would give it a weight.
* The plain versions of K6h and K7h against ``jax.vjp`` of JAX's
  ``bigru_fused`` (B7/B8 interpreted, float16 U_h): h and the f32
  cotangents to 2^-11 of their largest |value|; JAX returns dU_h in
  float16 (U_h's dtype), so the port's f32 dU_h is held to one float16
  step of the largest |value|, 2^-10 (measured: at most 4.6e-4).
* Six steps of ``vqa_attention`` in float16 on gathered grids (the
  resident store gathered on the device, and streamed host batches of the
  flat layout) and of stage-1 ``vlmap_description`` with the
  bidirectional phrase encoder, from JAX's bridged parameters: params
  rtol 2e-4 / atol 1e-3, losses rtol 2^-10 (the limits of the float16
  main path's test, which reasons them), with Adam's epsilon at 1e-3 as
  ``tests/test_torch_trainer.py``'s gathered test reasons (a gradient
  that cancels to float16 noise would otherwise step by up to the
  learning rate: stage 1 moved one of visual_proj.fc0.weight's 40960
  entries by 1.04e-3 at the default epsilon). A spy shows that float16
  tensors reach ``spatial_attention`` and ``bigru_fused``, which pick
  K2h/K8h and K6h/K7h on the card.
* The gathered evaluator and the float16 ``Predictor`` against JAX's from
  the same parameters: equal predictions and answers, metrics and logits
  within 2^-8 of their largest |value| (one float16 rounding of an
  activation flipped at each of a few layers between the kernels and the
  logits).
* All eight kernel wrappers take float16 and refuse float64
  (``tests/test_torch_float32_gathered.py``), and the four new libraries'
  sources: each includes its bf16 twin, whose headers it hashes.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_cli import TINY as CLI_TINY
from vqa_transfer_externaldata_tpu.cli import train as jax_train_cli
from vqa_transfer_externaldata_tpu.config import Config as JaxConfig
from vqa_transfer_externaldata_tpu.data import datasets as jds
from vqa_transfer_externaldata_tpu.models.zoo import build_model as jax_build
from vqa_transfer_externaldata_tpu.ops import attention as ja
from vqa_transfer_externaldata_tpu.ops import gru as jg
from vqa_transfer_externaldata_tpu.parallel import evaler as jev
from vqa_transfer_externaldata_tpu.parallel.mesh import create_mesh
from vqa_transfer_externaldata_tpu.parallel.trainer import Trainer as JaxTrainer
from vqa_transfer_externaldata_tpu.serving import Predictor as JaxPredictor
from vqa_transfer_externaldata_tpu.utils.checkpoint import (
    load_params as jax_load_params)
from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.data import datasets as tds
from vqa_transfer_externaldata_torch.models import vqa_attention as tmodel
from vqa_transfer_externaldata_torch.models.zoo import build_model
from vqa_transfer_externaldata_torch.ops import attention as ta
from vqa_transfer_externaldata_torch.ops import gru as tg
from vqa_transfer_externaldata_torch.ops import kernels
from vqa_transfer_externaldata_torch.parallel import evaler as tev
from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
from vqa_transfer_externaldata_torch.serving import PARAMS_FILE, Predictor
from vqa_transfer_externaldata_torch.utils.checkpoint import save_params
from vqa_transfer_externaldata_torch.utils.convert import params_from_flax

torch.set_num_threads(2)  # xdist runs several workers on the same cores

TOL_REL = 2.0 ** -11
TOL_F16_OUT_REL = 2.0 ** -10  # an output JAX returns in float16
TOL_MODEL_REL = 2.0 ** -8
PARAMS = dict(rtol=2e-4, atol=1e-3)
LOSS_RTOL = 2.0 ** -10
PLANTED = (1, 4, 7, 300.0)  # question, cell, channel, value

GATHERED = {
    "data.synthetic": True, "data.synthetic_layout": "joined",
    "data.synthetic_size": 128, "data.vocab_size": 64,
    "data.num_answers": 16, "data.grid_h": 3, "data.grid_w": 3,
    "data.feature_dim": 16, "data.pool5_dim": 16,
    "data.max_question_len": 6, "model.word_dim": 8, "model.rnn_dim": 8,
    "model.fusion_dim": 16, "model.att_hidden": 8, "model.answer_dim": 8,
    "model.dtype": "float16", "model.dropout": 0.0,
    "train.batch_size": 16, "train.device_data_cache": True,
    "train.resident_fused_attention": False, "train.adam_eps": 1e-3,
    "train.log_every": 2, "train.warmup_steps": 2,
    "train.learning_rate": 3e-3,
}
STREAMED = dict(GATHERED, **{"data.synthetic_layout": "flat",
                             "train.device_data_cache": False})
STAGE1 = {
    "model.model": "vlmap_description", "model.bidirectional_desc": True,
    "data.synthetic": True, "data.synthetic_size": 96,
    "data.vocab_size": 64, "data.pool5_dim": 16,
    "data.max_question_len": 6, "model.word_dim": 8, "model.rnn_dim": 8,
    "model.dtype": "float16", "model.dropout": 0.0, "model.num_tasks": 4,
    "model.task_dim": 8, "model.num_candidates": 12,
    "train.batch_size": 16, "train.device_data_cache": True,
    "train.adam_eps": 1e-3, "train.log_every": 2, "train.warmup_steps": 2,
    "train.learning_rate": 3e-3,
}


def _rel(got, want, what=""):
    """The largest error of ``got`` relative to ``want``'s largest
    |value|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# -- the plain versions against B5-B8 interpreted in float16 -----------------


def _grid(seed, B=3, N=20, C=32, H=16):
    """A post-ReLU grid with cells of different norms and the planted
    cell, in float16; W_v in float16; ws rounded to float16 (the op hands
    the kernels ws.to(dt)); qh and the score cotangent ds in float32."""
    rng = np.random.default_rng(seed)
    v = np.abs(rng.normal(size=(B, N, C))).astype(np.float32)
    v *= np.exp2(rng.uniform(-2, 2, size=(B, N, 1))).astype(np.float32)
    b, n, c, x = PLANTED
    v[b, n, c] = x
    qh = rng.normal(size=(B, H)).astype(np.float32)
    wv = (rng.normal(size=(C, H)) * 0.3).astype(np.float16)
    ws = rng.normal(size=(H,)).astype(np.float16).astype(np.float32)
    ds = rng.normal(size=(B, N)).astype(np.float32)
    return v.astype(np.float16), qh, wv, ws, ds


@pytest.mark.parametrize("normalize", [True, False])
def test_k2h_k8h_plain_versions_match_b5_b6_in_float16(normalize):
    """K2h's plain version (v_att, alpha; r the kernels' norm) against B5
    interpreted on a float16 grid, and K8h's against B6, both fed K2h's r;
    the planted cell's r is 0 with normalize on (a float32 square would
    not overflow)."""
    v, qh, wv, ws, ds = _grid(1)
    jv, jqh, jwv, jws, jds_ = map(jnp.asarray, (v, qh, wv, ws, ds))
    want = ja._attention_pallas_fwd(jv, jqh, jwv, jws, interpret=True,
                                    normalize=normalize)
    got = ta.attention_fwd_reference(
        *map(torch.from_numpy, (v, qh, wv, ws)), normalize)
    for name, a, b in zip(("v_att", "alpha"), got, want):
        assert _rel(a, b, name) <= TOL_REL, (name, _rel(a, b))
    r = got[2].numpy()
    b, n = PLANTED[:2]
    if normalize:
        assert r[b, n] == 0.0
        assert np.sum(np.square(v[b, n].astype(np.float32))) < np.inf
    want = ja._attention_pallas_bwd(jv, jqh, jwv, jws, jds_, jnp.asarray(r),
                                    interpret=True, normalize=normalize)
    got = ta.attention_bwd_reference(
        *map(torch.from_numpy, (v, qh, wv, ws, ds, r)), normalize)
    for name, a, b in zip(("dqh", "dwv", "dws"), got, want):
        assert _rel(a, b, name) <= TOL_REL, (name, _rel(a, b))


def test_k6h_k7h_plain_versions_match_b7_b8_in_float16():
    """K6h's and K7h's plain versions on float16 U_h against jax.vjp of
    JAX's bigru_fused, whose forward and backward are B7/B8 interpreted."""
    T, B, H = 7, 5, 8
    lens = np.array([7, 1, 4, 0, 3], np.int32)
    rng = np.random.default_rng(2)
    gx = [rng.normal(size=(T, B, 3 * H)).astype(np.float32) for _ in "fb"]
    uh = [(rng.normal(size=(H, 3 * H)) * 0.4).astype(np.float16)
          for _ in "fb"]
    bhn = [(rng.normal(size=(H,)) * 0.2).astype(np.float32) for _ in "fb"]
    ghT = [rng.normal(size=(B, H)).astype(np.float32) for _ in "fb"]
    args = (gx[0], gx[1], uh[0], uh[1], bhn[0], bhn[1])

    def f(gxf, gxb, uhf, uhb, bhnf, bhnb):
        return jg.bigru_fused(gxf, gxb, jnp.asarray(lens), uhf, uhb, bhnf,
                              bhnb, interpret=True)

    (hf, hb), vjp = jax.vjp(f, *map(jnp.asarray, args))
    want = vjp((jnp.asarray(ghT[0]), jnp.asarray(ghT[1])))
    t = [torch.from_numpy(a) for a in args]
    tl = torch.from_numpy(lens)
    got = tg.bigru_reference(t[0], t[1], tl, *t[2:])
    assert _rel(got[0], hf, "hTf") <= TOL_REL
    assert _rel(got[1], hb, "hTb") <= TOL_REL
    grads = tg.bigru_bwd_reference(t[0], t[1], got[2], got[3], tl, *t[2:],
                                   *map(torch.from_numpy, ghT))
    for name, a, b in zip(("dgxf", "dgxb", "duhf", "duhb", "dbhnf",
                           "dbhnb"), grads, want):
        tol = TOL_F16_OUT_REL if b.dtype == jnp.float16 else TOL_REL
        assert _rel(a, b, name) <= tol, (name, _rel(a, b))
    assert want[2].dtype == want[3].dtype == jnp.float16


# The op's float16 backward scales ds so that K8h's float16(dz r) sits in
# float16's normal range. An empty cell has r = 1e6 (rsqrt(0 + 1e-12)), 2^30
# times a long cell's, but it draws little attention, so its |ds| r is
# small: the scale must follow |ds_n| r_n of each cell, not max |ds| times
# max r, which would push every long cell's dz r down to float16's
# subnormals (measured here: dW_v 3.2e-3 off JAX's against 4.1e-4).
# Against JAX's op with its Pallas forward (B5 interpreted, h in f32 as
# K2h keeps it) and its explicit training backward (dz rounded to float16
# ahead of the r of the normalized grid): one float16 rounding apart on
# each term, each gradient to 2^-10 of its largest |value|.
TOL_F16_EMPTY_CELL = 2.0 ** -10


def _grid_with_an_empty_cell(seed=0, B=2, N=20, C=1024, H=16):
    """A sparse post-ReLU float16 grid below 256 (no float16 square
    overflows), its cell (0, 3) all zeros; W_v drawn about a small positive mean so
    that most long cells score above the empty cell, whose h is relu(qh)
    with qh <= 0; a cotangent g of v_att."""
    rng = np.random.default_rng(seed)
    v = np.maximum(rng.normal(size=(B, N, C)), 0.0) * 40.0
    v[0, 3] = 0.0
    qh = -np.abs(rng.normal(size=(B, H)) * 0.1).astype(np.float32)
    wv = (rng.normal(size=(C, H)) * 0.3 + 0.03).astype(np.float16)
    ws = (np.abs(rng.normal(size=(H,))) * 0.5).astype(np.float16).astype(
        np.float32)
    g = rng.normal(size=(B, C)).astype(np.float32)
    return v.astype(np.float16), qh, wv, ws, g


def test_f16_dzr_scale_follows_each_cells_ds_and_r():
    """The scale puts the largest |ds_n ws_j r_n| (and, without r, the
    largest |ds_n ws_j|) at 2^14..2^15, also where the cell with the
    largest r has a small ds."""
    rng = np.random.default_rng(3)
    ds = torch.from_numpy(rng.normal(size=(2, 20)).astype(np.float32)) * 0.05
    r = torch.full((2, 20), 2.0 ** -10)
    ds[0, 3], r[0, 3] = 1e-9, 1e6
    ws = torch.from_numpy(rng.normal(size=(16,)).astype(np.float32))
    for rr in (r, None):
        dzr = ds[:, :, None] * ws * (1.0 if rr is None else rr[:, :, None])
        top = float(dzr.abs().amax() * ta._f16_dzr_scale(ds, ws, rr))
        assert 2.0 ** 14 <= top < 2.0 ** 15, (rr is None, top)


def test_float16_training_op_with_an_empty_cell_matches_jax():
    """spatial_attention's training step on a float16 grid with an empty
    cell (K2h's and K8h's plain versions on the CPU) against JAX's op:
    finite, and dqh, dW_v and dws within TOL_F16_EMPTY_CELL."""
    v, qh, wv, ws, g = _grid_with_an_empty_cell()
    jv = jnp.asarray(v)
    (jv_att, jalpha), vjp = jax.vjp(
        lambda q, w, s: ja.spatial_attention(
            jv, q, w, s, normalize=True, feature_grad=False, interpret=True),
        *map(jnp.asarray, (qh, wv, ws)))
    want = vjp((jnp.asarray(g), jnp.zeros_like(jalpha)))
    assert float(jalpha[0, 3]) == float(jalpha[0].min())  # little attention
    tq, tw, ts = (torch.from_numpy(a).requires_grad_() for a in (qh, wv, ws))
    v_att, _ = ta.spatial_attention(torch.from_numpy(v), tq, tw, ts,
                                    normalize=True, feature_grad=False,
                                    train=True)
    got = torch.autograd.grad(v_att, (tq, tw, ts), torch.from_numpy(g))
    for name, a, b in zip(("dqh", "dwv", "dws"), got, want):
        assert _rel(a, b, name) <= TOL_F16_EMPTY_CELL, (name, _rel(a, b))


# -- training, evaluation and serving against JAX ----------------------------


def _losses(train_dir):
    with open(os.path.join(train_dir, "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    return {r["step"]: r["train/loss"] for r in recs if "train/loss" in r}


def _assert_run_matches(got, want, torch_dir, jax_dir):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].float().numpy(),
                                   want[k].float().numpy(), err_msg=k,
                                   **PARAMS)
    lt, lj = _losses(torch_dir), _losses(jax_dir)
    assert sorted(lt) == sorted(lj) == [2, 4, 6]
    for step in lj:
        np.testing.assert_allclose(lt[step], lj[step], rtol=LOSS_RTOL)


@pytest.mark.parametrize("loop", ["gathered_resident", "streamed_flat"])
def test_float16_gathered_training_matches_jax(loop, tmp_path, monkeypatch):
    """vqa_attention in float16 on gathered grids, fit_resident on the
    store gathered on the device and Trainer.fit on streamed host batches:
    every step hands a float16 grid and W_v to spatial_attention (K2h
    forward, K8h backward on the card), whose plain versions run here; 6
    steps against JAX's."""
    flat = GATHERED if loop == "gathered_resident" else STREAMED
    jcfg = JaxConfig().replace_flat(flat)
    jtr = JaxTrainer(jcfg, jax_build(jcfg), mesh=create_mesh(
        jcfg, devices=jax.devices()[:1]), train_dir=str(tmp_path / "jax"))
    jtrain = jds.load_dataset(jcfg, "train")
    js = jtr.init_state(next(jtrain.batches(1, epochs=1, shuffle=False)))
    init = params_from_flax(jax.device_get(js.params))
    seen = []
    real = tmodel.spatial_attention
    monkeypatch.setattr(tmodel, "spatial_attention",
                        lambda v, qh, wv, ws, **kw: seen.append(
                            (v.dtype, kw["use_kernels"]))
                        or real(v, qh, wv, ws, **kw))
    # The kernels' plain versions get the grid and W_v (rounded by the op)
    # in float16.
    fwd, bwd = [], []
    real_fwd, real_bwd = ta.attention_fwd_reference, ta.attention_bwd_reference
    monkeypatch.setattr(ta, "attention_fwd_reference",
                        lambda v, qh, wv, *a: fwd.append((v.dtype, wv.dtype))
                        or real_fwd(v, qh, wv, *a))
    monkeypatch.setattr(ta, "attention_bwd_reference",
                        lambda v, qh, wv, *a: bwd.append((v.dtype, wv.dtype))
                        or real_bwd(v, qh, wv, *a))
    cfg = Config().replace_flat(flat)
    tr = Trainer(cfg, build_model(cfg), train_dir=str(tmp_path / "torch"),
                 device="cpu")
    s = tr.init_state(init)
    ttrain = tds.load_dataset(cfg, "train")
    if loop == "streamed_flat":
        js = jtr.fit(jtrain.batches(16, seed=cfg.train.seed), js,
                     max_steps=6)
        s = tr.fit(ttrain.batches(16, seed=cfg.train.seed), s, max_steps=6)
    else:
        js = jtr.fit_resident(jtrain, js, max_steps=6)
        s = tr.fit_resident(ttrain, s, max_steps=6)
    want = params_from_flax(jax.device_get(js.params))
    jtr.close()
    tr.close()
    assert s.step == 6
    assert seen == [(torch.float16, True)] * 6
    assert fwd == bwd == [(torch.float16, torch.float16)] * 6
    _assert_run_matches(tr.model.state_dict(), want, tmp_path / "torch",
                        tmp_path / "jax")


def test_float16_stage1_bidirectional_matches_jax(tmp_path, monkeypatch):
    """Stage-1 vlmap_description with the bidirectional phrase encoder in
    float16: every step hands float16 U_h to bigru_fused (K6h forward, K7h
    backward on the card); 6 steps against JAX's, whose BiGRU runs B1/B2
    per direction in float16 (``fuse_directions`` off)."""
    jcfg = JaxConfig().replace_flat(STAGE1)
    spec_j = jax_build(jcfg)
    jtr = JaxTrainer(jcfg, spec_j, mesh=create_mesh(
        jcfg, devices=jax.devices()[:1]), train_dir=str(tmp_path / "jax"))
    jtrain = jds.load_dataset(jcfg, "train", stage=spec_j.stage)
    js = jtr.init_state(next(jtrain.batches(1, epochs=1, shuffle=False)))
    init = params_from_flax(jax.device_get(js.params))
    js = jtr.fit_resident(jtrain, js, max_steps=6)
    want = params_from_flax(jax.device_get(js.params))
    jtr.close()
    seen = []
    real = tg.bigru_fused
    monkeypatch.setattr(tg, "bigru_fused",
                        lambda gxf, gxb, lens, uhf, uhb, *a, **kw:
                        seen.append((gxf.dtype, uhf.dtype, uhb.dtype))
                        or real(gxf, gxb, lens, uhf, uhb, *a, **kw))
    cfg = Config().replace_flat(STAGE1)
    spec = build_model(cfg)
    tr = Trainer(cfg, spec, train_dir=str(tmp_path / "torch"), device="cpu")
    assert tr.model.dtype == torch.float16
    s = tr.fit_resident(tds.load_dataset(cfg, "train", stage=spec.stage),
                        tr.init_state(init), max_steps=6)
    tr.close()
    assert s.step == 6
    assert seen == [(torch.float32, torch.float16, torch.float16)] * 6
    _assert_run_matches(spec.module.state_dict(), want, tmp_path / "torch",
                        tmp_path / "jax")


def test_float16_gathered_evaluation_matches_jax(tmp_path, monkeypatch):
    """The gathered resident evaluator (a float16 grid through the
    gathered attention: K2h on the card) over a 100-question split in
    batches of 16 against JAX's from the same parameters: equal
    predictions, metrics within 2^-8."""
    over = dict(GATHERED, **{"data.synthetic_size": 100})
    jcfg = JaxConfig().replace_flat(over)
    jtr = JaxTrainer(jcfg, jax_build(jcfg), mesh=create_mesh(
        jcfg, devices=jax.devices()[:1]), train_dir=str(tmp_path / "jax"))
    jval = jds.load_dataset(jcfg, "val")
    js = jtr.init_state(next(jval.batches(1, epochs=1, shuffle=False)))
    cfg = Config().replace_flat(over)
    tr = Trainer(cfg, build_model(cfg), train_dir=str(tmp_path / "torch"),
                 device="cpu")
    state = tr.init_state(params_from_flax(jax.device_get(js.params)))
    seen = []
    real = tmodel.spatial_attention
    monkeypatch.setattr(tmodel, "spatial_attention",
                        lambda v, *a, **kw: seen.append(v.dtype)
                        or real(v, *a, **kw))
    jm, jp = jev.evaluate_split(jtr, js, jval)
    tm, tp = tev.evaluate_split(tr, state, tds.load_dataset(cfg, "val"))
    jtr.close()
    tr.close()
    assert seen and set(seen) == {torch.float16}
    assert tp.shape == (100,)
    np.testing.assert_array_equal(tp, jp)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], err_msg=k, rtol=0,
                                   atol=TOL_MODEL_REL * max(abs(jm[k]), 1))


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A tiny float16 vqa_attention run trained by JAX's cli.train, its
    params_final also saved in the port's format."""
    d = jax_train_cli.main(CLI_TINY + [
        "--model.model", "vqa_attention", "--model.dtype", "float16",
        "--train.train_dir", str(tmp_path_factory.mktemp("jax") / "run")])
    restored = jax_load_params(os.path.join(d, "params_final"))
    tree = restored["params"] if "params" in restored else restored
    save_params(os.path.join(d, PARAMS_FILE), params_from_flax(tree))
    return d


@pytest.mark.parametrize("batch", [8, 4])
def test_float16_predictor_matches_jax(run_dir, batch, monkeypatch):
    """The float16 Predictor (host features; the gathered attention with
    use_pallas on: K2h on the card) against JAX's on the same run: equal
    answers over 6 questions at batch 8 and 4 (a padded tail), and the
    model's logits within 2^-8 of their largest |value| of JAX's on the
    same ids and features."""
    rng = np.random.default_rng(7)
    feats = np.abs(rng.normal(size=(6, 2 * 2, 16))).astype(np.float32)
    questions = ["w5 w6 w7", "w8", "w9 w10", "w11 w12 w13", "w14", "w6"]
    jpred = JaxPredictor(run_dir, batch_size=batch)
    pred = Predictor(run_dir, batch_size=batch, device="cpu")
    assert pred.model.dtype == torch.float16 and pred.model.use_pallas
    seen = []
    real = tmodel.spatial_attention
    monkeypatch.setattr(tmodel, "spatial_attention",
                        lambda v, *a, **kw: seen.append(v.dtype)
                        or real(v, *a, **kw))
    assert pred.answer(feats, questions) == jpred.answer(feats, questions)
    assert seen and set(seen) == {torch.float16}
    q = pred._encode_questions(questions)
    want = jpred.spec.module.apply(
        {"params": jpred.params, **jpred._extra}, jnp.asarray(feats),
        jnp.asarray(q), train=False)["logits"]
    with torch.inference_mode():
        got = pred.model(torch.from_numpy(feats),
                         torch.from_numpy(q))["logits"]
    assert _rel(got.float(), want, "logits") <= TOL_MODEL_REL


@pytest.mark.parametrize("name", ["attention_fwd", "attention_bwd",
                                  "bigru_fwd", "bigru_bwd"])
def test_float16_kernel_sources(name):
    """K2h, K8h, K6h and K7h build their bf16 twin's source with float16 as
    its element type: each library's sources are its own file, the twin's
    and every header the twin includes, so an edit to any of them rebuilds
    both; the new file holds no kernel of its own."""
    twin = [p.name for p in kernels.sources(name)]
    assert [p.name for p in kernels.sources(f"{name}_f16")] == [
        f"{name}_f16.cu", *twin]
    assert "elem16.cuh" in twin
    text = (kernels.CSRC / f"{name}_f16.cu").read_text()
    assert "#define KERNEL_ELEM_F16" in text
    assert f'#include "{name}.cu"' in text
    assert "__global__" not in text and 'extern "C"' not in text
    assert kernels.name16(name, torch.float16) == f"{name}_f16"
    assert kernels.name16(name, torch.bfloat16) == name


def test_kernel_bits_fingerprints_and_compare():
    """tools/kernel_bits.py, which holds the bf16 libraries of two
    checkouts bit for bit against each other on the card: a fingerprint
    is of the bytes (two tensors differing in one last bit differ, a copy
    does not), and the comparison names each output that differs or that
    one side lacks."""
    from vqa_transfer_externaldata_torch.tools import kernel_bits

    x = torch.linspace(-1, 1, 97).to(torch.bfloat16)
    y = x.clone()
    y.view(torch.int16)[5] += 1
    assert kernel_bits._digest(x) == kernel_bits._digest(x.clone())
    assert kernel_bits._digest(x) != kernel_bits._digest(y)
    a = {"K2": {"v_att": "1", "alpha": "2"}, "K8": {"dwv": "3"}}
    b = {"K2": {"v_att": "1", "alpha": "9"}, "K6": {"hTf": "4"}}
    assert kernel_bits.compare(a, a) == []
    assert kernel_bits.compare(a, b) == [("K2", "alpha"), ("K6", "hTf"),
                                         ("K8", "dwv")]
