"""Port parity: the float32 paths that run the gathered attention (K2f/K8f
on the card) and the bidirectional GRU (K6f/K7f) against the JAX package
on the CPU, whose Pallas bodies B5/B6 and B7/B8 run in interpret mode in
float32 (or its XLA paths where JAX takes them).

* Six ``fit_resident`` steps of ``vqa_attention`` in float32 on the
  gathered store (``train.resident_fused_attention`` false) and of stage-1
  ``vlmap_description`` with the bidirectional phrase encoder, from JAX's
  bridged parameters, against JAX's Trainer: params rtol 2e-4 / atol 2e-5,
  losses rtol 1e-5 (the bound of ``tests/test_torch_trainer.py`` for two
  implementations of a step; the gathered run takes Adam's epsilon at
  1e-3 on both sides, as that file's gathered test reasons). A spy shows
  that each path hands float32 tensors to ``spatial_attention`` /
  ``bigru_fused``, which pick K2f/K8f and K6f/K7f on the card.
* The float32 ``Predictor`` against JAX's on a run JAX trained: equal
  answers and logits within 1e-5 (the same f32 forward, sums in another
  order); the gathered evaluator's predictions against JAX's.
* The plain versions of K2f, K8f, K6f and K7f in float32 against the
  Pallas bodies B5, B6, B7 and B8 interpreted in float32: 1e-5 on the
  forwards, 1e-4 on the backwards (``tests/test_torch_attention_train.py``
  and ``tests/test_torch_bigru.py`` reason both).
* What the CPU can check of the wrappers: the float32 ones refuse CPU
  tensors, every wrapper takes float16 as far as its device check and
  refuses float64 naming the three dtypes that have kernels, and the new
  libraries' sources.
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
from vqa_transfer_externaldata_torch.ops import attention_resident as tar
from vqa_transfer_externaldata_torch.ops import gru as tg
from vqa_transfer_externaldata_torch.ops import kernels
from vqa_transfer_externaldata_torch.parallel import evaler as tev
from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
from vqa_transfer_externaldata_torch.serving import PARAMS_FILE, Predictor
from vqa_transfer_externaldata_torch.utils.checkpoint import save_params
from vqa_transfer_externaldata_torch.utils.convert import params_from_flax

torch.set_num_threads(2)  # xdist runs several workers on the same cores

F32 = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
PARAMS = dict(rtol=2e-4, atol=2e-5)

GATHERED = {
    "data.synthetic": True, "data.synthetic_layout": "joined",
    "data.synthetic_size": 128, "data.vocab_size": 64,
    "data.num_answers": 16, "data.grid_h": 3, "data.grid_w": 3,
    "data.feature_dim": 16, "data.pool5_dim": 16,
    "data.max_question_len": 6, "model.word_dim": 8, "model.rnn_dim": 8,
    "model.fusion_dim": 16, "model.att_hidden": 8, "model.answer_dim": 8,
    "model.dtype": "float32", "model.dropout": 0.0,
    "train.batch_size": 16, "train.device_data_cache": True,
    "train.resident_fused_attention": False, "train.adam_eps": 1e-3,
    "train.log_every": 2, "train.warmup_steps": 2,
    "train.learning_rate": 3e-3,
}
STAGE1 = {
    "model.model": "vlmap_description", "model.bidirectional_desc": True,
    "data.synthetic": True, "data.synthetic_size": 96,
    "data.vocab_size": 64, "data.pool5_dim": 16,
    "data.max_question_len": 6, "model.word_dim": 8, "model.rnn_dim": 8,
    "model.dtype": "float32", "model.dropout": 0.0, "model.num_tasks": 4,
    "model.task_dim": 8, "model.num_candidates": 12,
    "train.batch_size": 16, "train.device_data_cache": True,
    "train.log_every": 2, "train.warmup_steps": 2,
    "train.learning_rate": 3e-3,
}


def _losses(train_dir):
    with open(os.path.join(train_dir, "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    return {r["step"]: r["train/loss"] for r in recs if "train/loss" in r}


def _jax_fit(flat, train_dir):
    """JAX fit_resident, 6 steps from its own init: the bridged initial and
    final parameters."""
    jcfg = JaxConfig().replace_flat(flat)
    spec = jax_build(jcfg)
    jtr = JaxTrainer(jcfg, spec, mesh=create_mesh(
        jcfg, devices=jax.devices()[:1]), train_dir=str(train_dir))
    ds = jds.load_dataset(jcfg, "train", stage=spec.stage)
    js = jtr.init_state(next(ds.batches(1, epochs=1, shuffle=False)))
    init = params_from_flax(jax.device_get(js.params))
    js = jtr.fit_resident(ds, js, max_steps=6)
    final = params_from_flax(jax.device_get(js.params))
    jtr.close()
    return init, final


def _assert_run_matches(got, want, torch_dir, jax_dir):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **PARAMS)
    lt, lj = _losses(torch_dir), _losses(jax_dir)
    assert sorted(lt) == sorted(lj) == [2, 4, 6]
    for step in lj:
        np.testing.assert_allclose(lt[step], lj[step], rtol=1e-5)


def test_float32_gathered_fit_resident_matches_jax(tmp_path, monkeypatch):
    """vqa_attention in float32 on the gathered store: every step hands a
    float32 grid and W_v to spatial_attention (K2f forward, K8f backward
    on the card), whose plain versions run here; 6 steps against JAX's."""
    init, want = _jax_fit(GATHERED, tmp_path / "jax")
    seen = []
    real = tmodel.spatial_attention
    monkeypatch.setattr(tmodel, "spatial_attention",
                        lambda v, qh, wv, ws, **kw: seen.append(
                            (v.dtype, wv.dtype, kw["use_kernels"]))
                        or real(v, qh, wv, ws, **kw))
    fwd, bwd = [], []
    real_fwd, real_bwd = ta.attention_fwd_reference, ta.attention_bwd_reference
    monkeypatch.setattr(ta, "attention_fwd_reference",
                        lambda v, *a: fwd.append(v.dtype) or real_fwd(v, *a))
    monkeypatch.setattr(ta, "attention_bwd_reference",
                        lambda v, *a: bwd.append(v.dtype) or real_bwd(v, *a))
    cfg = Config().replace_flat(GATHERED)
    tr = Trainer(cfg, build_model(cfg), train_dir=str(tmp_path / "torch"),
                 device="cpu")
    s = tr.fit_resident(tds.load_dataset(cfg, "train"), tr.init_state(init),
                        max_steps=6)
    tr.close()
    assert s.step == 6
    assert seen == [(torch.float32, torch.float32, True)] * 6
    assert fwd == bwd == [torch.float32] * 6
    _assert_run_matches(tr.model.state_dict(), want, tmp_path / "torch",
                        tmp_path / "jax")


def test_float32_streamed_first_step_matches_jax(tmp_path, monkeypatch):
    """``Trainer.fit`` on streamed host batches of the flat layout in
    float32: the uploader stages every grid in float32 (the compute dtype,
    not bf16), spatial_attention gets a float32 grid and W_v (K2f and K8f
    on the card, their plain versions here), and the first step's loss and
    parameters equal JAX's streamed step from the same bridged
    parameters (losses rtol 1e-5, parameters as PARAMS)."""
    from vqa_transfer_externaldata_torch.parallel import trainer as ttr

    flat = dict(GATHERED, **{"data.synthetic_layout": "flat",
                             "train.device_data_cache": False,
                             "train.log_every": 1})
    jcfg = JaxConfig().replace_flat(flat)
    jtr = JaxTrainer(jcfg, jax_build(jcfg), mesh=create_mesh(
        jcfg, devices=jax.devices()[:1]), train_dir=str(tmp_path / "jax"))
    jtrain = jds.load_dataset(jcfg, "train")
    js = jtr.init_state(next(jtrain.batches(1, epochs=1, shuffle=False)))
    init = params_from_flax(jax.device_get(js.params))
    js = jtr.fit(jtrain.batches(16, seed=jcfg.train.seed), js, max_steps=1)
    want = params_from_flax(jax.device_get(js.params))
    jtr.close()
    staged, seen = [], []
    real_host = ttr._host_tensor
    monkeypatch.setattr(ttr, "_host_tensor", lambda k, v, dt: (
        lambda out: staged.append((k, out[1])) or out)(real_host(k, v, dt)))
    real = tmodel.spatial_attention
    monkeypatch.setattr(tmodel, "spatial_attention",
                        lambda v, qh, wv, ws, **kw: seen.append(
                            (v.dtype, wv.dtype)) or real(v, qh, wv, ws, **kw))
    cfg = Config().replace_flat(flat)
    tr = Trainer(cfg, build_model(cfg), train_dir=str(tmp_path / "torch"),
                 device="cpu")
    s = tr.fit(tds.load_dataset(cfg, "train").batches(16, seed=cfg.train.seed),
               tr.init_state(init), max_steps=1)
    tr.close()
    assert s.step == 1
    assert ("features", torch.float32) in staged
    assert all(dt == torch.float32 for k, dt in staged if k == "features")
    assert seen == [(torch.float32, torch.float32)]
    got = tr.model.state_dict()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **PARAMS)
    lt, lj = _losses(tmp_path / "torch"), _losses(tmp_path / "jax")
    assert sorted(lt) == sorted(lj) == [1]
    np.testing.assert_allclose(lt[1], lj[1], rtol=1e-5)


def test_float32_stage1_bidirectional_matches_jax(tmp_path, monkeypatch):
    """Stage-1 vlmap_description with the bidirectional phrase encoder in
    float32: every step hands float32 U_h to bigru_fused (K6f forward, K7f
    backward on the card); 6 steps against JAX's, whose BiGRU runs B1/B2
    per direction (``fuse_directions`` off)."""
    init, want = _jax_fit(STAGE1, tmp_path / "jax")
    seen = []
    real = tg.bigru_fused
    monkeypatch.setattr(tg, "bigru_fused",
                        lambda gxf, gxb, lens, uhf, uhb, *a, **kw:
                        seen.append((gxf.dtype, uhf.dtype, uhb.dtype))
                        or real(gxf, gxb, lens, uhf, uhb, *a, **kw))
    cfg = Config().replace_flat(STAGE1)
    spec = build_model(cfg)
    tr = Trainer(cfg, spec, train_dir=str(tmp_path / "torch"), device="cpu")
    s = tr.fit_resident(tds.load_dataset(cfg, "train", stage=spec.stage),
                        tr.init_state(init), max_steps=6)
    tr.close()
    assert s.step == 6
    assert seen == [(torch.float32,) * 3] * 6
    _assert_run_matches(spec.module.state_dict(), want, tmp_path / "torch",
                        tmp_path / "jax")


def test_float32_gathered_evaluation_matches_jax(tmp_path):
    """The gathered resident evaluator (a float32 grid through the
    gathered attention: K2f on the card) over a 100-question split in
    batches of 16 against JAX's from the same parameters: equal
    predictions, metrics within 1e-5."""
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
    jm, jp = jev.evaluate_split(jtr, js, jval)
    tm, tp = tev.evaluate_split(tr, state, tds.load_dataset(cfg, "val"))
    jtr.close()
    tr.close()
    assert tp.shape == (100,)
    np.testing.assert_array_equal(tp, jp)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], err_msg=k, **F32)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A tiny float32 vqa_attention run trained by JAX's cli.train, its
    params_final also saved in the port's format."""
    d = jax_train_cli.main(CLI_TINY + [
        "--model.model", "vqa_attention",
        "--train.train_dir", str(tmp_path_factory.mktemp("jax") / "run")])
    restored = jax_load_params(os.path.join(d, "params_final"))
    tree = restored["params"] if "params" in restored else restored
    save_params(os.path.join(d, PARAMS_FILE), params_from_flax(tree))
    return d


@pytest.mark.parametrize("batch", [8, 4])
def test_float32_predictor_matches_jax(run_dir, batch, monkeypatch):
    """The float32 Predictor (host features; the gathered attention with
    use_pallas on: K2f on the card) against JAX's on the same run: equal
    answers over 6 questions at batch 8 and 4 (a padded tail), and the
    model's logits within 1e-5 of JAX's on the same ids and features."""
    rng = np.random.default_rng(7)
    cells = 2 * 2
    feats = rng.normal(size=(6, cells, 16)).astype(np.float32)
    questions = ["w5 w6 w7", "w8", "w9 w10", "w11 w12 w13", "w14", "w6"]
    jpred = JaxPredictor(run_dir, batch_size=batch)
    pred = Predictor(run_dir, batch_size=batch, device="cpu")
    assert pred.model.dtype == torch.float32 and pred.model.use_pallas
    seen = []
    real = tmodel.spatial_attention
    monkeypatch.setattr(tmodel, "spatial_attention",
                        lambda v, *a, **kw: seen.append(v.dtype)
                        or real(v, *a, **kw))
    assert pred.answer(feats, questions) == jpred.answer(feats, questions)
    assert seen and set(seen) == {torch.float32}
    q = pred._encode_questions(questions)
    want = jpred.spec.module.apply(
        {"params": jpred.params, **jpred._extra}, jnp.asarray(feats),
        jnp.asarray(q), train=False)["logits"]
    with torch.inference_mode():
        got = pred.model(torch.from_numpy(feats),
                         torch.from_numpy(q))["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _grid(seed, B=3, N=20, C=32, H=16):
    rng = np.random.default_rng(seed)
    v = np.abs(rng.normal(size=(B, N, C))).astype(np.float32)
    qh = rng.normal(size=(B, H)).astype(np.float32)
    wv = (rng.normal(size=(C, H)) * 0.3).astype(np.float32)
    ws = rng.normal(size=(H,)).astype(np.float32)
    ds = rng.normal(size=(B, N)).astype(np.float32)
    return v, qh, wv, ws, ds


@pytest.mark.parametrize("normalize", [True, False])
def test_k2f_k8f_plain_versions_match_b5_b6_in_float32(normalize):
    """K2f's plain version (v_att, alpha; r the kernels' norm) against B5
    interpreted in float32, and K8f's against B6, both fed K2f's r."""
    v, qh, wv, ws, ds = _grid(1)
    jv, jqh, jwv, jws, jds_ = map(jnp.asarray, (v, qh, wv, ws, ds))
    want = ja._attention_pallas_fwd(jv, jqh, jwv, jws, interpret=True,
                                    normalize=normalize)
    got = ta.attention_fwd_reference(
        *map(torch.from_numpy, (v, qh, wv, ws)), normalize)
    for name, a, b in zip(("v_att", "alpha"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **F32)
    r = got[2].numpy()
    want = ja._attention_pallas_bwd(jv, jqh, jwv, jws, jds_, jnp.asarray(r),
                                    interpret=True, normalize=normalize)
    got = ta.attention_bwd_reference(
        *map(torch.from_numpy, (v, qh, wv, ws, ds, r)), normalize)
    for name, a, b in zip(("dqh", "dwv", "dws"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **GRAD)


def test_k6f_k7f_plain_versions_match_b7_b8_in_float32():
    """K6f's and K7f's plain versions on float32 U_h against jax.vjp of
    JAX's bigru_fused, whose forward and backward are B7/B8 interpreted."""
    T, B, H = 7, 5, 8
    lens = np.array([7, 1, 4, 0, 3], np.int32)
    rng = np.random.default_rng(2)
    gx = [rng.normal(size=(T, B, 3 * H)).astype(np.float32) for _ in "fb"]
    uh = [(rng.normal(size=(H, 3 * H)) * 0.4).astype(np.float32)
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
    np.testing.assert_allclose(got[0].numpy(), np.asarray(hf), **F32)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(hb), **F32)
    grads = tg.bigru_bwd_reference(t[0], t[1], got[2], got[3], tl, *t[2:],
                                   *map(torch.from_numpy, ghT))
    for name, a, b in zip(("dgxf", "dgxb", "duhf", "duhb", "dbhnf",
                           "dbhnb"), grads, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **GRAD)


def test_float32_wrappers_refuse_cpu_tensors():
    """K2f, K8f, K6f and K7f launch on CUDA tensors or raise, directly and
    through the dispatch of their bf16 counterparts; the CPU paths go
    through the plain versions, never through them."""
    v, qh, wv, ws, ds = map(torch.from_numpy, _grid(3))
    r = torch.ones(ds.shape)
    counts = [ta.attention_fwd_f32.launches, ta.attention_bwd_f32.launches,
              tg.bigru_fwd_f32.launches, tg.bigru_bwd_f32.launches]
    for fn in (ta.attention_fwd_f32, ta.attention_fwd):
        with pytest.raises(ValueError, match="CUDA"):
            fn(v, qh, wv, ws, normalize=True)
    for fn in (ta.attention_bwd_f32, ta.attention_bwd):
        with pytest.raises(ValueError, match="CUDA"):
            fn(v, qh, wv, ws, ds, r, True)
    gx = torch.zeros(3, 4, 48)
    lens = torch.tensor([3, 0, 1, 2], dtype=torch.int32)
    uh, bhn, hs = torch.zeros(16, 48), torch.zeros(16), torch.zeros(3, 4, 16)
    ghT = torch.zeros(4, 16)
    for fn in (tg.bigru_fwd_f32, tg.bigru_fwd):
        with pytest.raises(ValueError, match="CUDA"):
            fn(gx, gx, lens, uh, uh, bhn, bhn)
    for fn in (tg.bigru_bwd_f32, tg.bigru_bwd):
        with pytest.raises(ValueError, match="CUDA"):
            fn(gx, gx, hs, hs, lens, uh, uh, bhn, bhn, ghT, ghT)
    assert counts == [ta.attention_fwd_f32.launches,
                      ta.attention_bwd_f32.launches,
                      tg.bigru_fwd_f32.launches, tg.bigru_bwd_f32.launches]


def _wrapper_calls(dt):
    """Each kernel wrapper called with its dtype-picking tensor in ``dt``
    (CPU tensors: the dtype is checked first)."""
    v, qh, wv, ws, ds = map(torch.from_numpy, _grid(4))
    r = torch.ones(ds.shape)
    gx, lens = torch.zeros(3, 4, 48), torch.tensor([3, 0, 1, 2],
                                                   dtype=torch.int32)
    uh, bhn, hs = torch.zeros(16, 48), torch.zeros(16), torch.zeros(3, 4, 16)
    ghT = torch.zeros(4, 16)
    store = torch.zeros(2, 8, 32, dtype=torch.bfloat16)
    rows = torch.zeros(3, dtype=torch.int32)
    al = torch.zeros(3, 8)
    return {
        "attention_fwd": lambda: ta.attention_fwd(
            v.to(dt), qh, wv.to(dt), ws, normalize=True),
        "attention_bwd": lambda: ta.attention_bwd(
            v.to(dt), qh, wv.to(dt), ws, ds, r, True),
        "gru_fwd": lambda: tg.gru_fwd(gx, lens, uh.to(dt), bhn),
        "gru_bwd": lambda: tg.gru_bwd(gx, hs, lens, uh.to(dt), bhn, ghT),
        "bigru_fwd": lambda: tg.bigru_fwd(gx, gx, lens, uh.to(dt),
                                          uh.to(dt), bhn, bhn),
        "bigru_bwd": lambda: tg.bigru_bwd(gx, gx, hs, hs, lens, uh.to(dt),
                                          uh.to(dt), bhn, bhn, ghT, ghT),
        "attention_resident_fwd": lambda: tar.attention_resident_fwd(
            store, rows, qh, wv.to(dt), ws, n_valid=8, normalize=False),
        "attention_resident_bwd": lambda: tar.attention_resident_bwd(
            store, rows, torch.zeros(3, 8, 16, dtype=dt), ws, al,
            torch.zeros(3, 32), al, n_valid=8, normalize=False),
    }


@pytest.mark.parametrize("wrapper", ["attention_fwd", "attention_bwd",
                                     "gru_fwd", "gru_bwd", "bigru_fwd",
                                     "bigru_bwd", "attention_resident_fwd",
                                     "attention_resident_bwd"])
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_wrappers_refuse_other_dtypes_naming_the_float16_item(wrapper,
                                                              dtype):
    """Every kernel wrapper takes bf16 (K1-K8), float16 (K1h-K8h) and
    float32 (K1f-K8f): a float16 tensor gets past the dtype to the device
    check, and on the CPU, where the ops run the plain versions, the
    wrapper refuses it with ValueError naming CUDA. A float64 one raises
    TypeError naming the three dtypes that have kernels, before anything
    is launched."""
    if dtype == torch.float16:
        with pytest.raises(ValueError, match="CUDA"):
            _wrapper_calls(dtype)[wrapper]()
        return
    with pytest.raises(TypeError, match="torch.bfloat16, torch.float16, "
                       "torch.float32"):
        _wrapper_calls(dtype)[wrapper]()


@pytest.mark.parametrize("name,headers", [
    ("attention_fwd_f32", ["attention_f32.cuh", "fp32_ring.cuh",
                           "store_rows_f32.cuh"]),
    ("attention_resident_fwd_f32", ["attention_f32.cuh", "fp32_ring.cuh",
                                    "store_rows_f32.cuh"]),
    ("attention_bwd_f32", ["fp32_ring.cuh", "store_rows_f32.cuh"]),
    ("bigru_fwd_f32", ["gru_seq_f32.cuh", "fp32_ring.cuh", "gru_step_f32.cuh",
                       "store_rows_f32.cuh", "fp32_tile.cuh"]),
    ("bigru_bwd_f32", ["gru_seq_f32.cuh", "gru_bptt_f32.cuh", "fp32_ring.cuh",
                       "gru_step_f32.cuh", "store_rows_f32.cuh",
                       "fp32_tile.cuh"]),
    ("gru_fwd_f32", ["gru_seq_f32.cuh", "fp32_ring.cuh", "gru_step_f32.cuh",
                     "store_rows_f32.cuh", "fp32_tile.cuh"]),
    ("attention_resident_bwd_f32", ["fp32_ring.cuh", "store_rows_f32.cuh"]),
])
def test_float32_kernel_sources(name, headers):
    """K2f runs K4f's launches (attention_f32.cuh) over a dense row source;
    the attention products (K2f, K4f, K5f, K8f) run fp32_ring.cuh's tile
    loop, the GRU's forward step form fp32_tile.cuh's; K1f's persistent
    kernel (gru_seq_f32.cuh) holds its U_h slice beside a cp.async ring of
    fp32_ring.cuh's copies; K6f and K7f run K1f's and K3f's persistent
    kernels (gru_seq_f32.cuh) and their step forms (gru_step_f32.cuh
    forward, gru_bptt_f32.cuh for the BPTT), so each library hashes the
    headers it shares."""
    assert [p.name for p in kernels.sources(name)] == [f"{name}.cu",
                                                       *headers]
