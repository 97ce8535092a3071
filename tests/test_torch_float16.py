"""Port parity: ``model.dtype float16`` on the main path against the JAX
package on the CPU, whose Pallas bodies B1-B4 run in interpret mode with
float16 operands (the JAX package runs every one of them in float16).

Tolerances. float16 keeps 11 significant bits, so one rounding moves a
value by at most 2^-11 of itself. Both sides round at the same places (the
state ahead of U_h, the gate cotangents, the store, the squares of the
norm, each glimpse's alpha * r, the saved h, the v_att cotangent and
dz * r), and their f32 sums run in another order: where two f32 results
differ in their last bits, a float16 rounding of them can land on the
neighbouring value, and what follows carries that 2^-11 step of one term.
A rounding to another type (bf16: 2^-8) or none at all moves many terms
at once.

* The GRU encoder: h (|h| < 1) to 5e-4 absolute, a flipped rounding of
  the state moving one product of a step by 2^-11 of itself, and each
  gradient to 2^-11 of its largest |value|: the BPTT rounds the gate
  cotangents to float16 as well, and a flip there moves one term of a sum.
* The resident op: v_att and alpha to 2^-11 of their largest |value|;
  dqh, dW_v and dws, whose sums add the G glimpses' terms after their
  float16 roundings, to G times that.
* One case of each scales the cotangent to float16's smallest subnormal
  (2^-24): JAX's ``astype(float16)`` and the port's rounding flush the
  entries below half of it to zero and keep the others as subnormals, so
  the gradients (sums over those entries) agree to the limits above; the
  GRU's BPTT with the cotangents kept in f32 is off by half its largest
  value.
* Six ``fit_resident`` steps (vqa_attention on the float16 store, then on
  the int8 store whose codes are widened to float16) from the same bridged
  parameters: ``test_torch_trainer.py`` holds the float32 runs to params
  rtol 2e-4 / atol 2e-5 and losses rtol 1e-5; in float16 the same f32
  summation-order noise flips float16 roundings of activations (2^-11 of
  a value), and Adam, which divides by sqrt(nu), turns a gradient entry
  near zero into an update difference up to the learning rate (3e-3). The
  parameters are held to rtol 2e-4 / atol 1e-3 (a third of one step's
  largest update) and the logged losses to rtol 2^-10 (two float16 steps
  of the loss); bf16 runs of the same steps differ from JAX's by 3 to 5
  times these limits.
* The f32-source store: a float16 model with a float32 grid uploads the
  float16 store that JAX's ``_prepare_resident`` builds (the grid rounded
  to float16 on the host, then normalized), bit for bit, and hands it to
  the op without a per-call copy.
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
from vqa_transfer_externaldata_tpu.models.zoo import build_model as jax_build
from vqa_transfer_externaldata_tpu.ops import attention_resident as jar
from vqa_transfer_externaldata_tpu.ops import gru as jgru
from vqa_transfer_externaldata_tpu.parallel.mesh import create_mesh
from vqa_transfer_externaldata_tpu.parallel.trainer import Trainer as JaxTrainer
from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.data import datasets as tds
from vqa_transfer_externaldata_torch.models import vqa_attention as tmodel
from vqa_transfer_externaldata_torch.models.zoo import build_model
from vqa_transfer_externaldata_torch.ops import attention_resident as tar
from vqa_transfer_externaldata_torch.ops import gru as tgru
from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
from vqa_transfer_externaldata_torch.utils.convert import params_from_flax

torch.set_num_threads(2)  # xdist runs several workers on the same cores

T, B, D, H = 7, 5, 6, 8
LENS = np.array([7, 1, 4, 0, 3])  # ragged, one empty row
M, N, C, HA, BA = 6, 13, 32, 16, 8  # the resident op: Np = 16 > N
TOL_H = 5e-4
TOL_GRU_GRAD_REL = 2.0 ** -11
TOL_OP_REL = 2.0 ** -11
SUBNORMAL = 2.0 ** -24  # float16's smallest subnormal


def _rel(got, want, what=""):
    """The largest error of ``got`` relative to ``want``'s largest
    |value|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# -- the GRU encoder (B1/B2 against K1h/K3h's plain versions) ---------------


def _gru_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, B, D)).astype(np.float32)
    mask = (np.arange(T)[None, :] < LENS[:, None]).astype(np.float32)
    params = {
        "wx": rng.normal(size=(D, 3 * H)).astype(np.float32) * 0.4,
        "uh": rng.normal(size=(H, 3 * H)).astype(np.float32) * 0.4,
        "b": rng.normal(size=(3 * H,)).astype(np.float32) * 0.2,
        "bhn": rng.normal(size=(H,)).astype(np.float32) * 0.2,
    }
    w = rng.normal(size=(B, H)).astype(np.float32)
    return x, mask, params, w


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_encoder_float16_matches_jax(reverse):
    """GRUEncoder in float16 (U_h and the state's copy in float16, as K1h
    and K3h take them) against JAX's, whose recurrence and BPTT are B1 and
    B2 in interpret mode with a float16 U_h: the final state, then the
    gradients of every parameter and of x."""
    x, mask, params, w = _gru_inputs(0)
    jm = jgru.GRUEncoder(H, jnp.float16, use_pallas=True, time_major=True,
                         reverse=reverse)

    def loss(p, xx):
        return jnp.sum(jm.apply({"params": p}, xx, jnp.asarray(mask))
                       .astype(jnp.float32) * w)

    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    enc = tgru.GRUEncoder(D, H, dtype=torch.float16, reverse=reverse)
    enc.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    xt = torch.from_numpy(x).requires_grad_()
    got = enc(xt, torch.from_numpy(mask))
    assert got.dtype == torch.float16 and want.dtype == jnp.float16
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32), atol=TOL_H,
                               rtol=0)
    (got.float() * torch.from_numpy(w)).sum().backward()
    assert _rel(xt.grad, gx, "x") <= TOL_GRU_GRAD_REL
    for k, p in enc.named_parameters():
        assert _rel(p.grad, gp[k], k) <= TOL_GRU_GRAD_REL, k


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_bwd_flushes_float16_subnormal_cotangents_as_jax(reverse):
    """The BPTT with a final-state cotangent small enough that the gate
    cotangents staged in float16 fall below its smallest subnormal: the
    plain version of K3h against B2 (interpreted, float16 U_h) rounds them
    to 0 at the same entries, so dU_h agrees; the f32 values, kept, would
    not."""
    rng = np.random.default_rng(4)
    gx = rng.normal(size=(T, B, 3 * H)).astype(np.float32)
    uh = (rng.normal(size=(H, 3 * H)) * 0.4).astype(np.float32)
    bhn = (rng.normal(size=(H,)) * 0.2).astype(np.float32)
    ghT = (rng.normal(size=(B, H)) * SUBNORMAL).astype(np.float32)
    lens = LENS.astype(np.int32)
    uh16 = jnp.asarray(uh).astype(jnp.float16)
    _, hseq = jgru._gru_pallas_fwd_call(jnp.asarray(gx), jnp.asarray(lens),
                                        uh16, jnp.asarray(bhn),
                                        interpret=True, reverse=reverse)
    want = jgru._gru_pallas_bwd_call(jnp.asarray(gx), hseq,
                                     jnp.asarray(lens), uh16,
                                     jnp.asarray(bhn), jnp.asarray(ghT),
                                     interpret=True, reverse=reverse)
    args = (torch.from_numpy(gx), torch.from_numpy(np.array(hseq)),
            torch.from_numpy(lens))
    got = tgru.gru_bwd_reference(*args, torch.from_numpy(uh).half(),
                                 torch.from_numpy(bhn), torch.from_numpy(ghT),
                                 reverse=reverse)
    # The case is the one it claims: gate cotangents (dgx holds them in
    # f32) both flushed to 0 and subnormal in float16.
    g = got[0].numpy()
    flushed = (g != 0) & (np.abs(g) < SUBNORMAL / 2)
    assert flushed.any() and ((np.abs(g) >= SUBNORMAL / 2)
                              & (np.abs(g) < 2.0 ** -14)).any()
    for name, t, w in zip(("dgx", "duh", "dbhn"), got, want):
        assert _rel(t, w, name) <= TOL_GRU_GRAD_REL, name
    kept = tgru.gru_bwd_reference(*args, torch.from_numpy(uh),
                                  torch.from_numpy(bhn),
                                  torch.from_numpy(ghT), reverse=reverse)
    assert _rel(kept[1], want[1]) > 2.0 ** -2


# -- the resident op (B3/B4 against K4h/K5h's plain versions) ---------------


def _op_inputs(glimpses, seed, rows_dtype):
    """A post-ReLU grid with cells of different norms as float16 rows, or
    the int8 codes of its normalized cells with their scale; rows that
    repeat an image; qh in float16, as the model's att_q gives it; wv, ws
    and the cotangents in float32."""
    rng = np.random.default_rng(seed)
    grid = np.abs(rng.normal(size=(M, N, C))).astype(np.float32)
    grid *= np.exp2(rng.uniform(-2, 2, size=(M, N, 1))).astype(np.float32)
    scale = 1.0
    if rows_dtype == "int8":
        g32 = grid / np.sqrt(np.sum(grid ** 2, -1, keepdims=True) + 1e-12)
        codes, scale = tar.quantize_store(g32)
        store = tar.pad_store_rows(codes)
    else:
        store = tar.pad_store_rows(grid.astype(np.float16))
    rows = rng.integers(0, M, size=BA).astype(np.int32)
    rows[1] = rows[0]
    qh = (rng.normal(size=(BA, HA)) * 0.5).astype(np.float16)
    wv = rng.normal(size=(C, HA)).astype(np.float32) * 0.3
    shape = (HA,) if glimpses == 1 else (HA, glimpses)
    ws = rng.normal(size=shape).astype(np.float32) * 0.3
    g = rng.normal(size=(BA, glimpses * C)).astype(np.float32)
    ga = rng.normal(size=(BA, N) + shape[1:]).astype(np.float32)
    return store, scale, rows, qh, wv, ws, g, ga


def _op_both(store, scale, rows, qh, wv, ws, g, ga, normalize):
    """JAX's op (B3/B4 interpreted) and the port's on the CPU (K4h/K5h's
    plain versions): [v_att, alpha, dqh, dwv, dws] of each."""
    kw = dict(n_valid=N, normalize=normalize)
    if scale != 1.0:
        kw["store_scale"] = scale

    def f(qh, wv, ws):
        return jar.spatial_attention_resident(
            jnp.asarray(store), jnp.asarray(rows), qh, wv, ws,
            interpret=True, **kw)

    fwd_j, vjp = jax.vjp(f, jnp.asarray(qh), jnp.asarray(wv),
                         jnp.asarray(ws))
    grads_j = vjp((jnp.asarray(g), jnp.asarray(ga)))
    ins = [torch.from_numpy(a).requires_grad_() for a in (qh, wv, ws)]
    va, al = tar.spatial_attention_resident(
        torch.from_numpy(store), torch.from_numpy(rows), *ins, **kw)
    (va * torch.from_numpy(g)).sum().add(
        (al * torch.from_numpy(ga)).sum()).backward()
    assert ins[0].grad.dtype == torch.float16
    got = [va.detach(), al.detach()] + [t.grad.float() for t in ins]
    want = [np.asarray(a, np.float32) for a in (*fwd_j, *grads_j)]
    return got, want


@pytest.mark.parametrize("glimpses", [1, 2, 8])
@pytest.mark.parametrize("rows_dtype,normalize", [
    ("float16", True), ("float16", False), ("int8", False)])
def test_resident_op_float16_matches_jax(glimpses, rows_dtype, normalize):
    """The op in float16 (float16 rows, or int8 codes widened to float16)
    against JAX's at 1, 2 and 8 glimpses: v_att, alpha, dqh, dW_v, dws."""
    store, scale, rows, qh, wv, ws, g, ga = _op_inputs(glimpses, 1,
                                                       rows_dtype)
    got, want = _op_both(store, scale, rows, qh, wv, ws, g, ga, normalize)
    for name, a, b, tol in zip(
            ("v_att", "alpha", "dqh", "dwv", "dws"), got, want,
            (TOL_OP_REL,) * 2 + (glimpses * TOL_OP_REL,) * 3):
        assert _rel(a, b, name) <= tol, (name, _rel(a, b))


@pytest.mark.parametrize("glimpses", [1, 2])
def test_resident_op_flushes_subnormal_cotangents_as_jax(glimpses):
    """A v_att cotangent around float16's smallest subnormal: JAX's B4
    rounds it to float16 (g.astype(dt)), flushing the entries below half of
    2^-24 to 0 and keeping the rest as subnormals, and so does the port's;
    dz * r, rounded again, is as small. dqh, dW_v and dws agree."""
    store, scale, rows, qh, wv, ws, g, ga = _op_inputs(glimpses, 2,
                                                       "float16")
    g = (g * SUBNORMAL).astype(np.float32)
    ga = np.zeros_like(ga)
    assert (np.abs(g) < SUBNORMAL / 2).any()
    assert (np.abs(g) >= SUBNORMAL / 2).any()
    got, want = _op_both(store, scale, rows, qh, wv, ws, g, ga, True)
    assert (g.astype(np.float16) == 0).sum() > (g == 0).sum()
    for name, a, b in zip(("dqh", "dwv", "dws"), got[2:], want[2:]):
        assert _rel(a, b, name) <= glimpses * TOL_OP_REL, name


# -- fit_resident in float16 --------------------------------------------------


TINY = {
    "data.synthetic": True, "data.synthetic_layout": "joined",
    "data.synthetic_size": 128, "data.vocab_size": 64,
    "data.num_answers": 16, "data.grid_h": 3, "data.grid_w": 3,
    "data.feature_dim": 16, "data.pool5_dim": 16,
    "data.max_question_len": 6, "model.word_dim": 8, "model.rnn_dim": 8,
    "model.fusion_dim": 16, "model.att_hidden": 8, "model.answer_dim": 8,
    "model.dtype": "float16", "model.dropout": 0.0,
    "train.batch_size": 16, "train.device_data_cache": True,
    "train.log_every": 2, "train.warmup_steps": 2,
    "train.learning_rate": 3e-3,
}


def _losses(train_dir):
    with open(os.path.join(train_dir, "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    return {r["step"]: r["train/loss"] for r in recs if "train/loss" in r}


@pytest.mark.parametrize("quantize", ["", "int8"])
def test_float16_fit_resident_matches_jax(quantize, tmp_path, monkeypatch):
    """Six gather-free steps of a float16 vqa_attention on the float16
    store (and on the int8 store) against JAX's, whose B1-B4 run in
    float16, from the same parameters. The op gets the uploaded store
    itself at every step, in float16 (or int8)."""
    flat = dict(TINY, **{"train.store_quantize": quantize})
    jcfg = JaxConfig().replace_flat(flat)
    jtr = JaxTrainer(jcfg, jax_build(jcfg), mesh=create_mesh(
        jcfg, devices=jax.devices()[:1]), train_dir=str(tmp_path / "jax"))
    jtrain = jds.load_dataset(jcfg, "train")
    js = jtr.init_state(next(jtrain.batches(1, epochs=1, shuffle=False)))
    params = params_from_flax(jax.device_get(js.params))
    js = jtr.fit_resident(jtrain, js, max_steps=6)
    want = params_from_flax(jax.device_get(js.params))
    jtr.close()
    seen = []
    real = tmodel.spatial_attention_resident
    monkeypatch.setattr(tmodel, "spatial_attention_resident",
                        lambda store, *a, **kw: seen.append(store.dtype)
                        or real(store, *a, **kw))
    cfg = Config().replace_flat(flat)
    tr = Trainer(cfg, build_model(cfg), train_dir=str(tmp_path / "torch"),
                 device="cpu")
    assert tr.model.dtype == torch.float16
    s = tr.fit_resident(tds.load_dataset(cfg, "train"), tr.init_state(params),
                        max_steps=6)
    tr.close()
    assert s.step == 6
    assert set(seen) == {torch.int8 if quantize else torch.float16}
    got = tr.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=2e-4, atol=1e-3, err_msg=k)
    lt, lj = _losses(tmp_path / "torch"), _losses(tmp_path / "jax")
    assert sorted(lt) == sorted(lj) == [2, 4, 6]
    for step in lj:
        np.testing.assert_allclose(lt[step], lj[step], rtol=2.0 ** -10)


# -- the store of an f32 source -----------------------------------------------


@pytest.mark.parametrize("quantize", ["", "int8"])
def test_float32_source_uploads_jax_float16_store(quantize, monkeypatch):
    """A float16 model whose source grid is float32 (values between
    float16 neighbours): the uploaded store equals JAX's _prepare_resident
    store bit for bit, float16 (or int8 codes of the same normalized
    values), and the op gets it at each call as it is: no float16 copy of
    an f32 store a step."""
    flat = dict(TINY, **{"train.store_quantize": quantize})
    jcfg = JaxConfig().replace_flat(flat)
    cfg = Config().replace_flat(flat)
    jtrain = jds.load_dataset(jcfg, "train")
    ttrain = tds.load_dataset(cfg, "train")
    rng = np.random.default_rng(9)
    src = np.asarray(jtrain.store.grid, np.float32)
    src = (src * (1 + rng.uniform(-2e-3, 2e-3, src.shape))).astype(np.float32)
    assert (src.astype(np.float16).astype(np.float32) != src).any()
    jtrain.store.grid = src
    ttrain.store.grid = src.copy()
    jtr = JaxTrainer(jcfg, jax_build(jcfg), mesh=create_mesh(
        jcfg, devices=jax.devices()[:1]))
    jdata, _, _ = jtr._prepare_resident(jtrain)
    want = np.asarray(jdata["grid_pad"])
    jtr.close()
    tr = Trainer(cfg, build_model(cfg), device="cpu")
    data, make_batch, _ = tr._prepare_resident(ttrain)
    store = data["grid"]
    assert store.dtype == (torch.int8 if quantize else torch.float16)
    assert want.dtype == (np.int8 if quantize else np.float16)
    n = src.shape[1]
    np.testing.assert_array_equal(store[:, :n].numpy(), want[:, :n])
    assert not store[:, n:].any()
    seen = []
    real = tmodel.spatial_attention_resident
    monkeypatch.setattr(tmodel, "spatial_attention_resident",
                        lambda st, *a, **kw: seen.append(st.data_ptr())
                        or real(st, *a, **kw))
    batch = make_batch(torch.arange(4))
    with torch.no_grad():
        tr.model(*tr.spec.inputs(batch))
    assert seen == [store.data_ptr()]
    tr.close()
