"""Port parity: the float32 main path and ``model.use_pallas`` against the
JAX package on the CPU (its Pallas bodies in interpret mode, or its XLA
paths where ``use_pallas`` is off).

* The resident op on float16 rows in a float32 model: the kernels K4f/K5f
  widen the rows on load, so the op computes on the values of JAX's
  ``store.astype(float32)`` without an f32 copy of the store; forward and
  gradients against JAX's op at 1e-5 (the same f32 math, sums in another
  order), each output held to 1e-5 of its largest value (a sum's rounding
  scales with its terms, and at 8 glimpses dws sums terms far larger than
  its smallest entries), at 1, 2 and 8 glimpses.
* ``model.use_pallas`` off: the GRU encoders and the gathered attention
  run their plain versions, as JAX's run XLA's; each against JAX's at 1e-5
  in float32 (bf16: 2e-2 on h, a last-bit flip of a bf16 rounding, 2^-8 of
  a value, carried through the recurrence), and the flag reaches each op
  the JAX package reads it in, and no other.
* Six ``fit_resident`` steps of the float32 main path (the cudnn GRU,
  one and two glimpses, the float16 store) against JAX's at
  ``test_torch_trainer.py``'s float32 bounds (params rtol 2e-4 / atol
  2e-5, losses rtol 1e-5).
* The float32 kernels' launch helpers (pure functions of the shapes) and
  their wrappers' refusals, which the CPU can check.
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
    VQAAttentionModel as JaxModel)
from vqa_transfer_externaldata_tpu.models.zoo import build_model as jax_build
from vqa_transfer_externaldata_tpu.parallel.mesh import create_mesh
from vqa_transfer_externaldata_tpu.parallel.trainer import Trainer as JaxTrainer
from vqa_transfer_externaldata_tpu.ops import attention as jatt
from vqa_transfer_externaldata_tpu.ops import attention_resident as jar
from vqa_transfer_externaldata_tpu.ops import gru as jgru
from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.data import datasets as tds
from vqa_transfer_externaldata_torch.models import vqa_attention as tmodel
from vqa_transfer_externaldata_torch.models.vqa_attention import (
    VQAAttentionModel)
from vqa_transfer_externaldata_torch.models.zoo import build_model
from vqa_transfer_externaldata_torch.ops import attention as tatt
from vqa_transfer_externaldata_torch.ops import attention_resident as tar
from vqa_transfer_externaldata_torch.ops import gru as tgru
from vqa_transfer_externaldata_torch.ops import kernels
from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
from vqa_transfer_externaldata_torch.utils.convert import params_from_flax

torch.set_num_threads(2)  # xdist runs several workers on the same cores

M, N, C, H, B = 6, 13, 24, 16, 8  # Np = 16 > n_valid = 13
TOL = dict(rtol=1e-5, atol=1e-5)
# What a dtype without kernels is told: the three dtypes that have them.
ITEM = "torch.bfloat16, torch.float16, torch.float32"


def _close(got, want, what=""):
    """Within 1e-5 of ``want``'s largest |value|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= 1e-5 * max(np.abs(want).max(), 1e-30), (what, err)


def _resident_inputs(G, seed=0):
    rng = np.random.default_rng(seed)
    grid = np.abs(rng.normal(size=(M, N, C))).astype(np.float32)
    grid *= np.exp2(rng.uniform(-2, 2, size=(M, N, 1))).astype(np.float32)
    store = jar.pad_store_rows(grid.astype(np.float16))
    rows = rng.integers(0, M, size=B).astype(np.int32)
    rows[1] = rows[0]  # two questions about one image
    qh = rng.normal(size=(B, H)).astype(np.float32) * 0.5
    wv = rng.normal(size=(C, H)).astype(np.float32) * 0.3
    ws = rng.normal(size=(H, G) if G > 1 else (H,)).astype(np.float32) * 0.3
    g = rng.normal(size=(B, G * C)).astype(np.float32)
    ga = rng.normal(size=(B, N, G) if G > 1 else (B, N)).astype(np.float32)
    return store, rows, qh, wv, ws, g, ga


@pytest.mark.parametrize("G", [1, 2, 8])
@pytest.mark.parametrize("normalize", [True, False])
def test_resident_op_on_float16_rows_matches_jax(G, normalize):
    """The op on the float16 store with float32 qh, wv and ws against
    JAX's op on ``store.astype(float32)`` (what its model hands B3/B4 in
    float32), forward and gradients."""
    store, rows, qh, wv, ws, g, ga = _resident_inputs(G)

    def f(qh, wv, ws):
        return jar.spatial_attention_resident(
            jnp.asarray(store.astype(np.float32)), jnp.asarray(rows), qh, wv,
            ws, n_valid=N, normalize=normalize, interpret=True)

    (va_j, al_j), vjp = jax.vjp(f, jnp.asarray(qh), jnp.asarray(wv),
                                jnp.asarray(ws))
    want = vjp((jnp.asarray(g), jnp.asarray(ga)))
    ins = [torch.from_numpy(a).requires_grad_() for a in (qh, wv, ws)]
    st = torch.from_numpy(store)
    assert st.dtype == torch.float16
    va, al = tar.spatial_attention_resident(
        st, torch.from_numpy(rows), *ins, n_valid=N, normalize=normalize)
    assert va.dtype == al.dtype == torch.float32
    _close(va.detach(), va_j, "v_att")
    _close(al.detach(), al_j, "alpha")
    (va * torch.from_numpy(g)).sum().add(
        (al * torch.from_numpy(ga)).sum()).backward()
    for name, t, w in zip(("dqh", "dwv", "dws"), ins, want):
        _close(t.grad, w, name)


@pytest.mark.parametrize("G", [1, 2])
def test_float16_rows_equal_their_float32_copy(G):
    """f16 -> f32 is exact, so the op on the float16 rows equals the op on
    their float32 copy bit for bit, forward and gradients, and the plain
    versions widen the rows themselves (compute dtype: qh's)."""
    store, rows, qh, wv, ws, g, _ = _resident_inputs(G, seed=1)
    outs = []
    for st in (torch.from_numpy(store), torch.from_numpy(store).float()):
        ins = [torch.from_numpy(a).requires_grad_() for a in (qh, wv, ws)]
        va, _ = tar.spatial_attention_resident(
            st, torch.from_numpy(rows), *ins, n_valid=N, normalize=True)
        va.backward(torch.from_numpy(g))
        outs.append([va.detach()] + [t.grad for t in ins])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,store_dtype", [
    (torch.float32, torch.float16), (torch.float32, torch.float32),
    (torch.float32, torch.int8), (torch.bfloat16, torch.float16)])
def test_model_hands_the_store_over_without_a_copy(monkeypatch, dtype,
                                                   store_dtype):
    """A float32 model passes f16, f32 and int8 stores to the op as they
    are (the kernels widen on load); a bf16 model casts a float store to
    bf16, as before."""
    seen = {}
    real = tmodel.spatial_attention_resident

    def spy(store, *args, **kw):
        seen["store"] = store
        return real(store, *args, **kw)

    monkeypatch.setattr(tmodel, "spatial_attention_resident", spy)
    model = VQAAttentionModel(32, 8, feature_dim=C, word_dim=8, rnn_dim=8,
                              fusion_dim=16, att_hidden=H, answer_dim=8,
                              n_cells=N, store_prenormalized=True,
                              dtype=dtype)
    store = torch.from_numpy(_resident_inputs(1)[0])
    store = (store.float() * 10).to(torch.int8) \
        if store_dtype == torch.int8 else store.to(store_dtype)
    rows = torch.tensor([0, 3, 5, 1], dtype=torch.int32)
    q = torch.randint(4, 32, (4, 5))
    with torch.no_grad():
        out = model((store, rows), q)
    assert out["logits"].shape == (4, 8)
    if dtype == torch.float32:
        assert seen["store"].data_ptr() == store.data_ptr()
        assert seen["store"].dtype == store_dtype
    else:
        assert seen["store"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_use_pallas_off_matches_jax_scan(dtype, atol, reverse):
    """GRUEncoder with use_pallas off (the plain recurrence on any device)
    against JAX's XLA scan (use_pallas False), forward and gradients."""
    rng = np.random.default_rng(2)
    T, Bq, D, Hh = 6, 5, 7, 16
    x = rng.normal(size=(T, Bq, D)).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([6, 1, 3, 0, 5])[:, None]).astype(
        np.float32)
    jdt = getattr(jnp, dtype)
    jm = jgru.GRUEncoder(Hh, jdt, use_pallas=False, time_major=True,
                         reverse=reverse)
    tree = jax.device_get(jm.init(jax.random.PRNGKey(0), x, mask)["params"])
    tree = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(scale=0.2, size=np.shape(a))
                   ).astype(np.float32), tree)
    w = rng.normal(size=(Bq, Hh)).astype(np.float32)

    def loss(p, xx):
        return jnp.sum(jm.apply({"params": p}, xx, mask).astype(jnp.float32)
                       * w)

    want = jm.apply({"params": tree}, x, mask)
    gp, gx = jax.grad(loss, argnums=(0, 1))(tree, jnp.asarray(x))
    enc = tgru.GRUEncoder(D, Hh, dtype=getattr(torch, dtype),
                          reverse=reverse, use_pallas=False)
    enc.load_state_dict(params_from_flax(tree))
    xt = torch.from_numpy(x).requires_grad_()
    got = enc(xt, torch.from_numpy(mask))
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)
    if dtype == "float32":
        (got * torch.from_numpy(w)).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
        for k, p in enc.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp[k]),
                                       **TOL, err_msg=k)


def test_bigru_use_pallas_off_matches_jax():
    """BiGRUEncoder with use_pallas off against JAX's (two XLA scans)."""
    rng = np.random.default_rng(3)
    T, Bq, D, Hh = 5, 4, 6, 8
    x = rng.normal(size=(T, Bq, D)).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([5, 2, 0, 4])[:, None]).astype(
        np.float32)
    jm = jgru.BiGRUEncoder(Hh, jnp.float32, use_pallas=False,
                           time_major=True)
    tree = jax.device_get(jm.init(jax.random.PRNGKey(1), x, mask)["params"])
    want = jm.apply({"params": tree}, x, mask)
    enc = tgru.BiGRUEncoder(D, Hh, dtype=torch.float32, use_pallas=False)
    enc.load_state_dict(params_from_flax(tree))
    got = enc(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gathered_attention_use_pallas_off_matches_jax(normalize, dtype):
    """spatial_attention with use_kernels off takes the JAX package's XLA
    forward and explicit backward: against JAX's spatial_attention with
    use_pallas False (feature_grad off, as the model calls it)."""
    rng = np.random.default_rng(4)
    Bq, Nn = 4, 9
    v = np.abs(rng.normal(size=(Bq, Nn, C))).astype(np.float32)
    qh = rng.normal(size=(Bq, H)).astype(np.float32) * 0.5
    wv = rng.normal(size=(C, H)).astype(np.float32) * 0.3
    ws = rng.normal(size=(H,)).astype(np.float32) * 0.3
    g = rng.normal(size=(Bq, C)).astype(np.float32)
    jdt = getattr(jnp, dtype)

    def f(qh, wv, ws):
        return jatt.spatial_attention(
            jnp.asarray(v).astype(jdt), qh, wv, ws, normalize=normalize,
            use_pallas=False, feature_grad=False)

    (va_j, al_j), vjp = jax.vjp(f, jnp.asarray(qh), jnp.asarray(wv),
                                jnp.asarray(ws))
    want = vjp((jnp.asarray(g), jnp.zeros_like(al_j)))
    ins = [torch.from_numpy(a).requires_grad_() for a in (qh, wv, ws)]
    va, al = tatt.spatial_attention(
        torch.from_numpy(v).to(getattr(torch, dtype)), *ins,
        normalize=normalize, feature_grad=False, use_kernels=False)
    tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(va.detach().numpy(), np.asarray(va_j), **tol)
    np.testing.assert_allclose(al.detach().numpy(), np.asarray(al_j), **tol)
    va.backward(torch.from_numpy(g))
    for name, t, w in zip(("dqh", "dwv", "dws"), ins, want):
        np.testing.assert_allclose(t.grad.numpy(),
                                   np.asarray(w, np.float32), **tol,
                                   err_msg=name)


def test_model_use_pallas_off_matches_jax():
    """vqa_attention with use_pallas off on gathered features, float32,
    dropout off: logits at evaluation and the training gradients against
    JAX's model with use_pallas False."""
    dims = dict(word_dim=8, rnn_dim=8, fusion_dim=16, att_hidden=H,
                answer_dim=8)
    V, A, Bq, T = 40, 12, 5, 6
    rng = np.random.default_rng(5)
    jm = JaxModel(vocab_size=V, num_answers=A, dtype=jnp.float32,
                  dropout=0.0, use_pallas=False, **dims)
    feats = np.abs(rng.normal(size=(Bq, N, C))).astype(np.float32)
    q = rng.integers(4, V, size=(Bq, T)).astype(np.int32)
    q[1, 2:] = 0
    tree = jax.device_get(jm.init(jax.random.PRNGKey(0), feats, q,
                                  train=False)["params"])
    tree = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=np.shape(a)) * 0.3).astype(np.float32),
        tree)
    tree["logit_scale"] = np.float32(10.0)
    labels = rng.integers(2, A, size=Bq)

    def loss(p):
        lg = jm.apply({"params": p}, feats, q, train=True)["logits"]
        return -jnp.mean(jax.nn.log_softmax(lg)[jnp.arange(Bq), labels])

    want = jm.apply({"params": tree}, feats, q, train=False)["logits"]
    grads = params_from_flax(jax.grad(loss)(tree))
    model = VQAAttentionModel(V, A, feature_dim=C, dropout=0.0,
                              dtype=torch.float32, use_pallas=False, **dims)
    model.load_state_dict(params_from_flax(tree))
    with torch.no_grad():
        got = model(torch.from_numpy(feats), torch.from_numpy(q))["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    lg = model(torch.from_numpy(feats), torch.from_numpy(q),
               train=True)["logits"]
    torch.nn.functional.cross_entropy(
        lg, torch.from_numpy(labels)).backward()
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("over,ops", [
    ({"model.model": "vqa_attention"}, {"gru_fused", "spatial_attention"}),
    ({"model.model": "vqa_attention2"}, {"gru_fused"}),
    ({"model.model": "vlmap_description"}, {"gru_fused"}),
    ({"model.model": "vlmap_description", "model.bidirectional_desc": True},
     {"bigru_fused"}),
])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_use_pallas_reaches_the_ops_jax_reads_it_in(monkeypatch, over, ops,
                                                    use_pallas):
    """model.use_pallas arrives as the ops' use_kernels where the JAX
    package reads it (GRUEncoder, BiGRUEncoder, the gathered single-glimpse
    attention), and nowhere else."""
    seen = {}

    def spy(name, module, real):
        def fn(*args, **kw):
            seen[name] = kw.get("use_kernels", True)
            return real(*args, **kw)
        monkeypatch.setattr(module, name, fn)

    spy("gru_fused", tgru, tgru.gru_fused)
    spy("bigru_fused", tgru, tgru.bigru_fused)
    spy("spatial_attention", tmodel, tmodel.spatial_attention)
    flat = {"data.vocab_size": 32, "data.num_answers": 8,
            "data.feature_dim": C, "data.pool5_dim": C, "data.grid_h": 3,
            "data.grid_w": 3, "data.max_question_len": 5,
            "model.word_dim": 8, "model.rnn_dim": 8, "model.fusion_dim": 16,
            "model.att_hidden": H, "model.answer_dim": 8,
            "model.num_candidates": 6, "model.num_tasks": 4,
            "model.task_dim": 4, "model.dtype": "float32",
            "model.use_pallas": use_pallas, **over}
    spec = build_model(Config().replace_flat(flat))
    rng = np.random.default_rng(0)
    n = 3
    batch = {"q_ids": torch.from_numpy(rng.integers(4, 32, (n, 5))),
             "desc_ids": torch.from_numpy(rng.integers(4, 32, (n, 5))),
             "features": torch.from_numpy(
                 rng.normal(size=(n, 9, C)).astype(np.float32)),
             "feature": torch.from_numpy(
                 rng.normal(size=(n, C)).astype(np.float32)),
             "task": torch.zeros(n, dtype=torch.int64),
             "candidates": torch.from_numpy(rng.integers(4, 32, (n, 6)))}
    with torch.no_grad():
        spec.module(*spec.inputs(batch))
    assert seen == {op: use_pallas for op in ops}


def test_float32_wrappers_refuse_cpu_tensors():
    """The float32 kernels' wrappers launch on CUDA tensors only (a CPU
    tensor goes to the plain versions, never here)."""
    gx = torch.zeros(2, 3, 48)
    lens = torch.ones(3, dtype=torch.int32)
    uh, bhn = torch.zeros(16, 48), torch.zeros(16)
    with pytest.raises(ValueError, match="CUDA"):
        tgru.gru_fwd_f32(gx, lens, uh, bhn)
    with pytest.raises(ValueError, match="CUDA"):
        tgru.gru_bwd_f32(gx, torch.zeros(2, 3, 16), lens, uh, bhn,
                         torch.zeros(3, 16))
    store = torch.zeros(4, 16, C, dtype=torch.float16)
    rows = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tar.attention_resident_fwd_f32(store, rows, torch.zeros(3, H),
                                       torch.zeros(C, H), torch.zeros(H),
                                       n_valid=13, normalize=False)
    with pytest.raises(ValueError, match="CUDA"):
        tar.attention_resident_bwd_f32(
            store, rows, torch.zeros(3, 16, H), torch.zeros(H),
            torch.zeros(3, 16), torch.zeros(3, C), torch.zeros(3, 16),
            n_valid=13, normalize=False)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16, torch.float64])
def test_kernel_dtype_names_the_float16_item(dtype):
    """The dtype that picks a kernel: bf16, float16 and float32 (the three
    model dtypes, each with its kernels) pass through; float64 raises
    TypeError naming the three."""
    x = torch.zeros(2, 3, dtype=dtype)
    if dtype != torch.float64:
        assert kernels.kernel_dtype("k", "v", x) == dtype
    else:
        with pytest.raises(TypeError, match=ITEM):
            kernels.kernel_dtype("k", "v", x)


@pytest.mark.parametrize("K", [1, 8, 511, 513, 4096, 50176, 200000])
@pytest.mark.parametrize("C_,H_", [(96, 200), (2048, 512), (4096, 1024)])
@pytest.mark.parametrize("sms", [1, 132])
def test_f32_dwv_splits_cover_every_cell_once(K, C_, H_, sms):
    """K5f's split of the cells (the C side rounds the chunk up to 8
    cells): at least one split, no more blocks than two a SM, at least 512
    cells a split but the last, every cell in exactly one split and no
    split empty."""
    S = kernels.f32_dwv_splits(K, C_, H_, sms)
    tiles = -(-C_ // kernels.F32_TILE) * -(-H_ // kernels.F32_TILE)
    assert S >= 1
    assert S == 1 or S * tiles <= 2 * sms
    per = -(-K // S)
    chunk = -(-per // 8) * 8
    bounds = [(z * chunk, min(K, (z + 1) * chunk)) for z in range(S)]
    assert bounds[0][0] == 0 and bounds[-1][1] == K
    assert all(a < b for a, b in bounds)
    assert all(b - a >= 512 for a, b in bounds[:-1])
    assert all(bounds[i][1] == bounds[i + 1][0] for i in range(S - 1))


def test_f32_rows_launch_fits_at_the_main_path():
    """K5f's rows launch at 8 glimpses of 196 cells of 2048 channels fits
    a block's shared memory; a 16384-channel grid at 8 glimpses does not,
    and the wrapper refuses it before a launch."""
    assert tar.f32_bwd_smem(196, 8, 2048) <= kernels.SMEM_OPTIN
    assert tar.f32_bwd_smem(196, 8, 16384) > kernels.SMEM_OPTIN


TINY = {
    "data.synthetic": True, "data.synthetic_layout": "joined",
    "data.synthetic_size": 128, "data.vocab_size": 64,
    "data.num_answers": 16, "data.grid_h": 3, "data.grid_w": 3,
    "data.feature_dim": 16, "data.pool5_dim": 16,
    "data.max_question_len": 6, "model.word_dim": 8, "model.rnn_dim": 8,
    "model.fusion_dim": 16, "model.att_hidden": 8, "model.answer_dim": 8,
    "model.dtype": "float32", "model.dropout": 0.0,
    "train.batch_size": 16, "train.device_data_cache": True,
    "train.log_every": 2, "train.warmup_steps": 2,
    "train.learning_rate": 3e-3,
}


def _losses(train_dir):
    with open(os.path.join(train_dir, "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    return {r["step"]: r["train/loss"] for r in recs if "train/loss" in r}


@pytest.mark.parametrize("model", ["vqa_attention", "vqa_attention2"])
def test_float32_fit_resident_matches_jax(model, tmp_path, monkeypatch):
    """model.dtype float32 on the main path (the cudnn GRU on float32
    U_h, the gather-free op on the float16 store handed over as it is):
    six steps against JAX's, whose B1/B2 and B3/B4 run in float32."""
    flat = dict(TINY, **{"model.model": model})
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
    s = tr.fit_resident(tds.load_dataset(cfg, "train"), tr.init_state(params),
                        max_steps=6)
    tr.close()
    assert s.step == 6 and set(seen) == {torch.float16}
    assert type(tr.model.gru).__name__ == "GRUEncoder"
    got = tr.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
    lt, lj = _losses(tmp_path / "torch"), _losses(tmp_path / "jax")
    assert sorted(lt) == sorted(lj) == [2, 4, 6]
    for step in lj:
        np.testing.assert_allclose(lt[step], lj[step], rtol=1e-5)
