"""Port parity: the int8 resident store (``train.store_quantize int8``)
against the JAX package.

- ``quantize_store`` and ``prenormalize_store(quantize="int8")``: codes and
  scale bit-equal to JAX's. The port pads the cell axis to a multiple of 8
  (JAX: 32, Mosaic's int8 tile), so the first N cells are compared and the
  padded ones must be zero.
- The op on int8 codes of an integer-valued grid with scale 1 equals the op
  on the float grid (1e-6, as JAX's own exact-plumbing test), at 1 and 2
  glimpses.
- The op on int8 codes with a real scale against JAX's
  ``spatial_attention_resident`` (Pallas B3/B4 in interpret mode) on the
  same padded codes, float32 compute: v_att, alpha, dqh, dW_v and dws to
  1e-5 (rtol and atol), the tolerance of the float store's parity test
  (``tests/test_torch_attention_resident.py``): the same f32 math, sums in
  another order.
- Quantization accuracy against the float store, as JAX's tests: relative
  v_att error under 1%, attention argmax kept for 90% of the questions.
- ``Trainer`` with ``train.store_quantize int8``: 6 ``fit_resident`` steps
  against JAX's from the same parameters (params rtol 2e-4 / atol 2e-5,
  losses rtol 1e-5, as ``test_torch_trainer.py``), training and the
  resident evaluator against the float store's run (loss rtol 0.05), the
  gate (``int4`` raises, int8 off the prenormalized path warns and keeps
  the float store), and ``cli.train`` writing the flag into its config.
"""

import contextlib
import json
import logging
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
from vqa_transfer_externaldata_tpu.parallel.mesh import create_mesh
from vqa_transfer_externaldata_tpu.parallel.trainer import Trainer as JaxTrainer
from vqa_transfer_externaldata_torch.cli import train as train_cli
from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.data import datasets as tds
from vqa_transfer_externaldata_torch.data.features import (
    FeatureStore, JoinedDataset)
from vqa_transfer_externaldata_torch.models.zoo import build_model
from vqa_transfer_externaldata_torch.ops import attention_resident as tar
from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
from vqa_transfer_externaldata_torch.utils.convert import params_from_flax

torch.set_num_threads(2)  # xdist runs several workers on the same cores

M, N, C, H, B = 6, 13, 24, 16, 8  # padded to Np = 16 (JAX: 32)
TOL = dict(rtol=1e-5, atol=1e-5)

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
    "train.learning_rate": 3e-3, "train.store_quantize": "int8",
}


def _normalized(grid):
    g32 = grid.astype(np.float32)
    return g32 / np.sqrt(np.sum(g32 ** 2, axis=-1, keepdims=True) + 1e-12)


def _inputs(glimpses, seed=0):
    """A post-ReLU float grid with cells of different norms, rows that
    repeat an image, and the op's float32 inputs; ws [H] or [H, G]."""
    rng = np.random.default_rng(seed)
    grid = np.abs(rng.normal(size=(M, N, C))).astype(np.float32)
    grid *= np.exp2(rng.uniform(-2, 2, size=(M, N, 1))).astype(np.float32)
    rows = rng.integers(0, M, size=B).astype(np.int32)
    rows[1] = rows[0]
    qh = rng.normal(size=(B, H)).astype(np.float32) * 0.5
    wv = rng.normal(size=(C, H)).astype(np.float32) * 0.3
    shape = (H,) if glimpses == 1 else (H, glimpses)
    ws = rng.normal(size=shape).astype(np.float32) * 0.3
    g = rng.normal(size=(B, glimpses * C)).astype(np.float32)
    ga = rng.normal(size=(B, N) + shape[1:]).astype(np.float32)
    return grid, rows, qh, wv, ws, g, ga


def _port(store, rows, qh, wv, ws, g, ga, **kw):
    """The port's op: forward outputs and (dqh, dwv, dws) under the
    cotangents g, ga."""
    ins = [torch.from_numpy(a).requires_grad_() for a in (qh, wv, ws)]
    va, al = tar.spatial_attention_resident(
        torch.from_numpy(store), torch.from_numpy(rows), *ins, n_valid=N,
        **kw)
    (va * torch.from_numpy(g)).sum().add(
        (al * torch.from_numpy(ga)).sum()).backward()
    return ([va.detach().numpy(), al.detach().numpy()],
            [t.grad.numpy() for t in ins])


# -- (a) the codes and the scale ---------------------------------------------


@pytest.mark.parametrize("dtype", [np.float16, np.float32])
def test_codes_and_scale_are_bit_equal_to_jax(dtype):
    rng = np.random.default_rng(3)
    grid = (rng.normal(size=(5, N, C)) * 3).astype(dtype)
    source = grid.copy()
    # A small chunk so that both chunked passes run more than once.
    chunk = 2 * N * C * 4
    want, jscale = jar.prenormalize_store(grid, quantize="int8",
                                          chunk_bytes=chunk)
    got, tscale = tar.prenormalize_store(grid, quantize="int8",
                                         chunk_bytes=chunk)
    assert tscale == jscale and 0 < tscale < 1
    assert got.dtype == torch.int8 and tuple(got.shape) == (5, 16, C)
    assert want.shape == (5, 32, C)
    np.testing.assert_array_equal(got[:, :N].numpy(), want[:, :N])
    assert not got[:, N:].any()
    np.testing.assert_array_equal(grid, source)  # the source is untouched
    # quantize_store of the whole normalized store gives the same codes.
    q_j, s_j = jar.quantize_store(_normalized(grid))
    q_t, s_t = tar.quantize_store(_normalized(grid))
    assert s_t == s_j == tscale
    np.testing.assert_array_equal(q_t, q_j)
    np.testing.assert_array_equal(q_t, got[:, :N].numpy())
    with pytest.raises(ValueError, match="int4"):
        tar.prenormalize_store(grid, quantize="int4")


def test_int8_pads_to_eight_cells():
    """A deliberate departure: int8 stores pad as float ones do (JAX pads
    them to 32 cells, a TPU tile)."""
    codes = np.ones((2, N, C), np.int8)
    assert tar.pad_store_rows(codes).shape == (2, 16, C)
    assert jar.pad_store_rows(codes).shape == (2, 32, C)
    np.testing.assert_array_equal(tar.pad_store_rows(codes)[:, :N], codes)


# -- (b) exact plumbing ------------------------------------------------------


@pytest.mark.parametrize("glimpses", [1, 2])
def test_int8_store_exact_plumbing(glimpses):
    """Codes that ARE the values (an integer-valued grid, scale 1) give the
    float store's forward and gradients: every piece of the int8 plumbing
    (the widening of the codes, the scale folds) with no quantization
    error in the comparison."""
    _, rows, qh, wv, ws, g, ga = _inputs(glimpses, seed=11)
    ints = np.random.default_rng(11).integers(
        -127, 128, size=(M, N, C)).astype(np.float32)
    fwd_f, grads_f = _port(tar.pad_store_rows(ints), rows, qh, wv, ws, g, ga)
    fwd_q, grads_q = _port(tar.pad_store_rows(ints.astype(np.int8)), rows,
                           qh, wv, ws, g, ga, store_scale=1.0)
    for name, a, b in zip(("v_att", "alpha", "dqh", "dwv", "dws"),
                          fwd_q + grads_q, fwd_f + grads_f):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=name)


# -- (c) against JAX with a real scale ---------------------------------------


@pytest.mark.parametrize("glimpses", [1, 2])
def test_int8_store_matches_jax(glimpses):
    grid, rows, qh, wv, ws, g, ga = _inputs(glimpses, seed=5)
    codes, scale = tar.quantize_store(_normalized(grid))
    store = tar.pad_store_rows(codes)  # Np = 16: JAX's op takes Np % 8 == 0

    def f(qh, wv, ws):
        return jar.spatial_attention_resident(
            jnp.asarray(store), jnp.asarray(rows), qh, wv, ws, n_valid=N,
            normalize=False, interpret=True, store_scale=scale)

    fwd_j, vjp = jax.vjp(f, jnp.asarray(qh), jnp.asarray(wv),
                         jnp.asarray(ws))
    grads_j = vjp((jnp.asarray(g), jnp.asarray(ga)))
    fwd_t, grads_t = _port(store, rows, qh, wv, ws, g, ga, store_scale=scale)
    for name, a, b in zip(("v_att", "alpha", "dqh", "dwv", "dws"),
                          fwd_t + grads_t, [*fwd_j, *grads_j]):
        np.testing.assert_allclose(a, np.asarray(b), **TOL, err_msg=name)


def test_int8_store_refuses_normalize():
    grid, rows, qh, wv, ws, _, _ = _inputs(1)
    codes, scale = tar.quantize_store(_normalized(grid))
    with pytest.raises(ValueError, match="normalize"):
        tar.spatial_attention_resident(
            torch.from_numpy(tar.pad_store_rows(codes)),
            torch.from_numpy(rows), torch.from_numpy(qh),
            torch.from_numpy(wv), torch.from_numpy(ws), n_valid=N,
            normalize=True, store_scale=scale)


# -- (d) quantization accuracy -----------------------------------------------


@pytest.mark.parametrize("glimpses", [1, 2])
def test_int8_store_tracks_the_float_store(glimpses):
    grid, rows, qh, wv, ws, g, ga = _inputs(glimpses, seed=7)
    g32 = _normalized(grid)
    codes, scale = tar.quantize_store(g32)
    assert codes.dtype == np.int8 and 0 < scale < 1
    (va_f, al_f), _ = _port(tar.pad_store_rows(g32), rows, qh, wv, ws, g, ga)
    (va_q, al_q), _ = _port(tar.pad_store_rows(codes), rows, qh, wv, ws, g,
                            ga, store_scale=scale)
    rel = np.linalg.norm(va_q - va_f) / np.linalg.norm(va_f)
    assert rel < 0.01, rel
    agree = al_q.argmax(1) == al_f.argmax(1)
    assert agree.mean() >= 0.9, agree.mean()


# -- (e) the Trainer ----------------------------------------------------------


def _losses(train_dir):
    with open(os.path.join(train_dir, "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    return {r["step"]: r["train/loss"] for r in recs if "train/loss" in r}


def test_fit_resident_int8_matches_jax(tmp_path):
    """6 steps on the int8 store against JAX's Trainer with the same flag,
    from the same parameters: the same codes and scale, the same math."""
    jcfg = JaxConfig().replace_flat(TINY)
    jtr = JaxTrainer(jcfg, jax_build(jcfg), mesh=create_mesh(
        jcfg, devices=jax.devices()[:1]), train_dir=str(tmp_path / "jax"))
    jds_train = jds.load_dataset(jcfg, "train")
    js = jtr.init_state(next(jds_train.batches(1, epochs=1, shuffle=False)))
    params = params_from_flax(jax.device_get(js.params))
    js = jtr.fit_resident(jds_train, js, max_steps=6)
    want = params_from_flax(jax.device_get(js.params))
    jscale = jtr.spec.module.store_scale
    jtr.close()

    cfg = Config().replace_flat(TINY)
    tr = Trainer(cfg, build_model(cfg), train_dir=str(tmp_path / "torch"),
                 device="cpu")
    ds = tds.load_dataset(cfg, "train")
    data, make_batch, _ = tr._prepare_resident(ds)
    assert data["grid"].dtype == torch.int8
    store, _, scale = make_batch(torch.arange(4))["features"]
    assert store is data["grid"] and scale == jscale and 0 < scale < 1
    s = tr.fit_resident(ds, tr.init_state(params), max_steps=6)
    tr.close()
    got = tr.model.state_dict()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
    lj, lt = _losses(tmp_path / "jax"), _losses(tmp_path / "torch")
    assert s.step == 6 and sorted(lt) == sorted(lj) == [2, 4, 6]
    for step in lj:
        np.testing.assert_allclose(lt[step], lj[step], rtol=1e-5)


def _joined(tmp_path, cfg):
    """JAX's test corpus: an f16 grid of 16 images in an npz store, 128
    questions."""
    d = cfg.data
    rng = np.random.default_rng(3)
    images, n = 16, 128
    path = str(tmp_path / "store.npz")
    if not os.path.exists(path):
        np.savez(path, grid=rng.normal(
            size=(images, d.grid_h, d.grid_w, d.feature_dim)).astype(
                np.float16),
                 pool5=rng.normal(size=(images, d.pool5_dim)).astype(
                     np.float32),
                 image_ids=np.arange(images, dtype=np.int64))
    rng = np.random.default_rng(4)
    rows = {
        "q_ids": rng.integers(4, d.vocab_size, size=(
            n, d.max_question_len)).astype(np.int32),
        "answer_id": rng.integers(4, d.num_answers, size=n).astype(np.int32),
        "image_index": rng.integers(0, images, size=n).astype(np.int32),
    }
    return JoinedDataset(rows, FeatureStore(path), index_key="image_index",
                         feature_keys=("features", "pool5"))


def test_int8_store_trains_and_evaluates_close_to_float(tmp_path,
                                                       monkeypatch):
    """The int8 run and the float run from the same seed: training and the
    resident evaluator, which reads the int8 store too, differ by
    quantization noise only."""
    seen = []
    plain = tar.attention_resident_fwd_reference
    monkeypatch.setattr(tar, "attention_resident_fwd_reference",
                        lambda store, *a, **kw: seen.append(store.dtype)
                        or plain(store, *a, **kw))
    results = {}
    for quant in ("", "int8"):
        cfg = Config().replace_flat(dict(TINY, **{
            "train.store_quantize": quant, "train.batch_size": 32}))
        tr = Trainer(cfg, build_model(cfg, generator=torch.Generator(
            ).manual_seed(0)), train_dir=str(tmp_path / f"q{quant}"),
                     device="cpu")
        s = tr.fit_resident(_joined(tmp_path, cfg), tr.init_state(),
                            max_steps=6)
        del seen[:]
        results[quant] = tr.evaluate_resident(s, _joined(tmp_path, cfg))
        # The float run's store is the synthetic corpus's float16 rows,
        # which the float32 model hands to the op as they are.
        assert seen and set(seen) == {torch.int8 if quant else
                                      torch.float16}, seen
        tr.close()
    (mf, pf), (mq, pq) = results[""], results["int8"]
    assert np.isfinite(mq["loss"])
    assert (pf == pq).mean() > 0.7
    np.testing.assert_allclose(mq["loss"], mf["loss"], rtol=0.05)


@contextlib.contextmanager
def _warnings():
    """The messages the port's logger warns with inside the block."""
    seen = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: seen.append(record.getMessage())
    logger = logging.getLogger("vqa_torch")
    logger.addHandler(handler)
    try:
        yield seen
    finally:
        logger.removeHandler(handler)


def test_store_quantize_gate(tmp_path):
    """Values other than '' and 'int8' raise; int8 off the prenormalized
    gather-free path (a Trainer that streams, whose resident evaluator
    normalizes in the op) warns and keeps the float store, as JAX's
    does."""
    cfg = Config().replace_flat(dict(TINY, **{"train.store_quantize": "int4"}))
    tr = Trainer(cfg, build_model(cfg), train_dir=str(tmp_path / "bad"),
                 device="cpu")
    with pytest.raises(ValueError, match="store_quantize"):
        tr._prepare_resident(tds.load_dataset(cfg, "train"))
    tr.close()
    cfg = Config().replace_flat(dict(TINY, **{
        "train.device_data_cache": False}))
    tr = Trainer(cfg, build_model(cfg), train_dir=str(tmp_path / "streamed"),
                 device="cpu")
    assert not tr.model.store_prenormalized
    with _warnings() as seen:
        data, make_batch, _ = tr._prepare_resident(
            tds.load_dataset(cfg, "train"))
    tr.close()
    assert data["grid"].dtype == torch.float16
    assert len(make_batch(torch.arange(4))["features"]) == 2
    assert any("store_quantize='int8'" in m and "float store" in m
               for m in seen), seen


# -- (f) the CLI --------------------------------------------------------------


def test_cli_train_with_int8_store(tmp_path):
    argv = ["--device", "cpu", "--train.train_dir", str(tmp_path),
            "--train.max_steps", "4"]
    for k, v in TINY.items():
        argv += [f"--{k}", str(v).lower() if isinstance(v, bool) else str(v)]
    train_dir = train_cli.main(argv)
    with open(os.path.join(train_dir, "config.json")) as fh:
        saved = json.load(fh)
    assert saved["train"]["store_quantize"] == "int8"
    losses = _losses(train_dir)
    assert sorted(losses) == [2, 4] and all(np.isfinite(list(losses.values())))
