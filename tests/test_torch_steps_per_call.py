"""Port parity: ``train.steps_per_call`` (k steps a call) in the Trainer's
two loops against the single-step loops and the JAX package's fused
dispatch (``lax.scan`` over k steps).

On the CPU the port runs the k steps of a call eagerly, through the same
body that a CUDA graph captures on the card (``Trainer._steps``): the
port at k = 4 must be bit-equal to the port at k = 1. Against JAX's
Trainer at k = 4 (one CPU device; its attention the Pallas B3/B4 pair in
interpret mode, its GRU B1/B2), float32 and dropout 0 from the same bridged
parameters, within rtol 1e-5 / atol 1e-6 (``tests/test_trainer.py``'s
bound for k = 4 against k = 1). Logged losses within rtol 1e-5.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from vqa_transfer_externaldata_tpu.config import Config as JaxConfig
from vqa_transfer_externaldata_tpu.data import datasets as jds
from vqa_transfer_externaldata_tpu.models.zoo import build_model as jax_build
from vqa_transfer_externaldata_tpu.parallel.mesh import create_mesh
from vqa_transfer_externaldata_tpu.parallel.trainer import Trainer as JaxTrainer
from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.data import datasets as tds
from vqa_transfer_externaldata_torch.models.zoo import build_model
from vqa_transfer_externaldata_torch.parallel import trainer as tt
from vqa_transfer_externaldata_torch.utils.convert import params_from_flax

torch.set_num_threads(2)  # xdist runs several workers on the same cores

TINY = {
    "data.synthetic": True, "data.synthetic_layout": "joined",
    "data.synthetic_size": 128, "data.vocab_size": 64,
    "data.num_answers": 16, "data.grid_h": 3, "data.grid_w": 3,
    "data.feature_dim": 16, "data.pool5_dim": 16,
    "data.max_question_len": 6, "model.word_dim": 8, "model.rnn_dim": 8,
    "model.fusion_dim": 16, "model.att_hidden": 8, "model.answer_dim": 8,
    "model.dtype": "float32", "model.dropout": 0.0,
    "train.batch_size": 16, "train.device_data_cache": True,
    "train.log_every": 4, "train.checkpoint_every": 8,
    "train.warmup_steps": 2, "train.learning_rate": 3e-3,
}
TOL = dict(rtol=1e-5, atol=1e-6)


def _records(train_dir):
    with open(os.path.join(train_dir, "metrics.jsonl")) as fh:
        return {r["step"]: r for r in map(json.loads, fh)
                if "train/loss" in r}


def _port_run(over, train_dir, loop, max_steps, params=None, seg=None):
    cfg = Config().replace_flat(dict(TINY, **over))
    spec = build_model(cfg, generator=torch.Generator().manual_seed(0))
    tr = tt.Trainer(cfg, spec, train_dir=str(train_dir), device="cpu")
    if seg is not None:
        tr.resident_segment_steps = seg
    state = tr.init_state(params)
    ds = tds.load_dataset(cfg, "train")
    if loop == "streamed":
        state = tr.fit(ds.batches(cfg.train.batch_size, seed=cfg.train.seed),
                       state, max_steps=max_steps)
    else:
        state = tr.fit_resident(ds, state, max_steps=max_steps)
    tr.close()
    return state, spec.module.state_dict()


def _jax_run(over, train_dir, loop, max_steps):
    jcfg = JaxConfig().replace_flat(dict(TINY, **over))
    jtr = JaxTrainer(jcfg, jax_build(jcfg), mesh=create_mesh(
        jcfg, devices=jax.devices()[:1]), train_dir=str(train_dir))
    ds = jds.load_dataset(jcfg, "train")
    js = jtr.init_state(next(ds.batches(1, epochs=1, shuffle=False)))
    init = params_from_flax(jax.device_get(js.params))
    if loop == "streamed":
        js = jtr.fit(ds.batches(jcfg.train.batch_size, seed=jcfg.train.seed),
                     js, max_steps=max_steps)
    else:
        js = jtr.fit_resident(ds, js, max_steps=max_steps)
    jtr.close()
    return init, params_from_flax(jax.device_get(js.params))


def _assert_bit_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("model", ["vqa_baseline", "vqa_attention"])
@pytest.mark.parametrize("loop", ["streamed", "resident"])
def test_steps_per_call_matches_single_step_and_jax(tmp_path, loop, model):
    """8 steps at k = 4 (two calls; log every 4, checkpoint every 8) from
    JAX's initialization: bit-equal to the port at k = 1 and within the
    tolerance of JAX's Trainer at k = 4, records at the same steps.
    ``vqa_attention`` trains on the joined store: streamed on host batches
    of gathered grids, resident through the gather-free path."""
    over = {"model.model": model}
    init, want = _jax_run(dict(over, **{"train.steps_per_call": 4}),
                          tmp_path / "jax", loop, 8)
    runs = {}
    for k in (1, 4):
        state, runs[k] = _port_run(dict(over, **{"train.steps_per_call": k}),
                                   tmp_path / f"k{k}", loop, 8, init)
        assert state.step == state.opt_state.count == 8
    _assert_bit_equal(runs[4], runs[1])
    for k in want:
        np.testing.assert_allclose(runs[4][k].numpy(), want[k].numpy(),
                                   err_msg=k, **TOL)
    rj, rt = _records(tmp_path / "jax"), _records(tmp_path / "k4")
    assert sorted(rt) == sorted(rj) == [4, 8]
    assert _records(tmp_path / "k1").keys() == rt.keys()
    for step in rj:
        np.testing.assert_allclose(rt[step]["train/loss"],
                                   rj[step]["train/loss"], rtol=1e-5)
    assert sorted(os.listdir(tmp_path / "k4" / "ckpt")) == [
        "ckpt_4.pt", "ckpt_8.pt"]


@pytest.mark.parametrize("loop", ["streamed", "resident"])
def test_tail_call_is_cut_to_max_steps(tmp_path, loop):
    """max_steps 10 at k = 4: calls of 4, 4 and 2 steps. The records fall at
    steps 4, 8 and 10 as JAX's, each with that call's last step's values
    (JAX's m[-1]), and the run equals the port at k = 1 bit for bit."""
    over = {"model.model": "vqa_baseline", "train.steps_per_call": 4}
    init, want = _jax_run(over, tmp_path / "jax", loop, 10)
    state, got = _port_run(over, tmp_path / "k4", loop, 10, init)
    assert state.step == 10
    _, single = _port_run(dict(over, **{"train.steps_per_call": 1,
                                        "train.log_every": 1}),
                          tmp_path / "k1", loop, 10, init)
    _assert_bit_equal(got, single)
    rj, rt = _records(tmp_path / "jax"), _records(tmp_path / "k4")
    assert sorted(rt) == sorted(rj) == [4, 8, 10]
    every = _records(tmp_path / "k1")
    for step in rj:
        for key in ("train/loss", "train/accuracy", "train/grad_norm",
                    "train/lr"):
            np.testing.assert_allclose(rt[step][key], rj[step][key],
                                       rtol=1e-5, err_msg=f"{step} {key}")
            assert rt[step][key] == every[step][key], (step, key)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **TOL)


def test_multi_segment_restaging_at_k2(tmp_path):
    """fit_resident at k = 2 re-staging its index table every 4 steps
    (segments of whole calls) trains as one segment does, bit for bit
    (``tests/test_trainer.py``'s multi-segment test)."""
    over = {"model.model": "vqa_baseline", "train.steps_per_call": 2}
    _, one = _port_run(over, tmp_path / "one", "resident", 12)
    state, many = _port_run(over, tmp_path / "many", "resident", 12, seg=4)
    assert state.step == 12
    _assert_bit_equal(many, one)


def test_resident_segments_are_whole_calls(tmp_path, monkeypatch):
    """At k = 4 a segment of 6 steps is cut to 4 (whole calls); 10 steps
    stage segments of 4, 4 and the 2 steps left, each step's rows once."""
    staged = []
    real = torch.from_numpy

    def spy(a):
        if a.dtype == np.int32 and a.shape[1:] == (16,):  # index rows
            staged.append(a.copy())
        return real(a)

    cfg = Config().replace_flat(dict(TINY, **{"model.model": "vqa_baseline",
                                              "train.steps_per_call": 4}))
    tr = tt.Trainer(cfg, build_model(cfg), train_dir=str(tmp_path),
                    device="cpu")
    tr.resident_segment_steps = 6
    ds = tds.load_dataset(cfg, "train")
    monkeypatch.setattr(tt.torch, "from_numpy", spy)
    tr.fit_resident(ds, tr.init_state(), max_steps=10)
    tr.close()
    monkeypatch.undo()
    assert [s.shape[0] for s in staged] == [4, 4, 2]
    rows = ds.index_batches(16, seed=cfg.train.seed)
    want = [next(rows) for _ in range(10)]
    np.testing.assert_array_equal(np.concatenate(staged), want)


def test_eager_body_equals_single_steps(tmp_path):
    """The body a graph captures (``Trainer._steps`` over k batches and a
    [k, 3] table of AdamW's host numbers), run eagerly, equals k calls of
    ``train_step`` bit for bit: parameters, moments, the counters, and the
    last step's metrics. Dropout on: both draw the same masks."""
    cfg = Config().replace_flat(dict(TINY, **{"model.dropout": 0.5}))
    ds = tds.load_dataset(cfg, "train")
    out = []
    for fused in (False, True):
        spec = build_model(cfg, generator=torch.Generator().manual_seed(0))
        tr = tt.Trainer(cfg, spec, train_dir=str(tmp_path / str(fused)),
                        device="cpu")
        _, make_batch, _ = tr._prepare_resident(ds)
        idx = [torch.from_numpy(i) for i, _ in zip(
            ds.index_batches(16, seed=1), range(3))]
        state = tr.init_state()
        if fused:
            metrics = tr._steps(state, lambda i: make_batch(idx[i]),
                                tr._table(state, 3))
            state = tt._advance(state, 3)
        else:
            for i in range(3):
                state, metrics = tr.train_step(state, make_batch(idx[i]))
        out.append((state, metrics))
        tr.close()
    (a, ma), (b, mb) = out
    assert a.step == b.step == a.opt_state.count == b.opt_state.count == 3
    for name in a.params:
        assert torch.equal(a.params[name], b.params[name]), name
    for name in a.opt_state.mu:
        assert torch.equal(a.opt_state.mu[name], b.opt_state.mu[name])
        assert torch.equal(a.opt_state.nu[name], b.opt_state.nu[name])
    assert torch.equal(a.rng.get_state(), b.rng.get_state())
    assert ma.keys() == mb.keys()
    for key in ma:
        assert torch.equal(ma[key], mb[key]), key


def test_graphs_are_recaptured_for_new_state_tensors():
    """The graph cache keeps its graphs while the state's tensors are the
    same objects at the same addresses, and drops them all when any is
    another (``init_state``, ``restore``)."""
    cfg = Config().replace_flat(TINY)
    tr = tt.Trainer(cfg, build_model(cfg), train_dir=None, device="cpu")
    cache = tt._GraphCache()
    built = []

    def build():
        built.append(object())
        return built[-1]

    state = tr.init_state()
    first = cache.get(state, ("k", 4), build)
    assert cache.get(state, ("k", 4), build) is first
    assert cache.get(state, ("k", 2), build) is built[1]
    moved = tt._advance(state, 4)  # counters only: the same tensors
    assert cache.get(moved, ("k", 4), build) is first
    fresh = tr.init_state()  # new moments and generator
    again = cache.get(fresh, ("k", 4), build)
    assert again is built[2] and len(built) == 3
    tr.close()
