"""Port parity: parallel/evaler.py (``padded_batches``, ``evaluate_split``),
the trainer's two evaluators and the eval CLI.

``evaluate_split`` runs against the JAX package's on the same (bridged)
parameters, in float32, whose eval forward runs B1 and B5 interpreted: the
predictions are equal and the metrics agree to 1e-5 (the same forward with
sums in another order; accuracies are means of 0/1 over the same
predictions).
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
from vqa_transfer_externaldata_tpu.parallel import evaler as jev
from vqa_transfer_externaldata_tpu.parallel.mesh import create_mesh
from vqa_transfer_externaldata_tpu.parallel.trainer import Trainer as JaxTrainer
from vqa_transfer_externaldata_torch.cli import eval as eval_cli
from vqa_transfer_externaldata_torch.cli import train as train_cli
from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.data import datasets as tds
from vqa_transfer_externaldata_torch.data.datasets import (
    ArrayDataset, synthetic_vocabs)
from vqa_transfer_externaldata_torch.models.zoo import build_model
from vqa_transfer_externaldata_torch.parallel import evaler as tev
from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
from vqa_transfer_externaldata_torch.utils.checkpoint import load_params
from vqa_transfer_externaldata_torch.utils.convert import params_from_flax

torch.set_num_threads(2)  # xdist runs several workers on the same cores

TINY = {
    "data.synthetic": True, "data.synthetic_layout": "flat",
    "data.synthetic_size": 40, "data.vocab_size": 64,
    "data.num_answers": 16, "data.grid_h": 3, "data.grid_w": 3,
    "data.feature_dim": 16, "data.pool5_dim": 16,
    "data.max_question_len": 6, "model.word_dim": 8, "model.rnn_dim": 8,
    "model.fusion_dim": 16, "model.att_hidden": 8, "model.answer_dim": 8,
    "model.dtype": "float32", "model.dropout": 0.0,
    "train.batch_size": 16, "train.warmup_steps": 2,
    "train.learning_rate": 3e-3,
}
TYPES = {"answer_types": ["yes/no", "number", "other"],
         "question_types": ["what color", "how many", "is the"]}


def test_padded_batches_equal_jax():
    rng = np.random.default_rng(0)
    arrays = {"q_ids": rng.integers(0, 9, size=(10, 3)).astype(np.int32),
              "answer_id": rng.integers(4, 9, size=10).astype(np.int32)}
    for bs in (4, 5):
        jgen, jn = jev.padded_batches(jds.ArrayDataset(dict(arrays)), bs)
        tgen, tn = tev.padded_batches(ArrayDataset(dict(arrays)), bs)
        jb, tb = list(jgen), list(tgen)
        assert tn == jn == 10 and len(tb) == len(jb)
        for a, b in zip(tb, jb):
            assert sorted(a) == sorted(b)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _with_types(ds, seed=1):
    rng = np.random.default_rng(seed)
    ds.arrays["answer_type_id"] = rng.integers(0, 3, size=len(ds))
    ds.arrays["question_type_id"] = rng.integers(0, 3, size=len(ds))
    return ds


@pytest.mark.parametrize("resident", [False, True])
def test_evaluate_split_matches_jax(tmp_path, resident):
    """evaluate_split over a flat val split of 40 rows in batches of 16 (a
    padded tail), with held-out answer ids and type tables, streamed or
    device-resident, against JAX's from the same parameters: equal
    predictions and result JSON, every metric within 1e-5."""
    over = dict(TINY, **{"train.device_data_cache": resident})
    jcfg = JaxConfig().replace_flat(over)
    jtr = JaxTrainer(jcfg, jax_build(jcfg), mesh=create_mesh(
        jcfg, devices=jax.devices()[:1]), train_dir=str(tmp_path / "jax"))
    jval = _with_types(jds.load_dataset(jcfg, "val"))
    js = jtr.init_state(next(jval.batches(1, epochs=1, shuffle=False)))
    cfg = Config().replace_flat(over)
    tr = Trainer(cfg, build_model(cfg), train_dir=str(tmp_path / "torch"),
                 device="cpu")
    state = tr.init_state(params_from_flax(jax.device_get(js.params)))
    tval = _with_types(tds.load_dataset(cfg, "val"))
    oov = np.unique(tval.arrays["answer_id"])[:2]
    _, answers = synthetic_vocabs(cfg)
    kw = dict(answer_vocab=answers, oov_answer_ids=oov, type_tables=TYPES)
    jm, jp = jev.evaluate_split(jtr, js, jval,
                                results_path=str(tmp_path / "j.json"), **kw)
    tm, tp = tev.evaluate_split(tr, state, tval,
                                results_path=str(tmp_path / "t.json"), **kw)
    jtr.close()
    tr.close()
    np.testing.assert_array_equal(tp, jp)
    assert "vqa_accuracy_oov_answers" in tm
    assert "vqa_accuracy_answer_type/yes_no" in tm
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    with open(tmp_path / "j.json") as fj, open(tmp_path / "t.json") as ft:
        results = json.load(ft)
        assert results == json.load(fj)
    assert len(results) == 40


@pytest.mark.parametrize("fused", [True, False])
def test_evaluate_resident_equals_evaluate(tmp_path, fused):
    """The resident evaluator over a joined split of 100 questions in
    batches of 16 (the last batch padded) equals the streamed evaluate()
    over padded_batches: the same predictions, metrics within 1e-5 (the
    store is normalized at upload on the gather-free path, in the op on
    the streamed one)."""
    over = dict(TINY, **{"data.synthetic_layout": "joined",
                         "data.synthetic_size": 100,
                         "train.device_data_cache": True,
                         "train.resident_fused_attention": fused})
    cfg = Config().replace_flat(over)
    tr = Trainer(cfg, build_model(cfg, generator=torch.Generator()
                                  .manual_seed(3)),
                 train_dir=str(tmp_path), device="cpu")
    state = tr.init_state()
    ds = tds.load_dataset(cfg, "val")
    m_stream, p_stream = tr.evaluate(state, tev.padded_batches(ds, 16)[0])
    m_res, p_res = tr.evaluate_resident(state, ds)
    tr.close()
    assert p_res.shape == (100,) and p_stream.shape == (112,)
    np.testing.assert_array_equal(p_res, p_stream[:100])
    assert set(m_stream) == {"loss", "accuracy", "vqa_accuracy"}
    assert set(m_res) == set(m_stream)
    for k in m_stream:
        np.testing.assert_allclose(m_res[k], m_stream[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_stage1_eval_reports_loss_metrics(tmp_path):
    """A stage-1 split carries 'label', not 'answer_id': both evaluators
    take the loss metrics through ModelSpec.label_key, and agree."""
    cfg = Config().replace_flat({
        "data.synthetic": True, "data.synthetic_size": 40,
        "data.vocab_size": 64, "data.pool5_dim": 16, "model.model": "vlmap",
        "model.word_dim": 8, "model.task_dim": 4, "model.num_tasks": 4,
        "model.num_candidates": 8, "model.dtype": "float32",
        "model.dropout": 0.0, "train.batch_size": 16})
    spec = build_model(cfg, generator=torch.Generator().manual_seed(4))
    assert spec.label_key == "label"
    tr = Trainer(cfg, spec, train_dir=str(tmp_path), device="cpu")
    state = tr.init_state()
    ds = tds.load_dataset(cfg, "val", stage=spec.stage)
    m, p = tr.evaluate(state, tev.padded_batches(ds, 16)[0])
    m_res, p_res = tr.evaluate_resident(state, ds)
    tr.close()
    assert set(m) == {"loss", "accuracy"} and np.isfinite(m["loss"])
    np.testing.assert_array_equal(p_res, p[:40])
    for k in m:
        np.testing.assert_allclose(m_res[k], m[k], rtol=1e-5, err_msg=k)


def test_label_less_split_gets_predictions_only(tmp_path):
    cfg = Config().replace_flat(TINY)
    tr = Trainer(cfg, build_model(cfg), train_dir=str(tmp_path),
                 device="cpu")
    ds = tds.load_dataset(cfg, "val")
    del ds.arrays["answer_id"], ds.arrays["answer_scores"]
    m, p = tev.evaluate_split(tr, tr.init_state(), ds)
    tr.close()
    assert m == {} and p.shape == (40,)


def test_train_then_eval_cli(tmp_path, capsys):
    """cli.train (streamed, flat) then cli.eval on its run directory: the
    eval adopts the run's config.json, restores the latest checkpoint (or
    the one named), writes results_val.json with a row per val question
    and prints one JSON line whose metrics equal evaluate_split's on the
    final parameters."""
    run = str(tmp_path / "run")
    argv = ["--device", "cpu", "--train.max_steps", "4",
            "--train.checkpoint_every", "2", "--train.train_dir", run]
    for k, v in TINY.items():
        argv += [f"--{k}", str(v).lower() if isinstance(v, bool) else str(v)]
    train_cli.main(argv)
    capsys.readouterr()
    metrics = eval_cli.main(["--device", "cpu", "--train.train_dir", run])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["split"] == "val" and line["step"] == 4
    with open(os.path.join(run, "results_val.json")) as fh:
        results = json.load(fh)
    assert len(results) == 40
    cfg = Config().replace_flat(TINY)
    tr = Trainer(cfg, build_model(cfg), train_dir=str(tmp_path / "t"),
                 device="cpu")
    state = tr.init_state(load_params(os.path.join(run, "params_final.pt")))
    want, _ = tev.evaluate_split(tr, state, tds.load_dataset(cfg, "val"))
    tr.close()
    assert metrics == pytest.approx(want, rel=1e-6)
    eval_cli.main(["--device", "cpu", "--train.train_dir", run,
                   "--checkpoint_step", "2", "--results_path",
                   str(tmp_path / "at2.json")])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "step"] == 2
