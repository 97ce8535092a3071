"""Port parity: parallel/trainer.py ``fit_resident``, the datasets and the
train CLI against the JAX package.

``fit_resident`` runs 6 steps on the CPU in float32 with dropout 0 from
the same (bridged) parameters as JAX ``Trainer.fit_resident`` on one CPU
device, whose attention is the Pallas B3/B4 pair and whose GRU is B1/B2 in
interpret mode. Tolerance: params rtol 2e-4 / atol 2e-5 (the JAX package's
own bound for two implementations of the resident step: Adam divides by
sqrt(nu), so a gradient entry near zero turns f32 summation-order noise
into an update difference of up to lr), logged losses rtol 1e-5.
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
from vqa_transfer_externaldata_torch.cli import train as train_cli
from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.data import datasets as tds
from vqa_transfer_externaldata_torch.models.zoo import build_model
from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
from vqa_transfer_externaldata_torch.serving import Predictor
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
    "train.log_every": 2, "train.warmup_steps": 2,
    "train.learning_rate": 3e-3,
}


def _losses(train_dir):
    with open(os.path.join(train_dir, "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    return {r["step"]: r["train/loss"] for r in recs if "train/loss" in r}


def test_fit_resident_matches_jax(tmp_path):
    jcfg = JaxConfig().replace_flat(TINY)
    spec = jax_build(jcfg)
    jtr = JaxTrainer(jcfg, spec, mesh=create_mesh(
        jcfg, devices=jax.devices()[:1]), train_dir=str(tmp_path / "jax"))
    jds_train = jds.load_dataset(jcfg, "train")
    js = jtr.init_state(next(jds_train.batches(1, epochs=1, shuffle=False)))
    params = params_from_flax(jax.device_get(js.params))
    js = jtr.fit_resident(jds_train, js, max_steps=6)
    want = params_from_flax(jax.device_get(js.params))
    jtr.close()

    cfg = Config().replace_flat(TINY)
    tr = Trainer(cfg, build_model(cfg), train_dir=str(tmp_path / "torch"),
                 device="cpu")
    assert tr.model.store_prenormalized
    s = tr.init_state(params)
    s = tr.fit_resident(tds.load_dataset(cfg, "train"), s, max_steps=6)
    tr.close()
    assert s.step == 6
    got = tr.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
    lj, lt = _losses(tmp_path / "jax"), _losses(tmp_path / "torch")
    assert sorted(lt) == sorted(lj) == [2, 4, 6]
    for step in lj:
        np.testing.assert_allclose(lt[step], lj[step], rtol=1e-5)


def test_segment_restaging_keeps_the_index_stream(tmp_path, monkeypatch):
    """fit_resident stages its index table in segments; re-staging every
    2 steps trains exactly as one segment does."""
    cfg = Config().replace_flat(TINY)
    runs = []
    for seg in (2048, 2):
        monkeypatch.setattr(Trainer, "resident_segment_steps", seg)
        spec = build_model(cfg, generator=torch.Generator().manual_seed(0))
        tr = Trainer(cfg, spec, train_dir=str(tmp_path / str(seg)),
                     device="cpu")
        tr.fit_resident(tds.load_dataset(cfg, "train"), tr.init_state(),
                        max_steps=5)
        tr.close()
        runs.append(spec.module.state_dict())
    for k in runs[0]:
        torch.testing.assert_close(runs[1][k], runs[0][k], rtol=0, atol=0)


def test_trainer_defaults_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config().replace_flat(TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, build_model(cfg), train_dir=str(tmp_path))


def test_synthetic_joined_arrays_and_index_stream_equal_jax():
    over = dict(TINY, **{"data.synthetic_size": 96})
    want = jds.load_dataset(JaxConfig().replace_flat(over), "val")
    got = tds.load_dataset(Config().replace_flat(over), "val")
    assert type(got).__name__ == "JoinedDataset"
    assert sorted(got.arrays) == sorted(want.arrays)
    for k in want.arrays:
        np.testing.assert_array_equal(got.arrays[k], want.arrays[k],
                                      err_msg=k)
    np.testing.assert_array_equal(got.store.grid, want.store.grid)
    np.testing.assert_array_equal(got.store.pool5, want.store.pool5)
    # 96 rows in batches of 16 over 3 epochs: epoch boundaries included.
    sj = want.index_batches(16, seed=7)
    st = got.index_batches(16, seed=7)
    for _ in range(18):
        a, b = next(st), next(sj)
        assert b.dtype == a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    bt = next(got.batches(5, seed=3))
    bj = next(want.batches(5, seed=3))
    for k in bj:
        np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)


def test_train_cli_run_is_served_by_predictor(tmp_path):
    argv = ["--device", "cpu", "--train.max_steps", "4",
            "--train.train_dir", str(tmp_path / "run")]
    for k, v in TINY.items():
        argv += [f"--{k}", str(v).lower() if isinstance(v, bool) else str(v)]
    train_dir = train_cli.main(argv)
    for name in ("config.json", "metrics.jsonl", "params_final.pt"):
        assert os.path.exists(os.path.join(train_dir, name)), name
    losses = _losses(train_dir)
    assert sorted(losses) == [2, 4] and all(np.isfinite(list(losses.values())))
    pred = Predictor(train_dir, batch_size=4, device="cpu")
    rng = np.random.default_rng(0)
    feats = np.abs(rng.normal(size=(3, 9, 16))).astype(np.float32)
    answers = pred.answer(feats, ["w1 w2", "w3", "w4 w5 w6"])
    assert len(answers) == 3
    assert all(a in pred.answer_vocab.tokens for a in answers)


@pytest.mark.parametrize("over,item", [
    ({"data.input_pipeline": "grain"}, "data_iter_4.json"),
])
def test_unported_cli_paths_name_their_roadmap_item(over, item, tmp_path):
    """The CLI paths that once raised with their ROADMAP item now run: the
    grain pipeline streams the joined corpus through ``Trainer.fit`` (the
    asked-for device cache ignored) and saves its iterator state beside
    the final checkpoint."""
    argv = ["--device", "cpu", "--train.train_dir", str(tmp_path),
            "--train.max_steps", "4"]
    for k, v in dict(TINY, **over).items():
        argv += [f"--{k}", str(v).lower() if isinstance(v, bool) else str(v)]
    train_dir = train_cli.main(argv)
    assert sorted(_losses(train_dir)) == [2, 4]
    assert os.path.exists(os.path.join(train_dir, "ckpt", item))


def test_train_cli_streams_raw_images(tmp_path):
    """``cli.train`` of ``vqa_end2end`` on JPEG artifacts
    (``data.image_dir``): the ImageQuestionDataset streams through
    ``Trainer.fit`` even with ``train.device_data_cache`` (it is not an
    ArrayDataset, as in the JAX package's CLI); the frozen backbone comes
    out of training unchanged, and the run serves decoded images."""
    from test_torch_end2end import TINY_E2E, argv_of, write_jpeg_artifacts
    from vqa_transfer_externaldata_torch.data.ingest import (
        _decode_pil, coco_image_path)
    from vqa_transfer_externaldata_torch.utils.checkpoint import load_params

    fx = write_jpeg_artifacts(str(tmp_path))
    flat = dict(TINY_E2E, **{
        "data.synthetic": False, "data.dataset_dir": fx["data_dir"],
        "data.image_dir": fx["image_dir"], "train.max_steps": 3,
        "data.vocab_path": os.path.join(fx["data_dir"], "vocab.json"),
        "data.answer_vocab_path": os.path.join(fx["data_dir"],
                                               "answer_vocab.json")})
    cfg = Config().replace_flat(flat)
    start = build_model(
        cfg, generator=torch.Generator().manual_seed(cfg.train.seed)
    ).module.state_dict()
    train_dir = train_cli.main(["--device", "cpu", "--train.train_dir",
                                str(tmp_path / "run")] + argv_of(flat))
    losses = _losses(train_dir)
    assert sorted(losses) == [1, 2, 3]
    assert all(np.isfinite(list(losses.values())))
    final = load_params(os.path.join(train_dir, "params_final.pt"))
    assert set(final) == set(start)
    for k, v in start.items():
        if k.startswith("resnet."):
            torch.testing.assert_close(final[k], v, rtol=0, atol=0, msg=k)
    assert not torch.equal(final["head.att_wv"], start["head.att_wv"])
    pred = Predictor(train_dir, batch_size=2, device="cpu")
    image = _decode_pil(coco_image_path(fx["image_dir"], "val2014",
                                    int(fx["ids"][0])), 64)
    assert len(pred.answer(image[None].repeat(3, 0), ["w4", "w5", "w6"])) \
        == 3


def test_in_loop_eval_is_not_ported(tmp_path):
    """The in-loop evaluation of fit_resident runs at every eval_every-th
    step, each boundary's record written once, and the trained state is
    unchanged by it (the evaluation takes no step and draws no dropout)."""
    cfg = Config().replace_flat(dict(TINY, **{"train.eval_every": 2,
                                              "model.dropout": 0.5}))
    finals = []
    for eval_ds in (None, tds.load_dataset(cfg, "val")):
        spec = build_model(cfg, generator=torch.Generator().manual_seed(0))
        tr = Trainer(cfg, spec, train_dir=str(tmp_path / str(len(finals))),
                     device="cpu")
        tr.fit_resident(tds.load_dataset(cfg, "train"), tr.init_state(),
                        max_steps=5, eval_ds=eval_ds)
        tr.close()
        finals.append(spec.module.state_dict())
    for k in finals[0]:
        torch.testing.assert_close(finals[1][k], finals[0][k], rtol=0, atol=0)
    assert sorted(_records(tmp_path / "1", "val/loss")) == [2, 4]
    assert not _records(tmp_path / "0", "val/loss")


def _records(train_dir, key):
    with open(os.path.join(train_dir, "metrics.jsonl")) as fh:
        return {r["step"]: r for r in map(json.loads, fh) if key in r}


def _jax_trainer(over, train_dir):
    jcfg = JaxConfig().replace_flat(dict(TINY, **over))
    jtr = JaxTrainer(jcfg, jax_build(jcfg), mesh=create_mesh(
        jcfg, devices=jax.devices()[:1]), train_dir=str(train_dir))
    return jcfg, jtr


def _assert_params_match(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("loop", ["streamed_flat", "gathered_resident"])
def test_gathered_training_matches_jax(tmp_path, loop):
    """6 steps on gathered features against JAX's, from the same bridged
    parameters: ``Trainer.fit`` on streamed host batches of the flat layout
    against JAX ``Trainer.fit``, and ``fit_resident`` with
    ``resident_fused_attention`` false (the store gathered on the device)
    against JAX's. The port's attention runs K2's and K8's plain versions,
    JAX's XLA forward and explicit backward. Tolerances as the resident
    test's, with Adam's epsilon at 1e-3 on both sides: the two backwards
    form the score cotangent with sums in another order, and where it
    cancels to ~1e-8 Adam with its default epsilon would turn that noise
    into a step of up to lr; with 1e-3 such a gradient steps linearly (by
    noise), while the ones above 1e-3 still step by about lr."""
    over = ({"data.synthetic_layout": "flat",
             "train.device_data_cache": False} if loop == "streamed_flat"
            else {"train.resident_fused_attention": False})
    over["train.adam_eps"] = 1e-3
    jcfg, jtr = _jax_trainer(over, tmp_path / "jax")
    jtrain = jds.load_dataset(jcfg, "train")
    js = jtr.init_state(next(jtrain.batches(1, epochs=1, shuffle=False)))
    params = params_from_flax(jax.device_get(js.params))
    cfg = Config().replace_flat(dict(TINY, **over))
    tr = Trainer(cfg, build_model(cfg), train_dir=str(tmp_path / "torch"),
                 device="cpu")
    assert not tr.model.store_prenormalized
    s = tr.init_state(params)
    ttrain = tds.load_dataset(cfg, "train")
    if loop == "streamed_flat":
        js = jtr.fit(jtrain.batches(16, seed=cfg.train.seed), js,
                     max_steps=6)
        s = tr.fit(ttrain.batches(16, seed=cfg.train.seed), s, max_steps=6)
    else:
        js = jtr.fit_resident(jtrain, js, max_steps=6)
        s = tr.fit_resident(ttrain, s, max_steps=6)
    jtr.close()
    tr.close()
    assert s.step == 6
    _assert_params_match(tr.model.state_dict(),
                         params_from_flax(jax.device_get(js.params)))
    lj, lt = _losses(tmp_path / "jax"), _losses(tmp_path / "torch")
    assert sorted(lt) == sorted(lj) == [2, 4, 6]
    for step in lj:
        np.testing.assert_allclose(lt[step], lj[step], rtol=1e-5)


def test_flat_synthetic_arrays_equal_jax():
    over = dict(TINY, **{"data.synthetic_layout": "flat",
                         "data.synthetic_size": 40})
    for split in ("train", "val"):
        want = jds.load_dataset(JaxConfig().replace_flat(over), split)
        got = tds.load_dataset(Config().replace_flat(over), split)
        assert sorted(got.arrays) == sorted(want.arrays)
        for k in want.arrays:
            np.testing.assert_array_equal(got.arrays[k], want.arrays[k],
                                          err_msg=k)


def test_lagged_in_loop_eval_records_match_jax(tmp_path):
    """The val records of fit_resident's lagged in-loop evaluation (eval
    every 2 steps, collected one log window late) against JAX's, from the
    same bridged parameters: the resident evaluator on the gather-free
    store, K4's plain version against B3 interpreted."""
    over = {"train.eval_every": 2}
    jcfg, jtr = _jax_trainer(over, tmp_path / "jax")
    jtrain = jds.load_dataset(jcfg, "train")
    js = jtr.init_state(next(jtrain.batches(1, epochs=1, shuffle=False)))
    params = params_from_flax(jax.device_get(js.params))
    jtr.fit_resident(jtrain, js, max_steps=4,
                     eval_ds=jds.load_dataset(jcfg, "val"))
    jtr.close()
    cfg = Config().replace_flat(dict(TINY, **over))
    tr = Trainer(cfg, build_model(cfg), train_dir=str(tmp_path / "torch"),
                 device="cpu")
    tr.fit_resident(tds.load_dataset(cfg, "train"), tr.init_state(params),
                    max_steps=4, eval_ds=tds.load_dataset(cfg, "val"))
    tr.close()
    want = _records(tmp_path / "jax", "val/loss")
    got = _records(tmp_path / "torch", "val/loss")
    assert sorted(got) == sorted(want) == [2, 4]
    for step in want:
        keys = {k for k in want[step] if k.startswith("val/")}
        assert keys == {k for k in got[step] if k.startswith("val/")}
        for k in keys:
            np.testing.assert_allclose(got[step][k], want[step][k],
                                       rtol=1e-5, err_msg=f"{step} {k}")
