"""Port parity on preprocessed artifacts: the artifact branch of
``load_dataset`` (npz/hdf5 tables, the lazy join against npz, hdf5 and raw
feature stores, the candidate resampler, the dense-count gate) against the
JAX package's on the same files, bit for bit; the two join faults that a
stage-1 region store reached (the lazy join and the resident upload of
``feature``); and the CLI path preprocess -> ``cli.train`` ->
``cli.eval`` -> ``cli.predict`` on the CPU, streamed, resident, on the
int8 store, and for stage 1 on a region store.

The fixtures are written by the tests (``test_torch_preprocess.py``'s
official-schema JSON and regions; feature stores written with numpy, in
place of the JAX tests' ResNet extraction). Training runs in float32 with
dropout 0; the resident and the streamed first steps agree to 1e-6
relative (the same batch, feature rows gathered on the device or on the
host)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_transfer_externaldata_tpu.config import Config as JaxConfig
from vqa_transfer_externaldata_tpu.data import datasets as jds
from vqa_transfer_externaldata_tpu.data import features as jfeatures
from vqa_transfer_externaldata_tpu.data import visualgenome as jvg
from vqa_transfer_externaldata_tpu.models.zoo import build_model as jax_build
from vqa_transfer_externaldata_tpu.parallel.mesh import create_mesh
from vqa_transfer_externaldata_tpu.parallel.trainer import Trainer as JaxTrainer
from vqa_transfer_externaldata_torch.cli import eval as eval_cli
from vqa_transfer_externaldata_torch.cli import predict as predict_cli
from vqa_transfer_externaldata_torch.cli import train as train_cli
from vqa_transfer_externaldata_torch.cli.preprocess import main as preprocess
from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.data import datasets as tds
from vqa_transfer_externaldata_torch.data import features as tfeatures
from vqa_transfer_externaldata_torch.data import visualgenome as vg
from vqa_transfer_externaldata_torch.models.zoo import build_model
from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
from vqa_transfer_externaldata_torch.serving import Predictor

from test_torch_preprocess import write_regions, write_vqa_json

torch.set_num_threads(2)  # xdist runs several workers on the same cores

C = 16  # channels of the tests' feature stores (grid and pool5)


def write_store(path, image_ids, fmt, grid_hw=2, seed=0):
    """A feature store of ``len(image_ids)`` rows in the extractor's
    layout (f16 [M, g, g, C] grids, f32 [M, C] pool5), as an npz file, an
    hdf5 file or a raw directory."""
    rng = np.random.default_rng(seed)
    m = len(image_ids)
    grid = rng.normal(size=(m, grid_hw, grid_hw, C)).astype(np.float16)
    pool5 = rng.normal(size=(m, C)).astype(np.float32)
    ids = np.asarray(image_ids, np.int64)
    if fmt == "npz":
        path += ".npz"
        np.savez(path, grid=grid, pool5=pool5, image_ids=ids)
    elif fmt == "hdf5":
        import h5py

        path += ".hdf5"
        with h5py.File(path, "w") as f:
            f["grid"], f["pool5"], f["image_ids"] = grid, pool5, ids
    else:
        os.makedirs(path)
        grid.tofile(os.path.join(path, "grid.f16.bin"))
        pool5.tofile(os.path.join(path, "pool5.f32.bin"))
        np.save(os.path.join(path, "image_ids.npy"), ids)
        with open(os.path.join(path, "meta.json"), "w") as fh:
            json.dump({"grid_shape": list(grid.shape), "pool5_dim": C}, fh)
    return path


def vqa_artifacts(root, fmt="hdf5", holdout=0.0):
    """The VQA fixture preprocessed by the port's CLI against a store of
    its three images (``image_index`` from the store)."""
    qp, ap = write_vqa_json(root)
    store = write_store(os.path.join(root, "feat"), [102, 100, 101], fmt)
    out = os.path.join(root, "pre")
    preprocess(["vqa_v2", "--out_dir", out, "--train_questions", qp,
                "--train_annotations", ap, "--val_questions", qp,
                "--val_annotations", ap, "--top_k", "8",
                "--max_question_len", "8", "--vocab_pad_to", "64",
                "--answer_holdout_fraction", str(holdout),
                "--feature_path", store])
    return out, store


def vg_artifacts(root, fmt="raw"):
    """The regions fixture preprocessed by the port's CLI, and a region
    store (row r = region r, a 1x1 grid: stage 1 reads pool5 only)."""
    rp, vp = write_regions(root)
    out = os.path.join(root, "vg")
    preprocess(["visualgenome", "--out_dir", out, "--region_descriptions",
                rp, "--vocab", vp, "--num_tasks", "2", "--num_candidates",
                "4", "--min_word_count", "1", "--max_desc_len", "6"])
    n_regions = np.load(os.path.join(out, "region_meta.npz"))[
        "image_id"].shape[0]
    store = write_store(os.path.join(root, "regions"),
                        np.arange(n_regions), fmt, grid_hw=1, seed=1)
    return out, store, vp


def _both(flat):
    return JaxConfig().replace_flat(flat), Config().replace_flat(flat)


def assert_batches_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in b:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("fmt", ["npz", "hdf5", "raw"])
def test_stage2_artifacts_load_as_in_jax(tmp_path, fmt):
    out, store = vqa_artifacts(str(tmp_path), fmt)
    flat = {"data.dataset_dir": out, "data.feature_path": store}
    jcfg, cfg = _both(flat)
    idx = np.array([7, 0, 3, 3, 5])
    for split in ("train", "val", "test"):
        if split == "test":
            with pytest.raises(FileNotFoundError, match="cli.preprocess"):
                tds.load_dataset(cfg, split)
            continue
        ours, theirs = tds.load_dataset(cfg, split), \
            jds.load_dataset(jcfg, split)
        assert isinstance(ours, tfeatures.JoinedDataset)
        assert (ours.index_key, ours.feature_keys) == \
            (theirs.index_key, theirs.feature_keys)
        assert_batches_equal(ours.take(idx), theirs.take(idx))
        for a, b in zip(ours.batches(3, seed=4, epochs=2),
                        theirs.batches(3, seed=4, epochs=2)):
            assert_batches_equal(a, b)
        assert ours.take(idx)["features"].shape == (5, 4, C)


@pytest.mark.parametrize("table", ["npz", "hdf5"])
def test_tables_without_a_store_load_as_in_jax(tmp_path, table):
    out, _ = vqa_artifacts(str(tmp_path))
    if table == "hdf5":
        import h5py

        for split in ("train", "val"):
            src = os.path.join(out, f"vqa_{split}.npz")
            with np.load(src) as f, h5py.File(src[:-4] + ".hdf5", "w") as h:
                for k in f.files:
                    h[k] = f[k]
            os.remove(src)
    jcfg, cfg = _both({"data.dataset_dir": out})
    for split in ("train", "val"):
        ours, theirs = tds.load_dataset(cfg, split), \
            jds.load_dataset(jcfg, split)
        assert type(ours) is tds.ArrayDataset
        assert_batches_equal(ours.arrays, theirs.arrays)
    saved = str(tmp_path / "saved.npz")
    ours.save(saved)
    assert_batches_equal(tds.ArrayDataset.load(saved).arrays,
                         jds.ArrayDataset.load(saved).arrays)


@pytest.mark.parametrize("stage", ["vlmap", "vlmap_desc"])
@pytest.mark.parametrize("resample", [True, False])
@pytest.mark.parametrize("fmt", ["npz", "raw"])
def test_stage1_artifacts_load_as_in_jax(tmp_path, stage, resample, fmt):
    """A region store joined into ``feature`` (the region's pool5), with
    and without the resampler: the train batches and the val rows equal
    JAX's."""
    out, store, _ = vg_artifacts(str(tmp_path), fmt)
    jcfg, cfg = _both({"data.dataset_dir": out, "data.feature_path": store,
                       "data.resample_negatives": resample,
                       "model.num_candidates": 4})
    ours, theirs = tds.load_dataset(cfg, "train", stage=stage), \
        jds.load_dataset(jcfg, "train", stage=stage)
    assert isinstance(ours, vg.CandidateResampler) == resample
    assert isinstance(theirs, jvg.CandidateResampler) == resample
    got = list(ours.batches(4, seed=1, epochs=2))
    want = list(theirs.batches(4, seed=1, epochs=2))
    assert len(got) == len(want) > 2
    for a, b in zip(got, want):
        assert_batches_equal(a, b)
        assert a["feature"].shape == (4, C)
    val, jval = tds.load_dataset(cfg, "val", stage=stage), \
        jds.load_dataset(jcfg, "val", stage=stage)
    idx = np.arange(len(jval))
    assert_batches_equal(val.take(idx), jval.take(idx))


def test_region_join_takes_pool5_as_feature(tmp_path):
    """The lazy join of a region table: ``feature`` is the region's pool5
    (it raised KeyError: 'feature' before), as JAX's ``take`` gives it."""
    out, store, _ = vg_artifacts(str(tmp_path))
    arrays = dict(np.load(os.path.join(out, "vlmap_train.npz")))
    ours = tfeatures.JoinedDataset(arrays, tfeatures.FeatureStore(store),
                                   index_key="region_index",
                                   feature_keys=("feature",))
    theirs = jfeatures.JoinedDataset(arrays, jfeatures.FeatureStore(store),
                                     index_key="region_index",
                                     feature_keys=("feature",))
    idx = np.array([2, 0, 2, 1])
    a, b = ours.take(idx), theirs.take(idx)
    assert_batches_equal(a, b)
    np.testing.assert_array_equal(
        a["feature"], ours.store.gather(arrays["region_index"][idx])["pool5"])


def test_resident_region_join_gathers_feature(tmp_path):
    """The resident upload of a region store: ``make_batch`` takes each
    region's pool5 into ``feature`` (it gave no ``feature`` before), as
    JAX's resident ``make_batch`` and its lazy ``take`` do."""
    out, store, _ = vg_artifacts(str(tmp_path))
    flat = {"data.dataset_dir": out, "data.feature_path": store,
            "data.resample_negatives": False, "data.vocab_size": 64,
            "data.pool5_dim": C, "model.model": "vlmap",
            "model.num_candidates": 4, "model.num_tasks": 2,
            "model.word_dim": 8, "model.task_dim": 4,
            "model.dtype": "float32", "train.device_data_cache": True}
    jcfg, cfg = _both(flat)
    ds, jds_ = tds.load_dataset(cfg, "train", stage="vlmap"), \
        jds.load_dataset(jcfg, "train", stage="vlmap")
    tr = Trainer(cfg, build_model(cfg), train_dir=str(tmp_path / "t"),
                 device="cpu")
    data, make_batch, _ = tr._prepare_resident(ds)
    tr.close()
    assert "grid" not in data  # stage 1 reads pool5 only
    jtr = JaxTrainer(jcfg, jax_build(jcfg), mesh=create_mesh(
        jcfg, devices=jax.devices()[:1]), train_dir=str(tmp_path / "j"))
    jdata, jmake_batch, _ = jtr._prepare_resident(jds_)
    jtr.close()
    idx = np.array([3, 0, 1, 3], np.int32)
    got = make_batch(torch.from_numpy(idx))
    want = jax.device_get(jmake_batch(jnp.asarray(idx), jdata))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(got["feature"].numpy(),
                                  jds_.take(idx)["feature"])


def test_dense_counts_follow_the_consumer(tmp_path):
    """Stored candidate counts where the stored sets train (resident, or
    no resampler); a streamed resampler counts each draw instead; past
    16 GB of counts the loader refuses, as JAX's does."""
    out, store, _ = vg_artifacts(str(tmp_path))
    base = {"data.dataset_dir": out, "data.feature_path": store,
            "data.vocab_size": 64, "model.num_candidates": 4,
            "model.dense_candidate_loss": True}
    for resident, resample, stored in ((True, True, True),
                                       (False, True, False),
                                       (False, False, True)):
        jcfg, cfg = _both(dict(base, **{
            "train.device_data_cache": resident,
            "data.resample_negatives": resample}))
        ours, theirs = tds.load_dataset(cfg, "train", stage="vlmap"), \
            jds.load_dataset(jcfg, "train", stage="vlmap")
        assert ("cand_counts" in ours.arrays) == stored
        assert_batches_equal(ours.arrays, theirs.arrays)
        assert_batches_equal(next(ours.batches(4, seed=0)),
                             next(theirs.batches(4, seed=0)))
    huge = dict(base, **{"data.vocab_size": 2 ** 36,
                         "data.resample_negatives": False})
    for cfg, load in ((Config().replace_flat(huge), tds.load_dataset),
                      (JaxConfig().replace_flat(huge), jds.load_dataset)):
        with pytest.raises(ValueError, match="candidate-count array"):
            load(cfg, "train", stage="vlmap")


def test_raw_image_inputs_load_as_in_jax(tmp_path):
    """The raw-image branch on ``cli.preprocess vqa_v2``'s artifacts: the
    store's ``image_ids`` saved as ``image_ids.npy`` beside them, one JPEG
    per id under the split's COCO name; the port's ImageQuestionDataset
    has JAX's table, paths and batches (pixels within one 8-bit step of
    JAX's native decoder, bit-equal to its PIL one)."""
    from PIL import Image

    from vqa_transfer_externaldata_tpu.data import ingest as jingest
    from vqa_transfer_externaldata_torch.data import ingest

    out, store = vqa_artifacts(str(tmp_path))
    ids = tfeatures.FeatureStore(store).image_ids
    np.save(os.path.join(out, "image_ids.npy"), ids)
    images = tmp_path / "coco"
    images.mkdir()
    rng = np.random.default_rng(0)
    for i in ids:
        for split in ("train2014", "val2014"):
            Image.fromarray(rng.integers(0, 256, (40, 52, 3)).astype(
                np.uint8)).save(ingest.coco_image_path(str(images), split,
                                                       int(i)), quality=90)
    over = {"data.dataset_dir": out, "model.model": "vqa_end2end",
            "data.image_dir": str(images), "data.image_size": 32,
            "data.feature_path": store}
    for split in ("train", "val"):
        ours = tds.load_dataset(Config().replace_flat(over), split)
        theirs = jds.load_dataset(JaxConfig().replace_flat(over), split)
        assert isinstance(ours, ingest.ImageQuestionDataset)
        assert ours.image_paths == theirs.image_paths
        assert sorted(ours.arrays) == sorted(theirs.arrays)
        a, b = next(ours.batches(2, seed=1)), next(theirs.batches(2, seed=1))
        for k in b:
            if k == "images":
                assert a[k].shape == (2, 32, 32, 3) and a[k].dtype == np.uint8
                assert np.abs(a[k].astype(int) - b[k].astype(int)).max() <= 1
                for row, idx in zip(a[k], a["image_index"]):
                    np.testing.assert_array_equal(row, jingest._decode_pil(
                        ours.image_paths[idx], 32))
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        ours.close()
        theirs.close()
    cfg = Config().replace_flat(over)
    with pytest.raises(FileNotFoundError, match="no preprocessed"):
        tds.load_dataset(cfg.replace_flat(
            {"data.dataset_dir": str(tmp_path / "none")}), "train")


STAGE2 = ["--data.vocab_size", "64", "--data.num_answers", "12",
          "--data.grid_h", "2", "--data.grid_w", "2",
          "--data.feature_dim", str(C), "--data.pool5_dim", str(C),
          "--data.max_question_len", "8",
          "--model.model", "vqa_attention", "--model.word_dim", "8",
          "--model.rnn_dim", "8", "--model.fusion_dim", "16",
          "--model.att_hidden", "8", "--model.answer_dim", "8",
          "--model.dtype", "float32", "--model.dropout", "0.0",
          "--train.batch_size", "8", "--train.max_steps", "3",
          "--train.log_every", "1", "--train.checkpoint_every", "100"]


def _stage2_argv(out, store, run_dir, *extra):
    return ["--device", "cpu", "--data.dataset_dir", out,
            "--data.feature_path", store,
            "--data.vocab_path", os.path.join(out, "vocab.json"),
            "--data.answer_vocab_path", os.path.join(out, "answer_vocab.json"),
            "--train.train_dir", run_dir] + STAGE2 + list(extra)


@pytest.mark.parametrize("resident", [False, True])
def test_preprocess_train_eval_cli(tmp_path, resident):
    """The JAX package's real-artifact training test on the port: the
    type breakdowns, their weighted mix equal to the overall accuracy,
    every val question in ``results_val.json``; then ``cli.predict``
    answers by image id from the same store."""
    out, store = vqa_artifacts(str(tmp_path))
    train_dir = train_cli.main(_stage2_argv(
        out, store, str(tmp_path / "run"), "--train.eval_every", "2",
        "--train.device_data_cache", str(resident).lower()))
    assert os.path.exists(os.path.join(train_dir, "params_final.pt"))
    with open(os.path.join(train_dir, "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    assert [r["step"] for r in recs if "val/loss" in r] == [2]
    # batch 16 over 8 rows: the one batch is tail-padded through take().
    metrics = eval_cli.main(["--device", "cpu", "--train.train_dir",
                             train_dir, "--train.batch_size", "16"])
    assert "vqa_accuracy" in metrics
    for key in ("vqa_accuracy_answer_type/yes_no",
                "vqa_accuracy_answer_type/number",
                "vqa_accuracy_question_type/how_many"):
        assert key in metrics
    total = (2 * metrics["vqa_accuracy_answer_type/yes_no"]
             + 2 * metrics["vqa_accuracy_answer_type/number"]
             + 4 * metrics["vqa_accuracy_answer_type/other"]) / 8
    assert abs(total - metrics["vqa_accuracy"]) < 1e-6
    with open(os.path.join(train_dir, "results_val.json")) as fh:
        results = json.load(fh)
    assert [r["question_id"] for r in results] == list(range(0, 80, 10))
    assert {"question_id", "answer"} <= set(results[0])
    answers = predict_cli.main(["--device", "cpu", "--train_dir", train_dir,
                                "--feature_path", store,
                                "--image_id", "101", "--question",
                                "what color is the cat?", "--image_id",
                                "100", "--question", "how many dogs?"])
    pred = Predictor(train_dir, device="cpu")
    feats = tfeatures.FeatureStore(store).gather(np.array([2, 1]))
    assert answers == pred.answer(feats["features"], [
        "what color is the cat?", "how many dogs?"])


def test_oov_metrics_through_cli_eval(tmp_path):
    """With an answer holdout, ``cli.eval`` adds the OOV and in-vocabulary
    accuracies over the rows whose answers are held out or not."""
    out, store = vqa_artifacts(str(tmp_path), "raw", holdout=0.5)
    train_dir = train_cli.main(_stage2_argv(
        out, store, str(tmp_path / "run"), "--train.eval_every", "100"))
    metrics = eval_cli.main(["--device", "cpu", "--train.train_dir",
                             train_dir])
    oov = json.load(open(os.path.join(out, "oov_split.json")))["oov_ids"]
    val = np.load(os.path.join(out, "vqa_val.npz"))
    held = np.isin(val["answer_id"], oov)
    assert held.any() and (~held & (val["answer_id"] != 1)).any()
    assert 0.0 <= metrics["vqa_accuracy_oov_answers"] <= 1.0
    assert 0.0 <= metrics["vqa_accuracy_in_vocab_answers"] <= 1.0


def test_int8_store_through_train_and_eval_cli(tmp_path):
    out, store = vqa_artifacts(str(tmp_path))
    train_dir = train_cli.main(_stage2_argv(
        out, store, str(tmp_path / "run_int8"),
        "--train.device_data_cache", "true",
        "--train.resident_fused_attention", "true",
        "--train.store_quantize", "int8", "--train.eval_every", "10000"))
    with open(os.path.join(train_dir, "config.json")) as fh:
        assert json.load(fh)["train"]["store_quantize"] == "int8"
    metrics = eval_cli.main(["--device", "cpu", "--train.train_dir",
                             train_dir])
    assert "vqa_accuracy" in metrics and np.isfinite(metrics["loss"])


def test_artifacts_without_val_train(tmp_path):
    """A preprocessing without a val split trains with no in-loop
    evaluation, as the JAX CLI does."""
    qp, ap = write_vqa_json(str(tmp_path))
    store = write_store(str(tmp_path / "feat"), [100, 101, 102], "npz")
    out = str(tmp_path / "pre")
    preprocess(["vqa_v2", "--out_dir", out, "--train_questions", qp,
                "--train_annotations", ap, "--top_k", "8",
                "--max_question_len", "8", "--vocab_pad_to", "64",
                "--feature_path", store])
    train_dir = train_cli.main(_stage2_argv(
        out, store, str(tmp_path / "run"), "--train.eval_every", "1"))
    with open(os.path.join(train_dir, "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    assert not [r for r in recs if "val/loss" in r]
    assert max(r["step"] for r in recs) == 3


STAGE1 = ["--data.vocab_size", "64", "--data.pool5_dim", str(C),
          "--data.max_question_len", "6",
          "--model.model", "vlmap_description",
          "--model.bidirectional_desc", "true", "--model.word_dim", "8",
          "--model.rnn_dim", "8", "--model.task_dim", "4",
          "--model.num_tasks", "2", "--model.num_candidates", "4",
          "--model.dtype", "float32", "--model.dropout", "0.0",
          "--train.batch_size", "4", "--train.max_steps", "3",
          "--train.log_every", "1", "--train.eval_every", "2",
          "--train.checkpoint_every", "100"]


def _first_loss(train_dir):
    with open(os.path.join(train_dir, "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    return [r["train/loss"] for r in recs if r["step"] == 1
            and "train/loss" in r][0]


def test_stage1_on_a_region_store_resident_equals_streamed(tmp_path):
    """Stage 1 through ``cli.train`` on the description artifacts and a
    region store: resident (stored candidates; its ``feature`` from the
    uploaded store) and streamed over the same index stream give the same
    first-step loss; with resampled negatives the run streams (with a
    warning when the cache was asked for); ``cli.eval`` reports the val
    split's loss metrics."""
    out, store, vp = vg_artifacts(str(tmp_path))
    argv = ["--device", "cpu", "--data.dataset_dir", out,
            "--data.feature_path", store, "--data.vocab_path", vp] + STAGE1
    runs = {}
    for name, flags in (
            ("resident", ["--train.device_data_cache", "true",
                          "--data.resample_negatives", "false"]),
            ("streamed", ["--train.device_data_cache", "false",
                          "--data.resample_negatives", "false"]),
            ("resampled", ["--train.device_data_cache", "true"])):
        runs[name] = train_cli.main(
            argv + flags + ["--train.train_dir", str(tmp_path / name)])
    np.testing.assert_allclose(_first_loss(runs["resident"]),
                               _first_loss(runs["streamed"]), rtol=1e-6)
    assert np.isfinite(_first_loss(runs["resampled"]))
    metrics = eval_cli.main(["--device", "cpu", "--train.train_dir",
                             runs["resident"]])
    assert np.isfinite(metrics["loss"]) and 0 <= metrics["accuracy"] <= 1
