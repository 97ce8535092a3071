"""Port parity: ``data/grain_loader.py``, the iterator state beside each
checkpoint (``utils/checkpoint.py``), the Trainer's stateful input and the
``--data.input_pipeline grain`` branch of ``cli.train``, against the JAX
package.

The port's ``GrainTrainIterator`` and JAX's run in one process on the
same grain, over the same rows: their batches and ``get_state()`` must be
equal, draw for draw, bit for bit (the images decode through each
package's native decoder, built from the same source by the same
compiler). A grain run resumed from its step-4 checkpoint must end bit
for bit where an uninterrupted run ends (float32, dropout 0, as JAX's
``tests/test_cli.py::test_end2end_grain_pipeline_exact_resume``).
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from test_torch_end2end import TINY_E2E, argv_of, write_jpeg_artifacts
from vqa_transfer_externaldata_tpu.data import datasets as jds
from vqa_transfer_externaldata_tpu.data import features as jfeatures
from vqa_transfer_externaldata_tpu.data import grain_loader as jgrain
from vqa_transfer_externaldata_tpu.data import ingest as jingest
from vqa_transfer_externaldata_torch.cli import train as train_cli
from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.data import datasets as tds
from vqa_transfer_externaldata_torch.data import features as tfeatures
from vqa_transfer_externaldata_torch.data import grain_loader as tgrain
from vqa_transfer_externaldata_torch.data import ingest as tingest
from vqa_transfer_externaldata_torch.models.zoo import build_model
from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
from vqa_transfer_externaldata_torch.utils.checkpoint import (
    CheckpointManager, load_params)

torch.set_num_threads(2)  # xdist runs several workers on the same cores

SHARDS = [(0, 1), (0, 2), (1, 2)]
SOURCES = ["array", "joined", "images"]
DRAWS = 5  # past the end of the first epoch of every source and shard

TINY = {  # stage 2 on the joined synthetic corpus, as test_torch_trainer's
    "data.synthetic": True, "data.synthetic_layout": "joined",
    "data.synthetic_size": 64, "data.vocab_size": 64,
    "data.num_answers": 16, "data.grid_h": 3, "data.grid_w": 3,
    "data.feature_dim": 16, "data.pool5_dim": 16,
    "data.max_question_len": 6, "model.word_dim": 8, "model.rnn_dim": 8,
    "model.fusion_dim": 16, "model.att_hidden": 8, "model.answer_dim": 8,
    "model.dtype": "float32", "model.dropout": 0.0,
    "train.batch_size": 16, "train.log_every": 1,
    "train.warmup_steps": 2, "train.learning_rate": 3e-3,
    "data.input_pipeline": "grain",
}


def _rows(n, n_images, seed=0):
    rng = np.random.default_rng(seed)
    return {"q_ids": rng.integers(0, 9, size=(n, 3)).astype(np.int32),
            "answer_id": np.arange(n, dtype=np.int32),
            "image_index": rng.integers(0, n_images, n).astype(np.int32)}


def _datasets(kind, root):
    """The port's and JAX's dataset of ``kind`` over the same rows."""
    rows = _rows(26, 5)
    if kind == "array":
        return tds.ArrayDataset(rows), jds.ArrayDataset(rows)
    if kind == "joined":
        rng = np.random.default_rng(1)
        store = os.path.join(root, "store.npz")
        np.savez(store, grid=rng.normal(size=(5, 2, 2, 8)).astype(np.float16),
                 pool5=rng.normal(size=(5, 8)).astype(np.float32),
                 image_ids=np.arange(5, dtype=np.int64))
        return (tfeatures.JoinedDataset(rows,
                                        tfeatures.FeatureStore(store)),
                jfeatures.JoinedDataset(rows,
                                        jfeatures.FeatureStore(store)))
    from PIL import Image

    rng = np.random.default_rng(2)
    paths = []
    for i in range(5):
        paths.append(os.path.join(root, f"img{i}.jpg"))
        Image.fromarray(rng.integers(0, 256, (20 + 3 * i, 24, 3)).astype(
            np.uint8)).save(paths[-1], quality=90)
    return (tingest.ImageQuestionDataset(rows, paths, image_size=16),
            jingest.ImageQuestionDataset(rows, paths, image_size=16,
                                         decode_workers=1))


def _assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("shard", SHARDS)
@pytest.mark.parametrize("kind", SOURCES)
def test_iterator_matches_jax_draw_for_draw(kind, shard, tmp_path):
    """Batches and states of the port's iterator equal JAX's, draw for
    draw, for each source and each shard of two data ranks."""
    port_ds, jax_ds = _datasets(kind, str(tmp_path))
    ours = tgrain.GrainTrainIterator(port_ds, batch_size=8, seed=3,
                                     shard=shard)
    theirs = jgrain.GrainTrainIterator(jax_ds, batch_size=8, seed=3,
                                       shard=shard)
    assert json.dumps(ours.get_state()) == json.dumps(theirs.get_state())
    for _ in range(DRAWS):
        got = next(ours)
        _assert_batches_equal(got, next(theirs))
        assert len(got["answer_id"]) == 8 // shard[1]
        assert json.dumps(ours.get_state()) == json.dumps(theirs.get_state())
    if kind == "images":
        for i, row in enumerate(got["image_index"]):
            np.testing.assert_array_equal(
                got["images"][i], tingest._decode(port_ds.image_paths[row],
                                                  16))


@pytest.mark.parametrize("kind", SOURCES)
def test_set_state_resumes_on_the_next_batch(kind, tmp_path):
    """A state taken after three draws, set on the same iterator later and
    on a new one, gives the batches that followed it."""
    port_ds, _ = _datasets(kind, str(tmp_path))
    it = tgrain.GrainTrainIterator(port_ds, batch_size=8, seed=5)
    for _ in range(3):
        next(it)
    state = it.get_state()
    json.dumps(state)  # a JSON dict
    after = [next(it) for _ in range(3)]
    it.set_state(state)
    fresh = tgrain.GrainTrainIterator(port_ds, batch_size=8, seed=5)
    fresh.set_state(state)
    for want in after:
        _assert_batches_equal(next(it), want)
        _assert_batches_equal(next(fresh), want)


def test_shards_are_disjoint_and_cover():
    """Two data ranks take disjoint strides of one seeded permutation; on
    a size that is not a multiple of the ranks both slices keep equal
    lengths, so no sample is in both ranks' parts of a global batch."""
    ds = tds.ArrayDataset({"answer_id": np.arange(24, dtype=np.int32)})
    full = next(tgrain.GrainTrainIterator(ds, batch_size=8, seed=1))
    parts = [next(tgrain.GrainTrainIterator(ds, batch_size=8, seed=1,
                                            shard=(k, 2)))
             for k in range(2)]
    a, b = (set(p["answer_id"].tolist()) for p in parts)
    assert len(a) == len(b) == 4 and not a & b
    assert a | b == set(full["answer_id"].tolist())
    odd = tds.ArrayDataset({"answer_id": np.arange(25, dtype=np.int32)})
    its = [tgrain.GrainTrainIterator(odd, batch_size=8, seed=2,
                                     shard=(k, 2)) for k in range(2)]
    for _ in range(6):  # two epochs of the 12-row slices
        b0, b1 = (set(next(i)["answer_id"].tolist()) for i in its)
        assert not b0 & b1
    with pytest.raises(ValueError, match="not divisible"):
        tgrain.GrainTrainIterator(ds, batch_size=9, seed=0, shard=(0, 2))


def test_make_grain_dataset_matches_jax(tmp_path):
    """``make_grain_dataset``: shuffled, decoded, fixed-shape batches,
    equal to JAX's; two builds with one seed give one epoch order."""
    port_ds, _ = _datasets("images", str(tmp_path))
    rows = {k: v[:16] for k, v in port_ds.arrays.items()}
    got = list(tgrain.make_grain_dataset(rows, port_ds.image_paths,
                                         image_size=16, batch_size=4,
                                         seed=3, num_epochs=2))
    want = list(jgrain.make_grain_dataset(rows, port_ds.image_paths,
                                          image_size=16, batch_size=4,
                                          seed=3, num_epochs=2))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        _assert_batches_equal({k: np.asarray(v) for k, v in g.items()}, w)
    assert got[0]["images"].shape == (4, 16, 16, 3)
    again = next(iter(tgrain.make_grain_dataset(
        rows, port_ds.image_paths, image_size=16, batch_size=4, seed=3)))
    np.testing.assert_array_equal(again["answer_id"], got[0]["answer_id"])
    plain = next(iter(tgrain.make_grain_dataset(
        rows, port_ds.image_paths, image_size=16, batch_size=4,
        shuffle=False)))
    np.testing.assert_array_equal(plain["answer_id"], np.arange(4))


class _CountingIterator:
    """A GrainTrainIterator that counts the batches drawn from it."""

    def __init__(self, it):
        self.it, self.drawn = it, 0

    def __iter__(self):
        return self

    def __next__(self):
        self.drawn += 1
        return next(self.it)

    def get_state(self):
        return self.it.get_state()


@pytest.mark.parametrize("k", [1, 2])
def test_fit_saves_the_state_without_overshoot(k, tmp_path):
    """``Trainer.fit`` on a stateful input: no prefetch thread draws
    ahead (with ``train.prefetch_batches`` 2), and each checkpoint's
    ``data_iter_<step>.json`` is the state after that step's batches (at
    ``train.steps_per_call`` k, after each call's k batches)."""
    cfg = Config().replace_flat(dict(TINY, **{
        "train.prefetch_batches": 2, "train.steps_per_call": k,
        "train.checkpoint_every": 2, "train.keep_checkpoints": 10}))
    spec = build_model(cfg, generator=torch.Generator().manual_seed(0))
    tr = Trainer(cfg, spec, train_dir=str(tmp_path), device="cpu")
    it = _CountingIterator(tgrain.GrainTrainIterator(
        tds.load_dataset(cfg, "train"), batch_size=16, seed=0))
    state = tr.fit(it, tr.init_state(), max_steps=5)
    tr.close()
    assert state.step == 5 and it.drawn == 5
    saved = {s: tr.ckpt.restore_data_iter(s) for s in tr.ckpt.all_steps()}
    assert sorted(saved) == ([1, 2, 4, 5] if k == 1 else [2, 4, 5])
    assert all(v == {"next_index": s} for s, v in saved.items()), saved


def _final(train_dir):
    return load_params(os.path.join(train_dir, "params_final.pt"))


def _run(argv, train_dir, steps):
    return train_cli.main(["--device", "cpu", "--train.train_dir",
                           str(train_dir), "--train.max_steps", str(steps)]
                          + argv)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("model", ["vqa_end2end", "vqa_attention"])
def test_cli_grain_resume_is_sample_exact(model, k, tmp_path):
    """``cli.train --data.input_pipeline grain``: 4 steps, then a resumed
    run to 6 in the same directory, ends bit for bit where 6 uninterrupted
    steps end: the raw-JPEG model (decoded per row) and stage 2 on the
    joined store (a ``take`` per row), eagerly and at
    ``train.steps_per_call`` 2. The 24 (64) questions make the resume
    fall inside the second (first) epoch."""
    if model == "vqa_end2end":
        fx = write_jpeg_artifacts(str(tmp_path))
        flat = dict(TINY_E2E, **{
            "data.synthetic": False, "data.dataset_dir": fx["data_dir"],
            "data.image_dir": fx["image_dir"],
            "data.input_pipeline": "grain",
            "data.vocab_path": os.path.join(fx["data_dir"], "vocab.json"),
            "data.answer_vocab_path": os.path.join(fx["data_dir"],
                                                   "answer_vocab.json")})
    else:
        flat = dict(TINY, **{"train.device_data_cache": True})
    argv = argv_of(dict(flat, **{"train.checkpoint_every": 4,
                                 "train.steps_per_call": k}))
    whole = _final(_run(argv, tmp_path / "whole", 6))
    part = _run(argv, tmp_path / "part", 4)
    assert os.path.exists(os.path.join(part, "ckpt", "data_iter_4.json"))
    assert _run(argv, tmp_path / "part", 6) == part
    resumed = _final(part)
    assert sorted(resumed) == sorted(whole)
    for name, want in whole.items():
        assert torch.equal(resumed[name], want), \
            f"{name}: the resumed run left the uninterrupted data stream"
    with open(os.path.join(part, "ckpt", "data_iter_6.json")) as fh:
        assert json.load(fh) == {"next_index": 6}


def test_data_iter_pruned_with_checkpoints(tmp_path):
    """``data_iter_<step>.json`` follows the keep-N policy: the state of a
    removed checkpoint goes with it; restoring takes the latest
    checkpoint's state, None where none was saved; no temporary file is
    left behind."""
    cfg = Config().replace_flat(dict(TINY, **{"train.keep_checkpoints": 2}))
    tr = Trainer(cfg, build_model(cfg), train_dir=str(tmp_path),
                 device="cpu")
    mgr, state = tr.ckpt, tr.init_state()
    assert mgr.restore_data_iter() is None
    for step in (1, 2, 3, 4):
        assert mgr.save(step, state, force=True)
        mgr.save_data_iter(step, {"next_index": step * 10})
    tr.close()
    left = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(mgr.directory, "data_iter_*")))
    assert left == ["data_iter_3.json", "data_iter_4.json"]
    assert mgr.all_steps() == [3, 4]
    assert mgr.restore_data_iter() == {"next_index": 40}
    assert mgr.restore_data_iter(3) == {"next_index": 30}
    assert mgr.restore_data_iter(1) is None


class _Rank1:
    """Rank 1 of a two-rank mesh, without collectives: what rank 0
    broadcasts is its listing's newest step, 3."""
    distributed, is_writer = True, False

    def from_writer(self, value):
        return 3

    def barrier(self):
        pass


def test_only_rank0_writes_the_state(tmp_path):
    """Under a mesh the other ranks write no iterator state (rank 0's is
    every rank's position) and read the one rank 0 wrote."""
    writer = CheckpointManager(str(tmp_path))
    rank1 = CheckpointManager(str(tmp_path), mesh=_Rank1())
    rank1.save_data_iter(3, {"next_index": 3})
    assert not os.listdir(writer.directory)
    open(os.path.join(writer.directory, "ckpt_3.pt"), "wb").close()
    writer.save_data_iter(3, {"next_index": 3})
    assert rank1.restore_data_iter() == {"next_index": 3}
