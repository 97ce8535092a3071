"""The port's checkpoints (utils/checkpoint.py::CheckpointManager): a
resumed run continues bit for bit, and the save policy and keep-N pruning
are the JAX package's (Orbax's)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_transfer_externaldata_tpu.utils.checkpoint import (
    CheckpointManager as JaxCheckpointManager)
from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.data import datasets as tds
from vqa_transfer_externaldata_torch.models.zoo import build_model
from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
from vqa_transfer_externaldata_torch.utils.checkpoint import (
    CheckpointManager)

torch.set_num_threads(2)  # xdist runs several workers on the same cores

TINY = {
    "data.synthetic": True, "data.synthetic_layout": "flat",
    "data.synthetic_size": 64, "data.vocab_size": 64,
    "data.num_answers": 16, "data.grid_h": 3, "data.grid_w": 3,
    "data.feature_dim": 16, "data.pool5_dim": 16,
    "data.max_question_len": 6, "model.word_dim": 8, "model.rnn_dim": 8,
    "model.fusion_dim": 16, "model.att_hidden": 8, "model.answer_dim": 8,
    "model.dtype": "float32", "model.dropout": 0.5,
    "train.batch_size": 16, "train.log_every": 10,
    "train.checkpoint_every": 20, "train.warmup_steps": 2,
    "train.learning_rate": 3e-3,
}


def _trainer(train_dir, **over):
    cfg = Config().replace_flat(dict(TINY, **over))
    spec = build_model(cfg, generator=torch.Generator().manual_seed(0))
    return cfg, Trainer(cfg, spec, train_dir=str(train_dir), device="cpu")


def test_resume_is_bitwise(tmp_path):
    """20 steps, a new trainer restored from the step-20 checkpoint, 20 more
    (the data stream realigned by skipping 20 batches) == 40 straight, bit
    for bit: parameters, Adam moments and the dropout stream (rate 0.5)
    all come back."""
    cfg, tr = _trainer(tmp_path / "straight")
    ds = tds.load_dataset(cfg, "train")
    straight = tr.fit(ds.batches(16, seed=0), tr.init_state(), max_steps=40)
    tr.close()

    _, tr = _trainer(tmp_path / "resumed")
    tr.fit(ds.batches(16, seed=0), tr.init_state(), max_steps=20)
    tr.close()
    _, tr = _trainer(tmp_path / "resumed")
    state = tr.restore(tr.init_state())
    assert state.step == 20
    batches = ds.batches(16, seed=0)
    for _ in range(20):
        next(batches)
    resumed = tr.fit(batches, state, max_steps=40)
    tr.close()
    assert resumed.step == straight.step == 40
    for k, p in straight.params.items():
        assert torch.equal(resumed.params[k], p), k
    for k in straight.opt_state.mu:
        assert torch.equal(resumed.opt_state.mu[k], straight.opt_state.mu[k])
        assert torch.equal(resumed.opt_state.nu[k], straight.opt_state.nu[k])
    assert resumed.opt_state.count == straight.opt_state.count == 40


def test_save_policy_and_pruning_match_orbax(tmp_path):
    """Saves offered at steps 1..12 with save_every 5 and keep 2: the first
    save and every fifth step write, the newest two stay; a forced save
    always writes. The same steps as the JAX package's Orbax manager."""
    _, tr = _trainer(tmp_path / "run")
    state = tr.init_state()
    mgr = CheckpointManager(str(tmp_path / "torch"), keep=2, save_every=5)
    jmgr = JaxCheckpointManager(str(tmp_path / "jax"), keep=2, save_every=5)
    got = [s for s in range(1, 13) if mgr.save(s, state)]
    want = [s for s in range(1, 13) if jmgr.save(s, {"x": jnp.ones(2)})]
    jmgr.wait()
    assert got == want == [1, 5, 10]
    assert mgr.all_steps() == list(jmgr._mngr.all_steps()) == [5, 10]
    assert mgr.save(13, state, force=True)
    jmgr.save(13, {"x": jnp.ones(2)}, force=True)
    jmgr.close()
    assert mgr.all_steps() == list(jmgr._mngr.all_steps()) == [10, 13]
    assert sorted(os.listdir(mgr.directory)) == ["ckpt_10.pt", "ckpt_13.pt"]
    tr.close()


def test_restore_picks_the_step_and_refuses_missing(tmp_path):
    cfg, tr = _trainer(tmp_path / "run", **{"train.checkpoint_every": 3,
                                            "train.keep_checkpoints": 10})
    ds = tds.load_dataset(cfg, "train")
    tr.fit(ds.batches(16, seed=0), tr.init_state(), max_steps=7)
    assert tr.ckpt.all_steps() == [1, 3, 6, 7]
    snapshot = {k: v.clone() for k, v in tr.model.state_dict().items()}
    state = tr.restore(tr.init_state(), step=3)
    assert state.step == 3 and state.opt_state.count == 3
    assert not all(torch.equal(snapshot[k], v)
                   for k, v in tr.model.state_dict().items())
    state = tr.restore(state)  # the latest: 7
    assert state.step == 7
    for k, v in tr.model.state_dict().items():
        assert torch.equal(snapshot[k], v), k
    with pytest.raises(FileNotFoundError, match="step 4"):
        tr.restore(state, step=4)
    tr.ckpt.save_data_iter(7, {"next_index": 7})
    assert tr.ckpt.restore_data_iter() == {"next_index": 7}
    assert tr.ckpt.restore_data_iter(3) is None  # saved without a state
    tr.close()
    _, empty = _trainer(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        empty.restore(empty.init_state())
    empty.close()
    np.testing.assert_equal(empty.ckpt.latest_step(), None)
    assert empty.ckpt.restore_data_iter() is None
