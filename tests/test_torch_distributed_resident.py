"""Port parity: two-rank ``Trainer.fit_resident`` (gloo, on the CPU)
against the JAX Trainer on a 2-device ``create_mesh``, for the replicated
store and for ``train.store_sharded`` (also sorted by image within each
rank's slot, on the int8 store).

Both runs start from the same (bridged) parameters, in float32 with
dropout 0, on datasets where the <unk> answers (weight 0 in the loss) fall
unevenly between the two ranks' halves of every batch, so a mean of the
ranks' means would differ from the global batch's mean that both packages
train on. Tolerance: parameters rtol 2e-4 / atol 2e-5 (JAX's
``test_sharded_equals_single_device``: Adam divides by sqrt(nu), so a
gradient entry near zero turns f32 summation-order noise into an update
difference of up to lr), logged losses rtol 1e-5; the resident evaluator's
predictions exactly equal, its metrics rtol 1e-4.

Run as a script this file is the ranks' worker (``tests/test_torch_ranks.py``);
it imports nothing of JAX.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.data import datasets as tds
from vqa_transfer_externaldata_torch.data import features as tfeat
from vqa_transfer_externaldata_torch.models.zoo import build_model
from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
from vqa_transfer_externaldata_torch.utils.vocab import UNK_ID

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_ranks as torch_ranks  # noqa: E402

torch.set_num_threads(2)

STEPS = 6
WORLD = 2
COMMON = {
    "data.vocab_size": 64, "data.num_answers": 16, "data.grid_h": 3,
    "data.grid_w": 3, "data.feature_dim": 16, "data.pool5_dim": 16,
    "data.max_question_len": 6, "model.word_dim": 8, "model.rnn_dim": 8,
    "model.fusion_dim": 16, "model.att_hidden": 8, "model.answer_dim": 8,
    "model.dtype": "float32", "model.dropout": 0.0,
    "train.batch_size": 16, "train.device_data_cache": True,
    "train.log_every": 2, "train.warmup_steps": 2,
    "train.learning_rate": 3e-3,
}
REPLICATED = dict(COMMON, **{"data.synthetic": True,
                             "data.synthetic_layout": "joined",
                             "data.synthetic_size": 128})
# M = 12 store rows (M % 8 != 0, as JAX's test), 100 questions, a float16
# store; k = 2 steps a call, as JAX's test.
SHARDED = dict(COMMON, **{"train.store_sharded": True,
                          "train.steps_per_call": 2})
M_STORE, N_QUESTIONS = 12, 100


def uneven_unk(arrays, batches):
    """<unk> on 6 of the 8 rows of each batch's first half (rank 0's rows),
    on none of its second half, for the batches of ``batches`` (rows
    [B] each)."""
    ans = np.array(arrays["answer_id"])
    for b in batches:
        half = b.size // 2
        ans[b[:6]] = UNK_ID
        second = b[half:]
        ans[second] = np.where(ans[second] == UNK_ID, 5, ans[second])
    arrays["answer_id"] = ans


def replicated_dataset(mod, cfg):
    """The synthetic joined split with :func:`uneven_unk` over the first
    STEPS batches of its index stream (one epoch: no row twice)."""
    ds = mod.load_dataset(cfg, "train")
    it = ds.index_batches(cfg.train.batch_size, seed=cfg.train.seed)
    uneven_unk(ds.arrays, [next(it) for _ in range(STEPS)])
    return ds


def write_sharded_fixture(out_dir):
    """A 12-row float16 store and 100 questions; <unk> on 70% of the
    questions whose image shard 0 holds (owner = row % 2), none of shard
    1's."""
    c = Config().replace_flat(SHARDED).data
    rng = np.random.default_rng(11)
    np.savez(os.path.join(out_dir, "store.npz"),
             grid=rng.normal(size=(M_STORE, c.grid_h, c.grid_w,
                                   c.feature_dim)).astype(np.float16),
             pool5=rng.normal(size=(M_STORE, c.pool5_dim)).astype(np.float32),
             image_ids=np.arange(M_STORE, dtype=np.int64))
    image = rng.integers(0, M_STORE, size=N_QUESTIONS).astype(np.int32)
    answer = rng.integers(4, c.num_answers, size=N_QUESTIONS).astype(np.int32)
    answer[(image % WORLD == 0) & (rng.random(N_QUESTIONS) < 0.7)] = UNK_ID
    np.savez(os.path.join(out_dir, "rows.npz"),
             q_ids=rng.integers(4, c.vocab_size, size=(
                 N_QUESTIONS, c.max_question_len)).astype(np.int32),
             answer_id=answer, image_index=image)


def sharded_dataset(mod, out_dir):
    with np.load(os.path.join(out_dir, "rows.npz")) as f:
        rows = {k: f[k] for k in f.files}
    return mod.JoinedDataset(rows, mod.FeatureStore(
        os.path.join(out_dir, "store.npz")), index_key="image_index",
        feature_keys=("features", "pool5"))


def train_port(flat, out_dir, run, device="cpu"):
    """The port's fit_resident and resident evaluation from the bridged
    parameters in ``out_dir/params.pt``, on this process's mesh (two
    ranks under the worker, one in the test); rank 0 saves the result."""
    cfg = Config().replace_flat(flat)
    if flat.get("train.store_sharded"):
        ds, val = (sharded_dataset(tfeat, out_dir) for _ in range(2))
    else:
        ds, val = replicated_dataset(tds, cfg), replicated_dataset(tds, cfg)
    tr = Trainer(cfg, build_model(cfg), train_dir=os.path.join(out_dir, run),
                 device=device)
    s = tr.init_state(torch.load(os.path.join(out_dir, "params.pt")))
    s = tr.fit_resident(ds, s, max_steps=STEPS)
    metrics, preds = tr.evaluate_resident(s, val)
    params = tr.full_state_dict()
    if tr.mesh.is_writer:
        torch.save({"params": params, "preds": torch.from_numpy(preds),
                    "metrics": metrics,
                    "step": s.step},
                   os.path.join(out_dir, f"{run}.pt"))
    tr.close()


# The sharded store as it is, and sorted by image within each rank's slot
# on the int8 codes of the prenormalized store (one global scale).
SHARDED_VARIANTS = {
    "sharded": {},
    "sharded_sorted_int8": {"train.sort_batch_by_image": True,
                            "train.store_quantize": "int8"},
}


def case_fit(rank, world, out_dir, mode):
    flat = (REPLICATED if mode == "replicated"
            else dict(SHARDED, **SHARDED_VARIANTS[mode]))
    train_port(flat, out_dir, f"ranks_{mode}")


def case_local_dirs(rank, world, out_dir, mode):
    """4 steps, a checkpoint every 2, each rank in a run directory of its
    own; rank 1's already lists a step-100 checkpoint (an empty file no
    one reads), so its own listing would skip every save."""
    cfg = Config().replace_flat(dict(REPLICATED, **{
        "train.checkpoint_every": 2}))
    run = os.path.join(out_dir, f"rank{rank}")
    if rank == 1:
        os.makedirs(os.path.join(run, "ckpt"))
        open(os.path.join(run, "ckpt", "ckpt_100.pt"), "wb").close()
    tr = Trainer(cfg, build_model(cfg), train_dir=run, device="cpu")
    tr.fit_resident(tds.load_dataset(cfg, "train"), tr.init_state(),
                    max_steps=4)
    tr.close()


def _losses(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    return {r["step"]: r["train/loss"] for r in recs if "train/loss" in r}


def _jax_run(flat, ds_fn, run_dir, out_dir):
    """JAX's Trainer on 2 CPU devices: bridged parameters into
    out_dir/params.pt, then its parameters, predictions and metrics."""
    import jax

    from vqa_transfer_externaldata_tpu.config import Config as JaxConfig
    from vqa_transfer_externaldata_tpu.models.zoo import build_model as jb
    from vqa_transfer_externaldata_tpu.parallel.mesh import create_mesh
    from vqa_transfer_externaldata_tpu.parallel.trainer import (
        Trainer as JaxTrainer)
    from vqa_transfer_externaldata_torch.utils.convert import params_from_flax

    jcfg = JaxConfig().replace_flat(flat)
    jtr = JaxTrainer(jcfg, jb(jcfg), mesh=create_mesh(
        jcfg, devices=jax.devices()[:WORLD]), train_dir=run_dir)
    ds = ds_fn(jcfg)
    js = jtr.init_state(next(ds.batches(1, epochs=1, shuffle=False)))
    torch.save(params_from_flax(jax.device_get(js.params)),
               os.path.join(out_dir, "params.pt"))
    js = jtr.fit_resident(ds, js, max_steps=STEPS)
    metrics, preds = jtr.evaluate_resident(js, ds_fn(jcfg))
    want = params_from_flax(jax.device_get(js.params))
    jtr.close()
    return want, metrics, preds


def _compare(got, want, jmetrics, jpreds, lt, lj):
    assert set(got["params"]) == set(want)
    for k in want:
        np.testing.assert_allclose(got["params"][k].numpy(),
                                   want[k].numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=k)
    assert sorted(lt) == sorted(lj) == [2, 4, 6]
    for step in lj:
        np.testing.assert_allclose(lt[step], lj[step], rtol=1e-5)
    np.testing.assert_array_equal(got["preds"].numpy(), np.asarray(jpreds))
    for k in jmetrics:
        np.testing.assert_allclose(got["metrics"][k], jmetrics[k],
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_two_rank_replicated_store_matches_jax_mesh(tmp_path):
    from vqa_transfer_externaldata_tpu.data import datasets as jds

    out = str(tmp_path)
    want, jm, jp = _jax_run(REPLICATED,
                            lambda c: replicated_dataset(jds, c),
                            str(tmp_path / "jax"), out)
    torch_ranks.run_ranks(os.path.abspath(__file__), "fit", WORLD, out,
                          "replicated")
    got = torch.load(os.path.join(out, "ranks_replicated.pt"))
    assert got["step"] == STEPS
    # Only rank 0 wrote the run's records, each step once.
    lt = _losses(os.path.join(out, "ranks_replicated"))
    _compare(got, want, jm, jp, lt, _losses(tmp_path / "jax"))
    # The same run in one process of the port.
    train_port(REPLICATED, out, "single")
    one = torch.load(os.path.join(out, "single.pt"))
    for k in want:
        np.testing.assert_allclose(got["params"][k].numpy(),
                                   one["params"][k].numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=k)
    ls = _losses(os.path.join(out, "single"))
    for step in ls:
        np.testing.assert_allclose(lt[step], ls[step], rtol=1e-5)
    np.testing.assert_array_equal(got["preds"].numpy(), one["preds"].numpy())


@pytest.mark.parametrize("mode", sorted(SHARDED_VARIANTS))
def test_two_rank_sharded_store_matches_jax_mesh(mode, tmp_path):
    from vqa_transfer_externaldata_tpu.data import features as jfeat

    out = str(tmp_path)
    write_sharded_fixture(out)
    want, jm, jp = _jax_run(dict(SHARDED, **SHARDED_VARIANTS[mode]),
                            lambda c: sharded_dataset(jfeat, out),
                            str(tmp_path / "jax"), out)
    torch_ranks.run_ranks(os.path.abspath(__file__), "fit", WORLD, out, mode)
    got = torch.load(os.path.join(out, f"ranks_{mode}.pt"))
    assert got["step"] == STEPS
    _compare(got, want, jm, jp, _losses(os.path.join(out, f"ranks_{mode}")),
             _losses(tmp_path / "jax"))


def test_rank_local_directories_follow_rank_0(tmp_path):
    """The checkpoint policy follows rank 0's listing on every rank: the
    run ends (no rank waits in a save the other skipped), rank 0 alone
    wrote, and rank 1's directory is as it was."""
    out = str(tmp_path)
    torch_ranks.run_ranks(os.path.abspath(__file__), "local_dirs", WORLD,
                          out, "-", timeout=120)
    assert sorted(os.listdir(tmp_path / "rank0" / "ckpt")) == [
        "ckpt_1.pt", "ckpt_2.pt", "ckpt_4.pt"]
    assert os.listdir(tmp_path / "rank1" / "ckpt") == ["ckpt_100.pt"]


if __name__ == "__main__":
    torch_ranks.worker_main({"fit": case_fit,
                             "local_dirs": case_local_dirs})
