"""Tensor-parallel tables (``mesh.shard_params``) on gloo ranks on the CPU:
the rows of the word and answer tables split over the model axis, read
through ``ops/row_shard.py``'s sharded lookup and row product. Each
tensor-parallel run is held against the JAX Trainer on the same mesh of
CPU devices (``create_mesh``, the same ``shard_params``) from the same
bridged parameters, and against the port's data-parallel run.

- Stage 2 (``vqa_attention``, resident, gather-free): a 2x2 mesh with
  ``shard_params answer_embedding,word_emb`` against JAX's 2x2 mesh and
  against the port's 4x1 data-parallel mesh, 4 steps, dropout 0,
  float32: JAX's ``test_tensor_parallel_tables_match_data_parallel``
  tolerance, rtol 5e-4 / atol 1e-4 (the model group's sums run in another
  order; Adam's division by sqrt(nu) amplifies it near zero gradients);
  logged losses rtol 1e-5, the resident evaluator's predictions equal.
  Then the tensor-parallel checkpoint round trip: restored exactly, and
  each rank's rows are its slice of the whole table the checkpoint holds.
- Stage 1 (``vlmap_description``, bidirectional): the word table
  row-sharded on a 1x2 mesh (lookup and row product of one table) against
  JAX's 1x2 mesh at dropout 0, and, at dropout 0.5 (masks drawn for the
  global batch), against the port's 2x1 data-parallel mesh; the same
  tolerances.

Run as a script this file is the ranks' worker (``tests/test_torch_ranks.py``);
it imports nothing of JAX.
"""

import json
import os
import sys

import numpy as np
import torch

from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.data import datasets as tds
from vqa_transfer_externaldata_torch.models.zoo import build_model
from vqa_transfer_externaldata_torch.parallel.trainer import Trainer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_ranks as torch_ranks  # noqa: E402

torch.set_num_threads(2)

STAGE2 = {
    "data.synthetic": True, "data.synthetic_layout": "joined",
    "data.synthetic_size": 128, "data.vocab_size": 64,
    "data.num_answers": 16, "data.grid_h": 3, "data.grid_w": 3,
    "data.feature_dim": 16, "data.pool5_dim": 16,
    "data.max_question_len": 6, "model.word_dim": 8, "model.rnn_dim": 8,
    "model.fusion_dim": 16, "model.att_hidden": 8, "model.answer_dim": 8,
    "model.dtype": "float32", "model.dropout": 0.0,
    # 8 questions a data rank on the 4x1 mesh too: both meshes take the
    # gather-free path (batch % (8 * data ranks) == 0).
    "train.batch_size": 32, "train.device_data_cache": True,
    "train.log_every": 2, "train.warmup_steps": 2,
    "train.learning_rate": 3e-3, "train.checkpoint_every": 2,
}
STAGE1 = {
    "model.model": "vlmap_description", "model.bidirectional_desc": True,
    "data.synthetic": True, "data.synthetic_size": 96,
    "data.vocab_size": 64, "data.pool5_dim": 16,
    "data.max_question_len": 6, "model.word_dim": 8, "model.rnn_dim": 8,
    "model.dtype": "float32", "model.dropout": 0.0, "model.num_tasks": 4,
    "model.task_dim": 8, "model.num_candidates": 12,
    "train.batch_size": 16, "train.device_data_cache": True,
    "train.log_every": 2, "train.warmup_steps": 2,
    "train.learning_rate": 3e-3,
}
TP = {"mesh.num_model": 2,
      "mesh.shard_params": "answer_embedding,word_emb"}
STEPS = 4


def _train(flat, out_dir, run):
    """fit_resident from the bridged parameters in ``out_dir/params.pt``
    on this rank's mesh, then the resident evaluator on the training
    split; rank 0 saves the whole tables and the predictions. Returns the
    trainer and its state."""
    cfg = Config().replace_flat(flat)
    spec = build_model(cfg)
    tr = Trainer(cfg, spec, train_dir=os.path.join(out_dir, run),
                 device="cpu")
    ds = tds.load_dataset(cfg, "train", stage=spec.stage)
    s = tr.init_state(torch.load(os.path.join(out_dir, "params.pt")))
    s = tr.fit_resident(ds, s, max_steps=STEPS)
    _, preds = tr.evaluate_resident(s, ds)
    params = tr.full_state_dict()
    if tr.mesh.is_writer:
        torch.save({"params": params, "preds": torch.from_numpy(preds)},
                   os.path.join(out_dir, f"{run}.pt"))
    return tr, s


def case_stage2(rank, world, out_dir, mode):
    tr, s = _train(dict(STAGE2, **(TP if mode == "tp" else {})), out_dir,
                   mode)
    if mode == "tp":
        _round_trip(tr, s)
    tr.close()


def _round_trip(tr, s):
    """Restore the step-4 checkpoint over zeroed state: exact, and the
    sharded tables' rows are the checkpoint's whole tables' slices."""
    shards = {name: shard for name, (_, _, shard) in tr._row_shards.items()}
    assert sorted(shards) == ["answer_embedding", "word_emb.embedding"]
    assert tr.mesh.num_model == 2
    trained = [{k: v.detach().clone() for k, v in d.items()}
               for d in (s.params, s.opt_state.mu, s.opt_state.nu)]
    s2 = tr.init_state()
    with torch.no_grad():
        for d in (s2.params, s2.opt_state.mu, s2.opt_state.nu):
            for v in d.values():
                v.zero_()
    s2 = tr.restore(s2)
    assert s2.step == STEPS
    for want, got in zip(trained, (s2.params, s2.opt_state.mu,
                                   s2.opt_state.nu)):
        assert set(want) == set(got)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    saved = torch.load(os.path.join(tr.ckpt.directory, f"ckpt_{STEPS}.pt"))
    for name, shard in shards.items():
        whole = saved["params"][name]
        assert whole.shape[0] == 2 * shard.rows
        assert torch.equal(whole[shard.start:shard.start + shard.rows],
                           s2.params[name]), name
        assert torch.equal(
            saved["opt"]["mu"][name][shard.start:shard.start + shard.rows],
            s2.opt_state.mu[name]), name


STAGE1_TP = {"mesh.num_model": 2, "mesh.shard_params": "word_emb"}
# Stage 1's runs by mode: the mesh's settings and the dropout rate.
STAGE1_MODES = {"dp": ({}, 0.5), "tp": (STAGE1_TP, 0.5),
                "tp_d0": (STAGE1_TP, 0.0)}


def case_stage1(rank, world, out_dir, mode):
    over, rate = STAGE1_MODES[mode]
    tr, _ = _train(dict(STAGE1, **over, **{"model.dropout": rate}),
                   out_dir, f"stage1_{mode}")
    if over:
        assert list(tr._row_shards) == ["word_emb.embedding"]
    tr.close()


def _losses(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    return {r["step"]: r["train/loss"] for r in recs if "train/loss" in r}


def _jax_run(flat, n_devices, run_dir, out_dir):
    """JAX's Trainer on ``n_devices`` CPU devices (its ``create_mesh`` of
    ``flat``'s mesh settings): the bridged initial parameters into
    out_dir/params.pt, then its final parameters and its resident
    evaluator's predictions on the training split."""
    import jax

    from vqa_transfer_externaldata_tpu.config import Config as JaxConfig
    from vqa_transfer_externaldata_tpu.data import datasets as jds
    from vqa_transfer_externaldata_tpu.models.zoo import build_model as jb
    from vqa_transfer_externaldata_tpu.parallel.mesh import create_mesh
    from vqa_transfer_externaldata_tpu.parallel.trainer import (
        Trainer as JaxTrainer)
    from vqa_transfer_externaldata_torch.utils.convert import params_from_flax

    jcfg = JaxConfig().replace_flat(flat)
    spec = jb(jcfg)
    jtr = JaxTrainer(jcfg, spec, mesh=create_mesh(
        jcfg, devices=jax.devices()[:n_devices]), train_dir=run_dir)
    ds = jds.load_dataset(jcfg, "train", stage=spec.stage)
    js = jtr.init_state(next(ds.batches(1, epochs=1, shuffle=False)))
    torch.save(params_from_flax(jax.device_get(js.params)),
               os.path.join(out_dir, "params.pt"))
    js = jtr.fit_resident(ds, js, max_steps=STEPS)
    _, preds = jtr.evaluate_resident(js, ds)
    want = params_from_flax(jax.device_get(js.params))
    jtr.close()
    return want, np.asarray(preds)


def _assert_close(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=5e-4, atol=1e-4, err_msg=k)


def _assert_matches_jax(got, run_dir, want, jpreds, jax_dir):
    _assert_close(got["params"], want)
    np.testing.assert_array_equal(got["preds"].numpy(), jpreds)
    lt, lj = _losses(run_dir), _losses(jax_dir)
    assert sorted(lt) == sorted(lj) == [2, 4]
    for step in lj:
        np.testing.assert_allclose(lt[step], lj[step], rtol=1e-5)


def test_stage2_tensor_parallel_matches_data_parallel(tmp_path):
    out = str(tmp_path)
    script = os.path.abspath(__file__)
    want, jpreds = _jax_run(dict(STAGE2, **TP), 4, str(tmp_path / "jax"),
                            out)
    torch_ranks.run_ranks(script, "stage2", 4, out, "dp")
    torch_ranks.run_ranks(script, "stage2", 4, out, "tp")
    tp = torch.load(os.path.join(out, "tp.pt"))
    _assert_matches_jax(tp, os.path.join(out, "tp"), want, jpreds,
                        tmp_path / "jax")
    _assert_close(tp["params"],
                  torch.load(os.path.join(out, "dp.pt"))["params"])


def test_stage1_tensor_parallel_matches_data_parallel(tmp_path):
    out = str(tmp_path)
    script = os.path.abspath(__file__)
    want, jpreds = _jax_run(dict(STAGE1, **STAGE1_TP), 2,
                            str(tmp_path / "jax"), out)
    for mode in STAGE1_MODES:
        torch_ranks.run_ranks(script, "stage1", 2, out, mode)
    _assert_matches_jax(torch.load(os.path.join(out, "stage1_tp_d0.pt")),
                        os.path.join(out, "stage1_tp_d0"), want, jpreds,
                        tmp_path / "jax")
    _assert_close(
        torch.load(os.path.join(out, "stage1_tp.pt"))["params"],
        torch.load(os.path.join(out, "stage1_dp.pt"))["params"])


if __name__ == "__main__":
    torch_ranks.worker_main({"stage2": case_stage2, "stage1": case_stage1})
