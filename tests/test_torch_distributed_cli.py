"""The streamed multi-process run through the port's CLIs: ``cli.train``
under ``torch.distributed.run`` with two ranks and ``--device cpu`` (gloo)
on the flat layout, then ``cli.eval`` the same way.

Each rank streams its shard of every global batch (``batches(shard=(k,
2))``). With dropout on, the trained parameters must equal a
single-process ``Trainer.fit`` fed the two ranks' batches concatenated:
each rank draws the global batch's masks and keeps its rows, so the masks
are the single process's. Tolerance rtol 2e-4 / atol 2e-5 (JAX's
``test_sharded_equals_single_device``: the sums run in another order and
Adam's division by sqrt(nu) amplifies it near zero gradients); the logged
losses and the evaluation's metrics rtol 1e-5. Rank 0 alone writes
``metrics.jsonl`` (every step once), the checkpoints, ``params_final.pt``
and ``results_val.json``. With dropout off, the same two-rank run must
equal the JAX Trainer's ``fit`` on a 2-device ``create_mesh`` fed the same
global batches from the same parameters, within the same tolerances.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.data import datasets as tds
from vqa_transfer_externaldata_torch.models.zoo import build_model
from vqa_transfer_externaldata_torch.parallel import evaler as tev
from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
from vqa_transfer_externaldata_torch.utils.checkpoint import load_params

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_ranks as torch_ranks  # noqa: E402

torch.set_num_threads(2)

FLAT = {
    "data.synthetic": True, "data.synthetic_layout": "flat",
    "data.synthetic_size": 64, "data.vocab_size": 64,
    "data.num_answers": 16, "data.grid_h": 3, "data.grid_w": 3,
    "data.feature_dim": 16, "data.pool5_dim": 16,
    "data.max_question_len": 6, "model.word_dim": 8, "model.rnn_dim": 8,
    "model.fusion_dim": 16, "model.att_hidden": 8, "model.answer_dim": 8,
    "model.dtype": "float32", "model.dropout": 0.5,
    "train.batch_size": 16, "train.warmup_steps": 2,
    "train.learning_rate": 3e-3, "train.max_steps": 4,
    "train.log_every": 2, "train.eval_every": 2,
    "train.checkpoint_every": 2,
}


def _torchrun(module, argv, out_dir, tag):
    log = os.path.join(out_dir, f"{tag}.log")
    with open(log, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2", "-m", module, *argv],
            cwd=torch_ranks.REPO, env=torch_ranks.rank_env(), stdout=fh,
            stderr=subprocess.STDOUT)
        torch_ranks.wait_all([proc], [log], timeout=300)
    with open(log) as fh:
        return fh.read()


def _records(run):
    with open(os.path.join(run, "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh]


def _train_two_ranks(flat, run, out_dir):
    """``cli.train`` of ``flat`` on two gloo ranks into ``run``."""
    argv = ["--device", "cpu", "--train.train_dir", run]
    for k, v in flat.items():
        argv += [f"--{k}", str(v).lower() if isinstance(v, bool) else str(v)]
    _torchrun("vqa_transfer_externaldata_torch.cli.train", argv, out_dir,
              "train")


def _joined_batches(ds, seed):
    """The global batches of the two ranks' shards: rank 0's rows, then
    rank 1's."""
    shards = [ds.batches(16, seed=seed, shard=(k, 2)) for k in range(2)]
    while True:
        parts = [next(it) for it in shards]
        yield {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _seeded_init(cfg):
    """The parameters the CLI starts from (the seeded model)."""
    return build_model(cfg, generator=torch.Generator().manual_seed(
        cfg.train.seed))


def test_torchrun_streamed_train_then_eval(tmp_path):
    run = str(tmp_path / "run")
    _train_two_ranks(FLAT, run, str(tmp_path))

    # The same run in one process on the two ranks' batches concatenated.
    cfg = Config().replace_flat(dict(FLAT, **{
        "train.train_dir": str(tmp_path / "single")}))
    spec = _seeded_init(cfg)
    tr = Trainer(cfg, spec, device="cpu")
    ds = tds.load_dataset(cfg, "train")
    val = tds.load_dataset(cfg, "val")
    state = tr.fit(_joined_batches(ds, cfg.train.seed), tr.init_state(),
                   eval_batches_fn=lambda: tev.padded_batches(val, 16)[0])
    want = {k: v.clone() for k, v in spec.module.state_dict().items()}
    got = load_params(os.path.join(run, "params_final.pt"))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)

    # Rank 0 alone wrote the records (each step once) and the files.
    recs, one = _records(run), _records(str(tmp_path / "single"))
    for prefix in ("train/loss", "val/loss"):
        steps = [r["step"] for r in recs if prefix in r]
        assert steps == [r["step"] for r in one if prefix in r] == [2, 4]
    for a, b in zip(recs, one):
        for k in ("train/loss", "train/accuracy", "val/loss",
                  "val/accuracy"):
            if k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
    assert sorted(os.listdir(os.path.join(run, "ckpt"))) == sorted(
        os.listdir(tmp_path / "single" / "ckpt")) == [
        "ckpt_1.pt", "ckpt_2.pt", "ckpt_4.pt"]
    assert os.path.exists(os.path.join(run, "config.json"))

    # cli.eval with two ranks: each evaluates its rows of every batch.
    out = _torchrun("vqa_transfer_externaldata_torch.cli.eval",
                    ["--device", "cpu", "--train.train_dir", run],
                    str(tmp_path), "eval")
    lines = [json.loads(line) for line in out.splitlines()
             if line.startswith('{"split"')]
    assert len(lines) == 1 and lines[0]["step"] == 4, out[-2000:]
    with open(os.path.join(run, "results_val.json")) as fh:
        results = json.load(fh)
    assert len(results) == len(val)
    tr.init_state(got)
    metrics, preds = tev.evaluate_split(tr, state, val)
    tr.close()
    for k, v in metrics.items():
        np.testing.assert_allclose(lines[0][k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    _, answer_vocab = tds.synthetic_vocabs(cfg)
    assert [r["answer"] for r in results] == [
        answer_vocab.tokens[int(p)] for p in preds]


def test_torchrun_streamed_train_matches_jax_mesh(tmp_path):
    import jax

    from vqa_transfer_externaldata_tpu.config import Config as JaxConfig
    from vqa_transfer_externaldata_tpu.data import datasets as jds
    from vqa_transfer_externaldata_tpu.models.zoo import build_model as jb
    from vqa_transfer_externaldata_tpu.parallel.mesh import create_mesh
    from vqa_transfer_externaldata_tpu.parallel.trainer import (
        Trainer as JaxTrainer)
    from vqa_transfer_externaldata_torch.utils.convert import (
        params_from_flax, params_to_flax)

    flat = dict(FLAT, **{"model.dropout": 0.0, "train.eval_every": 100})
    run = str(tmp_path / "run")
    _train_two_ranks(flat, run, str(tmp_path))
    got = load_params(os.path.join(run, "params_final.pt"))

    cfg = Config().replace_flat(flat)
    init = _seeded_init(cfg).module.state_dict()
    jcfg = JaxConfig().replace_flat(flat)
    jtr = JaxTrainer(jcfg, jb(jcfg), mesh=create_mesh(
        jcfg, devices=jax.devices()[:2]), train_dir=str(tmp_path / "jax"))
    ds = jds.load_dataset(jcfg, "train")
    js = jtr.init_state(next(ds.batches(1, epochs=1, shuffle=False)),
                        params=params_to_flax(init))
    js = jtr.fit(_joined_batches(ds, jcfg.train.seed), js,
                 max_steps=jcfg.train.max_steps)
    want = params_from_flax(jax.device_get(js.params))
    jtr.close()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
    recs = [r for r in _records(run) if "train/loss" in r]
    jrecs = [r for r in _records(str(tmp_path / "jax")) if "train/loss" in r]
    assert [r["step"] for r in recs] == [r["step"] for r in jrecs] == [2, 4]
    for a, b in zip(recs, jrecs):
        np.testing.assert_allclose(a["train/loss"], b["train/loss"],
                                   rtol=1e-5)
