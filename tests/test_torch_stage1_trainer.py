"""Port parity: stage-1 training of ``vlmap_description`` with the
bidirectional phrase encoder through ``Trainer.fit_resident`` against the
JAX package's ``fit_resident`` on one CPU device, whose encoder runs the
Pallas kernels B1/B2 in interpret mode (the port's runs the plain versions
of K6/K7, the same math).

6 steps in float32 with dropout 0 from the same (bridged) parameters, with
the gathered candidate loss and with the dense one. Tolerance: params rtol 2e-4 / atol 2e-5, the
bound of tests/test_torch_trainer.py for two implementations of a training
step (Adam divides by sqrt(nu), so a gradient entry near zero turns f32
summation-order noise into an update difference of up to lr); logged
losses rtol 1e-5.
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
from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
from vqa_transfer_externaldata_torch.utils.convert import params_from_flax

torch.set_num_threads(2)  # xdist runs several workers on the same cores

TINY = {
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


def _losses(train_dir):
    with open(os.path.join(train_dir, "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    return {r["step"]: r["train/loss"] for r in recs if "train/loss" in r}


@pytest.fixture(scope="module", params=[False, True])
def jax_run(request, tmp_path_factory):
    """JAX fit_resident: 6 steps from its own init, with the dense
    candidate loss or not; the flag, the bridged initial and final
    parameters and the run directory."""
    dense = request.param
    tmp = tmp_path_factory.mktemp("jax_stage1")
    jcfg = JaxConfig().replace_flat(
        dict(TINY, **{"model.dense_candidate_loss": dense}))
    spec = jax_build(jcfg)
    jtr = JaxTrainer(jcfg, spec, mesh=create_mesh(
        jcfg, devices=jax.devices()[:1]), train_dir=str(tmp))
    ds = jds.load_dataset(jcfg, "train", stage=spec.stage)
    js = jtr.init_state(next(ds.batches(1, epochs=1, shuffle=False)))
    init = params_from_flax(jax.device_get(js.params))
    js = jtr.fit_resident(ds, js, max_steps=6)
    final = params_from_flax(jax.device_get(js.params))
    jtr.close()
    return dense, init, final, str(tmp)


def test_stage1_fit_resident_matches_jax(jax_run, tmp_path):
    dense, init, want, jax_dir = jax_run
    cfg = Config().replace_flat(
        dict(TINY, **{"model.dense_candidate_loss": dense}))
    spec = build_model(cfg)
    tr = Trainer(cfg, spec, train_dir=str(tmp_path), device="cpu")
    s = tr.init_state(init)
    s = tr.fit_resident(tds.load_dataset(cfg, "train", stage=spec.stage), s,
                        max_steps=6)
    tr.close()
    assert s.step == 6
    got = spec.module.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
    lj, lt = _losses(jax_dir), _losses(tmp_path)
    assert sorted(lt) == sorted(lj) == [2, 4, 6]
    for step in lj:
        np.testing.assert_allclose(lt[step], lj[step], rtol=1e-5)


def test_resident_rows_upload_in_the_compute_dtype(tmp_path):
    """With bf16 compute the float region features travel as bf16 (the
    JAX package's host cast: the same rounding), labels and ids as they
    are, and uint16 candidate counts as int16."""
    over = dict(TINY, **{"model.dtype": "bfloat16",
                         "model.num_candidates": 300,
                         "model.dense_candidate_loss": True})
    cfg = Config().replace_flat(over)
    spec = build_model(cfg)
    tr = Trainer(cfg, spec, train_dir=str(tmp_path), device="cpu")
    ds = tds.load_dataset(cfg, "train", stage=spec.stage)
    data, make_batch, nbytes = tr._prepare_resident(ds)
    assert data["feature"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        data["feature"].float().numpy(),
        torch.from_numpy(ds.arrays["feature"]).bfloat16().float().numpy())
    assert ds.arrays["cand_counts"].dtype == np.uint16
    assert data["cand_counts"].dtype == torch.int16
    np.testing.assert_array_equal(data["cand_counts"].numpy(),
                                  ds.arrays["cand_counts"])
    assert data["desc_ids"].dtype == torch.int32
    idx = torch.tensor([3, 0, 5], dtype=torch.int32)
    batch = make_batch(idx)
    np.testing.assert_array_equal(batch["label"].numpy(),
                                  ds.arrays["label"][[3, 0, 5]])
    assert nbytes == sum(v.numel() * v.element_size() for v in data.values())
    s = tr.fit_resident(ds, tr.init_state(), max_steps=2)
    assert s.step == 2
    assert all(np.isfinite(list(_losses(tmp_path).values())))
    tr.close()
