"""Port serving path: the port's Predictor and predict CLI on a tiny run
trained by the JAX package's ``cli.train`` (float32), its ``params_final``
brought over through the weight bridge. The port must answer exactly as
the JAX Predictor does (which runs the Pallas kernels in interpret mode).
"""

import json
import os

import numpy as np
import pytest
import torch

from tests.test_cli import TINY
from vqa_transfer_externaldata_tpu.cli import predict as jax_predict_cli
from vqa_transfer_externaldata_tpu.cli import train as jax_train_cli
from vqa_transfer_externaldata_tpu.serving import Predictor as JaxPredictor
from vqa_transfer_externaldata_tpu.utils.checkpoint import (
    load_params as jax_load_params)
from vqa_transfer_externaldata_torch.cli import predict as predict_cli
from vqa_transfer_externaldata_torch.serving import PARAMS_FILE, Predictor
from vqa_transfer_externaldata_torch.utils.checkpoint import save_params
from vqa_transfer_externaldata_torch.utils.convert import params_from_flax

torch.set_num_threads(2)  # xdist runs several workers on the same cores

N_CELLS, C = 2 * 2, 16
QUESTIONS = ["w5 w6 w7", "w8", "w9 w10", "w11 w12 w13", "w14"]


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A tiny JAX run whose params are also saved in the port's format."""
    d = jax_train_cli.main(TINY + [
        "--model.model", "vqa_attention",
        "--train.train_dir", str(tmp_path_factory.mktemp("jax") / "run")])
    restored = jax_load_params(os.path.join(d, "params_final"))
    tree = restored["params"] if "params" in restored else restored
    save_params(os.path.join(d, PARAMS_FILE), params_from_flax(tree))
    return d


def test_port_predictor_answers_identically_to_jax(run_dir):
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(5, N_CELLS, C)).astype(np.float32)
    feats_b = rng.normal(size=(5, N_CELLS, C)).astype(np.float32)
    questions_b = ["w6 w7", "w9", "w10 w11", "w12", "w13 w14"]
    jax_pred = JaxPredictor(run_dir, batch_size=4)
    want = jax_pred.answer(feats, QUESTIONS)
    want_b = jax_pred.answer(feats_b, questions_b)

    pred = Predictor(run_dir, batch_size=4, device="cpu")
    assert pred.answer(feats, QUESTIONS) == want  # 5 rows at batch 4: padded
    assert Predictor(run_dir, batch_size=8, device="cpu").answer(
        feats, QUESTIONS) == want
    # submit/result: two requests in flight, results ordered
    h1 = pred.submit(feats, QUESTIONS)
    h2 = pred.submit(feats_b, questions_b)
    assert pred.result(h1) == want
    assert pred.result(h2) == want_b
    # features already on the device skip the upload
    assert pred.answer(torch.from_numpy(feats), QUESTIONS) == want


def test_port_staged_store_answers_identically_to_jax(run_dir):
    rng = np.random.default_rng(1)
    store = rng.normal(size=(7, 2, 2, C)).astype(np.float32)  # [M,g,g,C]
    idx = np.array([6, 0, 3, 3, 5])
    jax_pred = JaxPredictor(run_dir, batch_size=4)
    jax_pred.stage_store(store)
    want = jax_pred.answer_indexed(idx, QUESTIONS)

    pred = Predictor(run_dir, batch_size=4, device="cpu")
    with pytest.raises(ValueError, match="stage_store"):
        pred.answer_indexed(idx, QUESTIONS)
    pred.stage_store(store)
    assert pred.answer_indexed(idx, QUESTIONS) == want
    assert pred.answer(store.reshape(7, N_CELLS, C)[idx], QUESTIONS) == want


@pytest.mark.parametrize("bad", [[0, 7], [-1, 2]])
def test_answer_indexed_checks_the_range(run_dir, bad):
    """The JAX gather clamps a bad row silently; the port raises."""
    pred = Predictor(run_dir, batch_size=4, device="cpu")
    pred.stage_store(np.zeros((7, N_CELLS, C), np.float32))
    with pytest.raises(IndexError, match="out of range for a staged store"):
        pred.answer_indexed(np.array(bad), QUESTIONS[:2])


def test_predictor_defaults_to_cuda(run_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(run_dir, batch_size=4)


def test_orbax_params_are_refused_with_directions(run_dir):
    with pytest.raises(ValueError, match="params_from_flax"):
        Predictor(run_dir, batch_size=4, device="cpu",
                  params_path=os.path.join(run_dir, "params_final"))


def test_predict_cli_matches_jax(run_dir, tmp_path, capsys):
    rng = np.random.default_rng(2)
    store_path = str(tmp_path / "store.npz")
    np.savez(store_path,
             grid=rng.normal(size=(3, 2, 2, C)).astype(np.float16),
             pool5=rng.normal(size=(3, C)).astype(np.float32),
             image_ids=np.array([100, 101, 102]))
    args = ["--train_dir", run_dir, "--feature_path", store_path,
            "--image_id", "101", "--image_id", "100",
            "--question", "w5 w6", "--question", "w7 w8 w9"]
    want = jax_predict_cli.main(args)
    capsys.readouterr()
    got = predict_cli.main(args + ["--device", "cpu"])
    assert got == want
    assert json.loads(capsys.readouterr().out) == {"answers": want}
