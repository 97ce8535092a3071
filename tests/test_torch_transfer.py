"""Port parity: the cross-stage transfer (utils/checkpoint.py
``transfer_init`` and ``answer_embedding_from_words``) against the JAX
package's on bridged trees, bit for bit; its error cases; and the train
CLI end to end on the CPU: stage 1, then stage 2 initialized from stage
1's ``params_final.pt``, then ``Predictor(device="cpu")`` on the result.
"""

import contextlib
import json
import logging
import os

import jax
import numpy as np
import pytest
import torch

from vqa_transfer_externaldata_tpu.config import Config as JaxConfig
from vqa_transfer_externaldata_tpu.data import datasets as jds
from vqa_transfer_externaldata_tpu.models.zoo import build_model as jax_build
from vqa_transfer_externaldata_tpu.utils import checkpoint as jck
from vqa_transfer_externaldata_tpu.utils.vocab import Vocab as JaxVocab
from vqa_transfer_externaldata_torch.cli import train as train_cli
from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.data.datasets import synthetic_vocabs
from vqa_transfer_externaldata_torch.models.zoo import build_model
from vqa_transfer_externaldata_torch.serving import Predictor
from vqa_transfer_externaldata_torch.utils import checkpoint as tck
from vqa_transfer_externaldata_torch.utils.convert import params_from_flax
from vqa_transfer_externaldata_torch.utils.vocab import SPECIALS, Vocab

torch.set_num_threads(2)  # xdist runs several workers on the same cores

TINY = {
    "data.synthetic": True, "data.synthetic_layout": "joined",
    "data.synthetic_size": 64, "data.vocab_size": 64,
    "data.num_answers": 16, "data.grid_h": 3, "data.grid_w": 3,
    "data.feature_dim": 16, "data.pool5_dim": 16,
    "data.max_question_len": 6, "model.word_dim": 8, "model.rnn_dim": 8,
    "model.fusion_dim": 16, "model.att_hidden": 8, "model.answer_dim": 8,
    "model.dtype": "float32", "model.dropout": 0.0, "model.num_tasks": 4,
    "model.task_dim": 8, "model.num_candidates": 12,
    "train.batch_size": 16, "train.device_data_cache": True,
    "train.log_every": 2, "train.warmup_steps": 2,
    "train.learning_rate": 3e-3,
}


def _jax_params(jcfg, name):
    spec = jax_build(jcfg.replace_flat({"model.model": name}))
    ds = jds.load_dataset(jcfg, "train", stage=spec.stage)
    batch = next(ds.batches(2, epochs=1, shuffle=False))
    return jax.device_get(spec.module.init(
        {"params": jax.random.PRNGKey(0)}, *spec.inputs(batch),
        train=False)["params"])


@pytest.mark.parametrize("stage1", ["vlmap", "vlmap_description"])
def test_transfer_init_matches_jax(stage1):
    jcfg = JaxConfig().replace_flat(TINY)
    vq = _jax_params(jcfg, "vqa_attention")
    vl = _jax_params(jcfg, stage1)
    # A recognizable trained table; answer "w3" is word "w3".
    rng = np.random.default_rng(0)
    vl["word_emb"] = {"embedding": rng.normal(
        size=np.shape(vl["word_emb"]["embedding"])).astype(np.float32)}
    wv, av = jds.synthetic_vocabs(jcfg)
    want = params_from_flax(jck.transfer_init(vq, vl, wv, av))
    twv, tav = synthetic_vocabs(Config().replace_flat(TINY))
    got = tck.transfer_init(params_from_flax(vq), params_from_flax(vl),
                            twv, tav)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    table = vl["word_emb"]["embedding"]
    np.testing.assert_array_equal(got["word_emb.embedding"].numpy(), table)
    np.testing.assert_array_equal(
        got["answer_embedding"][tav.token_to_id["w3"]].numpy(),
        table[twv.token_to_id["w3"]])


def test_answer_embedding_from_words_matches_jax():
    tokens = SPECIALS + ["hot", "dog", "cat"]
    answers = SPECIALS + ["hot dog", "cat", "zzz"]
    table = np.random.default_rng(1).normal(size=(len(tokens), 4)).astype(
        np.float32)
    fallback = np.random.default_rng(2).normal(size=(7, 4)).astype(np.float32)
    want = jck.answer_embedding_from_words(
        table, JaxVocab.from_tokens(tokens), JaxVocab.from_tokens(answers),
        fallback=fallback)
    got = tck.answer_embedding_from_words(
        table, Vocab.from_tokens(tokens), Vocab.from_tokens(answers),
        fallback=fallback)
    np.testing.assert_array_equal(got, want)
    a = Vocab.from_tokens(answers).token_to_id
    np.testing.assert_array_equal(got[a["hot dog"]],
                                  (table[4] + table[5]) / np.float32(2))
    np.testing.assert_array_equal(got[a["zzz"]], fallback[a["zzz"]])


def _torch_params(name):
    cfg = Config().replace_flat(dict(TINY, **{"model.model": name}))
    return build_model(cfg, generator=torch.Generator().manual_seed(0)) \
        .module.state_dict()


def test_transfer_init_error_cases():
    wv, av = synthetic_vocabs(Config().replace_flat(TINY))
    vq, vl = _torch_params("vqa_attention"), _torch_params("vlmap")
    with pytest.raises(ValueError, match="word_emb"):  # stage 2 has none
        tck.transfer_init({"dense.weight": torch.zeros(2, 2)}, vl, wv, av)
    with pytest.raises(ValueError, match="stage-1"):  # stage 1 has none
        tck.transfer_init(vq, {"fc.weight": torch.zeros(2, 2)}, wv, av)
    twice = dict(vl, **{"head.word_emb.embedding": vl["word_emb.embedding"]})
    with pytest.raises(ValueError, match="ambiguous"):
        tck.transfer_init(vq, twice, wv, av)
    small = dict(vl, **{"word_emb.embedding": vl["word_emb.embedding"][:5]})
    with pytest.raises(ValueError, match="shape mismatch"):
        tck.transfer_init(vq, small, wv, av)
    wide = dict(vq, answer_embedding=torch.zeros(16, 5))
    with pytest.raises(ValueError, match="answer embedding dim"):
        tck.transfer_init(wide, vl, wv, av)


def test_transfer_init_nested_and_without_answer_table():
    """Tables are found by name wherever they are nested, and the inputs
    are left as they were; a stage-2 model without an answer table gets the
    word table and a warning, as in the JAX package."""
    wv, av = synthetic_vocabs(Config().replace_flat(TINY))
    vq, vl = _torch_params("vqa_attention"), _torch_params("vlmap")
    vl["word_emb.embedding"] = torch.randn(
        vl["word_emb.embedding"].shape,
        generator=torch.Generator().manual_seed(3))
    nested = {f"head.{k}": v for k, v in vq.items()}
    nested["resnet.conv1.weight"] = torch.ones(3)
    out = tck.transfer_init(nested, vl, wv, av)
    assert torch.equal(out["head.word_emb.embedding"], vl["word_emb.embedding"])
    assert out["resnet.conv1.weight"] is nested["resnet.conv1.weight"]
    assert not torch.equal(nested["head.word_emb.embedding"],
                           vl["word_emb.embedding"])
    assert torch.equal(out["head.answer_embedding"][av.token_to_id["w3"]],
                       vl["word_emb.embedding"][wv.token_to_id["w3"]])
    bare = {k: v for k, v in vq.items() if k != "answer_embedding"}
    with _warnings() as seen:
        out = tck.transfer_init(bare, vl, wv, av)
    assert set(out) == set(bare)
    assert torch.equal(out["word_emb.embedding"], vl["word_emb.embedding"])
    assert any("no 'answer_embedding'" in m for m in seen)


@contextlib.contextmanager
def _warnings():
    """The messages the port's logger warns with inside the block."""
    seen = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: seen.append(record.getMessage())
    logger = logging.getLogger("vqa_torch")
    logger.addHandler(handler)
    try:
        yield seen
    finally:
        logger.removeHandler(handler)


def _argv(over):
    argv = ["--device", "cpu"]
    for k, v in dict(TINY, **over).items():
        argv += [f"--{k}", str(v).lower() if isinstance(v, bool) else str(v)]
    return argv


def _losses(train_dir):
    with open(os.path.join(train_dir, "metrics.jsonl")) as fh:
        return [json.loads(line)["train/loss"] for line in fh]


def test_cli_stage1_then_transfer_then_serve(tmp_path):
    stage1 = train_cli.main(_argv({
        "model.model": "vlmap_description", "model.bidirectional_desc": True,
        "train.max_steps": 4, "train.train_dir": str(tmp_path / "s1")}))
    assert np.isfinite(_losses(stage1)).all() and len(_losses(stage1)) == 2
    s1 = torch.load(os.path.join(stage1, "params_final.pt"),
                    weights_only=True)
    assert "desc_bigru.fwd.uh" in s1 and "desc_bigru.bwd.uh" in s1
    with pytest.raises(ValueError, match="stage-1"):
        Predictor(stage1, device="cpu")
    # Stage 2 with the transferred tables frozen: they arrive unchanged.
    stage2 = train_cli.main(_argv({
        "train.pretrained_param_path": os.path.join(stage1,
                                                    "params_final.pt"),
        "train.freeze_params": "word_emb,answer_embedding",
        "train.max_steps": 4, "train.train_dir": str(tmp_path / "s2")}))
    assert np.isfinite(_losses(stage2)).all()
    s2 = torch.load(os.path.join(stage2, "params_final.pt"),
                    weights_only=True)
    assert torch.equal(s2["word_emb.embedding"], s1["word_emb.embedding"])
    wv, av = synthetic_vocabs(Config().replace_flat(TINY))
    for a in range(4, len(av)):  # every answer token is a word token
        w = wv.token_to_id[av.tokens[a]]
        assert torch.equal(s2["answer_embedding"][a],
                           s1["word_emb.embedding"][w]), a
    pred = Predictor(stage2, batch_size=4, device="cpu")
    feats = np.abs(np.random.default_rng(0).normal(size=(3, 9, 16))).astype(
        np.float32)
    answers = pred.answer(feats, ["w1 w2", "w3", "w4 w5 w6"])
    assert len(answers) == 3 and all(a in av.tokens for a in answers)


def test_cli_transfer_only_applies_to_stage2(tmp_path):
    with pytest.raises(ValueError, match="only applies to stage-2"):
        train_cli.main(_argv({"model.model": "vlmap",
                              "train.pretrained_param_path": "x",
                              "train.train_dir": str(tmp_path)}))
