"""Port parity of the no-attention ``vqa_baseline`` (models/vqa_baseline.py)
against the JAX package, and the entry points it shares with the attention
models:

- the model's logits and every gradient of its training loss through the
  weight bridge;
- 6 steps of resident ``fit_resident`` (pool5 on the device, no grid) and
  of streamed ``fit`` (the flat layout) against JAX's;
- ``cli.train`` then ``cli.eval``, ``Predictor(device="cpu")`` on pool5
  and ``cli.predict`` on a feature store;
- ``transfer_init`` into it: the word table bit for bit, a warning that
  the answer-space half does not apply.

float32 at tiny widths, torch at 2 threads, dropout 0. Tolerances: logits
1e-5 and gradients 1e-5 (the same f32 math, sums in another order);
training as ``test_torch_trainer.py``: params rtol 2e-4 / atol 2e-5,
logged losses rtol 1e-5.
"""

import contextlib
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_transfer_externaldata_tpu.config import Config as JaxConfig
from vqa_transfer_externaldata_tpu.data import datasets as jds
from vqa_transfer_externaldata_tpu.models.vqa_attention import (
    vqa_loss as jax_vqa_loss)
from vqa_transfer_externaldata_tpu.models.vqa_baseline import (
    VQABaselineModel as JaxModel)
from vqa_transfer_externaldata_tpu.models.zoo import build_model as jax_build
from vqa_transfer_externaldata_tpu.parallel.mesh import create_mesh
from vqa_transfer_externaldata_tpu.parallel.trainer import Trainer as JaxTrainer
from vqa_transfer_externaldata_torch.cli import eval as eval_cli
from vqa_transfer_externaldata_torch.cli import predict as predict_cli
from vqa_transfer_externaldata_torch.cli import train as train_cli
from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.data import datasets as tds
from vqa_transfer_externaldata_torch.models.vqa_attention import vqa_loss
from vqa_transfer_externaldata_torch.models.vqa_baseline import (
    VQABaselineModel)
from vqa_transfer_externaldata_torch.models.zoo import build_model
from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
from vqa_transfer_externaldata_torch.serving import Predictor
from vqa_transfer_externaldata_torch.utils import checkpoint as tck
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
    "model.model": "vqa_baseline",
    "train.batch_size": 16, "train.device_data_cache": True,
    "train.log_every": 2, "train.warmup_steps": 2,
    "train.learning_rate": 3e-3,
}
V, A, P, W, F, B, T = 64, 16, 32, 8, 16, 8, 6


@contextlib.contextmanager
def _records(level=logging.INFO):
    """(level, message) of what the port's logger says inside the block."""
    seen = []
    handler = logging.Handler(level)
    handler.emit = lambda r: seen.append((r.levelno, r.getMessage()))
    logger = logging.getLogger("vqa_torch")
    logger.addHandler(handler)
    try:
        yield seen
    finally:
        logger.removeHandler(handler)


def test_model_matches_jax():
    """Logits at eval and every gradient of the training loss against JAX's
    module through the bridge, from random values in every leaf."""
    rng = np.random.default_rng(0)
    mod = JaxModel(vocab_size=V, num_answers=A, word_dim=W, fusion_dim=F,
                   dropout=0.0, dtype=jnp.float32)
    pool5 = rng.normal(size=(B, P)).astype(np.float32)
    q = rng.integers(4, V, size=(B, T)).astype(np.int32)
    for i, n in enumerate([6, 1, 3, 0, 5, 2, 6, 4]):  # one empty question
        q[i, n:] = 0
    labels = rng.integers(4, A, size=B).astype(np.int32)
    tree = jax.device_get(mod.init(jax.random.PRNGKey(0), jnp.asarray(pool5),
                                   jnp.asarray(q), train=False)["params"])
    tree = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=np.shape(a)) * 0.3).astype(np.float32),
        tree)
    batch = {"answer_id": jnp.asarray(labels)}

    def jloss(params):
        out = mod.apply({"params": params}, jnp.asarray(pool5),
                        jnp.asarray(q), train=True,
                        rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_vqa_loss(out, batch)[0], out["logits"]

    (_, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(tree)
    want = params_from_flax(jax.device_get(jgrads))
    model = VQABaselineModel(V, A, feature_dim=P, word_dim=W, fusion_dim=F,
                             dropout=0.0, dtype=torch.float32)
    model.load_state_dict(params_from_flax(tree))
    with torch.no_grad():
        got = model(torch.from_numpy(pool5), torch.from_numpy(q))["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    out = model(torch.from_numpy(pool5), torch.from_numpy(q), train=True)
    vqa_loss(out, {"answer_id": torch.from_numpy(labels)})[0].backward()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_build_model_names_follow_the_flax_tree():
    cfg = Config().replace_flat(TINY)
    spec = build_model(cfg)
    jspec = jax_build(JaxConfig().replace_flat(TINY))
    tree = jspec.module.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 16)),
        jnp.ones((2, 6), jnp.int32), train=False)["params"]
    want = {k: tuple(v.shape) for k, v in params_from_flax(
        jax.device_get(tree)).items()}
    got = {k: tuple(v.shape) for k, v in spec.module.state_dict().items()}
    assert got == want
    assert spec.stage == "vqa" and spec.visual_key == "pool5"
    assert spec.inputs({"pool5": 1, "q_ids": 2, "features": 3}) == (1, 2)


def test_resident_upload_holds_pool5_and_no_grid(tmp_path):
    """The resident dataset of a model that reads no grid: the store's
    pool5 on the device and taken by row, no grid uploaded (a departure:
    JAX uploads the grid planes too), and the gather-free gate reports at
    info level, not as a warning."""
    cfg = Config().replace_flat(TINY)
    tr = Trainer(cfg, build_model(cfg), train_dir=str(tmp_path),
                 device="cpu")
    ds = tds.load_dataset(cfg, "train")
    with _records() as seen:
        data, make_batch, nbytes = tr._prepare_resident(ds)
    tr.close()
    assert "grid" not in data
    assert torch.equal(data["store_pool5"], torch.from_numpy(
        np.asarray(ds.store.pool5, np.float32)))
    idx = torch.tensor([3, 0, 7])
    batch = make_batch(idx)
    assert "features" not in batch
    rows = ds.arrays["image_index"][idx.numpy()]
    np.testing.assert_array_equal(batch["pool5"].numpy(),
                                  ds.store.pool5[rows])
    assert nbytes == sum(v.numel() * v.element_size() for v in data.values())
    gate = [lv for lv, m in seen if "resident_fused_attention" in m]
    assert gate == [logging.INFO]


def _losses(train_dir):
    with open(os.path.join(train_dir, "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    return {r["step"]: r["train/loss"] for r in recs if "train/loss" in r}


@pytest.mark.parametrize("loop", ["resident", "streamed"])
def test_training_matches_jax(tmp_path, loop):
    """6 steps from the same bridged parameters as JAX's: fit_resident on
    the joined corpus (pool5 taken by row on the device), and fit on
    streamed host batches of the flat layout."""
    over = ({} if loop == "resident" else
            {"data.synthetic_layout": "flat",
             "train.device_data_cache": False})
    jcfg = JaxConfig().replace_flat(dict(TINY, **over))
    jtr = JaxTrainer(jcfg, jax_build(jcfg), mesh=create_mesh(
        jcfg, devices=jax.devices()[:1]), train_dir=str(tmp_path / "jax"))
    jtrain = jds.load_dataset(jcfg, "train")
    js = jtr.init_state(next(jtrain.batches(1, epochs=1, shuffle=False)))
    params = params_from_flax(jax.device_get(js.params))
    cfg = Config().replace_flat(dict(TINY, **over))
    tr = Trainer(cfg, build_model(cfg), train_dir=str(tmp_path / "torch"),
                 device="cpu")
    s = tr.init_state(params)
    ttrain = tds.load_dataset(cfg, "train")
    if loop == "resident":
        js = jtr.fit_resident(jtrain, js, max_steps=6)
        s = tr.fit_resident(ttrain, s, max_steps=6)
    else:
        js = jtr.fit(jtrain.batches(16, seed=cfg.train.seed), js,
                     max_steps=6)
        s = tr.fit(ttrain.batches(16, seed=cfg.train.seed), s, max_steps=6)
    jtr.close()
    tr.close()
    want = params_from_flax(jax.device_get(js.params))
    got = tr.model.state_dict()
    assert s.step == 6 and set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
    lj, lt = _losses(tmp_path / "jax"), _losses(tmp_path / "torch")
    assert sorted(lt) == sorted(lj) == [2, 4, 6]
    for step in lj:
        np.testing.assert_allclose(lt[step], lj[step], rtol=1e-5)


def _argv(over):
    argv = ["--device", "cpu"]
    for k, v in dict(TINY, **over).items():
        argv += [f"--{k}", str(v).lower() if isinstance(v, bool) else str(v)]
    return argv


def test_cli_train_eval_and_serve_pool5(tmp_path, capsys):
    """cli.train (resident) and cli.eval on the run; the run served by
    Predictor(device="cpu") on pool5 vectors and by cli.predict from a
    feature store file, which picks each image's pool5."""
    run = str(tmp_path / "run")
    train_dir = train_cli.main(_argv({"train.max_steps": 4,
                                      "train.train_dir": run}))
    losses = _losses(train_dir)
    assert sorted(losses) == [2, 4] and all(np.isfinite(list(
        losses.values())))
    metrics = eval_cli.main(["--device", "cpu", "--train.train_dir",
                             train_dir])
    assert 0.0 <= metrics["vqa_accuracy"] <= 1.0
    assert os.path.exists(os.path.join(train_dir, "results_val.json"))

    pred = Predictor(train_dir, batch_size=4, device="cpu")
    assert pred.visual_key == "pool5"
    rng = np.random.default_rng(0)
    pool5 = rng.normal(size=(3, 16)).astype(np.float32)
    qs = ["w1 w2", "w3", "w4 w5 w6"]
    answers = pred.answer(pool5, qs)
    assert len(answers) == 3
    assert all(a in pred.answer_vocab.tokens for a in answers)
    store = str(tmp_path / "store.npz")
    np.savez(store, grid=rng.normal(size=(4, 3, 3, 16)).astype(np.float16),
             pool5=rng.normal(size=(4, 16)).astype(np.float32),
             image_ids=np.array([10, 11, 12, 13]))
    capsys.readouterr()
    got = predict_cli.main(["--train_dir", train_dir, "--device", "cpu",
                            "--feature_path", store, "--image_id", "12",
                            "--image_id", "10", "--question", qs[0],
                            "--question", qs[1]])
    assert json.loads(capsys.readouterr().out) == {"answers": got}
    with np.load(store) as f:
        assert got == pred.answer(f["pool5"][[2, 0]], qs[:2])


def test_transfer_init_into_the_baseline():
    """The stage-1 word table arrives bit for bit; the baseline has no
    answer table, so the rest keeps its fresh values and a warning says
    the answer-space half was skipped, as in JAX."""
    wv, av = tds.synthetic_vocabs(Config().replace_flat(TINY))
    g = torch.Generator().manual_seed(0)
    base = build_model(Config().replace_flat(TINY),
                       generator=g).module.state_dict()
    stage1 = build_model(Config().replace_flat(
        dict(TINY, **{"model.model": "vlmap"})), generator=g
    ).module.state_dict()
    stage1["word_emb.embedding"] = torch.randn(
        stage1["word_emb.embedding"].shape, generator=g)
    with _records(logging.WARNING) as seen:
        out = tck.transfer_init(base, stage1, wv, av)
    assert set(out) == set(base)
    assert torch.equal(out["word_emb.embedding"],
                       stage1["word_emb.embedding"])
    for k in base:
        if k != "word_emb.embedding":
            assert out[k] is base[k], k
    assert [lv for lv, m in seen if "no 'answer_embedding'" in m] == [
        logging.WARNING]
