"""Port parity: the raw-image model ``vqa_end2end`` (models/end2end.py, its
registry entry, the frozen backbone in the Trainer, the synthetic pixels,
the CLIs) against the JAX package.

The model is tiny: ResNet stages (1, 1, 1, 1), width 8, 64-pixel images
(a 2x2x256 grid), float32, dropout off, with nonzero random BatchNorm
statistics bridged through ``utils/convert.py``. Tolerances:

- logits: 1e-5 of the largest |logit| (measured 2e-7); gradients: 1e-4 of
  each leaf's largest |value| (measured 1.7e-5: the backward's f32 sums run
  in another order through the backbone's convolutions);
- training: parameters rtol 2e-4 / atol 2e-5 and logged losses rtol 1e-5,
  the bound of the port's other ``fit_resident`` parity tests (Adam turns
  f32 summation-order noise on a near-zero gradient into an update of up
  to lr);
- the frozen backbone, its BatchNorm statistics, the synthetic pixels and
  the example batches: bit for bit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_resnet import randomize_bn, tiny_torchvision_state_dict
from vqa_transfer_externaldata_tpu.config import Config as JaxConfig
from vqa_transfer_externaldata_tpu.data import datasets as jds
from vqa_transfer_externaldata_tpu.models import zoo as jzoo
from vqa_transfer_externaldata_tpu.models.vqa_attention import (
    vqa_loss as jax_vqa_loss)
from vqa_transfer_externaldata_tpu.parallel.mesh import create_mesh
from vqa_transfer_externaldata_tpu.parallel.trainer import Trainer as JaxTrainer
from vqa_transfer_externaldata_torch.cli import eval as eval_cli
from vqa_transfer_externaldata_torch.cli import predict as predict_cli
from vqa_transfer_externaldata_torch.cli import train as train_cli
from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.data import datasets as tds
from vqa_transfer_externaldata_torch.data.ingest import (
    _decode_pil, coco_image_path)
from vqa_transfer_externaldata_torch.models import zoo
from vqa_transfer_externaldata_torch.models.end2end import (
    VQAEnd2EndModel, end2end_loss)
from vqa_transfer_externaldata_torch.ops.resnet import (
    convert_torch_state_dict)
from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
from vqa_transfer_externaldata_torch.serving import PARAMS_FILE, Predictor
from vqa_transfer_externaldata_torch.utils.checkpoint import load_params
from vqa_transfer_externaldata_torch.utils.convert import (
    batch_stats_from_flax, batch_stats_to_flax, params_from_flax,
    params_to_flax)

torch.set_num_threads(2)  # xdist runs several workers on the same cores

SIZE, T = 64, 6
TINY_E2E = {
    "model.model": "vqa_end2end", "model.resnet_stages": "1,1,1,1",
    "model.resnet_width": 8, "data.image_size": SIZE,
    "data.grid_h": 2, "data.grid_w": 2,
    "data.synthetic": True, "data.synthetic_size": 32,
    "data.vocab_size": 64, "data.num_answers": 16, "data.pool5_dim": 16,
    "data.max_question_len": T, "model.word_dim": 8, "model.rnn_dim": 8,
    "model.fusion_dim": 16, "model.att_hidden": 8, "model.answer_dim": 8,
    "model.dtype": "float32", "model.dropout": 0.0,
    "train.batch_size": 8, "train.device_data_cache": True,
    "train.log_every": 1, "train.warmup_steps": 2,
    "train.learning_rate": 3e-3, "train.weight_decay": 1e-2,
    "train.checkpoint_every": 100,
}
TOL_LOGITS, TOL_GRAD = 1e-5, 1e-4


def argv_of(flat: dict) -> list:
    out = []
    for k, v in flat.items():
        out += [f"--{k}", str(v).lower() if isinstance(v, bool) else str(v)]
    return out


def write_jpeg_artifacts(root: str, *, n_images: int = 6,
                         n_questions: int = 24, seed: int = 0) -> dict:
    """Seeded COCO-named JPEGs (sizes around SIZE, so some resize) and
    ``vqa_{train,val}.npz`` question tables whose ``image_index`` rows
    name them through ``image_ids.npy``."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    image_dir, data_dir = os.path.join(root, "images"), \
        os.path.join(root, "data")
    os.makedirs(image_dir, exist_ok=True)
    os.makedirs(data_dir, exist_ok=True)
    ids = rng.choice(np.arange(1, 10 ** 6), size=n_images, replace=False)
    for split in ("train2014", "val2014"):
        for i in ids:
            h, w = (SIZE, SIZE) if i % 2 else (SIZE + 13, SIZE - 7)
            Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(
                np.uint8)).save(coco_image_path(image_dir, split, int(i)),
                                quality=90)
    np.save(os.path.join(data_dir, "image_ids.npy"), ids.astype(np.int64))
    words, answers = tds.synthetic_vocabs(Config().replace_flat(TINY_E2E))
    words.save(os.path.join(data_dir, "vocab.json"))
    answers.save(os.path.join(data_dir, "answer_vocab.json"))
    for split in ("train", "val"):
        n = n_questions
        answer = rng.integers(4, 16, size=n).astype(np.int32)
        scores = np.zeros((n, 16), np.float32)
        scores[np.arange(n), answer] = 1.0
        q_ids = rng.integers(4, 64, size=(n, T)).astype(np.int32)
        q_ids[:, 4:] = 0
        np.savez(os.path.join(data_dir, f"vqa_{split}.npz"), q_ids=q_ids,
                 answer_id=answer, answer_scores=scores,
                 question_id=np.arange(n, dtype=np.int64) + 1000,
                 image_index=rng.integers(0, n_images, n).astype(np.int32))
    return {"image_dir": image_dir, "data_dir": data_dir, "ids": ids}


def jax_variables(module, seed=0):
    """JAX init with random BatchNorm statistics, scales and biases."""
    rng = np.random.default_rng(seed)
    images = np.zeros((1, SIZE, SIZE, 3), np.uint8)
    q = np.ones((1, T), np.int32)
    init = jax.jit(lambda key, x, q: module.init(key, x, q, train=False))
    v = jax.tree_util.tree_map(np.asarray, jax.device_get(init(
        jax.random.PRNGKey(seed), jnp.asarray(images), jnp.asarray(q))))
    return (randomize_bn(v["params"], rng),
            randomize_bn(v["batch_stats"], rng))


def tiny_model(freeze_backbone=True):
    return VQAEnd2EndModel(
        64, 16, word_dim=8, rnn_dim=8, fusion_dim=16, att_hidden=8,
        answer_dim=8, dtype=torch.float32, freeze_backbone=freeze_backbone,
        image_size=SIZE, stage_sizes=(1, 1, 1, 1), width=8)


def batch(seed=1, n=4, size=SIZE):
    rng = np.random.default_rng(seed)
    q = rng.integers(4, 64, (n, T)).astype(np.int32)
    q[:, 4:] = 0
    return (rng.integers(0, 256, (n, size, size, 3)).astype(np.uint8), q,
            rng.integers(4, 16, n).astype(np.int32))


def rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("frozen", [True, False])
def test_end2end_forward_and_gradients_match_jax(frozen):
    """Logits and the loss's gradients. Frozen, the backbone gets none
    (JAX's are zeros behind stop_gradient); unfrozen, the head's explicit
    attention backward returns dv and every resnet leaf gets JAX's
    gradient. Images of 80 pixels exercise the on-device resize."""
    jm = jzoo.build_model(JaxConfig().replace_flat(TINY_E2E)).module.clone(
        freeze_backbone=frozen)
    params, stats = jax_variables(jm)
    images, q, labels = batch(size=80)

    def loss_fn(p):
        out = jm.apply({"params": p, "batch_stats": stats},
                       jnp.asarray(images), jnp.asarray(q), train=False)
        return jax_vqa_loss(out, {"answer_id": jnp.asarray(labels)})[0], out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    model = tiny_model(frozen)
    assert model.head.feature_grad is (not frozen)
    model.load_state_dict({**params_from_flax(params),
                           **batch_stats_from_flax(stats)})
    out = model(torch.from_numpy(images), torch.from_numpy(q))
    assert rel(out["logits"].detach().numpy(),
               np.asarray(jout["logits"])) <= TOL_LOGITS
    loss, _ = end2end_loss(out, {"answer_id": torch.from_numpy(labels)})
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()),
                                allow_unused=True)
    want = params_from_flax(jax.device_get(jgrads))
    for (k, _), g in zip(named.items(), grads):
        if k.startswith("resnet.") and frozen:
            assert g is None, k
            assert not want[k].any(), k
        else:
            assert rel(g.numpy(), want[k].numpy()) <= TOL_GRAD, k


def test_full_width_state_dict_equals_jax_tree():
    """At the config's full width (ResNet-101 at 448 pixels, the head at
    config.py's widths) the port's parameters and buffers have the names
    and shapes of JAX's init, bridged; no compute (JAX's eval_shape, the
    port on the meta device)."""
    cfg = {"model.model": "vqa_end2end"}
    jm = jzoo.build_model(JaxConfig().replace_flat(cfg)).module
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 448, 448, 3), jnp.uint8),
        jnp.zeros((1, 26), jnp.int32), train=False))
    zeros = lambda t: jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), t)
    want = {**params_from_flax(zeros(shapes["params"])),
            **batch_stats_from_flax(zeros(shapes["batch_stats"]))}
    with torch.device("meta"):
        spec = zoo.build_model(Config().replace_flat(cfg))
    got = spec.module.state_dict()
    assert spec.visual_key == "images" and spec.stage == "vqa"
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    n_resnet = sum(v.numel() for k, v in got.items()
                   if k.startswith("resnet.") and not k.endswith(
                       (".mean", ".var")))
    assert 42e6 < n_resnet < 46e6, n_resnet
    assert spec.module.freeze_backbone and spec.module.stem == \
        "space_to_depth"


def test_weight_bridge_round_trips_the_end2end_tree():
    """Every parameter and BatchNorm statistic of the end2end tree through
    the bridge and back, bit for bit; the Dense and GRU mappings as
    before (a Dense kernel is the transposed weight)."""
    params, stats = jax_variables(jzoo.build_model(
        JaxConfig().replace_flat(TINY_E2E)).module)
    sd = {**params_from_flax(params), **batch_stats_from_flax(stats)}
    model = tiny_model()
    model.load_state_dict(sd)  # every key and shape
    np.testing.assert_array_equal(sd["head.ans_proj.weight"].numpy(),
                                  params["head"]["ans_proj"]["kernel"].T)
    np.testing.assert_array_equal(sd["head.gru.uh"].numpy(),
                                  params["head"]["gru"]["uh"])
    np.testing.assert_array_equal(
        sd["resnet.layer3_0.conv2.weight"].numpy(),
        params["resnet"]["layer3_0"]["conv2"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["resnet.layer3_0.bn2.mean"].numpy(),
        stats["resnet"]["layer3_0"]["bn2"]["mean"])
    back = model.state_dict()
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                      jax.tree_util.tree_leaves_with_path(t)}
    for ours, theirs in ((params_to_flax(back), params),
                         (batch_stats_to_flax(back), stats)):
        a, b = flat(ours), flat(theirs)
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_synthetic_images_and_example_batch_equal_jax():
    jcfg, cfg = JaxConfig().replace_flat(TINY_E2E), \
        Config().replace_flat(TINY_E2E)
    for split in ("train", "val"):
        want, got = jds.load_dataset(jcfg, split), tds.load_dataset(cfg,
                                                                    split)
        assert sorted(got.arrays) == sorted(want.arrays)
        assert "images" in got.arrays and "features" not in got.arrays
        for k in want.arrays:
            assert got.arrays[k].dtype == want.arrays[k].dtype, k
            np.testing.assert_array_equal(got.arrays[k], want.arrays[k],
                                          err_msg=k)
    for family in zoo.MODELS:
        over = dict(TINY_E2E, **{"model.model": family})
        want = jzoo.example_batch(JaxConfig().replace_flat(over), 3)
        got = zoo.example_batch(Config().replace_flat(over), 3)
        assert sorted(got) == sorted(want), family
        for k in want:
            assert got[k].dtype == want[k].dtype and \
                got[k].shape == want[k].shape, (family, k)
    assert zoo.resnet_stage_sizes(Config()) == (3, 4, 23, 3)


def test_frozen_backbone_training_matches_jax(tmp_path):
    """3 resident steps on the synthetic pixels from the same parameters:
    the Trainer freezes ``resnet`` for a model that declares
    ``freeze_backbone`` (no Adam moments, no update, no weight decay), and
    the backbone's parameters and BatchNorm statistics come out bit-equal
    to what went in, on both sides."""
    jcfg = JaxConfig().replace_flat(TINY_E2E)
    spec = jzoo.build_model(jcfg)
    jtr = JaxTrainer(jcfg, spec, mesh=create_mesh(
        jcfg, devices=jax.devices()[:1]), train_dir=str(tmp_path / "jax"))
    ds = jds.load_dataset(jcfg, "train")
    example = next(ds.batches(1, epochs=1, shuffle=False))
    params, stats = jax_variables(spec.module)
    js = jtr.init_state(example, params=params,
                        extra_vars={"batch_stats": stats})
    js = jtr.fit_resident(ds, js, max_steps=3)
    want = params_from_flax(jax.device_get(js.params))
    jtr.close()

    cfg = Config().replace_flat(TINY_E2E)
    tr = Trainer(cfg, zoo.build_model(cfg), train_dir=str(tmp_path / "pt"),
                 device="cpu")
    start = {**params_from_flax(params), **batch_stats_from_flax(stats)}
    s = tr.init_state(start)
    assert not any(k.startswith("resnet.") for k in s.opt_state.mu)
    assert any(k.startswith("head.") for k in s.opt_state.mu)
    s = tr.fit_resident(tds.load_dataset(cfg, "train"), s, max_steps=3)
    tr.close()
    got = tr.model.state_dict()
    for k, v in got.items():
        if k.startswith("resnet."):
            torch.testing.assert_close(v, start[k], rtol=0, atol=0, msg=k)
            if k in want:
                torch.testing.assert_close(want[k], start[k], rtol=0,
                                           atol=0, msg=k)
        else:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       rtol=2e-4, atol=2e-5, err_msg=k)
    assert not any(k.startswith("resnet.") for k in s.opt_state.mu)

    def losses(d):
        with open(os.path.join(d, "metrics.jsonl")) as fh:
            return {r["step"]: (r["train/loss"], r["train/grad_norm"])
                    for r in map(json.loads, fh) if "train/loss" in r}

    lj, lt = losses(tmp_path / "jax"), losses(tmp_path / "pt")
    assert sorted(lj) == sorted(lt) == [1, 2, 3]
    for step in lj:
        np.testing.assert_allclose(lt[step], lj[step], rtol=1e-5)
    ck = torch.load(os.path.join(tmp_path, "pt", "ckpt", "ckpt_3.pt"),
                    weights_only=True)
    assert set(ck["buffers"]) == {k for k in got if k.endswith(
        (".mean", ".var"))}


def test_live_parameter_the_loss_cannot_reach_raises(tmp_path):
    """Only a frozen parameter may go without a gradient: with the
    backbone under ``no_grad`` but not frozen in the optimizer,
    ``train_step`` names the unreached parameters instead of training them
    on zeros."""
    cfg = Config().replace_flat(TINY_E2E)
    tr = Trainer(cfg, zoo.build_model(cfg), train_dir=str(tmp_path),
                 device="cpu")
    s = tr.init_state()
    ds = tds.load_dataset(cfg, "train")
    _, make_batch, _ = tr._prepare_resident(ds)
    idx = torch.from_numpy(next(ds.index_batches(8, seed=0)))
    frozen = tr.tx.frozen
    tr.tx.frozen = lambda name: False
    with pytest.raises(RuntimeError, match=r"live parameters \['resnet\."):
        tr.train_step(s, make_batch(idx))
    tr.tx.frozen = frozen
    s, metrics = tr.train_step(s, make_batch(idx))
    assert s.step == 1 and torch.isfinite(metrics["loss"])
    tr.close()


def test_cli_train_eval_predict_on_jpegs(tmp_path):
    """``cli.train`` on JPEG artifacts (streamed through
    ImageQuestionDataset) with a torchvision checkpoint grafted into the
    backbone, then ``cli.eval`` on its checkpoint and ``cli.predict
    --image`` against ``Predictor`` on the same decoded pixels."""
    fx = write_jpeg_artifacts(str(tmp_path))
    pth = str(tmp_path / "resnet_tiny.pth")
    sd = tiny_torchvision_state_dict()
    torch.save(sd, pth)
    flat = dict(TINY_E2E, **{
        "data.synthetic": False, "data.dataset_dir": fx["data_dir"],
        "data.image_dir": fx["image_dir"], "model.resnet_checkpoint": pth,
        "data.vocab_path": os.path.join(fx["data_dir"], "vocab.json"),
        "data.answer_vocab_path": os.path.join(fx["data_dir"],
                                               "answer_vocab.json"),
        "train.device_data_cache": False, "train.max_steps": 2,
        "train.log_every": 1, "train.eval_every": 2,
        "train.prefetch_batches": 0})
    run = str(tmp_path / "run")
    train_dir = train_cli.main(["--device", "cpu", "--train.train_dir", run]
                               + argv_of(flat))
    final = load_params(os.path.join(train_dir, PARAMS_FILE))
    want = convert_torch_state_dict(sd, stage_sizes=(1, 1, 1, 1),
                                    stem="space_to_depth")
    for k, v in want.items():
        torch.testing.assert_close(final[f"resnet.{k}"], v, rtol=0, atol=0,
                                   msg=k)
    with open(os.path.join(train_dir, "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    assert any("val/vqa_accuracy" in r for r in recs)

    metrics = eval_cli.main(["--device", "cpu", "--train.train_dir",
                             train_dir])
    assert 0.0 <= metrics["vqa_accuracy"] <= 1.0
    with open(os.path.join(train_dir, "results_val.json")) as fh:
        assert len(json.load(fh)) == 24

    paths = [coco_image_path(fx["image_dir"], "val2014", int(i))
             for i in fx["ids"][:3]]
    argv = ["--device", "cpu", "--train_dir", train_dir]
    for p in paths:
        argv += ["--image", p, "--question", "w4 w5 w6"]
    answers = predict_cli.main(argv)
    pred = Predictor(train_dir, batch_size=8, device="cpu")
    assert pred.visual_key == "images"
    direct = pred.answer(np.stack([_decode_pil(p, SIZE) for p in paths]),
                         ["w4 w5 w6"] * 3)
    assert answers == direct and len(answers) == 3
