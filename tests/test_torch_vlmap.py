"""Port parity: models/vlmap.py (both stage-1 models and their losses) and
the stage-1 datasets against the JAX package, through the weight bridge,
with dropout off. The JAX description model's GRU runs its Pallas kernels
(B1/B2) in interpret mode on the CPU, the port's bidirectional encoder the
plain versions of K6/K7.

float32. Tolerances: logits 1e-5 (cosines times a scale of 10, the same
forward with sums in another order); gradients 1e-4 relative and 1e-6
absolute (backward sums over the batch and the vocabulary in another
order); losses and metrics 1e-6 relative. The datasets are equal bit for
bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_transfer_externaldata_tpu.config import Config as JaxConfig
from vqa_transfer_externaldata_tpu.data import datasets as jds
from vqa_transfer_externaldata_tpu.models import vlmap as jv
from vqa_transfer_externaldata_tpu.models.zoo import build_model as jax_build
from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.data import datasets as tds
from vqa_transfer_externaldata_torch.models import vlmap as tv
from vqa_transfer_externaldata_torch.models.zoo import build_model
from vqa_transfer_externaldata_torch.utils.convert import (
    params_from_flax, params_to_flax)

torch.set_num_threads(2)  # xdist runs several workers on the same cores

TINY = {
    "data.synthetic": True, "data.synthetic_size": 48,
    "data.vocab_size": 64, "data.pool5_dim": 16,
    "data.max_question_len": 6, "model.word_dim": 8, "model.rnn_dim": 8,
    "model.dtype": "float32", "model.dropout": 0.0, "model.num_tasks": 4,
    "model.task_dim": 8, "model.num_candidates": 12,
}
LOGITS = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)
VARIANTS = [("vlmap", {}),
            ("vlmap_description", {}),
            ("vlmap_description", {"model.bidirectional_desc": True})]


def _specs(name, over, dense=False):
    flat = dict(TINY, **over, **{"model.model": name,
                                 "model.dense_candidate_loss": dense})
    jcfg, cfg = JaxConfig().replace_flat(flat), Config().replace_flat(flat)
    return jcfg, jax_build(jcfg), cfg, build_model(cfg)


def _batch(jcfg, stage, n=8, seed=0):
    """A training batch with duplicate candidates (one a duplicate of the
    positive) and its dense counts."""
    ds = jds.load_dataset(jcfg, "train", stage=stage)
    batch = dict(next(ds.batches(n, epochs=1, shuffle=False)))
    cand = np.asarray(batch["candidates"]).copy()
    cand[0, :3] = cand[0, 3]
    lab1 = int(batch["label"][1])
    cand[1, (lab1 + 1) % cand.shape[1]] = cand[1, lab1]
    batch["candidates"] = cand
    batch.pop("word", None)
    return jds.attach_candidate_counts(batch, jcfg.data.vocab_size)


def _random_tree(jspec, batch, seed):
    tree = jax.device_get(jspec.module.init(
        jax.random.PRNGKey(0), *jspec.inputs(batch), train=False)["params"])
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=np.shape(a)) * 0.3).astype(np.float32),
        tree)
    tree["logit_scale"] = np.float32(10.0)
    return tree


def _torch_batch(batch):
    # uint16 counts travel as int16 (as the trainer uploads them)
    return {k: torch.from_numpy(np.asarray(v).astype(np.int16)
                                if np.asarray(v).dtype == np.uint16
                                else np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("name,over", VARIANTS)
def test_eval_forward_matches_jax(name, over):
    jcfg, jspec, cfg, spec = _specs(name, over)
    batch = _batch(jcfg, jspec.stage)
    tree = _random_tree(jspec, batch, 0)
    want = jspec.module.apply({"params": tree}, *jspec.inputs(batch),
                              train=False)
    spec.module.load_state_dict(params_from_flax(tree))
    with torch.no_grad():
        got = spec.module(*spec.inputs(_torch_batch(batch)))
    assert spec.stage == jspec.stage
    for k in ("logits", "projection"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **LOGITS, err_msg=k)


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("name,over", VARIANTS)
def test_loss_and_every_gradient_match_jax(name, over, dense):
    jcfg, jspec, cfg, spec = _specs(name, over, dense)
    batch = _batch(jcfg, jspec.stage, seed=1)
    tree = _random_tree(jspec, batch, 1)

    def f(p):
        out = jspec.module.apply({"params": p}, *jspec.inputs(batch),
                                 train=True,
                                 rngs={"dropout": jax.random.PRNGKey(0)})
        return jspec.loss(out, batch)

    (lj, mj), gj = jax.value_and_grad(f, has_aux=True)(tree)
    want = params_from_flax(jax.device_get(gj))
    model = spec.module
    model.load_state_dict(params_from_flax(tree))
    tb = _torch_batch(batch)
    out = model(*spec.inputs(tb), train=True)
    assert ("logits_vocab" in out) == dense
    lt, mt = spec.loss(out, tb)
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-6)
    assert set(mt) == set(mj)
    for k in mj:
        np.testing.assert_allclose(mt[k].item(), float(mj[k]), rtol=1e-6,
                                   err_msg=k)
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **GRAD,
                                   err_msg=k)


@pytest.mark.parametrize("name,over", VARIANTS)
def test_dense_loss_equals_gathered_loss(name, over):
    """The count-weighted dense CE is the K-candidate CE, duplicates
    included: the same loss and gradients on the same parameters; eval
    stays on the gathered path."""
    _, _, cfg_g, spec_g = _specs(name, over)
    jcfg, _, _, spec_d = _specs(name, over, dense=True)
    batch = _torch_batch(_batch(jcfg, spec_g.stage, seed=2))
    spec_d.module.load_state_dict(spec_g.module.state_dict())
    res = []
    for spec in (spec_g, spec_d):
        loss, _ = spec.loss(spec.module(*spec.inputs(batch), train=True),
                            batch)
        loss.backward()
        res.append((loss.item(), {k: p.grad for k, p in
                                  spec.module.named_parameters()}))
    np.testing.assert_allclose(res[1][0], res[0][0], rtol=1e-6)
    for k, g in res[0][1].items():
        np.testing.assert_allclose(res[1][1][k].numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    with torch.no_grad():
        out = spec_d.module(*spec_d.inputs(batch))
    assert "logits" in out and "logits_vocab" not in out


def test_dense_loss_grad_finite_with_extreme_noncandidate_logits():
    """A non-candidate logit far above the candidate max must not NaN the
    backward (both where guards around the exp), and a row with no
    candidate (padding) must not send log(0) through it; the gradients
    equal JAX's."""
    s = np.array([[-50.0, 45.0, -50.0, -49.0],
                  [1.0, 2.0, 3.0, 4.0]], np.float32)
    c = np.array([[1, 0, 2, 1], [0, 0, 0, 0]], np.float32)
    word = np.array([3, 0], np.int32)
    mask = np.array([1.0, 0.0], np.float32)

    def jf(s):
        return jv._vlmap_dense_loss(
            {"logits_vocab": s}, {"cand_counts": jnp.asarray(c),
                                  "word": jnp.asarray(word),
                                  "example_mask": jnp.asarray(mask)})[0]

    lj, gj = jax.value_and_grad(jf)(jnp.asarray(s))
    st = torch.from_numpy(s).requires_grad_()
    lt, _ = tv._vlmap_dense_loss(
        {"logits_vocab": st},
        {"cand_counts": torch.from_numpy(c.astype(np.int16)),
         "word": torch.from_numpy(word), "example_mask": torch.from_numpy(mask)})
    lt.backward()
    assert np.isfinite(lt.item())
    assert torch.isfinite(st.grad).all(), st.grad
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-6)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=1e-7)
    # row 0: the softmax gradient over the candidate multiset {0, 2, 2, 3}
    p = torch.softmax(torch.tensor([s[0, 0], s[0, 2], s[0, 2], s[0, 3]]), 0)
    expect = np.array([p[0], 0.0, p[1] + p[2], p[3] - 1.0], np.float32)
    np.testing.assert_allclose(st.grad[0].numpy(), expect, rtol=1e-5,
                               atol=1e-7)
    assert st.grad[1].abs().max().item() == 0.0


def test_attach_candidate_counts_matches_jax():
    rng = np.random.default_rng(3)
    for K in (12, 300):  # uint8 counts, then uint16
        cand = rng.integers(0, 40, size=(9, K)).astype(np.int32)
        label = rng.integers(0, K, size=9).astype(np.int32)
        arrays = {"candidates": cand, "label": label}
        want = jds.attach_candidate_counts(arrays, 40)
        got = tds.attach_candidate_counts(arrays, 40)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    kept = tds.attach_candidate_counts(
        {"candidates": cand, "label": label, "word": np.zeros(9, np.int32)},
        40)
    np.testing.assert_array_equal(kept["word"], 0)


@pytest.mark.parametrize("stage", ["vlmap", "vlmap_desc"])
@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("dense", [False, True])
def test_stage1_datasets_equal_jax(stage, split, dense):
    flat = dict(TINY, **{"model.dense_candidate_loss": dense})
    want = jds.load_dataset(JaxConfig().replace_flat(flat), split,
                            stage=stage)
    got = tds.load_dataset(Config().replace_flat(flat), split, stage=stage)
    assert sorted(got.arrays) == sorted(want.arrays)
    for k in want.arrays:
        assert got.arrays[k].dtype == want.arrays[k].dtype, k
        np.testing.assert_array_equal(got.arrays[k], want.arrays[k],
                                      err_msg=k)
    for a, b in zip(got.index_batches(16, seed=4),
                    want.index_batches(16, seed=4)):
        np.testing.assert_array_equal(a, b)
        break


def test_bridge_round_trip_of_stage1_trees_is_exact():
    """flax -> state_dict -> flax gives the stage-1 tree back bit for bit:
    the visual_proj Dense layers, the 0-d logit_scale, the task table and
    the bidirectional encoder's two directions."""
    jcfg, jspec, _, spec = _specs("vlmap_description",
                                  {"model.bidirectional_desc": True})
    batch = _batch(jcfg, jspec.stage)
    tree = _random_tree(jspec, batch, 5)
    sd = params_from_flax(tree)
    assert set(sd) == set(spec.module.state_dict())
    assert sd["logit_scale"].shape == ()
    spec.module.load_state_dict(sd)
    back = params_to_flax(spec.module.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]),
                                      np.asarray(a), err_msg=str(path))
