"""The paper's claim on the port: answers never seen as stage-2 training
targets are answered through the transferred word space (the JAX
package's ``tests/test_transfer.py::test_transfer_beats_scratch_on_oov_answers``,
its protocol and thresholds unchanged), on ``synthetic_transfer_corpus``,
which equals the JAX package's bit for bit; and the stage-1 models held
against the JAX package's float64 numpy oracles
(``utils/fidelity.py::reference_vlmap_forward_numpy`` and
``reference_vlmap_desc_forward_numpy``) on bridged weights.

The oracles: float32 against float64, cosines times a scale of 10 from
sums of at most 64 products; logits to 1e-4 absolute, 1e-5 relative.
"""

import numpy as np
import pytest
import torch

from vqa_transfer_externaldata_tpu.config import Config as JaxConfig
from vqa_transfer_externaldata_tpu.data import datasets as jds
from vqa_transfer_externaldata_tpu.utils import fidelity
from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.data import datasets as tds
from vqa_transfer_externaldata_torch.models.zoo import build_model
from vqa_transfer_externaldata_torch.tools import oov_claim
from vqa_transfer_externaldata_torch.utils.convert import params_to_flax

torch.set_num_threads(2)  # xdist runs several workers on the same cores

# The JAX package's tests/conftest.py::tiny_config.
TINY = {
    "data.synthetic": True, "data.synthetic_size": 256,
    "data.vocab_size": 128, "data.num_answers": 32,
    "data.grid_h": 4, "data.grid_w": 4, "data.feature_dim": 32,
    "data.pool5_dim": 32, "data.max_question_len": 8,
    "model.word_dim": 16, "model.rnn_dim": 16, "model.fusion_dim": 32,
    "model.att_hidden": 16, "model.answer_dim": 16,
    "model.dtype": "float32", "model.num_tasks": 4,
    "model.task_dim": 8, "model.num_candidates": 16,
    "model.dropout": 0.1,
    "train.batch_size": 32, "train.max_steps": 40,
    "train.log_every": 10, "train.eval_every": 10_000,
    "train.checkpoint_every": 20, "train.warmup_steps": 1,
    "train.learning_rate": 3e-3,
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("over", [{}, {"model.num_tasks": 3,
                                       "data.num_answers": 20}])
def test_transfer_corpus_equals_jax(seed, over):
    flat = dict(TINY, **over)
    kw = dict(n_vlmap=96, n_train=64, n_val=48, oov_fraction=0.3,
              noise=0.2, seed=seed)
    ours = tds.synthetic_transfer_corpus(Config().replace_flat(flat), **kw)
    theirs = jds.synthetic_transfer_corpus(JaxConfig().replace_flat(flat),
                                           **kw)
    for a, b in zip(ours[:3], theirs[:3]):
        assert sorted(a.arrays) == sorted(b.arrays)
        for k, v in b.arrays.items():
            assert a.arrays[k].dtype == v.dtype, k
            np.testing.assert_array_equal(a.arrays[k], v, err_msg=k)
    np.testing.assert_array_equal(ours[3], theirs[3])
    with pytest.raises(ValueError, match="feature_dim == pool5_dim"):
        tds.synthetic_transfer_corpus(Config().replace_flat(
            dict(flat, **{"data.feature_dim": 8})))


def test_transfer_beats_scratch_on_oov_answers(tmp_path):
    """Stage 1 (``vlmap``) pretrains the word space on external data that
    covers every answer; stage 2 trains on the in-vocabulary answers only,
    its answer table (and logit bias) frozen, once transfer-initialized
    and once from scratch (``tools/oov_claim.py``). The freeze holds bit
    for bit (``run`` raises otherwise); both learn the in-vocabulary
    answers; only the transferred table answers the held-out ones. The JAX
    test's settings and thresholds."""
    cfg = Config().replace_flat(oov_claim.TINY)
    r = oov_claim.run(cfg, device="cpu", train_dir=str(tmp_path))
    oov_t, oov_s = r["oov_transfer"], r["oov_scratch"]
    in_t, in_s = r["in_vocab_transfer"], r["in_vocab_scratch"]
    print(f"OOV transfer {oov_t:.4f} scratch {oov_s:.4f}; in-vocab "
          f"transfer {in_t:.4f} scratch {in_s:.4f}")
    assert r["steps"] == 200 and r["held_out"] == 7
    assert in_t > 0.5, f"transfer in-vocab acc too low: {in_t}"
    assert in_s > 0.5, f"scratch in-vocab acc too low: {in_s}"
    assert oov_t > 0.3, f"transfer OOV acc {oov_t} (expected >> chance)"
    assert oov_t > 3 * max(oov_s, 1.0 / cfg.data.num_answers), (
        f"no transfer advantage: transfer {oov_t} vs scratch {oov_s}")
    assert r["meets_thresholds"]


SMALL = dict(n_vlmap=64, n_train=32, n_val=16, noise=0.25, seed=0)


def test_oov_corpus_padding_keeps_the_corpus():
    """``oov_claim.corpus`` at a concept dimension below the feature width:
    JAX's corpus at that dimension, zero channels after it."""
    flat = dict(oov_claim.TINY, **{"data.feature_dim": 128,
                                   "data.pool5_dim": 128})
    got = oov_claim.corpus(Config().replace_flat(flat), 32, **SMALL)
    want = jds.synthetic_transfer_corpus(
        JaxConfig().replace_flat(oov_claim.TINY), **SMALL)
    for a, b, key in zip(got[:3], want[:3], ("feature", "features",
                                             "features")):
        x = a.arrays[key]
        assert x.shape[-1] == 128 and not x[..., 32:].any()
        np.testing.assert_array_equal(x[..., :32], b.arrays[key])
        for k in b.arrays:
            if k != key:
                np.testing.assert_array_equal(a.arrays[k], b.arrays[k])
    np.testing.assert_array_equal(got[3], want[3])
    assert not oov_claim.meets_thresholds(
        {"oov_transfer": 0.5, "oov_scratch": 0.2, "in_vocab_transfer": 1.0,
         "in_vocab_scratch": 1.0}, 32)


@pytest.mark.parametrize("name", ["vlmap", "vlmap_description"])
def test_stage1_forward_matches_the_numpy_oracle(name):
    cfg = Config().replace_flat(dict(TINY, **{"model.model": name,
                                              "model.dropout": 0.0}))
    spec = build_model(cfg, generator=torch.Generator().manual_seed(3))
    model = spec.module.eval()
    stage = "vlmap" if name == "vlmap" else "vlmap_desc"
    batch = next(tds.load_dataset(cfg, "train", stage=stage).batches(
        8, epochs=1, shuffle=False))
    rng = np.random.default_rng(1)
    with torch.no_grad():  # weights far from their init, scale moved
        for p in model.parameters():
            p.copy_(torch.from_numpy(
                rng.normal(scale=0.3, size=tuple(p.shape)).astype(np.float32)))
        model.logit_scale.fill_(7.5)
        got = model(*spec.inputs({k: torch.from_numpy(v)
                                  for k, v in batch.items()}),
                    train=False)["logits"].double().numpy()
    tree = params_to_flax(model.state_dict())
    if name == "vlmap":
        want = fidelity.reference_vlmap_forward_numpy(
            tree, batch["feature"], batch["task"], batch["candidates"])
    else:
        want = fidelity.reference_vlmap_desc_forward_numpy(
            tree, batch["feature"], batch["desc_ids"], batch["task"],
            batch["candidates"])
    assert got.shape == want.shape == batch["candidates"].shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
