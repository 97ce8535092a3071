"""Port parity: models/vqa_attention.py and the registry against the JAX
package, through the weight bridge, with dropout off. The JAX eval forward
runs both Pallas kernels (B1, B5) in interpret mode on the CPU.

float32; tolerance 1e-5 on logits of magnitude ~10 (the same forward in
f32, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_transfer_externaldata_tpu.models.vqa_attention import (
    VQAAttentionModel as JaxModel, vqa_loss as jax_vqa_loss)
from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.models.vqa_attention import (
    VQAAttentionModel, vqa_loss)
from vqa_transfer_externaldata_torch.models.zoo import build_model
from vqa_transfer_externaldata_torch.utils.convert import params_from_flax

torch.set_num_threads(2)  # xdist runs several workers on the same cores

DIMS = dict(word_dim=8, rnn_dim=8, fusion_dim=16, att_hidden=8,
            answer_dim=8)
V, A, B, N, C, T = 64, 16, 5, 9, 16, 6


def _random_tree(rng):
    mod = JaxModel(vocab_size=V, num_answers=A, dtype=jnp.float32,
                   dropout=0.0, **DIMS)
    tree = jax.device_get(mod.init(
        jax.random.PRNGKey(0), jnp.zeros((B, N, C)),
        jnp.ones((B, T), jnp.int32), train=False)["params"])
    # Random values everywhere (biases included), the scale kept at 10.
    tree = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=np.shape(a)) * 0.3).astype(np.float32),
        tree)
    tree["logit_scale"] = np.float32(10.0)
    return mod, tree


def test_logits_match_jax_eval_forward():
    rng = np.random.default_rng(0)
    mod, tree = _random_tree(rng)
    feats = np.abs(rng.normal(size=(B, N, C))).astype(np.float32)
    q = rng.integers(4, V, size=(B, T)).astype(np.int32)
    for i, n in enumerate([6, 1, 3, 0, 5]):  # padded questions, one empty
        q[i, n:] = 0
    want = mod.apply({"params": tree}, jnp.asarray(feats), jnp.asarray(q),
                     train=False)
    model = VQAAttentionModel(V, A, feature_dim=C, dtype=torch.float32,
                              **DIMS)
    model.load_state_dict(params_from_flax(tree))
    with torch.inference_mode():
        got = model(torch.from_numpy(feats), torch.from_numpy(q))
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["alpha"].numpy(),
                               np.asarray(want["alpha"]),
                               rtol=1e-5, atol=1e-6)


def test_vqa_loss_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(6, A)).astype(np.float32) * 3
    batch = {
        "answer_id": np.array([2, 1, 5, 7, 1, 9], np.int32),  # 1 = <unk>
        "example_mask": np.array([1, 1, 1, 0, 1, 1], np.float32),
        "answer_scores": rng.uniform(size=(6, A)).astype(np.float32),
    }
    j_loss, j_m = jax_vqa_loss({"logits": jnp.asarray(logits)},
                               {k: jnp.asarray(v) for k, v in batch.items()})
    t_loss, t_m = vqa_loss({"logits": torch.from_numpy(logits)},
                           {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-6)
    assert set(t_m) == set(j_m)
    for k in j_m:
        np.testing.assert_allclose(float(t_m[k]), float(j_m[k]), rtol=1e-6,
                                   err_msg=k)


def test_build_model_full_width_defaults():
    """The registry builds vqa_attention at the config's full width, with
    f32 parameters and bf16 compute, from an explicit generator."""
    cfg = Config()
    a = build_model(cfg, generator=torch.Generator().manual_seed(7))
    b = build_model(cfg, generator=torch.Generator().manual_seed(7))
    sd = a.state_dict()
    assert sd["att_wv"].shape == (2048, 512)
    assert sd["gru.uh"].shape == (512, 1536)
    assert sd["word_emb.embedding"].shape == (8192, 300)
    assert sd["answer_embedding"].shape == (2000, 300)
    assert all(t.dtype == torch.float32 for t in sd.values())
    assert a.dtype == torch.bfloat16
    assert all(torch.equal(sd[k], t) for k, t in b.state_dict().items())


@pytest.mark.parametrize("overrides,item", [
    ({"model.model": "vqa_attention2"}, "item 11"),
    ({"model.glimpses": 2}, "item 11"),
    ({"model.model": "vlmap"}, "item 10"),
    ({"model.model": "vqa_end2end"}, "item 13"),
    ({"model.fidelity_mode": True}, "item 14"),
])
def test_unported_configs_name_their_roadmap_item(overrides, item):
    with pytest.raises(NotImplementedError, match=item):
        build_model(Config().replace_flat(overrides))


def test_resident_input_is_not_ported_yet():
    model = VQAAttentionModel(V, A, feature_dim=C, dtype=torch.float32,
                              **DIMS)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model((torch.zeros(2, N, C), torch.zeros(B, dtype=torch.int32)),
              torch.ones(B, T, dtype=torch.int64))
