"""Port parity: ops/layers.py and the weight bridge against flax.

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerances are float32 ones (1e-6 relative): the same math in f32, with
sums taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_transfer_externaldata_tpu.models.vqa_attention import (
    VQAAttentionModel as JaxVQAAttention)
from vqa_transfer_externaldata_tpu.ops import layers as jl
from vqa_transfer_externaldata_torch.ops import layers as tl
from vqa_transfer_externaldata_torch.utils.convert import (
    params_from_flax, params_to_flax)

torch.set_num_threads(2)  # xdist runs several workers on the same cores

F32 = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(5, 7), (2, 3, 16)])
def test_l2_normalize_matches_flax(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    x[0] = 0.0  # eps inside the sqrt keeps a zero row finite
    want = np.asarray(jl.l2_normalize(jnp.asarray(x)))
    got = tl.l2_normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **F32)
    assert np.all(np.isfinite(got))


def test_word_embedding_matches_flax():
    rng = np.random.default_rng(1)
    table = rng.normal(size=(32, 6)).astype(np.float32)
    ids = rng.integers(0, 32, size=(4, 5)).astype(np.int32)
    mod = jl.WordEmbedding(32, 6, dtype=jnp.float32)
    want = np.asarray(mod.apply({"params": {"embedding": table}},
                                jnp.asarray(ids)))
    emb = tl.WordEmbedding(32, 6, init_matrix=table, dtype=torch.float32)
    got = emb(torch.from_numpy(ids).long()).detach().numpy()
    np.testing.assert_array_equal(got, want)


def test_word_embedding_default_init():
    gen = torch.Generator().manual_seed(0)
    emb = tl.WordEmbedding(16, 4, dtype=torch.bfloat16, generator=gen)
    out = emb(torch.tensor([[0, 3]]))
    assert out.dtype == torch.bfloat16 and out.shape == (1, 2, 4)
    assert float(emb.embedding.detach().std()) < 0.05  # N(0, 0.01) init


def test_gated_tanh_matches_flax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 10)).astype(np.float32)
    mod = jl.GatedTanh(12, dtype=jnp.float32)
    params = jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32) * 0.3,
        mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    gt = tl.GatedTanh(10, 12, dtype=torch.float32)
    gt.load_state_dict(params_from_flax(params))
    got = gt(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **F32)


def _jax_vqa_tree():
    mod = JaxVQAAttention(vocab_size=64, num_answers=16, word_dim=8,
                          rnn_dim=8, fusion_dim=16, att_hidden=8,
                          answer_dim=8, dtype=jnp.float32, dropout=0.0)
    feats = jnp.zeros((2, 4, 16), jnp.float32)
    q = jnp.ones((2, 6), jnp.int32)
    return jax.device_get(
        mod.init(jax.random.PRNGKey(3), feats, q, train=False)["params"])


def test_bridge_round_trip_is_bit_exact():
    tree = _jax_vqa_tree()
    sd = params_from_flax(tree)
    back = params_to_flax(sd)
    flat_in = jax.tree_util.tree_leaves_with_path(tree)
    flat_out = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_out)
    for path, leaf in flat_in:
        np.testing.assert_array_equal(flat_out[path], np.asarray(leaf))
        assert flat_out[path].dtype == np.float32
    # Dense kernels [in, out] become Linear weights [out, in]
    assert sd["att_q.weight"].shape == (8, 8)
    assert tuple(sd["fuse_v.w.weight"].shape) == (16, 16)
    assert tuple(sd["ans_proj.weight"].shape) == (8, 16)
    np.testing.assert_array_equal(sd["ans_proj.weight"].numpy(),
                                  np.asarray(tree["ans_proj"]["kernel"]).T)


def test_bridge_loads_strictly_into_the_port_model():
    from vqa_transfer_externaldata_torch.models.vqa_attention import (
        VQAAttentionModel)

    model = VQAAttentionModel(64, 16, feature_dim=16, word_dim=8,
                              rnn_dim=8, fusion_dim=16, att_hidden=8,
                              answer_dim=8, dtype=torch.float32)
    sd = params_from_flax(_jax_vqa_tree())
    model.load_state_dict(sd)  # strict: same keys, same shapes
    assert set(model.state_dict()) == set(sd)


@pytest.mark.parametrize("shape,axis", [((4, 5, 3), 1), ((4, 5), 1),
                                        ((3, 6, 2), 0)])
def test_masked_mean_matches_flax(shape, axis):
    rng = np.random.default_rng(7)
    x = rng.normal(size=shape).astype(np.float32)
    mask = rng.integers(0, 2, size=shape[:2]).astype(np.float32)
    mask[1] = 0.0  # an all-false row (axis 1) / a zero slice (axis 0)
    want = np.asarray(jl.masked_mean(jnp.asarray(x), jnp.asarray(mask),
                                     axis=axis))
    got = tl.masked_mean(torch.from_numpy(x), torch.from_numpy(mask),
                         dim=axis).numpy()
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("features", [[7, 4], [9, 7, 4]])
def test_mlp_matches_flax(features):
    """fc0, fc1, ... with ReLU between and nothing after the last; dropout
    off at eval."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(5, 6)).astype(np.float32)
    mod = jl.MLP(features, dropout=0.5, dtype=jnp.float32)
    tree = jax.device_get(mod.init(jax.random.PRNGKey(0),
                                   jnp.asarray(x))["params"])
    tree = jax.tree_util.tree_map(
        lambda a: rng.normal(size=np.shape(a)).astype(np.float32), tree)
    want = np.asarray(mod.apply({"params": tree}, jnp.asarray(x)))
    mlp = tl.MLP(6, features, dropout=0.5, dtype=torch.float32)
    mlp.load_state_dict(params_from_flax(tree))
    got = mlp(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got < 0).any()  # no ReLU after the last layer


def test_mlp_dropout_keeps_and_scales_from_the_generator():
    """Training draws the mask from the generator: kept hidden units are
    scaled by 1 / (1 - rate), dropped ones are 0, and the same seed draws
    the same mask."""
    mlp = tl.MLP(6, [64, 3], dropout=0.25, dtype=torch.float32,
                 generator=torch.Generator().manual_seed(0))
    x = torch.randn(8, 6, generator=torch.Generator().manual_seed(1))
    hidden = torch.relu(mlp.fc0(x))
    drop = tl.dropout(hidden, 0.25, torch.Generator().manual_seed(2))
    kept = drop != 0
    torch.testing.assert_close(drop[kept], hidden[kept] / 0.75)
    assert 0.5 < kept[hidden > 0].float().mean().item() < 0.95
    a = mlp(x, train=True, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(a, mlp.fc1(drop))
