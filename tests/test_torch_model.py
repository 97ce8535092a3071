"""Port parity: models/vqa_attention.py and the registry against the JAX
package, through the weight bridge, with dropout off. The JAX eval forward
runs its Pallas kernels (B1, B5, or B3 for the resident input) in interpret
mode on the CPU, and its training gradients B2 and B4.

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
    spec = build_model(cfg, generator=torch.Generator().manual_seed(7))
    assert spec.stage == "vqa"
    a = spec.module
    b = build_model(cfg, generator=torch.Generator().manual_seed(7)).module
    sd = a.state_dict()
    assert sd["att_wv"].shape == (2048, 512)
    assert sd["gru.uh"].shape == (512, 1536)
    assert sd["word_emb.embedding"].shape == (8192, 300)
    assert sd["answer_embedding"].shape == (2000, 300)
    assert all(t.dtype == torch.float32 for t in sd.values())
    assert a.dtype == torch.bfloat16
    assert all(torch.equal(sd[k], t) for k, t in b.state_dict().items())


@pytest.mark.parametrize("overrides,variant,glimpses", [
    ({"model.fidelity_mode": True}, "tf", 1),
    ({"model.fidelity_mode": True, "model.model": "vqa_attention2"}, "tf",
     1),
    ({"model.rnn_variant": "tf"}, "tf", 1),
    ({"model.rnn_variant": "tf", "model.glimpses": 2}, "tf", 2),
])
def test_build_model_fidelity_configs_at_full_width(overrides, variant,
                                                    glimpses):
    """The checkpoint-fidelity configurations build at config.py's full
    width: the TF1 GRU's packed kernels over [x, h] (300 + 512 rows), in
    float32 under fidelity_mode, with one glimpse and use_pallas off."""
    m = build_model(Config().replace_flat(overrides)).module
    sd = m.state_dict()
    assert m.rnn_variant == variant and m.glimpses == glimpses
    assert sd["gru.gates_kernel"].shape == (812, 1024)
    assert sd["gru.candidate_kernel"].shape == (812, 512)
    assert "gru.uh" not in sd
    fidelity = overrides.get("model.fidelity_mode", False)
    assert m.dtype == (torch.float32 if fidelity else torch.bfloat16)
    assert m.use_pallas is not fidelity


def test_build_model_builds_vqa_end2end():
    """The registry builds the raw-image model: a ResNet backbone (frozen,
    the space-to-depth stem) under the attention head, fed uint8 images;
    its forward gives one logit row an image, the loss is vqa_loss."""
    cfg = Config().replace_flat({
        "model.model": "vqa_end2end", "model.resnet_stages": "1,1,1,1",
        "model.resnet_width": 8, "data.image_size": 64,
        "data.vocab_size": V, "data.num_answers": A,
        "data.max_question_len": T, "model.dtype": "float32",
        **{f"model.{k}": v for k, v in DIMS.items()}})
    spec = build_model(cfg, generator=torch.Generator().manual_seed(0))
    m = spec.module
    assert spec.stage == "vqa" and spec.visual_key == "images"
    assert spec.label_key == "answer_id" and spec.loss is vqa_loss
    assert m.freeze_backbone and not m.head.feature_grad
    assert m.resnet.stem == "space_to_depth" and m.resnet.out_channels == 256
    assert m.state_dict()["head.att_wv"].shape == (256, 8)
    rng = np.random.default_rng(0)
    batch = {"images": torch.from_numpy(
        rng.integers(0, 256, (3, 64, 64, 3)).astype(np.uint8)),
        "q_ids": torch.from_numpy(rng.integers(4, V, (3, T)))}
    out = m(*spec.inputs(batch))
    assert out["logits"].shape == (3, A) and out["alpha"].shape == (3, 4)
    assert torch.isfinite(out["logits"]).all()


@pytest.mark.parametrize("overrides,glimpses,visual", [
    ({"model.model": "vqa_attention2"}, 2, "features"),
    ({"model.glimpses": 2}, 2, "features"),
    ({"model.model": "vqa_baseline"}, None, "pool5"),
])
def test_build_model_builds_every_stage2_family(overrides, glimpses, visual):
    """The stage-2 families at the config's full width: two glimpses give a
    [512, 2] score matrix and a fusion over both weighted sums; the
    baseline reads pool5 and has no attention."""
    spec = build_model(Config().replace_flat(overrides))
    sd = spec.module.state_dict()
    assert spec.stage == "vqa" and spec.visual_key == visual
    if glimpses is None:
        assert "att_ws" not in sd and "answer_embedding" not in sd
        assert sd["mlp.fc0.weight"].shape == (1024, 2048 + 300)
        assert sd["classifier.weight"].shape == (2000, 1024)
    else:
        assert sd["att_ws"].shape == (512, glimpses)
        assert sd["fuse_v.w.weight"].shape == (1024, glimpses * 2048)


def _resident_inputs(rng, n_valid=N, M=4):
    """A padded [M, Np, C] store (zeros past n_valid), rows that repeat an
    image, and padded questions."""
    Np = n_valid + (-n_valid) % 8
    store = np.zeros((M, Np, C), np.float32)
    store[:, :n_valid] = np.abs(rng.normal(size=(M, n_valid, C)))
    rows = np.array([0, 0, 3, 1, 2, 3, 1, 0], np.int32)
    q = rng.integers(4, V, size=(8, T)).astype(np.int32)
    for i, n in enumerate([6, 1, 3, 0, 5, 2, 6, 4]):
        q[i, n:] = 0
    return store, rows, q


@pytest.mark.parametrize("prenormalized", [False, True])
def test_resident_forward_matches_jax(prenormalized):
    """The (store, rows) input against the JAX model's, whose attention is
    the Pallas B3 kernel in interpret mode; with ``store_prenormalized``
    the op skips the per-cell norm (the store is given normalized)."""
    rng = np.random.default_rng(4)
    store, rows, q = _resident_inputs(rng)
    if prenormalized:
        store /= np.sqrt((store ** 2).sum(-1, keepdims=True) + 1e-12)
    mod = JaxModel(vocab_size=V, num_answers=A, dtype=jnp.float32,
                   dropout=0.0, n_cells=N,
                   store_prenormalized=prenormalized, **DIMS)
    _, tree = _random_tree(rng)
    want = mod.apply({"params": tree},
                     (jnp.asarray(store), jnp.asarray(rows)), jnp.asarray(q),
                     train=False)
    model = VQAAttentionModel(V, A, feature_dim=C, dtype=torch.float32,
                              n_cells=N, store_prenormalized=prenormalized,
                              **DIMS)
    model.load_state_dict(params_from_flax(tree))
    with torch.inference_mode():
        got = model((torch.from_numpy(store), torch.from_numpy(rows)),
                    torch.from_numpy(q))
    assert got["alpha"].shape == (8, N)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["alpha"].numpy(),
                               np.asarray(want["alpha"]),
                               rtol=1e-5, atol=1e-6)


def test_resident_training_grads_match_jax():
    """Every parameter's gradient of the training loss (dropout 0) against
    jax.grad through the bridge: the GRU backward is B2 and the attention
    backward B4, both interpreted. Whole-model gradients are compared by
    cosine (>= 0.99999) and mean abs error (<= 1e-5 of the mean magnitude):
    a ReLU unit at z = 0 may take the other side in the other
    implementation and move single elements, which a max would report."""
    rng = np.random.default_rng(5)
    store, rows, q = _resident_inputs(rng)
    labels = rng.integers(4, A, size=8).astype(np.int32)
    mod = JaxModel(vocab_size=V, num_answers=A, dtype=jnp.float32,
                   dropout=0.0, n_cells=N, **DIMS)
    _, tree = _random_tree(rng)
    batch = {"answer_id": jnp.asarray(labels)}

    def jloss(params):
        out = mod.apply({"params": params},
                        (jnp.asarray(store), jnp.asarray(rows)),
                        jnp.asarray(q), train=True,
                        rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_vqa_loss(out, batch)[0]

    want = params_from_flax(jax.device_get(jax.grad(jloss)(tree)))
    model = VQAAttentionModel(V, A, feature_dim=C, dtype=torch.float32,
                              n_cells=N, dropout=0.0, **DIMS)
    model.load_state_dict(params_from_flax(tree))
    out = model((torch.from_numpy(store), torch.from_numpy(rows)),
                torch.from_numpy(q), train=True)
    vqa_loss(out, {"answer_id": torch.from_numpy(labels)})[0].backward()
    for name, p in model.named_parameters():
        a, b = p.grad.flatten(), want[name].flatten()
        cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
        mean_err = (a - b).abs().mean().item()
        assert cos >= 0.99999, (name, cos)
        assert mean_err <= 1e-5 * b.abs().mean().item() + 1e-12, (
            name, mean_err)


def test_dropout_is_seeded_scaled_and_off_at_eval():
    """Dropout on the fused vector: keeps each unit with probability
    1 - rate and scales it by 1 / (1 - rate); the mask comes from the given
    generator (same seed, same logits) and eval mode draws none."""
    rng = np.random.default_rng(6)
    store, rows, q = _resident_inputs(rng)
    model = VQAAttentionModel(V, A, feature_dim=C, dtype=torch.float32,
                              n_cells=N, dropout=0.25, **DIMS,
                              generator=torch.Generator().manual_seed(0))
    feats = (torch.from_numpy(store), torch.from_numpy(rows))
    qt = torch.from_numpy(q)

    def run(seed, train=True):
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return model(feats, qt, train=train, generator=g)["logits"]

    torch.testing.assert_close(run(1), run(1), rtol=0, atol=0)
    assert not torch.equal(run(1), run(2))
    torch.testing.assert_close(run(1, False), run(2, False), rtol=0, atol=0)
    # The fused vector as ans_proj receives it, with and without dropout:
    # each unit is either 0 or its eval value / (1 - rate), and over 40
    # draws of 7 x 16 live units the kept share is 0.75 (0.75 +- 0.04 is
    # about 6 sigma).
    seen = []
    hook = model.ans_proj.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].clone()))
    kept = []
    for seed in range(40):
        run(seed, False), run(seed)
        ref, drop = seen[-2], seen[-1]
        on, live = drop != 0, ref != 0  # the empty question's row is all 0
        torch.testing.assert_close(drop[on], ref[on] / 0.75)
        kept.append(on[live].float().mean().item())
    hook.remove()
    assert abs(np.mean(kept) - 0.75) < 0.04


def test_gathered_model_with_two_glimpses_runs_the_multi_op(monkeypatch):
    """On gathered features a G=2 model normalizes the grid and runs
    spatial_attention_multi (the single-glimpse op refuses a 2-D score
    matrix, pointing to it)."""
    from vqa_transfer_externaldata_torch.models import vqa_attention
    from vqa_transfer_externaldata_torch.ops.attention import (
        spatial_attention, spatial_attention_multi)

    with pytest.raises(ValueError, match="spatial_attention_multi"):
        spatial_attention(torch.zeros(B, N, C), torch.zeros(B, 8),
                          torch.zeros(C, 8), torch.zeros(8, 2))
    seen = []
    monkeypatch.setattr(vqa_attention, "spatial_attention_multi",
                        lambda v, *a: seen.append(v) or
                        spatial_attention_multi(v, *a))
    model = VQAAttentionModel(V, A, feature_dim=C, dtype=torch.float32,
                              glimpses=2, **DIMS)
    rng = np.random.default_rng(8)
    feats = torch.from_numpy(np.abs(rng.normal(size=(B, N, C))).astype(
        np.float32))
    out = model(feats, torch.from_numpy(
        rng.integers(4, V, size=(B, T)).astype(np.int32)))
    assert out["alpha"].shape == (B, N, 2)
    torch.testing.assert_close(seen[0].norm(dim=-1), torch.ones(B, N))


def test_gathered_training_grads_match_jax():
    """Every parameter's gradient of the training loss on gathered [B, N, C]
    features (dropout 0) against jax.grad of JAX's model, whose training
    forward is XLA's scale-after-matmul oracle and whose backward is the
    explicit math; the port's runs K2's and K8's plain versions. Compared
    as the resident gradients are (cosine and mean error: a ReLU unit at
    z = 0 may take the other side). The logits agree to 1e-5."""
    rng = np.random.default_rng(7)
    feats = np.abs(rng.normal(size=(8, N, C))).astype(np.float32)
    _, _, q = _resident_inputs(rng)
    labels = rng.integers(4, A, size=8).astype(np.int32)
    mod, tree = _random_tree(rng)
    batch = {"answer_id": jnp.asarray(labels)}

    def jloss(params):
        out = mod.apply({"params": params}, jnp.asarray(feats),
                        jnp.asarray(q), train=True,
                        rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_vqa_loss(out, batch)[0], out["logits"]

    (_, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(tree)
    want = params_from_flax(jax.device_get(jgrads))
    model = VQAAttentionModel(V, A, feature_dim=C, dtype=torch.float32,
                              dropout=0.0, **DIMS)
    assert model.feature_grad is False
    model.load_state_dict(params_from_flax(tree))
    out = model(torch.from_numpy(feats), torch.from_numpy(q), train=True)
    np.testing.assert_allclose(out["logits"].detach().numpy(),
                               np.asarray(jlogits), rtol=1e-5, atol=1e-5)
    vqa_loss(out, {"answer_id": torch.from_numpy(labels)})[0].backward()
    for name, p in model.named_parameters():
        a, b = p.grad.flatten(), want[name].flatten()
        cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
        mean_err = (a - b).abs().mean().item()
        assert cos >= 0.99999, (name, cos)
        assert mean_err <= 1e-5 * b.abs().mean().item() + 1e-12, (
            name, mean_err)
