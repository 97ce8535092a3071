"""Port parity: the TF1-exact GRU (``ops/gru.py::TFGRUEncoder``), the
checkpoint-fidelity assembly (``model.fidelity_mode``, ``models/zoo.py``)
and the port's float64 oracle (``utils/fidelity.py``) against the JAX
package on the CPU, whose resident attention runs its Pallas bodies B3/B4
in interpret mode.

Tolerances: the encoder in float32 1e-5 (the same recurrence, sums in
another order); in bf16, where both round the operands of every product to
bf16, 2e-2 absolute on h in (-1, 1) (a last-bit difference of the f32 state
can round it to the other bf16 neighbour, 2^-8 of it, ahead of the next
step's products). The fidelity forward against the float64 oracle at JAX's
own atol 5e-4 / rtol 1e-4 (its ``tests/test_fidelity.py``). Training: 6
``fit_resident`` steps at ``test_torch_trainer.py``'s float32 bounds
(params rtol 2e-4 / atol 2e-5, losses rtol 1e-5); in bf16 the parameters'
changes (all parameters as one vector) at cosine 0.999, each parameter
within 6 x lr of JAX's, and the losses at rtol 2e-3 (bf16 rounding flips
in either framework ride through Adam's normalized update, which moves a
parameter by at most the learning rate a step).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_transfer_externaldata_tpu.config import Config as JaxConfig
from vqa_transfer_externaldata_tpu.data import datasets as jds
from vqa_transfer_externaldata_tpu.models.zoo import build_model as jax_build
from vqa_transfer_externaldata_tpu.ops.gru import TFGRUEncoder as JaxTFGRU
from vqa_transfer_externaldata_tpu.parallel.mesh import create_mesh
from vqa_transfer_externaldata_tpu.parallel.trainer import Trainer as JaxTrainer
from vqa_transfer_externaldata_tpu.utils import fidelity as jax_fidelity
from vqa_transfer_externaldata_torch.cli import predict as predict_cli
from vqa_transfer_externaldata_torch.cli import train as train_cli
from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.data import datasets as tds
from vqa_transfer_externaldata_torch.models.zoo import build_model
from vqa_transfer_externaldata_torch.ops.gru import TFGRUEncoder
from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
from vqa_transfer_externaldata_torch.utils import fidelity
from vqa_transfer_externaldata_torch.utils.convert import (
    params_from_flax, params_to_flax)

torch.set_num_threads(2)  # xdist runs several workers on the same cores

B, T, D, H = 5, 7, 12, 16
LENGTHS = [7, 1, 4, 0, 6]  # padded questions, one empty

# JAX's own fidelity test's config (tests/test_fidelity.py).
ORACLE = {
    "data.synthetic": True, "data.vocab_size": 96, "data.num_answers": 24,
    "data.grid_h": 3, "data.grid_w": 4, "data.feature_dim": 40,
    "data.max_question_len": 9, "model.model": "vqa_attention",
    "model.word_dim": 12, "model.rnn_dim": 20, "model.fusion_dim": 28,
    "model.att_hidden": 24, "model.answer_dim": 16,
    "model.fidelity_mode": True,
}

TINY = {
    "data.synthetic": True, "data.synthetic_layout": "joined",
    "data.synthetic_size": 128, "data.vocab_size": 64,
    "data.num_answers": 16, "data.grid_h": 3, "data.grid_w": 3,
    "data.feature_dim": 16, "data.pool5_dim": 16,
    "data.max_question_len": 6, "model.word_dim": 8, "model.rnn_dim": 8,
    "model.fusion_dim": 16, "model.att_hidden": 8, "model.answer_dim": 8,
    "model.dtype": "float32", "model.dropout": 0.0,
    "train.batch_size": 16, "train.device_data_cache": True,
    "train.log_every": 2, "train.warmup_steps": 2,
    "train.learning_rate": 3e-3,
}


def _encoder_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.array(LENGTHS)[:, None]).astype(
        np.float32)
    return rng, x, mask


def _tf_params(rng):
    return {"gates_kernel": rng.normal(size=(D + H, 2 * H)) * 0.3,
            "gates_bias": 1.0 + rng.normal(size=(2 * H,)) * 0.1,
            "candidate_kernel": rng.normal(size=(D + H, H)) * 0.3,
            "candidate_bias": rng.normal(size=(H,)) * 0.1}


def _port_encoder(params, dtype):
    enc = TFGRUEncoder(D, H, dtype=dtype)
    enc.load_state_dict({k: torch.tensor(v, dtype=torch.float32)
                         for k, v in params.items()})
    return enc


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
def test_tf_gru_matches_jax(seed, dtype, atol):
    rng, x, mask = _encoder_inputs(seed)
    params = _tf_params(rng)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = JaxTFGRU(hidden=H, dtype=jdt).apply(
        {"params": {k: jnp.asarray(v, jnp.float32)
                    for k, v in params.items()}},
        jnp.asarray(x), jnp.asarray(mask))
    enc = _port_encoder(params, getattr(torch, dtype))
    got = enc(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)
    # The empty question keeps the zero start state.
    assert not got[3].float().abs().max().item()


def test_tf_gru_gradients_match_jax():
    rng, x, mask = _encoder_inputs(2)
    params = _tf_params(rng)
    w = rng.normal(size=(B, H)).astype(np.float32)

    def jloss(p, xx):
        out = JaxTFGRU(hidden=H, dtype=jnp.float32).apply(
            {"params": p}, xx, jnp.asarray(mask))
        return jnp.sum(out * w)

    jp = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
    gp, gx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    enc = _port_encoder(params, torch.float32)
    xt = torch.from_numpy(x).requires_grad_()
    (enc(xt, torch.from_numpy(mask)) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-5,
                               rtol=1e-5)
    for k, p in enc.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


def test_tf_gru_initializer_follows_jax():
    """Parameters [D+H, 2H] and [D+H, H], glorot-uniform over the whole
    packed shape, the gate bias 1.0 and the candidate bias 0, as JAX's
    TFGRUEncoder initializes them."""
    enc = TFGRUEncoder(300, 512, generator=torch.Generator().manual_seed(0))
    assert enc.gates_kernel.shape == (812, 1024)
    assert enc.candidate_kernel.shape == (812, 512)
    assert torch.equal(enc.gates_bias, torch.ones(1024))
    assert torch.equal(enc.candidate_bias, torch.zeros(512))
    for w, fan_out in ((enc.gates_kernel, 1024), (enc.candidate_kernel, 512)):
        limit = (6.0 / (812 + fan_out)) ** 0.5
        assert w.abs().max().item() <= limit
        assert w.abs().max().item() > 0.99 * limit
    tree = JaxTFGRU(hidden=512).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 3, 300)), jnp.ones((2, 3)))
    assert {k: tuple(v.shape) for k, v in tree["params"].items()} == {
        k: tuple(v.shape) for k, v in enc.state_dict().items()}


def _oracle_case(seed):
    """JAX's fidelity test: a fidelity-mode model's parameters moved off
    their initial values, a grid and padded questions, from ``seed``."""
    jcfg = JaxConfig().replace_flat(ORACLE)
    spec = jax_build(jcfg)
    rng = np.random.default_rng(seed)
    n = jcfg.data.grid_h * jcfg.data.grid_w
    feats = rng.normal(size=(5, n, jcfg.data.feature_dim)).astype(np.float32)
    q = rng.integers(0, jcfg.data.vocab_size,
                     size=(5, jcfg.data.max_question_len)).astype(np.int32)
    q[:, -2:] = 0
    variables = spec.module.init({"params": jax.random.PRNGKey(seed)},
                                 feats, q, train=False)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64)
        + rng.normal(scale=0.05, size=np.shape(a)), variables["params"])
    return spec, tree, feats, q


@pytest.mark.parametrize("seed", [0, 3])
def test_fidelity_forward_matches_jax_oracle(seed):
    """The port's fidelity-mode forward (TF1 GRU, float32, the plain
    gathered attention) against the JAX package's float64 numpy oracle
    ``reference_forward_numpy``, at JAX's own tolerance."""
    _, tree, feats, q = _oracle_case(seed)
    cfg = Config().replace_flat(ORACLE)
    model = build_model(cfg).module
    model.load_state_dict(params_from_flax(tree))
    with torch.no_grad():
        got = model(torch.from_numpy(feats), torch.from_numpy(q))["logits"]
    want = jax_fidelity.reference_forward_numpy(tree, feats, q)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.double().numpy(), want, atol=5e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("seed", [0, 3])
def test_fidelity_forward_matches_jax_forward(seed):
    """The same forward against JAX's fidelity-mode flax forward on the
    same float32 parameters."""
    spec, tree, feats, q = _oracle_case(seed)
    tree32 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    tree)
    want = spec.module.apply({"params": tree32}, feats, q, train=False)
    model = build_model(Config().replace_flat(ORACLE)).module
    model.load_state_dict(params_from_flax(tree32))
    with torch.no_grad():
        got = model(torch.from_numpy(feats), torch.from_numpy(q))
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got["alpha"].numpy(),
                               np.asarray(want["alpha"]), atol=1e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 3, 5])
def test_port_oracle_equals_jax_oracle(seed):
    """utils/fidelity.py's numpy oracle, keyed by the port's state_dict
    names, gives the JAX package's oracle's float64 logits."""
    _, tree, feats, q = _oracle_case(seed)
    sd = {k: v.numpy() for k, v in params_from_flax(tree).items()}
    # float64 leaves: rebuild them from the float64 tree, not the f32 bridge
    sd64 = {k: np.asarray(v, np.float64) for k, v in sd.items()}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        keys = [p.key for p in path]
        name = ".".join(keys)
        if keys[-1] == "kernel":
            sd64[".".join(keys[:-1] + ["weight"])] = np.asarray(leaf).T
        else:
            sd64[name] = np.asarray(leaf)
    got = fidelity.reference_forward_numpy(sd64, feats, q)
    want = jax_fidelity.reference_forward_numpy(tree, feats, q)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    # Tensors are read as their values, on any device.
    tens = {k: torch.from_numpy(v) for k, v in sd64.items()}
    np.testing.assert_array_equal(
        fidelity.reference_forward_numpy(tens, feats, q), got)


def test_logits_agree():
    f = lambda b: np.asarray(b)  # noqa: E731
    ok, dev = fidelity.logits_agree(f, lambda b: np.asarray(b) + 1e-6,
                                    np.zeros((2, 4), np.float32))
    assert ok and dev <= 1.1e-6
    ok, dev = fidelity.logits_agree(f, lambda b: torch.ones(2, 4),
                                    np.zeros((2, 4), np.float32))
    assert not ok and dev == 1.0


@pytest.mark.parametrize("over", [
    {}, {"model.glimpses": 3}, {"model.model": "vqa_attention2"},
    {"model.dtype": "bfloat16", "model.use_pallas": True,
     "model.rnn_variant": "cudnn"}])
def test_build_model_fidelity_mode_follows_jax(over):
    """fidelity_mode forces float32, the TF1 GRU, use_pallas off and one
    glimpse whatever else is set, as JAX's registry does; the parameter
    names and shapes are JAX's."""
    flat = dict(ORACLE, **over)
    jm = jax_build(JaxConfig().replace_flat(flat)).module
    m = build_model(Config().replace_flat(flat)).module
    assert (m.dtype, m.rnn_variant, m.use_pallas, m.glimpses) == (
        torch.float32, jm.rnn_variant, jm.use_pallas, jm.glimpses)
    assert (jm.dtype, jm.rnn_variant, jm.use_pallas, jm.glimpses) == (
        jnp.float32, "tf", False, 1)
    n = 12
    tree = jax.device_get(jm.init(
        jax.random.PRNGKey(0), jnp.zeros((2, n, 40)),
        jnp.ones((2, 9), jnp.int32), train=False)["params"])
    want = {k: tuple(v.shape) for k, v in params_from_flax(tree).items()}
    assert want == {k: tuple(v.shape) for k, v in m.state_dict().items()}
    # The bridge maps the TF GRU's names one to one.
    back = params_to_flax(m.state_dict())
    assert sorted(back["gru"]) == sorted(tree["gru"]) == [
        "candidate_bias", "candidate_kernel", "gates_bias", "gates_kernel"]


@pytest.mark.parametrize("model", ["vqa_attention", "vqa_attention2"])
def test_rnn_variant_tf_without_fidelity_mode(model):
    """model.rnn_variant tf alone swaps the encoder and keeps the dtype,
    use_pallas and glimpses, as in JAX; an unknown variant raises."""
    flat = dict(ORACLE, **{"model.fidelity_mode": False,
                           "model.rnn_variant": "tf", "model.model": model})
    m = build_model(Config().replace_flat(flat)).module
    jm = jax_build(JaxConfig().replace_flat(flat)).module
    assert type(m.gru).__name__ == "TFGRUEncoder"
    assert (m.dtype, m.use_pallas, m.glimpses) == (torch.bfloat16, True,
                                                   jm.glimpses)
    with pytest.raises(ValueError, match="rnn_variant"):
        build_model(Config().replace_flat(
            dict(flat, **{"model.rnn_variant": "lstm"})))


def test_end2end_ignores_the_fidelity_fields():
    """As in JAX, fidelity_mode and rnn_variant apply to the vqa_attention
    families only: vqa_end2end builds (its head keeps the cudnn GRU) and
    takes model.use_pallas."""
    flat = {"model.model": "vqa_end2end", "model.resnet_stages": "1,1,1,1",
            "model.resnet_width": 8, "data.image_size": 64,
            "model.fidelity_mode": True, "model.rnn_variant": "tf",
            "model.use_pallas": False, "model.word_dim": 8,
            "model.rnn_dim": 8, "model.fusion_dim": 16,
            "model.att_hidden": 8, "model.answer_dim": 8,
            "data.vocab_size": 32, "data.num_answers": 8}
    m = build_model(Config().replace_flat(flat)).module
    assert m.head.rnn_variant == "cudnn" and not m.head.use_pallas
    assert m.dtype == torch.bfloat16


def _losses(train_dir):
    with open(os.path.join(train_dir, "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    return {r["step"]: r["train/loss"] for r in recs if "train/loss" in r}


def _fit_pair(over, tmp_path):
    """Six fit_resident steps of the JAX Trainer and of the port's from
    the same (bridged) parameters: (the port's trainer, parameters and
    losses, JAX's parameters and losses)."""
    flat = dict(TINY, **over)
    jcfg = JaxConfig().replace_flat(flat)
    spec = jax_build(jcfg)
    jtr = JaxTrainer(jcfg, spec, mesh=create_mesh(
        jcfg, devices=jax.devices()[:1]), train_dir=str(tmp_path / "jax"))
    jtrain = jds.load_dataset(jcfg, "train")
    js = jtr.init_state(next(jtrain.batches(1, epochs=1, shuffle=False)))
    params = params_from_flax(jax.device_get(js.params))
    js = jtr.fit_resident(jtrain, js, max_steps=6)
    want = params_from_flax(jax.device_get(js.params))
    jtr.close()
    cfg = Config().replace_flat(flat)
    tr = Trainer(cfg, build_model(cfg), train_dir=str(tmp_path / "torch"),
                 device="cpu")
    s = tr.init_state(params)
    s = tr.fit_resident(tds.load_dataset(cfg, "train"), s, max_steps=6)
    tr.close()
    assert s.step == 6
    return (tr, params, tr.model.state_dict(), _losses(tmp_path / "torch"),
            want, _losses(tmp_path / "jax"))


@pytest.mark.parametrize("over", [
    {"model.rnn_variant": "tf"},
    {"model.fidelity_mode": True, "model.glimpses": 2}])
def test_fit_resident_matches_jax(over, tmp_path):
    """Six gather-free resident steps against JAX's in float32: the TF1
    GRU, and fidelity mode (one glimpse forced over the two asked for); a
    float32 model's store computes in float32 off its float16 rows."""
    tr, _, got, lt, want, lj = _fit_pair(over, tmp_path)
    assert type(tr.model.gru).__name__ == "TFGRUEncoder"
    assert tr.model.glimpses == 1 and tr.model.dtype == torch.float32
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
    assert sorted(lt) == sorted(lj) == [2, 4, 6]
    for step in lj:
        np.testing.assert_allclose(lt[step], lj[step], rtol=1e-5)


def test_fit_resident_tf_gru_bf16_matches_jax(tmp_path):
    """The TF1 GRU trained in bf16 (JAX tests/test_trainer.py:150-164),
    six steps against JAX's: bf16 rounding flips in either framework ride
    through Adam's normalized update, so the logged losses are held to
    2e-3, the parameters' changes (one vector) to cosine 0.999, and each
    parameter to what Adam can move it in 6 steps at most (6 x lr)."""
    over = {"model.rnn_variant": "tf", "model.dtype": "bfloat16"}
    tr, init, got, lt, want, lj = _fit_pair(over, tmp_path)
    assert tr.model.dtype == torch.bfloat16
    d_got = torch.cat([(got[k] - init[k]).flatten() for k in sorted(want)])
    d_want = torch.cat([(want[k] - init[k]).flatten() for k in sorted(want)])
    cos = torch.nn.functional.cosine_similarity(d_got, d_want, dim=0)
    assert cos.item() >= 0.999, cos.item()
    lr = TINY["train.learning_rate"]
    assert (d_got - d_want).abs().max().item() <= 6 * lr
    assert sorted(lt) == sorted(lj) == [2, 4, 6]
    for step in lj:
        np.testing.assert_allclose(lt[step], lj[step], rtol=2e-3)


def test_resident_evaluator_fidelity_predictions_equal_jax(tmp_path):
    """The resident evaluator (the gather-free op on the prenormalized
    float16 store, float32 compute) in fidelity mode on the same random
    parameters as JAX's: equal predictions, metrics within 1e-5."""
    from vqa_transfer_externaldata_tpu.parallel import evaler as jev
    from vqa_transfer_externaldata_torch.parallel import evaler as tev

    flat = dict(TINY, **{"model.fidelity_mode": True})
    jcfg = JaxConfig().replace_flat(flat)
    jtr = JaxTrainer(jcfg, jax_build(jcfg), mesh=create_mesh(
        jcfg, devices=jax.devices()[:1]), train_dir=str(tmp_path / "jax"))
    jval = jds.load_dataset(jcfg, "val")
    js = jtr.init_state(next(jval.batches(1, epochs=1, shuffle=False)))
    # Random parameters everywhere, so the predictions spread over answers.
    rng = np.random.default_rng(4)
    tree = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(scale=0.3, size=np.shape(a))
                   ).astype(np.float32), jax.device_get(js.params))
    js = js.replace(params=jax.device_put(tree))
    jm, jp = jev.evaluate_split(jtr, js, jval)
    jtr.close()
    cfg = Config().replace_flat(flat)
    tr = Trainer(cfg, build_model(cfg), train_dir=str(tmp_path / "torch"),
                 device="cpu")
    state = tr.init_state(params_from_flax(tree))
    tm, tp = tev.evaluate_split(tr, state, tds.load_dataset(cfg, "val"))
    tr.close()
    np.testing.assert_array_equal(tp, jp)
    assert len(set(np.asarray(tp).tolist())) > 1
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_cli_train_then_predict_in_fidelity_mode(tmp_path, capsys):
    """cli.train then cli.predict with --model.fidelity_mode true on the
    CPU: the run trains the TF1 GRU in float32 on the resident path, and
    cli.predict serves it from a feature store through the plain gathered
    attention (use_pallas off), as Predictor does."""
    from vqa_transfer_externaldata_torch.serving import Predictor

    argv = ["--device", "cpu", "--train.max_steps", "4",
            "--train.train_dir", str(tmp_path / "run"),
            "--model.fidelity_mode", "true"]
    for k, v in TINY.items():
        if k != "model.dtype":
            argv += [f"--{k}",
                     str(v).lower() if isinstance(v, bool) else str(v)]
    train_dir = train_cli.main(argv)
    losses = _losses(train_dir)
    assert sorted(losses) == [2, 4]
    assert all(np.isfinite(list(losses.values())))
    pred = Predictor(train_dir, batch_size=4, device="cpu")
    m = pred.model
    assert (m.dtype, m.rnn_variant, m.use_pallas) == (torch.float32, "tf",
                                                      False)
    # The config asks for bf16 (the default) and fidelity mode computes in
    # float32: host features keep their precision (a deliberate departure:
    # JAX's Predictor reads the config's dtype and rounds them to bf16).
    assert pred.cfg.model.dtype == "bfloat16" and pred._vis_cast is None
    rng = np.random.default_rng(0)
    store = str(tmp_path / "store.npz")
    np.savez(store, grid=rng.normal(size=(4, 9, 16)).astype(np.float16),
             pool5=rng.normal(size=(4, 16)).astype(np.float32),
             image_ids=np.array([10, 11, 12, 13]))
    qs = ["w1 w2", "w3"]
    capsys.readouterr()
    got = predict_cli.main(["--train_dir", train_dir, "--device", "cpu",
                            "--feature_path", store, "--image_id", "12",
                            "--image_id", "10", "--question", qs[0],
                            "--question", qs[1]])
    assert json.loads(capsys.readouterr().out) == {"answers": got}
    with np.load(store) as f:
        assert got == pred.answer(f["grid"][[2, 0]].astype(np.float32), qs)
