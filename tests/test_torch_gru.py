"""Port parity: ops/gru.py against the JAX GRUEncoder (whose fused path
runs the Pallas kernel B1 in interpret mode on the CPU) and against
``torch.nn.GRU`` as an independent check.

float32 throughout; tolerance 1e-5: the same recurrence in f32 with sums in
another order, over at most 7 steps of a contractive update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_transfer_externaldata_tpu.ops.gru import GRUEncoder as JaxGRU
from vqa_transfer_externaldata_torch.ops import gru as tg

torch.set_num_threads(2)  # xdist runs several workers on the same cores

TOL = dict(rtol=1e-5, atol=1e-5)
T, B, D, H = 7, 5, 6, 8


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, B, D)).astype(np.float32)
    lens = np.array([7, 1, 4, 0, 3])  # ragged, one empty row
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    params = {
        "wx": rng.normal(size=(D, 3 * H)).astype(np.float32) * 0.4,
        "uh": rng.normal(size=(H, 3 * H)).astype(np.float32) * 0.4,
        "b": rng.normal(size=(3 * H,)).astype(np.float32) * 0.2,
        "bhn": rng.normal(size=(H,)).astype(np.float32) * 0.2,
    }
    return x, mask, lens, params


def _port_encoder(params, reverse):
    enc = tg.GRUEncoder(D, H, dtype=torch.float32, reverse=reverse)
    enc.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    return enc


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_encoder_matches_jax_pallas(reverse):
    x, mask, _, params = _inputs()
    jmod = JaxGRU(H, dtype=jnp.float32, use_pallas=True, time_major=True,
                  reverse=reverse)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x),
                                 jnp.asarray(mask)))
    got = _port_encoder(params, reverse)(torch.from_numpy(x),
                                         torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_encoder_matches_torch_nn_gru(reverse):
    """cuDNN gate convention: b_ih = b, b_hh = [0, 0, b_hn]. A packed
    sequence stops each row at its length; the reverse direction of a
    bidirectional GRU walks each row's valid prefix backwards."""
    x, mask, lens, params = _inputs(1)
    keep = lens > 0  # packed sequences cannot hold an empty row
    ref = torch.nn.GRU(D, H, bidirectional=reverse)
    with torch.no_grad():
        for sfx in (["_l0", "_l0_reverse"] if reverse else ["_l0"]):
            getattr(ref, "weight_ih" + sfx).copy_(
                torch.from_numpy(params["wx"].T))
            getattr(ref, "weight_hh" + sfx).copy_(
                torch.from_numpy(params["uh"].T))
            getattr(ref, "bias_ih" + sfx).copy_(torch.from_numpy(params["b"]))
            getattr(ref, "bias_hh" + sfx).copy_(torch.from_numpy(
                np.concatenate([np.zeros(2 * H, np.float32),
                                params["bhn"]])))
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        torch.from_numpy(x[:, keep]), torch.from_numpy(lens[keep]),
        enforce_sorted=False)
    _, h_n = ref(packed)
    want = h_n[-1].detach().numpy()
    got = _port_encoder(params, reverse)(torch.from_numpy(x),
                                         torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy()[keep], want, **TOL)
    np.testing.assert_array_equal(got.detach().numpy()[~keep], 0.0)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_reference_hseq_matches_jax_kernel(reverse):
    """The plain version's full state sequence against the Pallas kernel's
    saved residuals (hseq, the next slice's BPTT input)."""
    from vqa_transfer_externaldata_tpu.ops.gru import _gru_pallas_fwd_call

    x, _, lens, params = _inputs(2)
    gx = (x.reshape(T * B, D) @ params["wx"] + params["b"]).reshape(
        T, B, 3 * H)
    hT_j, hseq_j = _gru_pallas_fwd_call(
        jnp.asarray(gx), jnp.asarray(lens, jnp.int32),
        jnp.asarray(params["uh"]), jnp.asarray(params["bhn"]),
        interpret=True, reverse=reverse)
    hT, hseq = tg.gru_reference(
        torch.from_numpy(gx), torch.from_numpy(lens).int(),
        torch.from_numpy(params["uh"]), torch.from_numpy(params["bhn"]),
        reverse=reverse)
    np.testing.assert_allclose(hseq.numpy(), np.asarray(hseq_j), **TOL)
    np.testing.assert_allclose(hT.numpy(), np.asarray(hT_j), **TOL)


def test_gru_reference_rounds_h_to_the_weight_dtype():
    """With bf16 U_h the state is rounded to bf16 ahead of the hidden
    matmul, as the kernels do: the result equals a manual f32 step on the
    rounded operands."""
    rng = np.random.default_rng(3)
    gx = torch.from_numpy(rng.normal(size=(2, 3, 3 * H)).astype(np.float32))
    uh = torch.from_numpy(rng.normal(size=(H, 3 * H)).astype(np.float32)
                          ).to(torch.bfloat16)
    bhn = torch.zeros(H)
    lens = torch.tensor([2, 2, 1], dtype=torch.int32)
    h1 = tg.gru_reference(gx[:1], lens, uh, bhn)[0]
    hT = tg.gru_reference(gx, lens, uh, bhn)[0]
    gh = h1.to(torch.bfloat16).float() @ uh.float()
    r = torch.sigmoid(gx[1, :, :H] + gh[:, :H])
    z = torch.sigmoid(gx[1, :, H:2 * H] + gh[:, H:2 * H])
    n = torch.tanh(gx[1, :, 2 * H:] + r * gh[:, 2 * H:])
    want = (1 - z) * n + z * h1
    torch.testing.assert_close(hT[:2], want[:2], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(hT[2], h1[2], rtol=0, atol=0)


def test_gru_fwd_wrapper_refuses_cpu_tensors():
    """The kernel wrapper launches on CUDA tensors or raises; the CPU path
    goes through gru_fused's plain version, never through the wrapper."""
    gx = torch.zeros(2, 3, 3 * H)
    lens = torch.ones(3, dtype=torch.int32)
    before = tg.gru_fwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        tg.gru_fwd(gx, lens, torch.zeros(H, 3 * H, dtype=torch.bfloat16),
                   torch.zeros(H))
    out = tg.gru_fused(gx, lens, torch.zeros(H, 3 * H), torch.zeros(H))
    assert out.shape == (3, H)
    assert tg.gru_fwd.launches == before
