"""Kernels K1 (gru_fwd) and K2 (attention_fwd) on the card against their
plain PyTorch versions. They need an NVIDIA GPU with nvcc (the kernels
have no CPU mode) and skip without one; on a GPU machine run

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Tolerances (max abs error), as in chip_smoke.py: h 2e-3 (sums in another
order; a last-bit difference of the state can flip its bf16 rounding ahead
of the hidden matmul), alpha 1e-5, v_att 2^-10 * max|v_att| in each
normalize mode (a bf16 weight p*r that rounds the other way moves its term
by at most 2^-7 of it; flipped terms may carry 1/8 of v_att), logits 5e-2
(bf16 activations between layers).
"""

import pytest
import torch

from vqa_transfer_externaldata_torch.ops import attention, gru

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gru_inputs(dev, T, B, H, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    gx = torch.randn(T, B, 3 * H, generator=g, device=dev) * 0.5
    lens = torch.randint(0, T + 1, (B,), generator=g, device=dev,
                         dtype=torch.int32)
    uh = (torch.randn(H, 3 * H, generator=g, device=dev) * H ** -0.5
          ).to(torch.bfloat16)
    bhn = torch.randn(H, generator=g, device=dev) * 0.1
    return gx, lens, uh, bhn


@pytest.mark.parametrize("shape", [(7, 20, 64), (26, 64, 512)])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_fwd_matches_plain(dev, shape, reverse):
    gx, lens, uh, bhn = _gru_inputs(dev, *shape)
    before = gru.gru_fwd.launches
    hT, hseq = gru.gru_fwd(gx, lens, uh, bhn, reverse=reverse)
    rT, rseq = gru.gru_reference(gx, lens, uh, bhn, reverse=reverse)
    torch.cuda.synchronize()
    assert gru.gru_fwd.launches == before + shape[0]  # one per timestep
    assert (hseq - rseq).abs().max().item() <= 2e-3
    assert (hT - rT).abs().max().item() <= 2e-3
    assert torch.equal(hT, hseq[0 if reverse else -1])


@pytest.mark.parametrize("n", [9, 196])
@pytest.mark.parametrize("normalize", [True, False])
def test_attention_fwd_matches_plain(dev, n, normalize):
    g = torch.Generator(device=dev).manual_seed(1)
    B, C, H = 3, 64, 128
    # Cells scaled by factors in [1/4, 4]: their norms differ, so a weight
    # taken with another cell's norm shows in v_att.
    scale = torch.exp2(torch.rand(B, n, 1, generator=g, device=dev) * 4 - 2)
    v = (torch.randn(B, n, C, generator=g, device=dev).relu() * scale).to(
        torch.bfloat16)
    qh = torch.randn(B, H, generator=g, device=dev) * 0.5
    wv = (torch.randn(C, H, generator=g, device=dev) * 0.1).to(
        torch.bfloat16)
    ws = (torch.randn(H, generator=g, device=dev) * 0.1).to(
        torch.bfloat16).float()
    before = attention.attention_fwd.launches
    va, al = attention.attention_fwd(v, qh, wv, ws, normalize=normalize)
    rv, ra = attention.attention_fwd_reference(v, qh, wv, ws, normalize)
    torch.cuda.synchronize()
    assert attention.attention_fwd.launches == before + 2
    assert (va - rv).abs().max().item() <= 2.0 ** -10 * rv.abs().max().item()
    assert (al - ra).abs().max().item() <= 1e-5


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    gx, lens, uh, bhn = _gru_inputs(dev, 3, 4, 24)
    with pytest.raises(ValueError, match="H % 16"):
        gru.gru_fwd(gx, lens, uh, bhn)
    gx, lens, uh, bhn = _gru_inputs(dev, 3, 4, 32)
    with pytest.raises(TypeError, match="uh"):
        gru.gru_fwd(gx, lens, uh.float(), bhn)
    v = torch.zeros(2, 9, 64, device=dev)
    qh, ws = torch.zeros(2, 128, device=dev), torch.zeros(128, device=dev)
    wv = torch.zeros(64, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="v must be"):
        attention.attention_fwd(v, qh, wv, ws, normalize=True)
    with pytest.raises(ValueError, match="H % 128"):
        attention.attention_fwd(v.to(torch.bfloat16), qh[:, :96], wv[:, :96],
                                ws[:96], normalize=True)


def test_model_forward_goes_through_both_kernels(dev, monkeypatch):
    from vqa_transfer_externaldata_torch.models.vqa_attention import (
        VQAAttentionModel)

    g = torch.Generator().manual_seed(2)
    model = VQAAttentionModel(64, 16, feature_dim=64, word_dim=16,
                              rnn_dim=64, fusion_dim=32, att_hidden=128,
                              answer_dim=16, dtype=torch.bfloat16,
                              generator=g).to(dev).eval()
    feats = torch.randn(5, 9, 64, generator=g).relu().to(dev)
    q = torch.randint(4, 64, (5, 6), generator=g)
    q[1, 2:] = 0
    q = q.to(dev)
    counts = gru.gru_fwd.launches, attention.attention_fwd.launches
    with torch.inference_mode():
        out = model(feats, q)["logits"]
    assert (gru.gru_fwd.launches, attention.attention_fwd.launches) == (
        counts[0] + q.shape[1], counts[1] + 2)
    monkeypatch.setattr(gru, "gru_fwd", gru.gru_reference)
    monkeypatch.setattr(
        attention, "attention_fwd",
        lambda v, qh, wv, ws, *, normalize:
        attention.attention_fwd_reference(v, qh, wv, ws, normalize))
    with torch.inference_mode():
        ref = model(feats, q)["logits"]
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 5e-2
