"""Kernels K1 (gru_fwd; also at both tilings of its launch plan and past
the 64-row tile, its launch shape against kernels.gru_fwd_plan, under CUDA
graph capture, and two calls bit-equal), K2 (attention_fwd; also at the
edges of its score tiles, its launch shape against kernels.score_plan, two
calls bit-equal, and its alpha and r bit-equal to K4's on the identity
store), K3 (gru_bwd), K4
(attention_resident_fwd) and K5 (attention_resident_bwd) at 1, 2 and 8
glimpses on bf16 rows and on int8 codes (K4 also at the edges of its score
tiles, and two calls bit-equal), K6 (bigru_fwd; also at both tilings
and past the point where both directions' j-tiles are resident at once,
its launch shape against kernels.gru_fwd_plan with two directions, under
CUDA graph capture, and two calls bit-equal), K7 (bigru_bwd; also its
launch shape, under CUDA graph capture, and two calls bit-equal) and
K8 (attention_bwd; also at the edges of its dz stage's 128-cell tiles,
its launch shape against kernels.dz_plan, and two calls bit-equal; K2 and
K8 also on the bf16 grid of the raw-image model's ResNet-101 at its
batches 8 and 32, and both refusing a grid view that is not contiguous),
and
the probes P1 (probe_mxu_rows) and
P2 (probe_bwd_ceiling) on the card against their plain PyTorch
versions; K5 and K8 also at the edges of the dW_v GEMM's tiles that they
share with P2 (csrc/attention_dwv.cuh), its launch shape, and two calls of
each bit-equal; K5's rows stage (csrc/attention_rows.cuh) at ragged
batches and cell counts, its launch shape against kernels.rows_plan, two
calls bit-equal and under CUDA graph capture. They need an NVIDIA GPU with nvcc (the kernels have no
CPU mode) and skip without one; on a GPU machine run

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances (max abs error), as in chip_smoke.py: h 2e-3 (sums in another
order; a last-bit difference of the state can flip its bf16 rounding ahead
of the hidden matmul), alpha 1e-5, v_att 2^-10 * max|v_att| in each
normalize mode (a bf16 weight p*r that rounds the other way moves its term
by at most 2^-7 of it; flipped terms may carry 1/8 of v_att), logits 5e-2
(bf16 activations between layers). K3-K5 are held relative to the largest
value of each output (see chip_smoke.py for the reasons): K3 2^-8, K4's
saved h 2^-7, K5 2^-9. K6 runs K1's persistent kernel and K7 K3's, each
with a direction axis (one cooperative launch for all steps of both
chains), so each of K6 and K7 equals two K1 (K3) calls on the same inputs
bit for bit.
K8 recomputes z, so a unit whose z lies
within rounding of 0 may take the other side of the ReLU in one version:
each output is held to 2^-9 of its largest value plus, per entry, what such
units can move it (``_k8_allowance``, the reasoning of chip_smoke.py). K4
and K5 with G glimpses keep those limits for alpha, h, each glimpse's v_att
and each column of dws; dqh and dW_v, whose dz sums G glimpse terms, get G
times K5's. On int8 codes K4 and K5 widen each code to bf16 exactly, so the
limits are the bf16 rows'. The probes sum the same exact products in
another order: 2^-14 of each output's largest value (``tools.TOL_REL``).
"""

import pytest
import torch

from vqa_transfer_externaldata_torch.ops import (
    attention, attention_resident as ar, gru, kernels)
from vqa_transfer_externaldata_torch.tools import (
    TOL_REL, probe_bwd_ceiling as p2, probe_mxu_rows as p1)

TOL_K3 = 2.0 ** -8
TOL_K4_H = 2.0 ** -7
TOL_K5 = 2.0 ** -9

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


@pytest.mark.parametrize("B", [1, 17, 64, 65, 256, 1024])
@pytest.mark.parametrize("T", [1, 7, 26])
@pytest.mark.parametrize("H", [16, 64, 512])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_fwd_matches_plain(dev, B, T, H, reverse):
    """K1's persistent launch against its plain version (2e-3) and
    against K6's matching direction on the same inputs, bit for bit: two
    launches of one kernel body (gru_seq_kernel of gru_fwd_step.cuh), K1's
    with one direction, K6's with both chains. Over both tilings of
    kernels.gru_fwd_plan: B=1, 17, 64 and 65 take 16-row blocks, 256
    64-row ones, 1024 walks b-tiles; lengths hold 0 and T."""
    gx, lens, uh, bhn = _gru_inputs(dev, T, B, H)
    lens[0] = T
    if B > 1:
        lens[1] = 0
    before = gru.gru_fwd.launches
    hT, hseq = gru.gru_fwd(gx, lens, uh, bhn, reverse=reverse)
    after = gru.gru_fwd.launches
    rT, rseq = gru.gru_reference(gx, lens, uh, bhn, reverse=reverse)
    k6 = gru.bigru_fwd(gx, gx, lens, uh, uh, bhn, bhn)
    torch.cuda.synchronize()
    assert after == before + 1  # one persistent launch for all T steps
    assert torch.isfinite(hseq).all()
    assert (hseq - rseq).abs().max().item() <= 2e-3
    assert (hT - rT).abs().max().item() <= 2e-3
    assert torch.equal(hT, hseq[0 if reverse else -1])
    d = int(reverse)
    assert torch.equal(hT, k6[d]), (hT - k6[d]).abs().max().item()
    assert torch.equal(hseq, k6[2 + d]), (hseq - k6[2 + d]).abs().max().item()


@pytest.mark.parametrize("B", [64, 256, 1024])
def test_gru_fwd_is_deterministic(dev, B):
    """Two calls on the same inputs give the same bits: the grid barrier
    orders every exchange of the state between blocks."""
    gx, lens, uh, bhn = _gru_inputs(dev, 26, B, 512, seed=3)
    first = gru.gru_fwd(gx, lens, uh, bhn)
    second = gru.gru_fwd(gx, lens, uh, bhn)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B", [1, 256])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_fwd_past_the_64_row_tile_matches_plain(dev, B, reverse):
    """At H = 880 a 64-row block's shared memory does not fit, so every
    batch takes 16-row blocks (B=256 walking b-tiles), still within 2e-3
    of the plain version and bit-equal to K6's matching direction (two
    launches of one kernel body, K6's with both chains)."""
    gx, lens, uh, bhn = _gru_inputs(dev, 26, B, 880, seed=6)
    lens[0] = 26
    cfg = gru.gru_fwd_launch_config(B, 880, dev)
    assert cfg["rows"] == 16 and cfg["per_sm_by_rows"][64] == 0
    hT, hseq = gru.gru_fwd(gx, lens, uh, bhn, reverse=reverse)
    rT, rseq = gru.gru_reference(gx, lens, uh, bhn, reverse=reverse)
    k6 = gru.bigru_fwd(gx, gx, lens, uh, uh, bhn, bhn)
    torch.cuda.synchronize()
    assert (hseq - rseq).abs().max().item() <= 2e-3
    assert (hT - rT).abs().max().item() <= 2e-3
    d = int(reverse)
    assert torch.equal(hT, k6[d]) and torch.equal(hseq, k6[2 + d])


def test_gru_fwd_launch_shape_and_limit(dev):
    """The C side derives the grid from the batch rows that
    kernels.gru_fwd_plan takes and from its own occupancy query, and it
    equals the plan's on the same blocks per SM: at the training shape 32
    j-tiles x 4 rows of 64-row blocks, one an SM; at the serving batch
    more than 32 blocks. A width at which not even a 16-row block's
    shared memory fits raises instead of falling back."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for B, H in [(256, 512), (64, 512), (1, 512), (128, 512), (1024, 512),
                 (64, 64), (1, 880), (256, 1568)]:
        cfg = gru.gru_fwd_launch_config(B, H, dev)
        plan = kernels.gru_fwd_plan(B, H, sms, cfg["per_sm_by_rows"])
        assert cfg["rows"] == plan["rows"]
        assert cfg["blocks_per_sm"] == cfg["per_sm_by_rows"][cfg["rows"]] >= 1
        assert cfg["grid"] == plan["grid"]
        assert cfg["launches"] == plan["launches"] == 1
        assert 0 < cfg["smem_bytes"] <= 232448
    train = gru.gru_fwd_launch_config(256, 512, dev)
    assert train["grid"] == [32, 4, 1] and train["rows"] == 64
    serve = gru.gru_fwd_launch_config(64, 512, dev)
    assert serve["grid"][0] * serve["grid"][1] > 32
    gx, lens, uh, bhn = _gru_inputs(dev, 2, 4, 1584)
    with pytest.raises(ValueError, match="gru_fwd_plan"):
        gru.gru_fwd(gx, lens, uh, bhn)


def test_gru_fwd_captures_in_a_cuda_graph(dev):
    """The cooperative launch is accepted under stream capture, and the
    graph's replay on new inputs equals an eager call on them."""
    gx, lens, uh, bhn = _gru_inputs(dev, 26, 256, 512, seed=4)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gru.gru_fwd(gx, lens, uh, bhn)  # warm up off the capture stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = gru.gru_fwd.launches
    with torch.cuda.graph(graph):
        hT, hseq = gru.gru_fwd(gx, lens, uh, bhn)
    assert gru.gru_fwd.launches == before + 1
    gx2, lens2, _, _ = _gru_inputs(dev, 26, 256, 512, seed=5)
    gx.copy_(gx2)
    lens.copy_(lens2)
    graph.replay()
    want = gru.gru_fwd(gx, lens, uh, bhn)
    torch.cuda.synchronize()
    assert torch.equal(hT, want[0]) and torch.equal(hseq, want[1])


def _k2_inputs(dev, B, N, C, H, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    # Cells scaled by factors in [1/4, 4]: their norms differ, so a weight
    # taken with another cell's norm shows in v_att.
    scale = torch.exp2(torch.rand(B, N, 1, generator=g, device=dev) * 4 - 2)
    v = (torch.randn(B, N, C, generator=g, device=dev).relu() * scale).to(
        torch.bfloat16)
    qh = torch.randn(B, H, generator=g, device=dev) * 0.5
    wv = (torch.randn(C, H, generator=g, device=dev) * 0.1).to(
        torch.bfloat16)
    ws = (torch.randn(H, generator=g, device=dev) * 0.1).to(
        torch.bfloat16).float()
    return v, qh, wv, ws


# K2's score tiles at their edges: one question and past the 128-cell tile
# (B * N from 1 to 1568 cells; N=129 puts a tile boundary inside a
# question), C % 64 == 32 (the last 64-channel chunk half zero-filled), the
# 128-unit tile (H = 128, 384) and the 256-unit one (H = 256).
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("n", [1, 9, 129, 196])
@pytest.mark.parametrize("C", [64, 96])
@pytest.mark.parametrize("H", [128, 256, 384])
@pytest.mark.parametrize("normalize", [True, False])
def test_attention_fwd_matches_plain(dev, B, n, C, H, normalize):
    v, qh, wv, ws = _k2_inputs(dev, B, n, C, H)
    before = attention.attention_fwd.launches
    va, al, r = attention.attention_fwd(v, qh, wv, ws, normalize=normalize)
    rv, ra, rr = attention.attention_fwd_reference(v, qh, wv, ws, normalize)
    torch.cuda.synchronize()
    assert attention.attention_fwd.launches == before + 2
    assert (r - rr).abs().max().item() <= 1e-6 * rr.abs().max().item()
    assert (va - rv).abs().max().item() <= 2.0 ** -10 * rv.abs().max().item()
    assert (al - ra).abs().max().item() <= 1e-5


@pytest.mark.parametrize("shape", [(8, 196, 2048, 512), (256, 196, 2048, 512),
                                   (3, 129, 96, 384)])
@pytest.mark.parametrize("normalize", [True, False])
def test_attention_fwd_is_deterministic(dev, shape, normalize):
    """Two K2 calls on the same inputs give the same bits: no atomics, no
    split-K, the partial scores summed in unit-tile order."""
    args = _k2_inputs(dev, *shape)
    first = attention.attention_fwd(*args, normalize=normalize)
    second = attention.attention_fwd(*args, normalize=normalize)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(1, 1, 64, 128), (3, 129, 96, 384),
                                   (8, 196, 2048, 512), (256, 196, 2048, 512)])
@pytest.mark.parametrize("normalize", [True, False])
def test_attention_fwd_equals_k4_on_the_identity_store(dev, shape, normalize):
    """K2 and K4 run one score tile (score_tile.cuh) on the same rows in the
    same order: K4 on the store v [B, N, C] with rows 0..B-1, every cell
    valid, one glimpse, gives K2's alpha and r bit for bit. (v_att is not
    compared: K2 rounds the weights p * r to bf16, K4 alpha * r.)"""
    B, N, C, H = shape
    v, qh, wv, ws = _k2_inputs(dev, B, N, C, H)
    rows = torch.arange(B, dtype=torch.int32, device=dev)
    _, al, r = attention.attention_fwd(v, qh, wv, ws, normalize=normalize)
    _, al4, _, r4 = ar._launch_fwd(v, rows, qh, wv, ws, N, normalize, False)
    torch.cuda.synchronize()
    assert torch.equal(al, al4)
    assert torch.equal(r.reshape(-1), r4)


def test_attention_fwd_score_launch_shape(dev):
    """K2's score launch as the C side sets it equals kernels.score_plan,
    within a block's shared memory; K4's score launch on bf16 rows takes
    the same tile, stages, shared memory and grid over the same cells."""
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    for B, N, C, H in [(1, 1, 64, 128), (8, 196, 2048, 512),
                       (64, 196, 2048, 512), (256, 196, 2048, 512),
                       (3, 129, 96, 384), (17, 9, 2048, 2304)]:
        plan = kernels.score_plan(B, N, C, H)
        assert attention.score_launch_config(B, N, H) == plan, (B, N, H)
        assert plan["smem_bytes"] <= limit
        del plan["n_part"]
        assert ar.score_launch_config(B * N, H, False) == plan, (B, N, H)


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
    gx, lens, uh, bhn = _gru_inputs(dev, 3, 4, 32)
    _, hseq = gru.gru_reference(gx, lens, uh, bhn)
    with pytest.raises(ValueError, match="H % 64"):
        gru.gru_bwd(gx, hseq, lens, uh, bhn, torch.zeros(4, 32, device=dev))
    store, rows, qh, wv, ws = _resident_inputs(dev, 3, 9, 64, 128, 2)
    with pytest.raises(TypeError, match="store must be"):
        ar.attention_resident_fwd(store.float(), rows, qh, wv, ws, n_valid=9,
                                  normalize=False)
    with pytest.raises(ValueError, match="n_valid"):
        ar.attention_resident_fwd(store, rows, qh, wv, ws, n_valid=17,
                                  normalize=False)
    h = torch.zeros(2, 16, 128, device=dev, dtype=torch.bfloat16)
    al, sga = torch.zeros(2, 16, device=dev), torch.zeros(2, 16, device=dev)
    with pytest.raises(ValueError, match="C % 128"):
        ar.attention_resident_bwd(store, rows, h, ws, al,
                                  torch.zeros(2, 64, device=dev), sga,
                                  n_valid=9, normalize=False)


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
        counts[0] + 1, counts[1] + 2)
    monkeypatch.setattr(gru, "gru_fwd", gru.gru_reference)
    monkeypatch.setattr(
        attention, "attention_fwd",
        lambda v, qh, wv, ws, *, normalize:
        attention.attention_fwd_reference(v, qh, wv, ws, normalize))
    with torch.inference_mode():
        ref = model(feats, q)["logits"]
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 5e-2


def _rel_err(got, want):
    return (got - want).abs().max().item() / max(want.abs().max().item(),
                                                 1e-30)


@pytest.mark.parametrize("shape", [(7, 20, 64), (26, 256, 512)])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_bwd_matches_plain(dev, shape, reverse):
    T, B, H = shape
    gx, lens, uh, bhn = _gru_inputs(dev, T, B, H, seed=3)
    lens[0], lens[1] = T, 1  # the longest and the shortest question
    _, hseq = gru.gru_reference(gx, lens, uh, bhn, reverse=reverse)
    ghT = torch.randn(B, H, generator=torch.Generator(device=dev)
                      .manual_seed(4), device=dev)
    before = gru.gru_bwd.launches
    got = gru.gru_bwd(gx, hseq, lens, uh, bhn, ghT, reverse=reverse)
    want = gru.gru_bwd_reference(gx, hseq, lens, uh, bhn, ghT,
                                 reverse=reverse)
    torch.cuda.synchronize()
    assert gru.gru_bwd.launches == before + 3  # steps, dU_h, db_hn
    for name, a, b in zip(("dgx", "duh", "dbhn"), got, want):
        assert torch.isfinite(a).all(), name
        assert _rel_err(a, b) <= TOL_K3, (name, _rel_err(a, b))


def _k3_k7_inputs(dev, T, B, H, reverse, seed=11):
    """One direction's BPTT inputs, its hseq from the plain forward."""
    gx, lens, uh, bhn = _gru_inputs(dev, T, B, H, seed)
    lens[0], lens[1] = T, 1  # the longest and the shortest question
    _, hseq = gru.gru_reference(gx, lens, uh, bhn, reverse=reverse)
    ghT = torch.randn(B, H, generator=torch.Generator(device=dev)
                      .manual_seed(seed + 1), device=dev)
    return gx, hseq, lens, uh, bhn, ghT


@pytest.mark.parametrize("B", [17, 256, 1024])
@pytest.mark.parametrize("T", [1, 26])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_bwd_equals_k7_direction_bit_for_bit(dev, B, T, reverse):
    """K3 and K7 run one persistent body (gru_bwd_step.cuh): K3 one
    direction on 4 rows of blocks at H=512, K7 both on 2 rows each, so each
    of K7's blocks walks twice the b-tiles. Each block's products, their
    order and its partial slots are those of a K3 call with the same
    `reverse`, and every direction's bf16 copy of the states is written by
    that direction's blocks: K3's outputs equal K7's matching direction bit
    for bit (B=17 a ragged b-tile, B=1024 more b-tiles than resident
    blocks, T=1 no step with a pre-step state)."""
    H = 512
    mine = _k3_k7_inputs(dev, T, B, H, reverse)
    other = _k3_k7_inputs(dev, T, B, H, not reverse, seed=13)
    other = (other[0], other[1], mine[2], *other[3:])  # one lens for both
    fwd, bwd = (other, mine) if reverse else (mine, other)
    got = gru.gru_bwd(*mine, reverse=reverse)
    k7 = gru.bigru_bwd(fwd[0], bwd[0], fwd[1], bwd[1], mine[2], fwd[3],
                       bwd[3], fwd[4], bwd[4], fwd[5], bwd[5])
    torch.cuda.synchronize()
    d = int(reverse)
    for name, a, b in zip(("dgx", "duh", "dbhn"), got,
                          (k7[d], k7[2 + d], k7[4 + d])):
        assert torch.isfinite(a).all(), name
        assert torch.equal(a, b), (name, (a - b).abs().max().item())


@pytest.mark.parametrize("B", [256, 1024])
def test_gru_bwd_is_deterministic(dev, B):
    """Two calls on the same inputs give the same bits: the grid barrier
    orders every exchange between blocks, and no result takes atomics."""
    ins = _k3_k7_inputs(dev, 26, B, 512, False, seed=17)
    first = gru.gru_bwd(*ins)
    second = gru.gru_bwd(*ins)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_gru_bwd_launch_shape_and_limit(dev):
    """At the training shape the step kernel runs 32 j-tiles x 4 b-tile
    rows of blocks, one a SM; a width whose U_h slices do not fit in shared
    memory raises instead of falling back."""
    cfg = gru.gru_bwd_launch_config(256, 512, dev)
    assert cfg["grid"] == [32, 4, 1]
    assert cfg["blocks_per_sm"] >= 1
    assert cfg["smem_bytes"] <= 232448
    assert cfg["max_width"] == 576
    assert gru.gru_bwd_launch_config(1024, 512, dev)["grid"][0] == 32
    gx, hseq, lens, uh, bhn, ghT = _k3_k7_inputs(dev, 2, 4, 640, False)
    with pytest.raises(RuntimeError, match="gru_bwd.*H <= 576"):
        gru.gru_bwd(gx, hseq, lens, uh, bhn, ghT)


def _resident_inputs(dev, M, n_valid, C, H, B, seed=5):
    g = torch.Generator(device=dev).manual_seed(seed)
    Np = n_valid + (-n_valid) % 8
    scale = torch.exp2(torch.rand(M, n_valid, 1, generator=g, device=dev)
                       * 4 - 2)
    store = torch.zeros(M, Np, C, device=dev, dtype=torch.bfloat16)
    store[:, :n_valid] = (torch.randn(M, n_valid, C, generator=g, device=dev)
                          .relu() * scale).to(torch.bfloat16)
    rows = torch.randint(0, M, (B,), generator=g, device=dev,
                         dtype=torch.int32)
    if B > 1:
        rows[1] = rows[0]  # two questions about one image
    qh = torch.randn(B, H, generator=g, device=dev) * 0.5
    wv = ((torch.rand(C, H, generator=g, device=dev) * 2 - 1)
          * (6.0 / (C + H)) ** 0.5).to(torch.bfloat16)
    ws = (torch.randn(H, generator=g, device=dev) * 0.05).to(
        torch.bfloat16).float()
    return store, rows, qh, wv, ws


@pytest.mark.parametrize("shape", [(5, 13, 128, 128, 6),
                                   (64, 196, 2048, 512, 256)])
@pytest.mark.parametrize("normalize", [True, False])
def test_attention_resident_fwd_bwd_match_plain(dev, shape, normalize):
    M, n_valid, C, H, B = shape
    store, rows, qh, wv, ws = _resident_inputs(dev, M, n_valid, C, H, B)
    kw = dict(n_valid=n_valid, normalize=normalize)
    before = ar.attention_resident_fwd.launches
    va, al, h = ar.attention_resident_fwd(store, rows, qh, wv, ws,
                                          save_h=True, **kw)
    rv, ra, rh = ar.attention_resident_fwd_reference(store, rows, qh, wv, ws,
                                                     save_h=True, **kw)
    torch.cuda.synchronize()
    assert ar.attention_resident_fwd.launches == before + 2
    assert (va - rv).abs().max().item() <= 2.0 ** -10 * rv.abs().max().item()
    assert (al - ra).abs().max().item() <= 1e-5
    assert al[:, n_valid:].abs().max().item() == 0.0
    assert _rel_err(h.float(), rh.float()) <= TOL_K4_H

    g = torch.Generator(device=dev).manual_seed(6)
    gv = torch.randn(B, C, generator=g, device=dev)
    sga = torch.randn(B, al.shape[1], generator=g, device=dev)
    before = ar.attention_resident_bwd.launches
    got = ar.attention_resident_bwd(store, rows, rh, ws, ra, gv, sga, **kw)
    want = ar.attention_resident_bwd_reference(store, rows, rh, ws, ra, gv,
                                               sga, **kw)
    torch.cuda.synchronize()
    assert ar.attention_resident_bwd.launches == before + 3
    for name, a, b in zip(("dqh", "dwv", "dws"), got, want):
        assert torch.isfinite(a).all(), name
        assert _rel_err(a, b) <= TOL_K5, (name, _rel_err(a, b))


@pytest.mark.parametrize("glimpses", [2, 8])
@pytest.mark.parametrize("shape", [(5, 13, 128, 128, 6),
                                   (64, 196, 2048, 512, 256)])
@pytest.mark.parametrize("normalize", [True, False])
def test_attention_resident_glimpses_match_plain(dev, glimpses, shape,
                                                 normalize):
    M, n_valid, C, H, B = shape
    G = glimpses
    store, rows, qh, wv, _ = _resident_inputs(dev, M, n_valid, C, H, B)
    g = torch.Generator(device=dev).manual_seed(7)
    ws = (torch.randn(H, G, generator=g, device=dev) * 0.05).to(
        torch.bfloat16).float()
    kw = dict(n_valid=n_valid, normalize=normalize)
    before = ar.attention_resident_fwd.launches
    va, al, h = ar.attention_resident_fwd(store, rows, qh, wv, ws,
                                          save_h=True, **kw)
    rv, ra, rh = ar.attention_resident_fwd_reference(store, rows, qh, wv, ws,
                                                     save_h=True, **kw)
    torch.cuda.synchronize()
    assert ar.attention_resident_fwd.launches == before + 2
    assert va.shape == (B, G * C) and al.shape == (B, rh.shape[1], G)
    for k in range(G):  # each glimpse against its own largest value
        a, b = va[:, k * C:(k + 1) * C], rv[:, k * C:(k + 1) * C]
        assert (a - b).abs().max().item() <= 2.0 ** -10 * b.abs().max().item()
    assert (al - ra).abs().max().item() <= 1e-5
    assert al[:, n_valid:].abs().max().item() == 0.0
    assert _rel_err(h.float(), rh.float()) <= TOL_K4_H

    gv = torch.randn(B, G * C, generator=g, device=dev)
    sga = torch.randn(B, ra.shape[1], G, generator=g, device=dev)
    before = ar.attention_resident_bwd.launches
    got = ar.attention_resident_bwd(store, rows, rh, ws, ra, gv, sga, **kw)
    want = ar.attention_resident_bwd_reference(store, rows, rh, ws, ra, gv,
                                               sga, **kw)
    torch.cuda.synchronize()
    assert ar.attention_resident_bwd.launches == before + 3
    assert got[2].shape == (H, G)
    for name, a, b in zip(("dqh", "dwv"), got, want):
        assert torch.isfinite(a).all(), name
        assert _rel_err(a, b) <= G * TOL_K5, (name, _rel_err(a, b))
    for k in range(G):
        assert _rel_err(got[2][:, k], want[2][:, k]) <= TOL_K5, k


def _int8_codes(store):
    """The int8 codes and scale of ``store`` normalized per cell, as
    ``prenormalize_store(quantize="int8")`` makes them (on the card)."""
    f = store.float()
    f = f * torch.rsqrt((f * f).sum(-1, keepdim=True) + 1e-12)
    scale = f.abs().max().item() / 127.0
    return torch.clamp(torch.round(f / scale), -127, 127).to(torch.int8), scale


@pytest.mark.parametrize("glimpses", [1, 2, 8])
@pytest.mark.parametrize("shape", [(5, 13, 128, 128, 6),
                                   (64, 196, 2048, 512, 256)])
def test_attention_resident_int8_matches_plain(dev, glimpses, shape):
    """K4/K5 on int8 rows against their plain versions on the same codes,
    under the bf16 rows' limits; the launches count as int8 ones."""
    M, n_valid, C, H, B = shape
    G = glimpses
    store, rows, qh, wv, _ = _resident_inputs(dev, M, n_valid, C, H, B)
    codes, scale = _int8_codes(store)
    # The op hands the kernels W_v with the store's scale folded in, so z
    # has the normalized store's size.
    wv = (wv.float() * scale).to(torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(8)
    ws = (torch.randn(H, G, generator=g, device=dev) * 0.05).to(
        torch.bfloat16).float()
    if G == 1:
        ws = ws[:, 0].contiguous()
    kw = dict(n_valid=n_valid, normalize=False)
    before = (ar.attention_resident_fwd.launches,
              ar.attention_resident_fwd.launches_int8)
    va, al, h = ar.attention_resident_fwd(codes, rows, qh, wv, ws,
                                          save_h=True, **kw)
    rv, ra, rh = ar.attention_resident_fwd_reference(codes, rows, qh, wv, ws,
                                                     save_h=True, **kw)
    torch.cuda.synchronize()
    assert (ar.attention_resident_fwd.launches,
            ar.attention_resident_fwd.launches_int8) == (before[0],
                                                         before[1] + 2)
    for k in range(G):  # each glimpse against its own largest value
        a, b = va[:, k * C:(k + 1) * C], rv[:, k * C:(k + 1) * C]
        assert (a - b).abs().max().item() <= 2.0 ** -10 * b.abs().max().item()
    assert (al - ra).abs().max().item() <= 1e-5
    assert _rel_err(h.float(), rh.float()) <= TOL_K4_H

    gv = torch.randn(B, G * C, generator=g, device=dev)
    sga = torch.randn(ra.shape, generator=g, device=dev)
    before = (ar.attention_resident_bwd.launches,
              ar.attention_resident_bwd.launches_int8)
    got = ar.attention_resident_bwd(codes, rows, rh, ws, ra, gv, sga, **kw)
    want = ar.attention_resident_bwd_reference(codes, rows, rh, ws, ra, gv,
                                               sga, **kw)
    torch.cuda.synchronize()
    assert (ar.attention_resident_bwd.launches,
            ar.attention_resident_bwd.launches_int8) == (before[0],
                                                         before[1] + 3)
    for name, a, b in zip(("dqh", "dwv"), got, want):
        assert torch.isfinite(a).all(), name
        assert _rel_err(a, b) <= G * TOL_K5, (name, _rel_err(a, b))
    dws, dws_ref = got[2].reshape(H, G), want[2].reshape(H, G)
    for k in range(G):
        assert _rel_err(dws[:, k], dws_ref[:, k]) <= TOL_K5, k
    with pytest.raises(ValueError, match="normalize"):
        ar.attention_resident_fwd(codes, rows, qh, wv, ws, n_valid=n_valid,
                                  normalize=True)


# K4's score GEMM at the edges of its tiles: cells that are not a multiple
# of the 128-row tile (B=6 of Np=16: 96 cells; B=5 of Np=200: 1000),
# C % 64 == 32 (the last 64-channel chunk half zero-filled), the 128-column
# tile (H = 128, 384) and the 256-column one (H = 512), G = 1, 2 and 8, bf16
# rows with normalize on and off and int8 codes (normalize off: the store is
# prenormalized). The limits are the other K4 cases'.
K4_EDGE_SHAPES = [(5, 13, 96, 128, 6), (5, 13, 96, 384, 6),
                  (5, 13, 96, 512, 6), (9, 196, 224, 384, 5)]


@pytest.mark.parametrize("row_type,normalize", [("bf16", True),
                                                ("bf16", False),
                                                ("int8", False)])
@pytest.mark.parametrize("glimpses", [1, 2, 8])
@pytest.mark.parametrize("shape", K4_EDGE_SHAPES)
def test_attention_resident_fwd_tile_edges_match_plain(dev, shape, glimpses,
                                                       row_type, normalize):
    M, n_valid, C, H, B = shape
    G = glimpses
    store, rows, qh, wv, _ = _resident_inputs(dev, M, n_valid, C, H, B)
    count = "launches"
    if row_type == "int8":
        store, scale = _int8_codes(store)
        wv = (wv.float() * scale).to(torch.bfloat16)
        count = "launches_int8"
    g = torch.Generator(device=dev).manual_seed(12)
    ws = (torch.randn(H, G, generator=g, device=dev) * 0.05).to(
        torch.bfloat16).float()
    if G == 1:
        ws = ws[:, 0].contiguous()
    kw = dict(n_valid=n_valid, normalize=normalize)
    before = getattr(ar.attention_resident_fwd, count)
    va, al, h = ar.attention_resident_fwd(store, rows, qh, wv, ws,
                                          save_h=True, **kw)
    rv, ra, rh = ar.attention_resident_fwd_reference(store, rows, qh, wv, ws,
                                                     save_h=True, **kw)
    torch.cuda.synchronize()
    assert getattr(ar.attention_resident_fwd, count) == before + 2
    assert va.shape == (B, G * C) and h.shape == rh.shape
    for k in range(G):  # each glimpse against its own largest value
        a, b = va[:, k * C:(k + 1) * C], rv[:, k * C:(k + 1) * C]
        assert (a - b).abs().max().item() <= 2.0 ** -10 * b.abs().max().item()
    assert (al - ra).abs().max().item() <= 1e-5
    assert al[:, n_valid:].abs().max().item() == 0.0
    assert _rel_err(h.float(), rh.float()) <= TOL_K4_H


@pytest.mark.parametrize("int8", [False, True])
def test_attention_resident_fwd_is_deterministic(dev, int8):
    """Two K4 calls on the same inputs at the training shape give the same
    bits: no atomics, no split-K, partial scores summed in a fixed order."""
    store, rows, qh, wv, _ = _resident_inputs(dev, 64, 196, 2048, 512, 256)
    if int8:
        store, scale = _int8_codes(store)
        wv = (wv.float() * scale).to(torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(13)
    ws = (torch.randn(512, 2, generator=g, device=dev) * 0.05).to(
        torch.bfloat16).float()
    kw = dict(n_valid=196, normalize=not int8, save_h=True)
    first = ar.attention_resident_fwd(store, rows, qh, wv, ws, **kw)
    second = ar.attention_resident_fwd(store, rows, qh, wv, ws, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_attention_resident_score_launch_shape(dev):
    """K4's score launch: 128 x 256 tiles at H=512 (the column tiles of a
    cell tile side by side in the grid), 128 x 128 where 256 does not
    divide H, and dynamic shared memory above the default 48 KB that a
    block of the card may still take."""
    main = ar.score_launch_config(256 * 200, 512, False)
    assert main["tile"] == [128, 256] and main["grid"] == [2, 400]
    assert ar.score_launch_config(96, 384, True)["tile"] == [128, 128]
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    for H in (384, 512):
        for int8 in (False, True):
            smem = ar.score_launch_config(96, H, int8)["smem_bytes"]
            assert 48 * 1024 < smem <= limit, (H, int8, smem)


def test_int8_op_grads_go_through_k4_k5(dev):
    """The op on an int8 store with its scale launches the int8 K4 and K5
    and agrees with the op run on the CPU plain path."""
    store, rows, qh, wv, ws = _resident_inputs(dev, 5, 13, 128, 128, 8)
    codes, scale = _int8_codes(store)
    # An int8 store computes in qh's dtype: bf16, as the model's.
    ins = [t.clone().requires_grad_()
           for t in (qh.to(torch.bfloat16), wv.float(), ws)]
    counts = (ar.attention_resident_fwd.launches_int8,
              ar.attention_resident_bwd.launches_int8)
    va, al = ar.spatial_attention_resident(codes, rows, *ins, n_valid=13,
                                           store_scale=scale)
    (va.square().sum() + al[:, 0].sum()).backward()
    assert (ar.attention_resident_fwd.launches_int8,
            ar.attention_resident_bwd.launches_int8) == (counts[0] + 2,
                                                         counts[1] + 3)
    cpu = [t.detach().cpu().requires_grad_() for t in ins]
    rv, ra = ar.spatial_attention_resident(codes.cpu(), rows.cpu(), *cpu,
                                           n_valid=13, store_scale=scale)
    (rv.square().sum() + ra[:, 0].sum()).backward()
    assert _rel_err(va.detach().cpu(), rv.detach()) <= 2.0 ** -8
    for a, b in zip(ins, cpu):
        cos = torch.nn.functional.cosine_similarity(
            a.grad.flatten().cpu(), b.grad.flatten(), dim=0).item()
        assert cos >= 0.999, cos


@pytest.mark.parametrize("q", [1, 2, 3, 4])
def test_probe_mxu_rows_matches_plain(dev, q):
    g = torch.Generator(device=dev).manual_seed(9)
    store = torch.randn(5, 24, 64, generator=g, device=dev).to(torch.bfloat16)
    wv = (torch.randn(64, 128, generator=g, device=dev) * 0.1).to(
        torch.bfloat16)
    rows = torch.randint(0, 5, (12,), generator=g, device=dev,
                         dtype=torch.int32)
    before = p1.probe_mxu_rows.launches
    got = p1.probe_mxu_rows(store, rows, wv, q)
    want = p1.probe_mxu_rows_reference(store, rows, wv, q)
    torch.cuda.synchronize()
    assert p1.probe_mxu_rows.launches == before + 1
    assert got.shape == (12 // q, q * 24, 128)
    assert _rel_err(got, want) <= TOL_REL


def test_probe_bwd_ceiling_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(10)
    store = torch.randn(5, 24, 128, generator=g, device=dev).to(
        torch.bfloat16)
    h = torch.randn(6, 24, 128, generator=g, device=dev).to(torch.bfloat16)
    gv = torch.randn(6, 128, generator=g, device=dev).to(torch.bfloat16)
    rows = torch.randint(0, 5, (6,), generator=g, device=dev,
                         dtype=torch.int32)
    before = p2.probe_bwd_ceiling.launches
    got = p2.probe_bwd_ceiling(store, rows, h, gv)
    want = p2.probe_bwd_ceiling_reference(store, rows, h, gv)
    torch.cuda.synchronize()
    assert p2.probe_bwd_ceiling.launches == before + 3
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert _rel_err(a, b) <= TOL_REL


def test_probes_run_at_full_size(dev):
    """Both probes' entries at the TPU probes' sizes, with two timed
    launches (their checks raise when a kernel disagrees)."""
    r1 = p1.run(iters=2)
    assert set(r1["by_q"]) == {1, 2, 3, 4}
    assert all(v["ms"] > 0 for v in r1["by_q"].values())
    r2 = p2.run(iters=2)
    assert r2["ms"] > 0 and r2["dwv_rel_err"] <= TOL_REL


def test_resident_op_grads_go_through_k4_k5(dev):
    """The autograd op on the card launches K4 forward and K5 backward and
    its grads agree with the op run on the CPU plain path."""
    store, rows, qh, wv, ws = _resident_inputs(dev, 5, 13, 128, 128, 8)
    ins = [t.clone().requires_grad_() for t in (qh, wv.float(), ws)]
    counts = (ar.attention_resident_fwd.launches,
              ar.attention_resident_bwd.launches)
    va, al = ar.spatial_attention_resident(store, rows, *ins, n_valid=13,
                                           normalize=True)
    (va.square().sum() + al[:, 0].sum()).backward()
    assert (ar.attention_resident_fwd.launches,
            ar.attention_resident_bwd.launches) == (counts[0] + 2,
                                                    counts[1] + 3)
    cpu = [t.detach().cpu().requires_grad_() for t in (qh, wv.float(), ws)]
    rv, ra = ar.spatial_attention_resident(store.cpu(), rows.cpu(), *cpu,
                                           n_valid=13, normalize=True)
    (rv.square().sum() + ra[:, 0].sum()).backward()
    for a, b in zip(ins, cpu):
        cos = torch.nn.functional.cosine_similarity(
            a.grad.flatten().cpu(), b.grad.flatten(), dim=0).item()
        assert cos >= 0.999, cos


def test_two_glimpse_op_grads_go_through_k4_k5(dev):
    """The op with a [H, 2] score matrix launches K4 and K5 once each and
    its grads agree with the op run on the CPU plain path."""
    store, rows, qh, wv, ws = _resident_inputs(dev, 5, 13, 128, 128, 8)
    ws2 = torch.stack([ws, ws.flip(0)], 1)
    ins = [t.clone().requires_grad_() for t in (qh, wv.float(), ws2)]
    counts = (ar.attention_resident_fwd.launches,
              ar.attention_resident_bwd.launches)
    va, al = ar.spatial_attention_resident(store, rows, *ins, n_valid=13,
                                           normalize=True)
    assert va.shape == (8, 256) and al.shape == (8, 13, 2)
    (va.square().sum() + al[:, 0].sum()).backward()
    assert (ar.attention_resident_fwd.launches,
            ar.attention_resident_bwd.launches) == (counts[0] + 2,
                                                    counts[1] + 3)
    cpu = [t.detach().cpu().requires_grad_() for t in (qh, wv.float(), ws2)]
    rv, ra = ar.spatial_attention_resident(store.cpu(), rows.cpu(), *cpu,
                                           n_valid=13, normalize=True)
    (rv.square().sum() + ra[:, 0].sum()).backward()
    for a, b in zip(ins, cpu):
        cos = torch.nn.functional.cosine_similarity(
            a.grad.flatten().cpu(), b.grad.flatten(), dim=0).item()
        assert cos >= 0.999, cos


def _bigru_inputs(dev, T, B, H, seed=7):
    gxf, lens, uhf, bhnf = _gru_inputs(dev, T, B, H, seed)
    gxb, _, uhb, bhnb = _gru_inputs(dev, T, B, H, seed + 1)
    lens[0], lens[1] = T, 1  # the longest and the shortest question
    return gxf, gxb, lens, uhf, uhb, bhnf, bhnb


@pytest.mark.parametrize("shape", [(7, 20, 64), (26, 256, 512)])
def test_bigru_fwd_bwd_match_plain_and_one_direction_kernels(dev, shape):
    T, B, H = shape
    gxf, gxb, lens, uhf, uhb, bhnf, bhnb = _bigru_inputs(dev, T, B, H)
    before = gru.bigru_fwd.launches
    got = gru.bigru_fwd(gxf, gxb, lens, uhf, uhb, bhnf, bhnb)
    want = gru.bigru_reference(gxf, gxb, lens, uhf, uhb, bhnf, bhnb)
    (hTf, hseqf), (hTb, hseqb) = (gru.gru_fwd(gxf, lens, uhf, bhnf),
                                  gru.gru_fwd(gxb, lens, uhb, bhnb,
                                              reverse=True))
    torch.cuda.synchronize()
    assert gru.bigru_fwd.launches == before + 1  # all steps, both chains
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 2e-3
    for a, b in zip(got, (hTf, hTb, hseqf, hseqb)):
        assert torch.equal(a, b)

    g = torch.Generator(device=dev).manual_seed(8)
    ghTf = torch.randn(B, H, generator=g, device=dev)
    ghTb = torch.randn(B, H, generator=g, device=dev)
    hsf, hsb = got[2], got[3]
    before = gru.bigru_bwd.launches
    got = gru.bigru_bwd(gxf, gxb, hsf, hsb, lens, uhf, uhb, bhnf, bhnb,
                        ghTf, ghTb)
    want = gru.bigru_bwd_reference(gxf, gxb, hsf, hsb, lens, uhf, uhb, bhnf,
                                   bhnb, ghTf, ghTb)
    one_f = gru.gru_bwd(gxf, hsf, lens, uhf, bhnf, ghTf)
    one_b = gru.gru_bwd(gxb, hsb, lens, uhb, bhnb, ghTb, reverse=True)
    torch.cuda.synchronize()
    assert gru.bigru_bwd.launches == before + 3  # steps, dU_h, db_hn
    names = ("dgxf", "dgxb", "duhf", "duhb", "dbhnf", "dbhnb")
    ones = (one_f[0], one_b[0], one_f[1], one_b[1], one_f[2], one_b[2])
    for name, a, b, c in zip(names, got, want, ones):
        assert torch.isfinite(a).all(), name
        assert _rel_err(a, b) <= TOL_K3, (name, _rel_err(a, b))
        assert torch.equal(a, c), name


def test_bigru_wrappers_reject_what_the_kernels_do_not_take(dev):
    gxf, gxb, lens, uhf, uhb, bhnf, bhnb = _bigru_inputs(dev, 3, 4, 32)
    with pytest.raises(TypeError, match="uhb"):
        gru.bigru_fwd(gxf, gxb, lens, uhf, uhb.float(), bhnf, bhnb)
    with pytest.raises(ValueError, match="gxb"):
        gru.bigru_fwd(gxf, gxb[:2], lens, uhf, uhb, bhnf, bhnb)
    _, _, hsf, hsb = gru.bigru_reference(gxf, gxb, lens, uhf, uhb, bhnf,
                                         bhnb)
    ghT = torch.zeros(4, 32, device=dev)
    with pytest.raises(ValueError, match="H % 64"):
        gru.bigru_bwd(gxf, gxb, hsf, hsb, lens, uhf, uhb, bhnf, bhnb, ghT,
                      ghT)
    # Past H = 576 U_h's slices do not fit in a block's shared memory: it
    # raises, as K3 does, naming the limit.
    gxf, gxb, lens, uhf, uhb, bhnf, bhnb = _bigru_inputs(dev, 2, 4, 640)
    hs = torch.zeros(2, 4, 640, device=dev)
    ghT = torch.zeros(4, 640, device=dev)
    before = gru.bigru_bwd.launches
    with pytest.raises(RuntimeError, match="bigru_bwd.*H <= 576"):
        gru.bigru_bwd(gxf, gxb, hs, hs, lens, uhf, uhb, bhnf, bhnb, ghT,
                      ghT)
    assert gru.bigru_bwd.launches == before


def _two_k1(gxf, gxb, lens, uhf, uhb, bhnf, bhnb):
    """K1 on each chain, in K6's output order (hTf, hTb, hseqf, hseqb)."""
    (hTf, hsf), (hTb, hsb) = (gru.gru_fwd(gxf, lens, uhf, bhnf),
                              gru.gru_fwd(gxb, lens, uhb, bhnb, reverse=True))
    return hTf, hTb, hsf, hsb


@pytest.mark.parametrize("B", [1, 17, 64, 256, 1024])
@pytest.mark.parametrize("T", [1, 7, 26])
@pytest.mark.parametrize("rows", kernels.GRU_FWD_ROWS)
def test_bigru_fwd_tilings_equal_two_k1_calls(dev, B, T, rows):
    """K6 at both tilings (16 and 64 rows a block, whichever the plan
    takes) equals two K1 calls bit for bit, in one cooperative launch for
    both chains, and stays within 2e-3 of its plain version; lengths hold
    0 and T."""
    gxf, lens, uhf, bhnf = _gru_inputs(dev, T, B, 512, seed=11)
    gxb, _, uhb, bhnb = _gru_inputs(dev, T, B, 512, seed=12)
    lens[0] = T
    if B > 1:
        lens[1] = 0
    args = (gxf, gxb, lens, uhf, uhb, bhnf, bhnb)
    before = gru.bigru_fwd.launches
    got = gru._launch_bigru_fwd(*args, rows)
    after = gru.bigru_fwd.launches
    ones = _two_k1(*args)
    want = gru.bigru_reference(*args)
    torch.cuda.synchronize()
    assert after == before + 1
    for a, b, c in zip(got, ones, want):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b), (a - b).abs().max().item()
        assert (a - c).abs().max().item() <= 2e-3


def test_bigru_fwd_two_launches_past_both_directions_resident(dev):
    """At H = 1568 one direction's 98 j-tiles of 16-row blocks fit on the
    card but not both directions' 196: the plan takes one launch a chain
    of the same kernel (grid [98, rows, 1], 2 launches), both counted, and
    the chains still equal two K1 calls bit for bit."""
    cfg = gru.bigru_fwd_launch_config(256, 1568, dev)
    assert cfg["launches"] == 2 and cfg["grid"][2] == 1
    assert cfg["rows"] == 16 and cfg["grid"][0] == 98
    args = _bigru_inputs(dev, 26, 256, 1568, seed=13)
    before = gru.bigru_fwd.launches
    got = gru.bigru_fwd(*args)
    after = gru.bigru_fwd.launches
    ones = _two_k1(*args)
    want = gru.bigru_reference(*args)
    torch.cuda.synchronize()
    assert after == before + 2
    for a, b, c in zip(got, ones, want):
        assert torch.equal(a, b), (a - b).abs().max().item()
        assert (a - c).abs().max().item() <= 2e-3


@pytest.mark.parametrize("B", [64, 256, 1024])
def test_bigru_fwd_is_deterministic(dev, B):
    """Two K6 calls on the same inputs give the same bits: the grid barrier
    orders every exchange of both chains' states between blocks."""
    args = _bigru_inputs(dev, 26, B, 512, seed=15)
    first = gru.bigru_fwd(*args)
    second = gru.bigru_fwd(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_bigru_fwd_captures_in_a_cuda_graph(dev):
    """K6's cooperative launch is accepted under stream capture, and the
    graph's replay on new inputs equals an eager call on them."""
    args = _bigru_inputs(dev, 26, 256, 512, seed=17)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gru.bigru_fwd(*args)  # warm up off the capture stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = gru.bigru_fwd.launches
    with torch.cuda.graph(graph):
        got = gru.bigru_fwd(*args)
    assert gru.bigru_fwd.launches == before + 1
    for a, b in zip(args, _bigru_inputs(dev, 26, 256, 512, seed=19)):
        a.copy_(b)
    graph.replay()
    want = gru.bigru_fwd(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_bigru_fwd_launch_shape(dev):
    """The C side derives K6's grid from the plan's rows and from its own
    instance's occupancy, and it equals kernels.gru_fwd_plan's with two
    directions on the same blocks per SM: at the stage-1 shape 32 j-tiles
    x 2 rows x 2 directions of 64-row blocks, one an SM, each walking 2 of
    the 4 b-tiles a step; one launch wherever both directions' j-tiles are
    resident at once, two past that; a width at which not even a 16-row
    block fits raises."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for B, H in [(256, 512), (64, 512), (1, 512), (17, 512), (1024, 512),
                 (64, 64), (1, 880), (256, 1056), (256, 1072),
                 (256, 1568)]:
        cfg = gru.bigru_fwd_launch_config(B, H, dev)
        plan = kernels.gru_fwd_plan(B, H, sms, cfg["per_sm_by_rows"], 2)
        assert cfg["rows"] == plan["rows"]
        assert cfg["blocks_per_sm"] == cfg["per_sm_by_rows"][cfg["rows"]] >= 1
        assert cfg["grid"] == plan["grid"]
        assert cfg["launches"] == plan["launches"]
        assert cfg["grid"][2] * cfg["launches"] == 2
        assert 0 < cfg["smem_bytes"] <= 232448
        assert cfg["smem_bytes"] == gru._fwd_config(
            "gru_fwd", B, H, cfg["rows"], dev)["smem_bytes"]
    train = gru.bigru_fwd_launch_config(256, 512, dev)
    if train["rows"] == 64:
        assert train["grid"] == [32, 2, 2] and train["b_tiles"] == 4
    assert train["launches"] == 1
    assert gru.bigru_fwd_launch_config(256, 1056, dev)["launches"] == 1
    assert gru.bigru_fwd_launch_config(256, 1072, dev)["launches"] == 2
    gxf, gxb, lens, uhf, uhb, bhnf, bhnb = _bigru_inputs(dev, 2, 4, 1584)
    before = gru.bigru_fwd.launches
    with pytest.raises(ValueError, match="gru_fwd_plan"):
        gru.bigru_fwd(gxf, gxb, lens, uhf, uhb, bhnf, bhnb)
    assert gru.bigru_fwd.launches == before


def _k7_args(dev, T, B, H, seed):
    """K7's inputs, its hseqs from the plain forward."""
    gxf, gxb, lens, uhf, uhb, bhnf, bhnb = _bigru_inputs(dev, T, B, H, seed)
    _, _, hsf, hsb = gru.bigru_reference(gxf, gxb, lens, uhf, uhb, bhnf,
                                         bhnb)
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    ghTf = torch.randn(B, H, generator=g, device=dev)
    ghTb = torch.randn(B, H, generator=g, device=dev)
    return gxf, gxb, hsf, hsb, lens, uhf, uhb, bhnf, bhnb, ghTf, ghTb


@pytest.mark.parametrize("B", [256, 1024])
def test_bigru_bwd_is_deterministic(dev, B):
    """Two K7 calls on the same inputs give the same bits: the grid barrier
    orders every exchange between blocks of both chains, and no result
    takes atomics."""
    args = _k7_args(dev, 26, B, 512, seed=21)
    first = gru.bigru_bwd(*args)
    second = gru.bigru_bwd(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_bigru_bwd_captures_in_a_cuda_graph(dev):
    """K7's cooperative launch and the two launches after it are accepted
    under stream capture, and the graph's replay on new inputs equals an
    eager call on them."""
    args = _k7_args(dev, 26, 256, 512, seed=23)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gru.bigru_bwd(*args)  # warm up off the capture stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = gru.bigru_bwd.launches
    with torch.cuda.graph(graph):
        got = gru.bigru_bwd(*args)
    assert gru.bigru_bwd.launches == before + 3
    for a, b in zip(args, _k7_args(dev, 26, 256, 512, seed=25)):
        a.copy_(b)
    graph.replay()
    want = gru.bigru_bwd(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_bigru_bwd_launch_shape(dev):
    """At the stage-1 shape K7's step kernel runs 32 j-tiles x 2 rows x 2
    directions, one block an SM: both chains' 128 blocks resident at once,
    each walking 2 of the 4 b-tiles a step (B=1024: 8 each); a single
    b-tile takes one row."""
    cfg = gru.bigru_bwd_launch_config(256, 512, dev)
    assert cfg["grid"] == [32, 2, 2] and cfg["b_tiles"] == 4
    assert cfg["blocks_per_sm"] == 1 and cfg["max_width"] == 576
    assert cfg["smem_bytes"] == gru.gru_bwd_launch_config(
        256, 512, dev)["smem_bytes"] <= 232448
    assert gru.bigru_bwd_launch_config(17, 512, dev)["grid"] == [32, 1, 2]
    assert gru.bigru_bwd_launch_config(1024, 512, dev)["grid"] == [32, 2, 2]


def test_fused_bigru_encoder_goes_through_k6_k7(dev):
    """The BiGRU encoder on the card launches K6 forward and K7 backward
    and no K1/K3, and its output and gradients agree with the
    per-direction encoders (K1/K3) on the same weights."""
    g = torch.Generator().manual_seed(9)
    enc = gru.BiGRUEncoder(32, 64, generator=g).to(dev)
    x = torch.randn(6, 10, 32, generator=g).to(dev)
    mask = (torch.arange(6)[None, :] <
            torch.tensor([6, 1, 3, 0, 5, 2, 6, 4, 1, 3])[:, None]).float()
    mask = mask.to(dev)

    def two_encoders(x, mask):
        return torch.cat([enc.fwd(x, mask), enc.bwd(x, mask)], dim=-1)

    res = []
    for fn, want in ((enc, [1, 3, 0, 0]), (two_encoders, [0, 0, 2, 6])):
        enc.zero_grad()
        counts = [getattr(gru, n).launches for n in
                  ("bigru_fwd", "bigru_bwd", "gru_fwd", "gru_bwd")]
        out = fn(x, mask)
        out.float().square().sum().backward()
        torch.cuda.synchronize()
        delta = [getattr(gru, n).launches - c for n, c in zip(
            ("bigru_fwd", "bigru_bwd", "gru_fwd", "gru_bwd"), counts)]
        assert delta == want
        res.append((out.float(), {k: p.grad.clone()
                                  for k, p in enc.named_parameters()}))
    assert (res[0][0] - res[1][0]).abs().max().item() <= 2e-2
    for k, a in res[0][1].items():
        cos = torch.nn.functional.cosine_similarity(
            a.flatten(), res[1][1][k].flatten(), dim=0).item()
        assert cos >= 0.999, (k, cos)


def _k8_allowance(v, qh, wv, ws, ds, r, normalize):
    """Per-entry bound on what ReLU flips can move K8's outputs against its
    plain version: units whose plain z is within 2^-12 of the sum of the
    magnitudes of its terms (two orders of f32 sums over C products differ
    by less) may flip, each moving dqh_bk by |ds_n ws_k| and dW_v[:, k] by
    |v_n| |ds_n ws_k| r_n."""
    vf = v.float()
    z = vf @ wv.float()
    mag = vf.abs() @ wv.float().abs()
    if normalize:
        z, mag = z * r[:, :, None], mag * r[:, :, None]
    z = z + qh[:, None, :]
    unsure = (z.abs() <= 2.0 ** -12 * (mag + qh.abs()[:, None, :])).float()
    flip = unsure * (ds[:, :, None] * ws).abs()
    rr = r if normalize else torch.ones_like(r)
    return (flip.sum(1), torch.einsum("bnc,bnh->ch", vf.abs(),
                                      flip * rr[:, :, None]),
            int(unsure.sum().item()))


# K8 at the edges of its dz stage's 128-cell tiles: one cell, a tile
# spanning 3 questions, questions of 127 and 129 cells (one tile boundary
# inside a question, either side) at 128-unit tiles, questions longer than
# two tiles, the training shape, and 128 questions a tile (N=7 at B=1024:
# 20 slots, every tile ragged against its questions).
K8_SHAPES = [(1, 1, 128, 128), (3, 13, 128, 128), (2, 127, 256, 384),
             (2, 129, 256, 384), (3, 300, 128, 128), (256, 196, 2048, 512),
             (1024, 7, 2048, 512)]


@pytest.mark.parametrize("shape", K8_SHAPES)
@pytest.mark.parametrize("normalize", [True, False])
def test_attention_bwd_matches_plain(dev, shape, normalize):
    B, N, C, H = shape
    v, qh, wv, ws, ds, r = _k8_inputs(dev, B, N, C, H, normalize)
    before = attention.attention_bwd.launches
    got = attention.attention_bwd(v, qh, wv, ws, ds, r, normalize)
    want = attention.attention_bwd_reference(v, qh, wv, ws, ds, r, normalize)
    torch.cuda.synchronize()
    assert attention.attention_bwd.launches == (
        before + kernels.ATTENTION_BWD_LAUNCHES)
    a_dqh, a_dwv, _ = _k8_allowance(v, qh, wv, ws, ds, r, normalize)
    for name, a, b, allow in zip(("dqh", "dwv", "dws"), got, want,
                                 (a_dqh, a_dwv, 0.0)):
        assert torch.isfinite(a).all(), name
        limit = TOL_K5 * b.abs().max().item() + allow
        assert ((a - b).abs() <= limit).all(), (name, _rel_err(a, b))


@pytest.mark.parametrize("shape", [(3, 300, 128, 128), (1024, 7, 2048, 512),
                                   (2, 129, 256, 384)])
def test_attention_bwd_dz_stage_is_deterministic(dev, shape):
    """Two K8 calls give the same bits where a question spans several
    tiles and where a tile spans many questions: each question's partials
    are folded in tile order, with no atomics."""
    args = _k8_inputs(dev, *shape, True)
    first = attention.attention_bwd(*args, True)
    second = attention.attention_bwd(*args, True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_attention_bwd_dz_launch_shape(dev):
    """K8's dz launch as the C side sets it equals kernels.dz_plan (but the
    partials' shape, which only the wrapper allocates) at the training
    shape and at the card-test shapes, within a block's shared memory."""
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    for B, N, C, H in K8_SHAPES + [(1, 7, 128, 2304)]:
        plan = kernels.dz_plan(B, N, C, H)
        del plan["partials"]
        assert attention.dz_launch_config(B, N, H) == plan, (B, N, H)
        assert plan["smem_bytes"] <= limit


def test_gathered_op_grads_go_through_k2_k8(dev):
    """The autograd op on the card launches K2 forward and K8 backward, and
    its parameter gradients agree with the explicit backward's
    (bwd_kernel=False) to cosine 0.999, under a loss that drives v_att and
    alpha along random directions."""
    g = torch.Generator(device=dev).manual_seed(11)
    B, N, C, H = 16, 49, 256, 128
    v = torch.randn(B, N, C, generator=g, device=dev).relu().to(
        torch.bfloat16)
    params = [torch.randn(B, H, generator=g, device=dev) * 0.5,
              torch.randn(C, H, generator=g, device=dev) * 0.05,
              torch.randn(H, generator=g, device=dev) * 0.05]
    wa = torch.randn(B, C, generator=g, device=dev)
    wb = torch.randn(B, N, generator=g, device=dev)
    grads = []
    for bwd_kernel in (True, False):
        ins = [p.clone().requires_grad_() for p in params]
        counts = (attention.attention_fwd.launches,
                  attention.attention_bwd.launches)
        va, al = attention.spatial_attention(v, *ins, normalize=True,
                                             bwd_kernel=bwd_kernel,
                                             feature_grad=False)
        ((va * wa).sum() + (al * wb).sum()).backward()
        assert (attention.attention_fwd.launches - counts[0],
                attention.attention_bwd.launches - counts[1]) == (
                    2, kernels.ATTENTION_BWD_LAUNCHES if bwd_kernel else 0)
        grads.append([t.grad for t in ins])
    for a, b in zip(*grads):
        cos = torch.nn.functional.cosine_similarity(
            a.flatten(), b.flatten(), dim=0).item()
        assert cos >= 0.999, cos


# The dW_v GEMM shared by K5, K8 and P2 (csrc/attention_dwv.cuh) at the
# edges of its tiles: cells that are not a multiple of the 64-cell chunk
# (B=5 of n_valid=13: 65 cells; B=9 of 196: 1764 in 7 splits, the last one
# short; B=5 of 196: 980 in 4), C = 128, 256 and 2048 (one, two and sixteen
# channel tiles), H = 128, 384 (128-unit tiles) and 512 (256-unit tiles).
DWV_EDGE_SHAPES = [(5, 13, 128, 128, 5), (5, 13, 256, 384, 5),
                   (5, 13, 2048, 512, 5), (9, 196, 256, 384, 9),
                   (9, 196, 2048, 512, 5)]


def _k5_inputs(dev, shape, glimpses, row_type, seed=14):
    """K5's inputs at ``shape``: the store (bf16, or its int8 codes with W_v
    scaled as the op scales it), the saved h and alpha of the plain
    forward, and random cotangents."""
    M, n_valid, C, H, B = shape
    G = glimpses
    store, rows, qh, wv, _ = _resident_inputs(dev, M, n_valid, C, H, B)
    if row_type == "int8":
        store, scale = _int8_codes(store)
        wv = (wv.float() * scale).to(torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(seed)
    ws = (torch.randn(H, G, generator=g, device=dev) * 0.05).to(
        torch.bfloat16).float()
    if G == 1:
        ws = ws[:, 0].contiguous()
    _, al, h = ar.attention_resident_fwd_reference(
        store, rows, qh, wv, ws, n_valid=n_valid, normalize=False,
        save_h=True)
    gv = torch.randn(B, G * C, generator=g, device=dev)
    sga = torch.randn(al.shape, generator=g, device=dev)
    return store, rows, h, ws, al, gv, sga


@pytest.mark.parametrize("row_type,normalize", [("bf16", True),
                                                ("bf16", False),
                                                ("int8", False)])
@pytest.mark.parametrize("glimpses", [1, 2, 8])
@pytest.mark.parametrize("shape", DWV_EDGE_SHAPES)
def test_attention_resident_bwd_dwv_tile_edges_match_plain(
        dev, shape, glimpses, row_type, normalize):
    """K5 at the dW_v GEMM's tile edges against its plain version, at the
    limits of the other K5 cases (G * 2^-9 for dqh and dW_v, 2^-9 for each
    glimpse's dws)."""
    G, H = glimpses, shape[3]
    store, rows, h, ws, al, gv, sga = _k5_inputs(dev, shape, G, row_type)
    kw = dict(n_valid=shape[1], normalize=normalize)
    count = "launches_int8" if row_type == "int8" else "launches"
    before = getattr(ar.attention_resident_bwd, count)
    got = ar.attention_resident_bwd(store, rows, h, ws, al, gv, sga, **kw)
    want = ar.attention_resident_bwd_reference(store, rows, h, ws, al, gv,
                                               sga, **kw)
    torch.cuda.synchronize()
    assert getattr(ar.attention_resident_bwd, count) == before + 3
    for name, a, b in zip(("dqh", "dwv"), got, want):
        assert torch.isfinite(a).all(), name
        assert _rel_err(a, b) <= G * TOL_K5, (name, _rel_err(a, b))
    dws, dws_ref = got[2].reshape(H, G), want[2].reshape(H, G)
    for k in range(G):
        assert _rel_err(dws[:, k], dws_ref[:, k]) <= TOL_K5, k


def _k8_inputs(dev, B, N, C, H, normalize, seed=10):
    g = torch.Generator(device=dev).manual_seed(seed)
    scale = torch.exp2(torch.rand(B, N, 1, generator=g, device=dev) * 4 - 2)
    v = (torch.randn(B, N, C, generator=g, device=dev).relu() * scale).to(
        torch.bfloat16)
    qh = torch.randn(B, H, generator=g, device=dev) * 0.5
    wv = ((torch.rand(C, H, generator=g, device=dev) * 2 - 1)
          * (6.0 / (C + H)) ** 0.5).to(torch.bfloat16)
    ws = (torch.randn(H, generator=g, device=dev) * 0.05).to(
        torch.bfloat16).float()
    _, al, r = attention.attention_fwd(v, qh, wv, ws, normalize=normalize)
    ds = (torch.randn(B, N, generator=g, device=dev) * al).contiguous()
    return v, qh, wv, ws, ds, r


@pytest.mark.parametrize("shape", [s[1:] for s in DWV_EDGE_SHAPES])
@pytest.mark.parametrize("normalize", [True, False])
def test_attention_bwd_dwv_tile_edges_match_plain(dev, shape, normalize):
    """K8 at the dW_v GEMM's tile edges (B questions of N cells, C, H as
    K5's), at test_attention_bwd_matches_plain's limits."""
    N, C, H, B = shape
    v, qh, wv, ws, ds, r = _k8_inputs(dev, B, N, C, H, normalize)
    before = attention.attention_bwd.launches
    got = attention.attention_bwd(v, qh, wv, ws, ds, r, normalize)
    want = attention.attention_bwd_reference(v, qh, wv, ws, ds, r, normalize)
    torch.cuda.synchronize()
    assert attention.attention_bwd.launches == (
        before + kernels.ATTENTION_BWD_LAUNCHES)
    a_dqh, a_dwv, _ = _k8_allowance(v, qh, wv, ws, ds, r, normalize)
    for name, a, b, allow in zip(("dqh", "dwv", "dws"), got, want,
                                 (a_dqh, a_dwv, 0.0)):
        assert torch.isfinite(a).all(), name
        limit = TOL_K5 * b.abs().max().item() + allow
        assert ((a - b).abs() <= limit).all(), (name, _rel_err(a, b))


@pytest.mark.parametrize("kernel", ["k5", "k5_int8", "k8", "p2"])
def test_dwv_kernels_are_deterministic(dev, kernel):
    """Two calls of K5 (bf16 rows at G=2, int8 codes at G=1), K8 and P2 on
    the same inputs at the main shape give the same bits: every split's
    partial is summed in a fixed order, with no atomics."""
    if kernel.startswith("k5"):
        row_type = "int8" if kernel == "k5_int8" else "bf16"
        args = _k5_inputs(dev, (64, 196, 2048, 512, 256),
                          1 if row_type == "int8" else 2, row_type)

        def call():
            return ar.attention_resident_bwd(*args, n_valid=196,
                                             normalize=row_type == "bf16")
    elif kernel == "k8":
        args = _k8_inputs(dev, 256, 196, 2048, 512, True)

        def call():
            return attention.attention_bwd(*args, True)
    else:
        x = p2.make_inputs(dev)

        def call():
            return p2.probe_bwd_ceiling(x["store"], x["rows"], x["h"],
                                        x["g"])
    first = call()
    second = call()
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_dwv_launch_shape(dev):
    """The dW_v launch at the main shapes (K5 and K8 over 256 x 196 cells,
    P2 over 256 x 200): 128 x 256 tiles, 4 stages, 4 splits of whole
    64-cell chunks, one wave on the card, and dynamic shared memory above
    the default 48 KB that a block of the card may still take; the C side
    agrees with kernels.dwv_plan there and at a 128-unit tile."""
    from vqa_transfer_externaldata_torch.ops import kernels

    props = torch.cuda.get_device_properties(dev)
    limit = props.shared_memory_per_block_optin
    sms = props.multi_processor_count
    for K, C, H, int8 in [(256 * 196, 2048, 512, False),
                          (256 * 196, 2048, 512, True),
                          (256 * 200, 2048, 512, False),
                          (65, 256, 384, False), (1764, 256, 384, True)]:
        plan = kernels.dwv_plan(K, C, H, sms, int8)
        assert ar.dwv_launch_config(K, C, H, int8, plan["splits"]) == plan
        assert 48 * 1024 < plan["smem_bytes"] <= limit, plan
        gx, gy, gz = plan["grid"]
        per = plan["chunks_per_split"] * kernels.DWV_CHUNK
        assert (gz - 1) * per < K <= gz * per
        if K > 256 * 100:
            assert plan["tile"] == [128, 256] and plan["stages"] == 4
            assert plan["splits"] == 4 and gx * gy * gz <= sms


# K5's rows stage (csrc/attention_rows.cuh), one block a question, at
# C=2048, H=512.
@pytest.mark.parametrize("row_type,normalize", [("bf16", True),
                                                ("bf16", False),
                                                ("int8", False)])
@pytest.mark.parametrize("glimpses", [1, 2, 8])
@pytest.mark.parametrize("n_valid", [1, 7, 196])
@pytest.mark.parametrize("B", [1, 17, 256, 1024])
def test_attention_resident_bwd_rows_matches_plain(
        dev, B, n_valid, glimpses, row_type, normalize):
    """K5 at ragged batches and cell counts against its plain version, at
    the limits of the other K5 cases (G * 2^-9 for dqh and dW_v, 2^-9 for
    each glimpse's dws)."""
    G = glimpses
    shape = (min(64, B + 3), n_valid, 2048, 512, B)
    store, rows, h, ws, al, gv, sga = _k5_inputs(dev, shape, G, row_type)
    kw = dict(n_valid=n_valid, normalize=normalize)
    count = "launches_int8" if row_type == "int8" else "launches"
    before = getattr(ar.attention_resident_bwd, count)
    got = ar.attention_resident_bwd(store, rows, h, ws, al, gv, sga, **kw)
    want = ar.attention_resident_bwd_reference(store, rows, h, ws, al, gv,
                                               sga, **kw)
    torch.cuda.synchronize()
    assert getattr(ar.attention_resident_bwd, count) == before + 3
    for name, a, b in zip(("dqh", "dwv"), got, want):
        assert torch.isfinite(a).all(), name
        assert _rel_err(a, b) <= G * TOL_K5, (name, _rel_err(a, b))
    dws, dws_ref = got[2].reshape(512, G), want[2].reshape(512, G)
    for k in range(G):
        assert _rel_err(dws[:, k], dws_ref[:, k]) <= TOL_K5, k


@pytest.mark.parametrize("B,glimpses,row_type", [(1, 8, "bf16"),
                                                 (17, 8, "bf16"),
                                                 (256, 1, "bf16"),
                                                 (256, 1, "int8"),
                                                 (1024, 2, "bf16")])
def test_attention_resident_bwd_rows_is_deterministic(
        dev, B, glimpses, row_type):
    """Two K5 calls give the same bits: the sums over a question's cells
    meet in a fixed order."""
    args = _k5_inputs(dev, (min(64, B + 3), 196, 2048, 512, B), glimpses,
                      row_type)
    kw = dict(n_valid=196, normalize=row_type == "bf16")
    first = ar.attention_resident_bwd(*args, **kw)
    second = ar.attention_resident_bwd(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_attention_resident_bwd_captures_in_a_cuda_graph(dev):
    """K5's three launches are accepted under stream capture, and the
    graph's replay on new cotangents equals an eager call on them."""
    store, rows, h, ws, al, gv, sga = _k5_inputs(
        dev, (64, 196, 2048, 512, 17), 2, "bf16")
    kw = dict(n_valid=196, normalize=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ar.attention_resident_bwd(store, rows, h, ws, al, gv, sga, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = ar.attention_resident_bwd.launches
    with torch.cuda.graph(graph):
        got = ar.attention_resident_bwd(store, rows, h, ws, al, gv, sga, **kw)
    assert ar.attention_resident_bwd.launches == before + 3
    *_, gv2, sga2 = _k5_inputs(dev, (64, 196, 2048, 512, 17), 2, "bf16",
                               seed=15)
    gv.copy_(gv2)
    sga.copy_(sga2)
    graph.replay()
    want = ar.attention_resident_bwd(store, rows, h, ws, al, gv, sga, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_attention_resident_bwd_rows_launch_shape(dev):
    """The C side's rows launch equals kernels.rows_plan's at the main
    shapes and at narrow, ragged and wide ones, within the card's shared
    memory, and K5 refuses an h that is not 16-byte aligned."""
    from vqa_transfer_externaldata_torch.ops import kernels

    props = torch.cuda.get_device_properties(dev)
    limit = props.shared_memory_per_block_optin
    for B, n_valid, G, C, H in [(256, 196, 1, 2048, 512),
                                (256, 196, 2, 2048, 512),
                                (17, 196, 8, 2048, 512),
                                (1024, 196, 1, 2048, 512),
                                (5, 13, 2, 256, 384), (3, 9, 1, 128, 2304),
                                (1, 1, 8, 128, 128)]:
        plan = kernels.rows_plan(B, n_valid, G, C, H)
        assert ar.rows_launch_config(B, n_valid, G, C, H) == plan
        assert plan["smem_bytes"] <= limit
    store, rows, h, ws, al, gv, sga = _k5_inputs(
        dev, (64, 196, 2048, 512, 17), 1, "bf16")
    shifted = torch.empty(h.numel() + 8, dtype=h.dtype, device=dev)
    h_off = shifted[1:1 + h.numel()].view(h.shape)
    h_off.copy_(h)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ar.attention_resident_bwd(store, rows, h_off, ws, al, gv, sga,
                                  n_valid=196, normalize=True)


@pytest.fixture(scope="module")
def end2end_model():
    """The raw-image model at full width (ResNet-101 at 448 pixels, the
    head at config.py's widths, bf16) from seeded random weights, on the
    card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from vqa_transfer_externaldata_torch.models.end2end import (
        VQAEnd2EndModel)

    model = VQAEnd2EndModel(8192, 2000,
                            generator=torch.Generator().manual_seed(3))
    return model.to("cuda").eval()


def _resnet_grid(model, B, seed=21):
    g = torch.Generator(device="cuda").manual_seed(seed)
    images = torch.randint(0, 256, (B, 448, 448, 3), generator=g,
                           device="cuda", dtype=torch.uint8)
    with torch.no_grad():
        return model.features(images)


@pytest.mark.parametrize("B", [8, 32])
def test_attention_on_a_resnet_grid_matches_plain(dev, end2end_model, B):
    """The end2end head's K2 and K8 at its serving (8) and training (32)
    batches on the bf16 grid the backbone produces, a contiguous view of
    its channels_last activations, against their plain versions (the
    limits of the tests above)."""
    v = _resnet_grid(end2end_model, B)
    assert v.shape == (B, 196, 2048) and v.dtype == torch.bfloat16
    assert v.is_contiguous()
    head = end2end_model.head
    g = torch.Generator(device=dev).manual_seed(B)
    qh = torch.randn(B, 512, generator=g, device=dev) * 0.5
    wv = head.att_wv.detach().to(torch.bfloat16).contiguous()
    ws = head.att_ws.detach().to(torch.bfloat16).float()
    va, al, r = attention.attention_fwd(v, qh, wv, ws, normalize=True)
    rv, ra, rr = attention.attention_fwd_reference(v, qh, wv, ws, True)
    torch.cuda.synchronize()
    assert torch.isfinite(va).all()
    assert (r - rr).abs().max().item() <= 1e-6 * rr.abs().max().item()
    assert (va - rv).abs().max().item() <= 2.0 ** -10 * rv.abs().max().item()
    assert (al - ra).abs().max().item() <= 1e-5
    ds = (torch.randn(B, 196, generator=g, device=dev) * al).contiguous()
    got = attention.attention_bwd(v, qh, wv, ws, ds, r, True)
    want = attention.attention_bwd_reference(v, qh, wv, ws, ds, r, True)
    torch.cuda.synchronize()
    a_dqh, a_dwv, _ = _k8_allowance(v, qh, wv, ws, ds, r, True)
    for name, a, b, allow in zip(("dqh", "dwv", "dws"), got, want,
                                 (a_dqh, a_dwv, 0.0)):
        assert torch.isfinite(a).all(), name
        limit = TOL_K5 * b.abs().max().item() + allow
        assert ((a - b).abs() <= limit).all(), (name, _rel_err(a, b))


def test_attention_refuses_a_non_contiguous_grid(dev, end2end_model):
    """The grid the head reads is a view of the backbone's channels_last
    activations (no copy). A grid view that is not contiguous (NCHW
    activations seen as [B, h*w, C], a slice of wider channels) is refused
    by K2 and K8, and the op passes it on as it is: it is never read with
    the wrong strides."""
    from vqa_transfer_externaldata_torch.ops.resnet import (
        preprocess_images)

    images = torch.zeros(2, 448, 448, 3, dtype=torch.uint8, device=dev)
    with torch.no_grad():
        grid = end2end_model.resnet(preprocess_images(images, 448))["grid"]
        flat = end2end_model.features(images)
    assert grid.is_contiguous()
    assert grid.reshape(2, 196, 2048).data_ptr() == grid.data_ptr()
    torch.testing.assert_close(flat, grid.reshape(2, 196, 2048),
                               rtol=0, atol=0)
    v, qh, wv, ws = _k2_inputs(dev, 2, 196, 2048, 512)
    nchw = v.transpose(1, 2).contiguous().view(2, 2048, 14, 14)
    wide = torch.zeros(2, 196, 4096, dtype=torch.bfloat16, device=dev)
    wide[..., :2048] = v
    ds = torch.zeros(2, 196, device=dev)
    r = torch.ones(2, 196, device=dev)
    for bad in (nchw.flatten(2).transpose(1, 2), wide[..., :2048]):
        assert not bad.is_contiguous() and torch.equal(bad, v)
        with pytest.raises(ValueError, match="contiguous"):
            attention.attention_fwd(bad, qh, wv, ws, normalize=True)
        with pytest.raises(ValueError, match="contiguous"):
            attention.spatial_attention(bad, qh, wv, ws, normalize=True)
        with pytest.raises(ValueError, match="contiguous"):
            attention.attention_bwd(bad, qh, wv, ws, ds, r, True)
