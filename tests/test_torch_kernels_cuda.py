"""Kernels K1 (gru_fwd; also at both tilings of its launch plan and past
the 64-row tile, its launch shape against kernels.gru_fwd_plan, under CUDA
graph capture, and two calls bit-equal), K2 (attention_fwd; also at the
edges of its score tiles, its launch shape against kernels.score_plan, two
calls bit-equal, and its alpha and r bit-equal to K4's on the identity
store), K3 (gru_bwd), K4
(attention_resident_fwd; K2, K3, K4 on bf16 and int8 rows, and K8 also
under CUDA graph capture) and K5 (attention_resident_bwd) at 1, 2 and 8
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

The float32 kernels K1f, K3f, K4f and K5f (FFMA, f32 sums, no rounding to
a narrower type anywhere) differ from their plain versions only by the
order of f32 sums: each output is held to ``TOL_F32`` (1e-5) of its largest
value, and K5f's dqh and dW_v, whose dz sums G glimpse terms, to G times
that; see chip_smoke.py for the reasoning. K2f and K8f (the gathered
attention on a float32 grid) are held the same way, K2f's r to 1e-6 and
K8f's dqh and dW_v also to K8's per-entry allowance for ReLU flips, and
K6f (K7f), which run K1f's (K3f's) step with both chains in each launch,
equal two K1f (K3f) calls bit for bit. The float32 attention products
(csrc/fp32_ring.cuh) are also held at every copy width their plan takes
(rows whose pitch is 16-, 8-, 4-byte aligned or less, a grid 4 bytes off
an allocation), two calls bit-equal, and a plan the rows' alignment does
not allow refused before any launch. The float16 kernels K1h-K8h are
the bf16 bodies on float16, held to the bf16 limits scaled by float16's
step (the sections below), K6h (K7h) bit-equal to two K1h (K3h) calls.
Every kernel takes bf16, float16 and float32 and refuses float64. Every
16-bit wrapper takes every width its Pallas body takes (zero-padded to
its kernel's multiples), and the GRU's step form runs past the
persistent kernels' shared memory: the widths section at the end holds
them to the limits above, K6/K7 bit-equal to two K1/K3 calls in either
form.
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
    launches of one kernel body, K6's with both chains). The persistent
    form is asked for: the route takes the step form past
    kernels.GRU_FWD_STEP_ABOVE."""
    gx, lens, uh, bhn = _gru_inputs(dev, 26, B, 880, seed=6)
    lens[0] = 26
    cfg = gru.gru_fwd_launch_config(B, 880, dev)
    assert cfg["rows"] == 16 and cfg["per_sm_by_rows"][64] == 0
    hT, hseq = gru._gru_fwd16(gx, lens, uh, bhn, reverse, torch.bfloat16,
                              "persistent")
    rT, rseq = gru.gru_reference(gx, lens, uh, bhn, reverse=reverse)
    k6 = gru._bigru_fwd16(gx, gx, lens, uh, uh, bhn, bhn, torch.bfloat16,
                          "persistent")
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
    more than 32 blocks. At a width at which not even a 16-row block's
    shared memory fits the persistent launch's shape raises, and gru_fwd
    runs the step form (kernels.gru_fwd_route) against its plain
    version."""
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
    with pytest.raises(ValueError, match="gru_fwd_plan"):
        gru.gru_fwd_launch_config(4, 1584, dev)
    gx, lens, uh, bhn = _gru_inputs(dev, 2, 4, 1584)
    before = gru.gru_fwd_wide.launches
    hT, _ = gru.gru_fwd(gx, lens, uh, bhn)
    assert gru.gru_fwd_wide.launches == before + 2  # one a step
    rT, _ = gru.gru_reference(gx, lens, uh, bhn)
    assert (hT - rT).abs().max().item() <= 2e-3


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
    """Dtypes, stores and cell counts the kernels do not take raise; the
    widths the Pallas bodies take run (H = 24 for K1, 32 for K3, 96 for
    K2, C = 64 for K5: zero-padded by the wrappers) and match their plain
    versions."""
    gx, lens, uh, bhn = _gru_inputs(dev, 3, 4, 24)
    hT, hseq = gru.gru_fwd(gx, lens, uh, bhn)
    rT, rseq = gru.gru_reference(gx, lens, uh, bhn)
    assert (hseq - rseq).abs().max().item() <= 2e-3
    gx, lens, uh, bhn = _gru_inputs(dev, 3, 4, 32)
    with pytest.raises(TypeError, match="uh"):
        gru.gru_fwd(gx, lens, uh.double(), bhn)
    v = torch.zeros(2, 9, 64, device=dev)
    qh, ws = torch.zeros(2, 128, device=dev), torch.zeros(128, device=dev)
    wv = torch.zeros(64, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="v must be"):
        attention.attention_fwd(v, qh, wv, ws, normalize=True)
    vb = torch.rand(2, 9, 64, device=dev).to(torch.bfloat16)
    narrow = (qh[:, :96].contiguous(), wv[:, :96].contiguous(), ws[:96])
    got = attention.attention_fwd(vb, *narrow, normalize=True)
    want = attention.attention_fwd_reference(vb, *narrow, True)
    assert (got[1] - want[1]).abs().max().item() <= 1e-5
    _, hseq = gru.gru_reference(gx, lens, uh, bhn)
    ghT = torch.ones(4, 32, device=dev)
    got = gru.gru_bwd(gx, hseq, lens, uh, bhn, ghT)
    want = gru.gru_bwd_reference(gx, hseq, lens, uh, bhn, ghT)
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= TOL_K3
    store, rows, qh, wv, ws = _resident_inputs(dev, 3, 9, 64, 128, 2)
    with pytest.raises(TypeError, match="store must be"):
        ar.attention_resident_fwd(store.half(), rows, qh, wv, ws, n_valid=9,
                                  normalize=False)
    with pytest.raises(ValueError, match="n_valid"):
        ar.attention_resident_fwd(store, rows, qh, wv, ws, n_valid=17,
                                  normalize=False)
    _, al, h = ar.attention_resident_fwd_reference(
        store, rows, qh, wv, ws, n_valid=9, normalize=False, save_h=True)
    g, sga = torch.ones(2, 64, device=dev), torch.zeros_like(al)
    got = ar.attention_resident_bwd(store, rows, h, ws, al, g, sga,
                                    n_valid=9, normalize=False)
    want = ar.attention_resident_bwd_reference(store, rows, h, ws, al, g,
                                               sga, n_valid=9,
                                               normalize=False)
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= TOL_K5


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
    rows of blocks, one a SM; at a width whose U_h slices do not fit in
    shared memory the persistent launch's shape raises, naming the limit,
    and gru_bwd runs the step form (kernels.gru_bwd_route: T + 4
    launches) against its plain version."""
    cfg = gru.gru_bwd_launch_config(256, 512, dev)
    assert cfg["grid"] == [32, 4, 1]
    assert cfg["blocks_per_sm"] >= 1
    assert cfg["smem_bytes"] <= 232448
    assert cfg["max_width"] == 576
    assert gru.gru_bwd_launch_config(1024, 512, dev)["grid"][0] == 32
    with pytest.raises(RuntimeError, match="gru_bwd.*H <= 576"):
        gru.gru_bwd_launch_config(4, 640, dev)
    gx, hseq, lens, uh, bhn, ghT = _k3_k7_inputs(dev, 2, 4, 640, False)
    before = gru.gru_bwd_wide.launches
    got = gru.gru_bwd(gx, hseq, lens, uh, bhn, ghT)
    assert gru.gru_bwd_wide.launches == before + kernels.gru_step_plan(
        2, 4, 640, True)["launches"]
    want = gru.gru_bwd_reference(gx, hseq, lens, uh, bhn, ghT)
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= TOL_K3


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_attention_resident_softmax_past_48kb(dev, dtype):
    """K4 (K4h, K4f) at G = 8 glimpses over a 28 x 28 grid (Np = 784): the
    wsum launch's softmaxes take 2 G Np 4 = 50,176 B of shared memory
    (K4f's G Np 4), past the 48 KB a launch has without opting in, which
    the launches now do up to the card's limit (kernels.SMEM_OPTIN); the
    wrappers raise only past it. Against the plain version at the
    glimpse tests' limits (float32's 1e-5)."""
    M, n_valid, C, H, B, G = 5, 784, 128, 128, 6, 8
    store, rows, qh, wv, _ = _resident_inputs(dev, M, n_valid, C, H, B)
    store, wv = store.to(dtype), wv.to(dtype)
    g = torch.Generator(device=dev).manual_seed(8)
    ws = (torch.randn(H, G, generator=g, device=dev) * 0.05).to(dtype).float()
    counter = {torch.bfloat16: ar.attention_resident_fwd,
               torch.float16: ar.attention_resident_fwd_f16,
               torch.float32: ar.attention_resident_fwd_f32}[dtype]
    kw = dict(n_valid=n_valid, normalize=False)
    before = counter.launches
    va, al, _ = ar.attention_resident_fwd(store, rows, qh, wv, ws, **kw)
    rv, ra, _ = ar.attention_resident_fwd_reference(store, rows, qh, wv, ws,
                                                    **kw)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    assert va.shape == (B, G * C) and al.shape == (B, n_valid, G)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -10
    for k in range(G):
        a, b = va[:, k * C:(k + 1) * C], rv[:, k * C:(k + 1) * C]
        assert (a - b).abs().max().item() <= tol * b.abs().max().item(), k
    assert (al - ra).abs().max().item() <= 1e-5
    cell = (1 if dtype == torch.float32 else 2) * G * 4  # bytes a cell
    big = (kernels.SMEM_OPTIN // cell + 8) // 8 * 8  # past the limit
    with pytest.raises(ValueError, match="shared memory"):
        ar.attention_resident_fwd(store[:, :1].expand(M, big, C).contiguous(),
                                  rows, qh, wv, ws, n_valid=big,
                                  normalize=False)


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
    ghT = torch.ones(4, 32, device=dev)
    # H = 32 (padded to 64) and, past H = 576, where U_h's slices do not
    # fit in a block's shared memory, the step form: both run and equal
    # two one-direction calls.
    got = gru.bigru_bwd(gxf, gxb, hsf, hsb, lens, uhf, uhb, bhnf, bhnb, ghT,
                        ghT)
    one = gru.gru_bwd(gxf, hsf, lens, uhf, bhnf, ghT)
    assert all(torch.equal(a, b) for a, b in zip(got[::2], one))
    gxf, gxb, lens, uhf, uhb, bhnf, bhnb = _bigru_inputs(dev, 2, 4, 640)
    _, _, hsf, hsb = gru.bigru_reference(gxf, gxb, lens, uhf, uhb, bhnf,
                                         bhnb)
    ghT = torch.ones(4, 640, device=dev)
    before = (gru.bigru_bwd.launches, gru.bigru_bwd_wide.launches)
    got = gru.bigru_bwd(gxf, gxb, hsf, hsb, lens, uhf, uhb, bhnf, bhnb, ghT,
                        ghT)
    assert (gru.bigru_bwd.launches, gru.bigru_bwd_wide.launches) == (
        before[0], before[1] + kernels.gru_step_plan(2, 4, 640, True,
                                                     2)["launches"])
    want = gru.bigru_bwd_reference(gxf, gxb, hsf, hsb, lens, uhf, uhb, bhnf,
                                   bhnb, ghT, ghT)
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= TOL_K3


def _two_k1(gxf, gxb, lens, uhf, uhb, bhnf, bhnb):
    """K1 on each chain, in K6's output order (hTf, hTb, hseqf, hseqb)."""
    (hTf, hsf), (hTb, hsb) = (
        gru._gru_fwd16(gxf, lens, uhf, bhnf, False, torch.bfloat16,
                       "persistent"),
        gru._gru_fwd16(gxb, lens, uhb, bhnb, True, torch.bfloat16,
                       "persistent"))
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
    the chains still equal two K1 calls bit for bit. The persistent form
    is asked for: the route takes the step form past
    kernels.GRU_FWD_STEP_ABOVE."""
    cfg = gru.bigru_fwd_launch_config(256, 1568, dev)
    assert cfg["launches"] == 2 and cfg["grid"][2] == 1
    assert cfg["rows"] == 16 and cfg["grid"][0] == 98
    args = _bigru_inputs(dev, 26, 256, 1568, seed=13)
    before = gru.bigru_fwd.launches
    got = gru._bigru_fwd16(*args, torch.bfloat16, "persistent")
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
    resident at once, two past that; at a width at which not even a 16-row
    block fits the persistent launch's shape raises and bigru_fwd runs the
    step form."""
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
    with pytest.raises(ValueError, match="gru_fwd_plan"):
        gru.bigru_fwd_launch_config(4, 1584, dev)
    # There bigru_fwd takes the step form: no persistent launch, one step
    # form launch a step, against its plain version.
    gxf, gxb, lens, uhf, uhb, bhnf, bhnb = _bigru_inputs(dev, 2, 4, 1584)
    before = (gru.bigru_fwd.launches, gru.bigru_fwd_wide.launches)
    got = gru.bigru_fwd(gxf, gxb, lens, uhf, uhb, bhnf, bhnb)
    assert (gru.bigru_fwd.launches,
            gru.bigru_fwd_wide.launches) == (before[0], before[1] + 2)
    want = gru.bigru_reference(gxf, gxb, lens, uhf, uhb, bhnf, bhnb)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 2e-3


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


def _replays_like_eager(fn, args, fresh, counter, launches):
    """``fn(*args)`` under stream capture (warmed up on a side stream
    first): the wrapper counts its ``launches`` once, at capture, and the
    graph's replay after ``fresh`` is copied into ``args`` equals an eager
    call on them, bit for bit."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = getattr(*counter)
    with torch.cuda.graph(graph):
        got = fn(*args)
    assert getattr(*counter) == before + launches
    for a, b in zip(args, fresh):
        a.copy_(b)
    graph.replay()
    want = fn(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)


def test_attention_fwd_captures_in_a_cuda_graph(dev):
    """K2's score and wsum launches are accepted under stream capture at
    the gathered training shape, and replay like an eager call."""
    shape = (256, 196, 2048, 512)
    _replays_like_eager(
        lambda *a: attention.attention_fwd(*a, normalize=True),
        _k2_inputs(dev, *shape), _k2_inputs(dev, *shape, seed=2),
        (attention.attention_fwd, "launches"), 2)


def test_gru_bwd_captures_in_a_cuda_graph(dev):
    """K3's cooperative launch and the two launches after it are accepted
    under stream capture, and replay like an eager call."""
    _replays_like_eager(
        gru.gru_bwd, _k3_k7_inputs(dev, 26, 256, 512, False, seed=21),
        _k3_k7_inputs(dev, 26, 256, 512, False, seed=27),
        (gru.gru_bwd, "launches"), 3)


@pytest.mark.parametrize("int8", [False, True])
def test_attention_resident_fwd_captures_in_a_cuda_graph(dev, int8):
    """K4's score and wsum launches on bf16 rows and on int8 codes are
    accepted under stream capture at the training shape (its saved h
    too), and replay like an eager call on new store rows, rows, qh and
    W_v."""
    def inputs(seed):
        store, rows, qh, wv, _ = _resident_inputs(dev, 64, 196, 2048, 512,
                                                  256, seed=seed)
        if int8:
            store, scale = _int8_codes(store)
            wv = (wv.float() * scale).to(torch.bfloat16)
        ws = (torch.randn(512, 1, generator=torch.Generator(device=dev)
                          .manual_seed(seed), device=dev) * 0.05).to(
            torch.bfloat16).float()
        return store, rows, qh, wv, ws

    _replays_like_eager(
        lambda *a: ar.attention_resident_fwd(
            *a, n_valid=196, normalize=not int8, save_h=True),
        inputs(5), inputs(6),
        (ar.attention_resident_fwd, "launches_int8" if int8 else "launches"),
        2)


def test_attention_bwd_captures_in_a_cuda_graph(dev):
    """K8's four launches are accepted under stream capture at the
    gathered training shape, and replay like an eager call."""
    shape = (256, 196, 2048, 512)
    _replays_like_eager(
        lambda *a: attention.attention_bwd(*a, True),
        _k8_inputs(dev, *shape, True), _k8_inputs(dev, *shape, True, seed=12),
        (attention.attention_bwd, "launches"),
        kernels.ATTENTION_BWD_LAUNCHES)


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


# ---------------------------------------------------------------------------
# The float32 kernels K1f, K3f, K4f, K5f
# ---------------------------------------------------------------------------

TOL_F32 = 1e-5


def _rel(got, want):
    return ((got - want).abs().max().item()
            / max(want.abs().max().item(), 1e-30))


def _f32_gru_inputs(dev, T, B, H, seed=0):
    gx, lens, _, bhn = _gru_inputs(dev, T, B, H, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    uh = torch.randn(H, 3 * H, generator=g, device=dev) * H ** -0.5
    lens[0] = T
    if B > 1:
        lens[1] = 0
    return gx, lens, uh, bhn


@pytest.mark.parametrize("B", [1, 65, 256])
@pytest.mark.parametrize("T", [1, 26])
@pytest.mark.parametrize("H", [16, 100, 512])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_f32_kernels_match_plain(dev, B, T, H, reverse):
    """K1f (one persistent launch) and K3f (every step's gh, the chain, the
    dU_h product and the db_hn sum: 4 launches) against their plain
    versions on float32 U_h, through the dispatch of gru_fwd and gru_bwd;
    lengths hold 0 and T, H need not be a multiple of a tile."""
    gx, lens, uh, bhn = _f32_gru_inputs(dev, T, B, H)
    f0, b0 = gru.gru_fwd_f32.launches, gru.gru_bwd_f32.launches
    k1 = gru.gru_fwd.launches
    hT, hseq = gru.gru_fwd(gx, lens, uh, bhn, reverse=reverse)
    rT, rseq = gru.gru_reference(gx, lens, uh, bhn, reverse=reverse)
    ghT = torch.randn(B, H, device=dev)
    got = gru.gru_bwd(gx, rseq, lens, uh, bhn, ghT, reverse=reverse)
    want = gru.gru_bwd_reference(gx, rseq, lens, uh, bhn, ghT,
                                 reverse=reverse)
    torch.cuda.synchronize()
    assert gru.gru_fwd_f32.launches == f0 + 1
    assert gru.gru_bwd_f32.launches == b0 + kernels.GRU_F32_BWD_LAUNCHES
    assert gru.gru_fwd.launches == k1
    assert torch.equal(hT, hseq[0 if reverse else -1])
    assert _rel(hseq, rseq) <= TOL_F32 and _rel(hT, rT) <= TOL_F32
    for name, a, b in zip(("dgx", "duh", "dbhn"), got, want):
        assert torch.isfinite(a).all(), name
        assert _rel(a, b) <= TOL_F32, (name, _rel(a, b))


def test_gru_f32_kernels_are_deterministic(dev):
    gx, lens, uh, bhn = _f32_gru_inputs(dev, 26, 256, 512)
    a = gru.gru_fwd_f32(gx, lens, uh, bhn)
    b = gru.gru_fwd_f32(gx, lens, uh, bhn)
    ghT = torch.randn(256, 512, device=dev)
    c = gru.gru_bwd_f32(gx, a[1], lens, uh, bhn, ghT)
    d = gru.gru_bwd_f32(gx, a[1], lens, uh, bhn, ghT)
    for x, y in zip(a + c, b + d):
        assert torch.equal(x, y)


# The float32 GRU's two forms: the persistent kernels of gru_seq_f32.cuh
# (K1f one launch, K3f 4) where they fit, the step form of gru_step_f32.cuh
# elsewhere (H = 1100: past both persistent kernels' shared memory).
F32_STEP_H = 1100


def _f32_seq_inputs(dev, T, B, H, seed):
    """K1f/K3f inputs with lengths 1..T (one row at T) and ghT."""
    gx, _, uh, bhn = _f32_gru_inputs(dev, T, B, H, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    lens = torch.randint(1, T + 1, (B,), generator=g, device=dev,
                         dtype=torch.int32)
    lens[0] = T
    ghT = torch.randn(B, H, generator=g, device=dev)
    return gx, lens, uh, bhn, ghT


@pytest.mark.parametrize("B", [1, 8, 63, 256])
@pytest.mark.parametrize("H", [6, 100, 101, 512, F32_STEP_H])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_f32_persistent_form_equals_step_form(dev, B, H, reverse):
    """K1f and K3f through their wrappers: the route takes the persistent
    form where it fits (1 and 4 launches a call) and the step form at
    H = 1100 (T and T + 4); every output bit-equal to the step form's on
    the same inputs and within TOL_F32 of the plain versions, lengths
    1..T, both directions; two calls give the same bits."""
    T = 26
    gx, lens, uh, bhn, ghT = _f32_seq_inputs(dev, T, B, H, seed=B + H)
    persistent = H != F32_STEP_H
    for name in ("gru_fwd_f32", "gru_bwd_f32"):
        assert gru._f32_route(name, B, H, dev) == (
            "persistent" if persistent else "step")
    f0, b0 = gru.gru_fwd_f32.launches, gru.gru_bwd_f32.launches
    hT, hseq = gru.gru_fwd_f32(gx, lens, uh, bhn, reverse=reverse)
    got = gru.gru_bwd_f32(gx, hseq, lens, uh, bhn, ghT, reverse=reverse)
    torch.cuda.synchronize()
    assert gru.gru_fwd_f32.launches - f0 == (1 if persistent else T)
    assert gru.gru_bwd_f32.launches - b0 == (
        kernels.GRU_F32_BWD_LAUNCHES if persistent
        else T + kernels.GRU_F32_STEP_BWD_LAUNCHES)
    step_fwd = gru._gru_fwd32(gx, lens, uh, bhn, reverse, "step")
    step_bwd = gru._gru_bwd32(gx, hseq, lens, uh, bhn, ghT, reverse, "step")
    again = (gru.gru_fwd_f32(gx, lens, uh, bhn, reverse=reverse)
             + gru.gru_bwd_f32(gx, hseq, lens, uh, bhn, ghT,
                               reverse=reverse))
    rT, rseq = gru.gru_reference(gx, lens, uh, bhn, reverse=reverse)
    want = gru.gru_bwd_reference(gx, hseq, lens, uh, bhn, ghT,
                                 reverse=reverse)
    torch.cuda.synchronize()
    for name, a, b, c in zip(("hT", "hseq", "dgx", "duh", "dbhn"),
                             (hT, hseq) + got, step_fwd + step_bwd, again):
        assert torch.isfinite(a).all(), name
        assert torch.equal(a, b), (name, (a - b).abs().max().item())
        assert torch.equal(a, c), name
    assert _rel(hT, rT) <= TOL_F32 and _rel(hseq, rseq) <= TOL_F32
    for name, a, b in zip(("dgx", "duh", "dbhn"), got, want):
        assert _rel(a, b) <= TOL_F32, (name, _rel(a, b))


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_f32_persistent_forms_capture_in_a_cuda_graph(dev, reverse):
    """K1f's cooperative launch and K3f's four launches are accepted under
    stream capture (1 and 4 counted at the capture), and the graph's
    replay on new inputs equals an eager call on them bit for bit."""
    T, B, H = 26, 256, 512
    gx, lens, uh, bhn, ghT = _f32_seq_inputs(dev, T, B, H, seed=4)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture stream
        _, hs = gru.gru_fwd_f32(gx, lens, uh, bhn, reverse=reverse)
        gru.gru_bwd_f32(gx, hs, lens, uh, bhn, ghT, reverse=reverse)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    f0, b0 = gru.gru_fwd_f32.launches, gru.gru_bwd_f32.launches
    with torch.cuda.graph(graph):
        hT, hseq = gru.gru_fwd_f32(gx, lens, uh, bhn, reverse=reverse)
        dgx, duh, dbhn = gru.gru_bwd_f32(gx, hseq, lens, uh, bhn, ghT,
                                         reverse=reverse)
    assert gru.gru_fwd_f32.launches == f0 + 1
    assert gru.gru_bwd_f32.launches == b0 + kernels.GRU_F32_BWD_LAUNCHES
    gx2, lens2, _, _, ghT2 = _f32_seq_inputs(dev, T, B, H, seed=5)
    gx.copy_(gx2)
    lens.copy_(lens2)
    ghT.copy_(ghT2)
    graph.replay()
    want = gru.gru_fwd_f32(gx, lens, uh, bhn, reverse=reverse)
    want += gru.gru_bwd_f32(gx, want[1], lens, uh, bhn, ghT,
                            reverse=reverse)
    torch.cuda.synchronize()
    for a, b in zip((hT, hseq, dgx, duh, dbhn), want):
        assert torch.equal(a, b)


def test_gru_f32_launch_config_matches_the_plan(dev):
    """The C side derives K1f's and K3f's chain's grids from its occupancy
    query, and they equal kernels.gru_f32_plan's on the same blocks per
    SM, with the plan's shared memory; at the training shape 32 unit
    tiles x 4 rows of blocks, one an SM. Where a block's shared memory
    does not fit (H = 1100) the C side reports no grid and no block, the
    route takes the step form, and asking for the persistent form raises
    (no fallback)."""
    for B, H in [(256, 512), (1, 6), (63, 101), (8, 100), (1024, 512),
                 (64, 1013), (300, 40)]:
        for name in ("gru_fwd_f32", "gru_bwd_f32"):
            cfg = gru._f32_launch_config(name, B, H, dev)
            assert cfg["c_grid"] == cfg["grid"], (name, B, H, cfg)
            assert cfg["c_smem_bytes"] == cfg["smem_bytes"] <= 232448
            assert cfg["blocks_per_sm"] >= 1
    for name in ("gru_fwd_f32", "gru_bwd_f32"):
        assert gru._f32_launch_config(name, 256, 512, dev)["grid"] == [
            32, 4, 1]
        c = gru._f32_config(name, 4, F32_STEP_H, dev)
        assert c["grid"] == [0, 0, 0] and c["blocks_per_sm"] == 0
        assert gru._f32_route(name, 4, F32_STEP_H, dev) == "step"
    gx, lens, uh, bhn, ghT = _f32_seq_inputs(dev, 2, 4, F32_STEP_H, seed=9)
    _, hseq = gru.gru_fwd_f32(gx, lens, uh, bhn)
    with pytest.raises(RuntimeError, match="gru_fwd_f32"):
        gru._gru_fwd32(gx, lens, uh, bhn, False, "persistent")
    with pytest.raises(RuntimeError, match="gru_bwd_f32"):
        gru._gru_bwd32(gx, hseq, lens, uh, bhn, ghT, False, "persistent")


# The float32 BPTT's step form (csrc/gru_bptt_f32.cuh, K3f's and K7f's
# form="step") on its own cases: the training width 2400 and 1100 (past the
# persistent chain), and widths where the persistent form also runs; lengths
# uniform in 1..T (row 0 at T, row 1 at 0), every row live, every row but
# one dead after the first step, and T = 1.
F32_STEP_CASES = [(26, 256, 2400, "uniform"), (26, 256, 1100, "uniform"),
                  (26, 63, 1100, "uniform"), (26, 1, 1100, "uniform"),
                  (26, 256, 1100, "all"), (26, 256, 1100, "one"),
                  (1, 8, 1100, "uniform"), (26, 256, 512, "all"),
                  (26, 256, 512, "one"), (1, 8, 512, "uniform"),
                  (2, 5, 100, "uniform"), (26, 63, 101, "one")]


def _f32_step_inputs(dev, T, B, H, kind, seed):
    """Both chains' BPTT inputs, K1f's states of each, and lengths of
    ``kind``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    gx = [torch.randn(T, B, 3 * H, generator=g, device=dev) * 0.5
          for _ in "fb"]
    uh = [torch.randn(H, 3 * H, generator=g, device=dev) * H ** -0.5
          for _ in "fb"]
    bhn = [torch.randn(H, generator=g, device=dev) * 0.1 for _ in "fb"]
    ghT = [torch.randn(B, H, generator=g, device=dev) for _ in "fb"]
    if kind == "uniform":
        lens = torch.randint(1, T + 1, (B,), generator=g, device=dev,
                             dtype=torch.int32)
        lens[0] = T
        if B > 1:
            lens[1] = 0
    elif kind == "all":
        lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    else:  # every row but one dead after the first step
        lens = torch.ones(B, dtype=torch.int32, device=dev)
        lens[B // 2] = T
    hsf = gru.gru_fwd_f32(gx[0], lens, uh[0], bhn[0])[1]
    hsb = gru.gru_fwd_f32(gx[1], lens, uh[1], bhn[1], reverse=True)[1]
    return gx, uh, bhn, ghT, lens, hsf, hsb


@pytest.mark.parametrize("case", F32_STEP_CASES)
def test_gru_f32_step_forms_match_plain_persistent_and_each_other(dev,
                                                                  case):
    """K3f's step form in both directions and K7f's: within TOL_F32 of the
    plain versions; bit-equal to the persistent form where the route
    takes it (H <= 1013); K7f's chains bit-equal to a K3f step-form call
    each (forward, and reverse on the backward chain); T + 4 launches a
    call each (kernels.gru_f32_launches where the route is the step form);
    two calls give the same bits."""
    T, B, H, kind = case
    gx, uh, bhn, ghT, lens, hsf, hsb = _f32_step_inputs(dev, T, B, H, kind,
                                                        seed=T + B + H)
    persistent = gru._f32_route("gru_bwd_f32", B, H, dev) == "persistent"
    want_launches = T + kernels.GRU_F32_STEP_BWD_LAUNCHES
    if not persistent:
        assert kernels.gru_f32_launches(
            T, B, H, *gru._f32_occupancy("gru_bwd_f32", H, dev),
            True) == want_launches
    k3 = {}
    for chain, reverse, hs in ((0, False, hsf), (1, True, hsb)):
        b0 = gru.gru_bwd_f32.launches
        got = gru._gru_bwd32(gx[chain], hs, lens, uh[chain], bhn[chain],
                             ghT[chain], reverse, "step")
        torch.cuda.synchronize()
        assert gru.gru_bwd_f32.launches - b0 == want_launches
        again = gru._gru_bwd32(gx[chain], hs, lens, uh[chain], bhn[chain],
                               ghT[chain], reverse, "step")
        want = gru.gru_bwd_reference(gx[chain], hs, lens, uh[chain],
                                     bhn[chain], ghT[chain], reverse=reverse)
        for name, a, b, c in zip(("dgx", "duh", "dbhn"), got, want, again):
            assert torch.isfinite(a).all(), name
            assert torch.equal(a, c), name
            assert _rel(a, b) <= TOL_F32, (name, reverse, _rel(a, b))
        if persistent:
            other = gru._gru_bwd32(gx[chain], hs, lens, uh[chain],
                                   bhn[chain], ghT[chain], reverse,
                                   "persistent")
            for name, a, b in zip(("dgx", "duh", "dbhn"), got, other):
                assert torch.equal(a, b), (name, reverse)
        k3[chain] = got
    b0 = gru.bigru_bwd_f32.launches
    got7 = gru.bigru_bwd_f32(gx[0], gx[1], hsf, hsb, lens, uh[0], uh[1],
                             bhn[0], bhn[1], ghT[0], ghT[1], form="step")
    torch.cuda.synchronize()
    assert gru.bigru_bwd_f32.launches - b0 == want_launches
    pairs = zip(("dgxf", "dgxb", "duhf", "duhb", "dbhnf", "dbhnb"), got7,
                (k3[0][0], k3[1][0], k3[0][1], k3[1][1], k3[0][2],
                 k3[1][2]))
    for name, a, b in pairs:
        assert torch.equal(a, b), name


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_f32_step_form_captures_in_a_cuda_graph(dev, reverse):
    """One K3f step-form call (its T + 4 launches, counted at the capture)
    is accepted under stream capture, and the graph's replay on new inputs
    (lengths too) equals an eager call on them bit for bit."""
    T, B, H = 26, 64, 1100
    gx, uh, bhn, ghT, lens, hsf, hsb = _f32_step_inputs(dev, T, B, H,
                                                        "uniform", seed=13)
    c = 1 if reverse else 0
    hseq = hsb if reverse else hsf
    args = [gx[c], hseq, lens, uh[c], bhn[c], ghT[c]]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture stream
        gru._gru_bwd32(*args, reverse, "step")
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    b0 = gru.gru_bwd_f32.launches
    with torch.cuda.graph(graph):
        out = gru._gru_bwd32(*args, reverse, "step")
    assert gru.gru_bwd_f32.launches - b0 == (
        T + kernels.GRU_F32_STEP_BWD_LAUNCHES)
    new = _f32_step_inputs(dev, T, B, H, "one", seed=14)
    fresh = [new[0][c], new[6] if reverse else new[5], new[4], new[1][c],
             new[2][c], new[3][c]]
    for dst, src in zip(args, fresh):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize()
    want = gru._gru_bwd32(*fresh, reverse, "step")
    for a, b in zip(out, want):
        assert torch.equal(a, b)


# kernel_bits.f32_step_fingerprints(0) on the commit before the BPTT's step
# form was redesigned (its K3f and K7f step forms, run on an H100 80GB HBM3
# with the card machine's torch): the values the redesign must keep. The
# inputs come from a seeded CUDA generator, so another torch build may draw
# others.
F32_STEP_PARENT_BITS = {
    "K3f step reverse=False": {
        "dgx": "aead1e144ff6c602c62b7d7b28d7aa61"
               "b686406505796ff62a031c6867c62aa9",
        "duh": "8fd45b941f263e311b3a03aad80bbda3"
               "3d948e0aa474041800950f9a1434b4df",
        "dbhn": "7480d4708dd268ce2ac045fb0a758705"
                "7628aab5d6aebf24b4bde26050e06203"},
    "K3f step reverse=True": {
        "dgx": "0ca805bc201f9b436d58f9abed5b243d"
               "cc050419674c55b6507d73f33e080525",
        "duh": "dd4d84cbb14f825f00fe4cb648f69209"
               "3389ef3b1f40068f8a7c0b2c3f29b4f9",
        "dbhn": "bf560da4757abda09a9ff6c256244de0"
                "d8df30e623560ec0a6ba8a4d4d861253"},
    "K7f step": {
        "dgxf": "aead1e144ff6c602c62b7d7b28d7aa61"
                "b686406505796ff62a031c6867c62aa9",
        "dgxb": "49e4ca28d49d64c57cb2de7e2c33cc9a"
                "1f8261cacaa9a1d440e040e4e89e97ef",
        "duhf": "8fd45b941f263e311b3a03aad80bbda3"
                "3d948e0aa474041800950f9a1434b4df",
        "duhb": "ef88fbf40e6ee6cbb4846904dd62b850"
                "2f94f68c22cf17d379acafb70edeaf3b",
        "dbhnf": "7480d4708dd268ce2ac045fb0a758705"
                 "7628aab5d6aebf24b4bde26050e06203",
        "dbhnb": "51dacc6f1ee93087a7dc7a51567627bc"
                 "ec7f9058ab4f9ac2b08f8e4e15fe65c9"}}


def test_gru_f32_step_forms_keep_the_parent_bits(dev):
    """K3f's step form both ways and K7f's, at 1100 units, B = 256, T = 26,
    lengths 1..T (``kernel_bits.f32_step_fingerprints``, -0 read as +0),
    give the frozen values of the step form they replaced."""
    from vqa_transfer_externaldata_torch.tools import kernel_bits

    assert kernel_bits.f32_step_fingerprints(0) == F32_STEP_PARENT_BITS


def _f32_resident_inputs(dev, M, n_valid, C, H, B, G, rows_dtype, seed=7):
    store, rows, qh, wv, ws = _resident_inputs(dev, M, n_valid, C, H, B,
                                               seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    grid, scale = store.float(), 1.0
    if rows_dtype == torch.int8:  # W_v scaled as the op scales it
        grid = grid / grid.norm(dim=-1, keepdim=True).clamp_min(1e-6)
        scale = grid.abs().max().item() / 127
        store = (grid / scale).round().to(torch.int8)
    else:
        store = grid.to(rows_dtype)
    wv = (torch.rand(C, H, generator=g, device=dev) * 2 - 1) * (
        6.0 / (C + H)) ** 0.5 * scale
    ws = torch.randn(H, G, generator=g, device=dev) * 0.05
    return store, rows, qh, wv, (ws if G > 1 else ws[:, 0].contiguous())


@pytest.mark.parametrize("shape", [(5, 13, 96, 200, 6),
                                   (64, 196, 2048, 512, 256)])
@pytest.mark.parametrize("G", [1, 2, 8])
@pytest.mark.parametrize("rows_dtype", [torch.float32, torch.float16,
                                        torch.int8])
@pytest.mark.parametrize("normalize", [True, False])
def test_attention_resident_f32_kernels_match_plain(dev, shape, G,
                                                    rows_dtype, normalize):
    """K4f and K5f against their plain versions on f32 rows, f16 rows
    (widened on load) and int8 codes, at 1, 2 and 8 glimpses, through the
    dispatch of attention_resident_fwd / _bwd (float32 wv and h); K5f fed
    the plain version's saved h and alpha. C and H need not be a multiple
    of a tile."""
    if rows_dtype == torch.int8 and normalize:
        pytest.skip("an int8 store is normalized before it is quantized")
    M, n_valid, C, H, B = shape
    store, rows, qh, wv, ws = _f32_resident_inputs(dev, M, n_valid, C, H, B,
                                                   G, rows_dtype)
    Np = store.shape[1]
    f0 = ar.attention_resident_fwd_f32.launches
    b0 = ar.attention_resident_bwd_f32.launches
    k45 = (ar.attention_resident_fwd.launches,
           ar.attention_resident_bwd.launches)
    v, a, h = ar.attention_resident_fwd(store, rows, qh, wv, ws,
                                        n_valid=n_valid, normalize=normalize,
                                        save_h=True)
    rv, ra, rh = ar.attention_resident_fwd_reference(
        store, rows, qh, wv, ws, n_valid=n_valid, normalize=normalize,
        save_h=True)
    gen = torch.Generator(device=dev).manual_seed(3)
    gv = torch.randn(B, G * C, generator=gen, device=dev)
    sga = torch.randn(ra.shape, generator=gen, device=dev) * 0.1
    got = ar.attention_resident_bwd(store, rows, rh, ws, ra, gv, sga,
                                    n_valid=n_valid, normalize=normalize)
    want = ar.attention_resident_bwd_reference(
        store, rows, rh, ws, ra, gv, sga, n_valid=n_valid,
        normalize=normalize)
    torch.cuda.synchronize()
    assert h.dtype == torch.float32 and h.shape == (B, Np, H)
    assert ar.attention_resident_fwd_f32.launches == f0 + 2 + normalize
    assert ar.attention_resident_bwd_f32.launches == b0 + 3
    assert (ar.attention_resident_fwd.launches,
            ar.attention_resident_bwd.launches) == k45
    assert _rel(a, ra) <= TOL_F32 and _rel(h, rh) <= TOL_F32
    for k in range(G):
        assert _rel(v[:, k * C:(k + 1) * C], rv[:, k * C:(k + 1) * C]) \
            <= TOL_F32
    for name, x, y, tol in zip(("dqh", "dwv", "dws"), got, want,
                               (G * TOL_F32, G * TOL_F32, TOL_F32)):
        assert torch.isfinite(x).all(), name
        assert _rel(x, y) <= tol, (name, _rel(x, y))


def test_attention_resident_f32_kernels_are_deterministic(dev):
    store, rows, qh, wv, ws = _f32_resident_inputs(
        dev, 64, 196, 2048, 512, 256, 2, torch.float16)
    kw = dict(n_valid=196, normalize=False)
    a = ar.attention_resident_fwd_f32(store, rows, qh, wv, ws, save_h=True,
                                      **kw)
    b = ar.attention_resident_fwd_f32(store, rows, qh, wv, ws, save_h=True,
                                      **kw)
    gv = torch.randn(256, 2 * 2048, device=dev)
    sga = torch.randn(a[1].shape, device=dev) * 0.1
    c = ar.attention_resident_bwd_f32(store, rows, a[2], ws, a[1], gv, sga,
                                      **kw)
    d = ar.attention_resident_bwd_f32(store, rows, a[2], ws, a[1], gv, sga,
                                      **kw)
    for x, y in zip(a + c, b + d):
        assert torch.equal(x, y)


def test_kernels_refuse_other_dtypes_naming_the_float16_item(dev):
    """Every kernel takes bf16, float16 and float32: float16 launches all
    eight float16 kernels (K1h-K8h), each counting its own launches, and
    float64 raises TypeError naming the three dtypes that have kernels, on
    the card as on the CPU; a chain pair whose U_h dtypes differ raises
    too."""
    item = "torch.bfloat16, torch.float16, torch.float32"
    v, qh, wv, ws = _k2_inputs(dev, 2, 9, 128, 128)
    ds, r = torch.zeros(2, 9, device=dev), torch.ones(2, 9, device=dev)
    gx, lens, uh, bhn = _gru_inputs(dev, 3, 4, 64)
    _, hseq = gru.gru_reference(gx, lens, uh, bhn)
    ghT = torch.zeros(4, 64, device=dev)
    store, rows, qh4, wv4, ws4 = _resident_inputs(dev, 3, 9, 128, 128, 2)
    h = torch.zeros(2, store.shape[1], 128, device=dev)
    al = torch.zeros(2, store.shape[1], device=dev)
    dt = torch.float64
    with pytest.raises(TypeError, match=item):
        attention.attention_fwd(v.to(dt), qh, wv.to(dt), ws, normalize=True)
    with pytest.raises(TypeError, match=item):
        attention.attention_bwd(v.to(dt), qh, wv.to(dt), ws, ds, r, True)
    with pytest.raises(TypeError, match=item):
        gru.bigru_fwd(gx, gx, lens, uh.to(dt), uh.to(dt), bhn, bhn)
    with pytest.raises(TypeError, match=item):
        gru.bigru_bwd(gx, gx, hseq, hseq, lens, uh.to(dt), uh.to(dt), bhn,
                      bhn, ghT, ghT)
    with pytest.raises(TypeError, match=item):
        gru.gru_fwd(gx, lens, uh.double(), bhn)
    with pytest.raises(TypeError, match=item):
        gru.gru_bwd(gx, hseq, lens, uh.double(), bhn, ghT)
    with pytest.raises(TypeError, match=item):
        ar.attention_resident_fwd(store, rows, qh4, wv4.double(), ws4,
                                  n_valid=9, normalize=False)
    with pytest.raises(TypeError, match=item):
        ar.attention_resident_bwd(store, rows, h.double(), ws4, al,
                                  torch.zeros(2, 128, device=dev), al,
                                  n_valid=9, normalize=False)
    wrappers = ((gru, "gru_fwd_f16"), (gru, "gru_bwd_f16"),
                (ar, "attention_resident_fwd_f16"),
                (ar, "attention_resident_bwd_f16"),
                (attention, "attention_fwd_f16"),
                (attention, "attention_bwd_f16"), (gru, "bigru_fwd_f16"),
                (gru, "bigru_bwd_f16"))
    before = [getattr(m, n).launches for m, n in wrappers]
    gru.gru_fwd(gx, lens, uh.half(), bhn)
    gru.gru_bwd(gx, hseq, lens, uh.half(), bhn, ghT)
    st16 = store.half()
    ar.attention_resident_fwd(st16, rows, qh4, wv4.half(), ws4, n_valid=9,
                              normalize=False)
    ar.attention_resident_bwd(st16, rows, h.half(), ws4, al,
                              torch.zeros(2, 128, device=dev), al,
                              n_valid=9, normalize=False)
    attention.attention_fwd(v.half(), qh, wv.half(), ws, normalize=True)
    attention.attention_bwd(v.half(), qh, wv.half(), ws, ds, r, True)
    gru.bigru_fwd(gx, gx, lens, uh.half(), uh.half(), bhn, bhn)
    gru.bigru_bwd(gx, gx, hseq, hseq, lens, uh.half(), uh.half(), bhn, bhn,
                  ghT, ghT)
    torch.cuda.synchronize()
    assert [getattr(m, n).launches - c
            for (m, n), c in zip(wrappers, before)] == [1, 3, 2, 3, 2, 4,
                                                        1, 3]
    # A bf16 store under float16 weights (or the other way) is refused.
    with pytest.raises(TypeError, match="store must be float16 or int8"):
        ar.attention_resident_fwd(store, rows, qh4, wv4.half(), ws4,
                                  n_valid=9, normalize=False)
    with pytest.raises(TypeError, match="uhb"):
        gru.bigru_fwd(gx, gx, lens, uh.float(), uh, bhn, bhn)
    with pytest.raises(TypeError, match="uhb"):
        gru.bigru_bwd(gx, gx, hseq, hseq, lens, uh.float(), uh, bhn, bhn,
                      ghT, ghT)
    with pytest.raises(TypeError, match="uhb"):
        gru.bigru_fwd(gx, gx, lens, uh.half(), uh, bhn, bhn)
    with pytest.raises(TypeError, match="wv must be torch.float16"):
        attention.attention_fwd(v.half(), qh, wv, ws, normalize=True)


# ---------------------------------------------------------------------------
# The float32 kernels K2f, K8f (gathered attention) and K6f, K7f (BiGRU)
# ---------------------------------------------------------------------------


def _f32_grid_inputs(dev, B, N, C, H, seed=2):
    g = torch.Generator(device=dev).manual_seed(seed)
    scale = torch.exp2(torch.rand(B, N, 1, generator=g, device=dev) * 4 - 2)
    v = torch.randn(B, N, C, generator=g, device=dev).relu() * scale
    qh = torch.randn(B, H, generator=g, device=dev) * 0.5
    wv = (torch.rand(C, H, generator=g, device=dev) * 2 - 1) * (
        6.0 / (C + H)) ** 0.5
    ws = torch.randn(H, generator=g, device=dev) * 0.1
    ds = torch.randn(B, N, generator=g, device=dev) * 0.01
    return v, qh, wv, ws, ds


# One cell, one question, a 128-cell tile boundary inside a question, C
# and H off every tile (C=2000, H=500), the serving and training shapes.
F32_GRID_SHAPES = [(1, 1, 16, 8), (3, 13, 96, 200), (2, 129, 96, 130),
                   (4, 196, 2000, 500), (64, 196, 2048, 512),
                   (256, 196, 2048, 512)]


@pytest.mark.parametrize("shape", F32_GRID_SHAPES)
@pytest.mark.parametrize("normalize", [True, False])
def test_attention_f32_kernels_match_plain(dev, shape, normalize):
    """K2f and K8f against their plain versions on a float32 grid, through
    the dispatch of attention_fwd / attention_bwd; K8f fed the same ds and
    K2f's r. Each output within TOL_F32 of its largest value, r within
    1e-6; K8f's dqh and dW_v also, entry by entry, what units whose
    recomputed z lies within rounding of 0 can move them (each version
    sums z's f32 products in its own order, so such a unit may take the
    other side of the ReLU in one: _k8_allowance, as for K8); no bf16
    kernel launches."""
    B, N, C, H = shape
    v, qh, wv, ws, ds = _f32_grid_inputs(dev, B, N, C, H)
    f0, b0 = attention.attention_fwd_f32.launches, \
        attention.attention_bwd_f32.launches
    k28 = (attention.attention_fwd.launches, attention.attention_bwd.launches)
    va, al, r = attention.attention_fwd(v, qh, wv, ws, normalize=normalize)
    rv, ra, rr = attention.attention_fwd_reference(v, qh, wv, ws, normalize)
    got = attention.attention_bwd(v, qh, wv, ws, ds, r, normalize)
    want = attention.attention_bwd_reference(v, qh, wv, ws, ds, r, normalize)
    torch.cuda.synchronize()
    assert attention.attention_fwd_f32.launches == f0 + 2 + normalize
    assert attention.attention_bwd_f32.launches == b0 + 3
    assert (attention.attention_fwd.launches,
            attention.attention_bwd.launches) == k28
    assert _rel(r, rr) <= 1e-6
    assert _rel(va, rv) <= TOL_F32 and _rel(al, ra) <= TOL_F32
    a_dqh, a_dwv, _ = _k8_allowance(v, qh, wv, ws, ds, r, normalize)
    for name, a, b, allow in zip(("dqh", "dwv", "dws"), got, want,
                                 (a_dqh, a_dwv, 0.0)):
        assert torch.isfinite(a).all(), name
        limit = TOL_F32 * b.abs().max().item() + allow
        assert ((a - b).abs() <= limit).all(), (name, _rel(a, b))


@pytest.mark.parametrize("normalize", [True, False])
def test_attention_f32_kernels_are_deterministic(dev, normalize):
    v, qh, wv, ws, ds = _f32_grid_inputs(dev, 256, 196, 2048, 512)
    a = attention.attention_fwd_f32(v, qh, wv, ws, normalize=normalize)
    b = attention.attention_fwd_f32(v, qh, wv, ws, normalize=normalize)
    c = attention.attention_bwd_f32(v, qh, wv, ws, ds, a[2], normalize)
    d = attention.attention_bwd_f32(v, qh, wv, ws, ds, a[2], normalize)
    torch.cuda.synchronize()
    for x, y in zip(a + c, b + d):
        assert torch.equal(x, y)


def test_gathered_op_float32_grads_go_through_k2f_k8f(dev):
    """The autograd op on a float32 grid launches K2f forward and K8f
    backward (no bf16 kernel), and its parameter gradients agree with the
    explicit backward's (bwd_kernel=False) to cosine 0.99999 (chip_smoke's
    F32_GRAD_COS): both are float32 with only the order of sums apart, and
    a unit whose z lies within rounding of 0 may take the other side of
    the ReLU in one of them."""
    v, qh, wv, ws, _ = _f32_grid_inputs(dev, 16, 49, 256, 128, seed=11)
    g = torch.Generator(device=dev).manual_seed(12)
    wa = torch.randn(16, 256, generator=g, device=dev)
    wb = torch.randn(16, 49, generator=g, device=dev)
    grads = []
    for bwd_kernel in (True, False):
        ins = [p.clone().requires_grad_() for p in (qh, wv, ws)]
        counts = [getattr(attention, n).launches for n in (
            "attention_fwd_f32", "attention_bwd_f32", "attention_fwd",
            "attention_bwd")]
        va, al = attention.spatial_attention(v, *ins, normalize=True,
                                             bwd_kernel=bwd_kernel,
                                             feature_grad=False)
        ((va * wa).sum() + (al * wb).sum()).backward()
        torch.cuda.synchronize()
        assert [getattr(attention, n).launches - c for n, c in zip(
            ("attention_fwd_f32", "attention_bwd_f32", "attention_fwd",
             "attention_bwd"), counts)] == [3, 3 if bwd_kernel else 0, 0, 0]
        grads.append([t.grad for t in ins])
    for a, b in zip(*grads):
        cos = torch.nn.functional.cosine_similarity(
            a.flatten(), b.flatten(), dim=0).item()
        assert cos >= 0.99999, cos


def _two_k1f(gxf, gxb, lens, uhf, uhb, bhnf, bhnb):
    """K1f on each chain, in K6f's output order (hTf, hTb, hseqf, hseqb)."""
    (hTf, hsf), (hTb, hsb) = (
        gru.gru_fwd_f32(gxf, lens, uhf, bhnf),
        gru.gru_fwd_f32(gxb, lens, uhb, bhnb, reverse=True))
    return hTf, hTb, hsf, hsb


# K6f/K7f's shapes: the two first from the 16-bit tests, a width off a unit
# tile, the stage-1 shape, and the widths at each route boundary on an
# H100 (K7f's chain persistent up to 1013 units, K6f up to 1024).
BIGRU_F32_SHAPES = [(1, 1, 16), (7, 65, 100), (26, 256, 512),
                    (26, 200, 600), (3, 64, 1013), (3, 64, 1014),
                    (3, 64, 1024), (3, 64, 1025)]


@pytest.mark.parametrize("shape", BIGRU_F32_SHAPES)
def test_bigru_f32_kernels_match_plain_and_two_k1f_k3f(dev, shape):
    """K6f and K7f through the dispatch of bigru_fwd / bigru_bwd on float32
    U_h, in the route's form and then in every other (the persistent
    kernels with both chains a launch on the plan's b-tiles, K6f's on
    64-row b-tiles, with one chain a launch, the step form; a width whose
    route is the step form takes only that): bit-equal to a K1f (K3f) call
    on each chain's inputs and to every other form, within TOL_F32 of
    their plain versions, with the plan's launches a call (persistent: K6f
    1, K7f 4; one chain a launch: 2 and 5; the step form: T and T + 4),
    the C side's grid and shared memory the plan's, and no bf16 kernel;
    lengths hold 0, 1 and T."""
    T, B, H = shape
    gxf, lens, _, bhnf = _f32_gru_inputs(dev, T, B, H, seed=7)
    gxb, _, _, bhnb = _f32_gru_inputs(dev, T, B, H, seed=8)
    if B > 2:
        lens[2] = 1
    g = torch.Generator(device=dev).manual_seed(9)
    uhf = torch.randn(H, 3 * H, generator=g, device=dev) * H ** -0.5
    uhb = torch.randn(H, 3 * H, generator=g, device=dev) * H ** -0.5
    ghTf = torch.randn(B, H, generator=g, device=dev)
    ghTb = torch.randn(B, H, generator=g, device=dev)
    args = (gxf, gxb, lens, uhf, uhb, bhnf, bhnb)
    routes, want_launches = {}, {}
    for name, step in (("bigru_fwd_f32", T),
                       ("bigru_bwd_f32",
                        T + kernels.GRU_F32_STEP_BWD_LAUNCHES)):
        routes[name] = gru._f32_route(name, B, H, dev)
        if routes[name] == "persistent":
            plan = gru._f32_launch_config(name, B, H, dev)
            assert plan["c_grid"] == plan["grid"], (name, plan)
            assert plan["c_smem_bytes"] == plan["smem_bytes"]
            want_launches[name] = {"persistent": plan["launches"],
                                   "per_chain": 5 if "bwd" in name else 2,
                                   "persistent64": plan["launches"],
                                   "step": step}
            # K6f's 128-row b-tiles where a block would walk two of 64
            # rows a step: the stage-1 shape, and (200, 600), whose 76
            # blocks a row leave one row of blocks for 4 b-tiles.
            assert plan["rows"] == (128 if name == "bigru_fwd_f32" and (
                B, H) in ((256, 512), (200, 600)) else 64), plan
        else:
            want_launches[name] = {f: step for f in (
                "persistent", "per_chain", "persistent64", "step")}
    assert routes["bigru_fwd_f32"] == (
        "persistent" if H <= 1024 else "step")
    assert routes["bigru_bwd_f32"] == (
        "persistent" if H <= 1013 else "step")
    c0 = {n: getattr(gru, n).launches for n in (
        "bigru_fwd_f32", "bigru_bwd_f32", "bigru_fwd", "bigru_bwd")}
    got = gru.bigru_fwd(*args)
    hsf, hsb = got[2], got[3]
    bwd = (gxf, gxb, hsf, hsb, lens, uhf, uhb, bhnf, bhnb, ghTf, ghTb)
    got7 = gru.bigru_bwd(*bwd)
    torch.cuda.synchronize()
    assert {n: getattr(gru, n).launches - c for n, c in c0.items()} == {
        "bigru_fwd_f32": want_launches["bigru_fwd_f32"]["persistent"],
        "bigru_bwd_f32": want_launches["bigru_bwd_f32"]["persistent"],
        "bigru_fwd": 0, "bigru_bwd": 0}
    want = gru.bigru_reference(*args)
    want7 = gru.bigru_bwd_reference(*bwd)
    ones = _two_k1f(*args)
    one_f = gru.gru_bwd_f32(gxf, hsf, lens, uhf, bhnf, ghTf)
    one_b = gru.gru_bwd_f32(gxb, hsb, lens, uhb, bhnb, ghTb, reverse=True)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, ones):
        assert _rel(a, b) <= TOL_F32
        assert torch.equal(a, c)
    ones7 = (one_f[0], one_b[0], one_f[1], one_b[1], one_f[2], one_b[2])
    for name, a, b, c in zip(("dgxf", "dgxb", "duhf", "duhb", "dbhnf",
                              "dbhnb"), got7, want7, ones7):
        assert torch.isfinite(a).all(), name
        assert _rel(a, b) <= TOL_F32, (name, _rel(a, b))
        assert torch.equal(a, c), name
    for form in ("persistent", "per_chain", "persistent64", "step"):
        f6 = form if routes["bigru_fwd_f32"] == "persistent" else "step"
        f7 = form if routes["bigru_bwd_f32"] == "persistent" else "step"
        f7 = "persistent" if f7 == "persistent64" else f7
        c1 = (gru.bigru_fwd_f32.launches, gru.bigru_bwd_f32.launches)
        other = gru.bigru_fwd_f32(*args, form=f6)
        other7 = gru.bigru_bwd_f32(*bwd, form=f7)
        torch.cuda.synchronize()
        assert (gru.bigru_fwd_f32.launches - c1[0],
                gru.bigru_bwd_f32.launches - c1[1]) == (
            want_launches["bigru_fwd_f32"][form],
            want_launches["bigru_bwd_f32"][form]), form
        for a, b in zip(other + other7, got + got7):
            assert torch.equal(a, b), (form, (a - b).abs().max().item())


def test_bigru_f32_kernels_are_deterministic(dev):
    gxf, lens, uhf, bhnf = _f32_gru_inputs(dev, 26, 256, 512, seed=3)
    gxb, _, uhb, bhnb = _f32_gru_inputs(dev, 26, 256, 512, seed=4)
    args = (gxf, gxb, lens, uhf, uhb, bhnf, bhnb)
    a = gru.bigru_fwd_f32(*args)
    b = gru.bigru_fwd_f32(*args)
    ghT = torch.randn(256, 512, device=dev)
    c = gru.bigru_bwd_f32(gxf, gxb, a[2], a[3], lens, uhf, uhb, bhnf, bhnb,
                          ghT, ghT)
    d = gru.bigru_bwd_f32(gxf, gxb, a[2], a[3], lens, uhf, uhb, bhnf, bhnb,
                          ghT, ghT)
    torch.cuda.synchronize()
    for x, y in zip(a + c, b + d):
        assert torch.equal(x, y)


def test_bigru_f32_persistent_forms_capture_in_a_cuda_graph(dev):
    """K6f's cooperative launch and K7f's four launches are accepted under
    stream capture (1 and 4 counted at the capture), and the graph's
    replay on new inputs equals an eager call on them bit for bit."""
    T, B, H = 26, 256, 512
    gxf, lens, uhf, bhnf, ghTf = _f32_seq_inputs(dev, T, B, H, seed=4)
    gxb, _, uhb, bhnb, ghTb = _f32_seq_inputs(dev, T, B, H, seed=6)
    args = (gxf, gxb, lens, uhf, uhb, bhnf, bhnb)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture stream
        hs = gru.bigru_fwd_f32(*args)
        gru.bigru_bwd_f32(gxf, gxb, hs[2], hs[3], lens, uhf, uhb, bhnf,
                          bhnb, ghTf, ghTb)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    f0, b0 = gru.bigru_fwd_f32.launches, gru.bigru_bwd_f32.launches
    with torch.cuda.graph(graph):
        out = gru.bigru_fwd_f32(*args)
        out7 = gru.bigru_bwd_f32(gxf, gxb, out[2], out[3], lens, uhf, uhb,
                                 bhnf, bhnb, ghTf, ghTb)
    assert gru.bigru_fwd_f32.launches == f0 + 1
    assert gru.bigru_bwd_f32.launches == b0 + kernels.GRU_F32_BWD_LAUNCHES
    for x, seed in ((gxf, 5), (gxb, 7)):
        x.copy_(_f32_seq_inputs(dev, T, B, H, seed=seed)[0])
    lens.copy_(_f32_seq_inputs(dev, T, B, H, seed=5)[1])
    ghTf.copy_(_f32_seq_inputs(dev, T, B, H, seed=5)[4])
    graph.replay()
    want = gru.bigru_fwd_f32(*args)
    want7 = gru.bigru_bwd_f32(gxf, gxb, want[2], want[3], lens, uhf, uhb,
                              bhnf, bhnb, ghTf, ghTb)
    torch.cuda.synchronize()
    for a, b in zip(out + out7, want + want7):
        assert torch.equal(a, b)


def test_fused_bigru_encoder_float32_goes_through_k6f_k7f(dev):
    """The float32 BiGRU encoder on the card launches K6f forward and K7f
    backward (1 and 4 launches, both chains in each) and no other GRU
    kernel, and its output and gradients equal the per-direction
    encoders' (K1f/K3f) on the same weights bit for bit."""
    g = torch.Generator().manual_seed(9)
    enc = gru.BiGRUEncoder(32, 64, dtype=torch.float32, generator=g).to(dev)
    x = torch.randn(6, 10, 32, generator=g).to(dev)
    mask = (torch.arange(6)[None, :] <
            torch.tensor([6, 1, 3, 0, 5, 2, 6, 4, 1, 3])[:, None]).float()
    mask = mask.to(dev)

    def two_encoders(x, mask):
        return torch.cat([enc.fwd(x, mask), enc.bwd(x, mask)], dim=-1)

    names = ("bigru_fwd_f32", "bigru_bwd_f32", "gru_fwd_f32", "gru_bwd_f32",
             "bigru_fwd", "bigru_bwd", "gru_fwd", "gru_bwd")
    res = []
    for fn, want in ((enc, [1, kernels.GRU_F32_BWD_LAUNCHES, 0, 0, 0, 0, 0,
                            0]),
                     (two_encoders, [0, 0, 2, 2 * kernels.GRU_F32_BWD_LAUNCHES,
                                     0, 0, 0, 0])):
        enc.zero_grad()
        counts = [getattr(gru, n).launches for n in names]
        out = fn(x, mask)
        out.square().sum().backward()
        torch.cuda.synchronize()
        assert [getattr(gru, n).launches - c
                for n, c in zip(names, counts)] == want
        res.append((out, {k: p.grad.clone()
                          for k, p in enc.named_parameters()}))
    assert torch.equal(res[0][0], res[1][0])
    for k, a in res[0][1].items():
        assert torch.equal(a, res[1][1][k]), k


# ---------------------------------------------------------------------------
# The float16 kernels K1h, K3h, K4h, K5h: K1's, K3's, K4's and K5's bodies
# built with float16 as their element type. Each limit is the bf16 kernel's
# with float16's step, 2^-11 of a value, in place of bf16's 2^-8: K1h's h
# to TOL_GRU / 8, K3h to 2^-11 of each output's largest value, K4h's saved
# h to 2^-10 (one float16 step of the largest value), K5h to 2^-12 (G times
# that for dqh and dW_v). v_att keeps bf16's 2^-10: its weights alpha * r
# are rounded to float16, and the two versions' alpha differ by ~4e-5 of
# themselves, the same way within a question (the softmax's sum), which is
# a tenth of a float16 step: many weights land one step apart, all in one
# direction, and each moves its term by at most 2^-10 of it (v >= 0), so
# v_att moves by at most 2^-10 of itself. alpha keeps K2/K4's 1e-5.
# ---------------------------------------------------------------------------

TOL_F16_GRU = 2e-3 / 8
TOL_F16_K3 = 2.0 ** -11
TOL_F16_K4_H = 2.0 ** -10
TOL_F16_VATT = 2.0 ** -10
TOL_F16_K5 = 2.0 ** -12


@pytest.mark.parametrize("B", [1, 65, 256])
@pytest.mark.parametrize("T", [1, 26])
@pytest.mark.parametrize("H", [64, 512])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_f16_kernels_match_plain(dev, B, T, H, reverse):
    """K1h and K3h against their plain versions on float16 U_h, through
    the dispatch of gru_fwd and gru_bwd; lengths hold 0 and T. Only the
    float16 kernels' counters move: one persistent launch for K1h, three
    launches for K3h."""
    gx, lens, uh, bhn = _gru_inputs(dev, T, B, H)
    uh = uh.half()
    lens[0] = T
    if B > 1:
        lens[1] = 0
    names = ("gru_fwd_f16", "gru_bwd_f16", "gru_fwd", "gru_bwd",
             "gru_fwd_f32", "gru_bwd_f32")
    before = [getattr(gru, n).launches for n in names]
    hT, hseq = gru.gru_fwd(gx, lens, uh, bhn, reverse=reverse)
    rT, rseq = gru.gru_reference(gx, lens, uh, bhn, reverse=reverse)
    ghT = torch.randn(B, H, device=dev)
    got = gru.gru_bwd(gx, rseq, lens, uh, bhn, ghT, reverse=reverse)
    want = gru.gru_bwd_reference(gx, rseq, lens, uh, bhn, ghT,
                                 reverse=reverse)
    torch.cuda.synchronize()
    assert [getattr(gru, n).launches - c
            for n, c in zip(names, before)] == [1, 3, 0, 0, 0, 0]
    assert torch.equal(hT, hseq[0 if reverse else -1])
    assert (hseq - rseq).abs().max().item() <= TOL_F16_GRU
    for name, a, b in zip(("dgx", "duh", "dbhn"), got, want):
        assert torch.isfinite(a).all(), name
        assert _rel(a, b) <= TOL_F16_K3, (name, _rel(a, b))


def test_gru_f16_kernels_are_deterministic(dev):
    gx, lens, uh, bhn = _gru_inputs(dev, 26, 256, 512)
    uh = uh.half()
    a = gru.gru_fwd_f16(gx, lens, uh, bhn)
    b = gru.gru_fwd_f16(gx, lens, uh, bhn)
    ghT = torch.randn(256, 512, device=dev)
    c = gru.gru_bwd_f16(gx, a[1], lens, uh, bhn, ghT)
    d = gru.gru_bwd_f16(gx, a[1], lens, uh, bhn, ghT)
    for x, y in zip(a + c, b + d):
        assert torch.equal(x, y)


def _f16_resident_inputs(dev, M, n_valid, C, H, B, G, int8, seed=7):
    """K4h/K5h's inputs: float16 rows (or the int8 codes of their
    normalized cells, W_v scaled as the op scales it), float16 W_v."""
    store, rows, qh, _, _ = _resident_inputs(dev, M, n_valid, C, H, B,
                                             seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    grid, scale = store.float(), 1.0
    if int8:
        grid = grid / grid.norm(dim=-1, keepdim=True).clamp_min(1e-6)
        scale = grid.abs().max().item() / 127
        store = (grid / scale).round().to(torch.int8)
    else:
        store = grid.half()
    wv = ((torch.rand(C, H, generator=g, device=dev) * 2 - 1) * (
        6.0 / (C + H)) ** 0.5 * scale).half()
    ws = torch.randn(H, G, generator=g, device=dev) * 0.05
    return store, rows, qh, wv, (ws if G > 1 else ws[:, 0].contiguous())


@pytest.mark.parametrize("shape", [(5, 13, 128, 128, 6),
                                   (64, 196, 2048, 512, 256)])
@pytest.mark.parametrize("G", [1, 2, 8])
@pytest.mark.parametrize("int8,normalize", [(False, True), (False, False),
                                            (True, False)])
def test_attention_resident_f16_kernels_match_plain(dev, shape, G, int8,
                                                    normalize):
    """K4h and K5h against their plain versions on float16 rows and on
    int8 codes (widened to float16), at 1, 2 and 8 glimpses, through the
    dispatch of attention_resident_fwd / _bwd (float16 wv and h); K5h fed
    the plain version's saved h and alpha. The bf16 kernels' counters stay
    where they were, and the float16 ones count int8 rows apart."""
    M, n_valid, C, H, B = shape
    store, rows, qh, wv, ws = _f16_resident_inputs(dev, M, n_valid, C, H, B,
                                                   G, int8)
    attr = "launches_int8" if int8 else "launches"
    fwd16, bwd16 = ar.attention_resident_fwd_f16, ar.attention_resident_bwd_f16
    f0, b0 = getattr(fwd16, attr), getattr(bwd16, attr)
    k45 = (ar.attention_resident_fwd.launches,
           ar.attention_resident_fwd.launches_int8,
           ar.attention_resident_bwd.launches,
           ar.attention_resident_bwd.launches_int8)
    kw = dict(n_valid=n_valid, normalize=normalize)
    v, a, h = ar.attention_resident_fwd(store, rows, qh, wv, ws, save_h=True,
                                        **kw)
    rv, ra, rh = ar.attention_resident_fwd_reference(store, rows, qh, wv, ws,
                                                     save_h=True, **kw)
    gen = torch.Generator(device=dev).manual_seed(3)
    gv = torch.randn(B, G * C, generator=gen, device=dev)
    sga = torch.randn(ra.shape, generator=gen, device=dev) * 0.1
    got = ar.attention_resident_bwd(store, rows, rh, ws, ra, gv, sga, **kw)
    want = ar.attention_resident_bwd_reference(store, rows, rh, ws, ra, gv,
                                               sga, **kw)
    torch.cuda.synchronize()
    assert h.dtype == torch.float16 and h.shape == rh.shape
    assert getattr(fwd16, attr) == f0 + 2 and getattr(bwd16, attr) == b0 + 3
    assert (ar.attention_resident_fwd.launches,
            ar.attention_resident_fwd.launches_int8,
            ar.attention_resident_bwd.launches,
            ar.attention_resident_bwd.launches_int8) == k45
    assert (a - ra).abs().max().item() <= 1e-5
    assert _rel(h, rh) <= TOL_F16_K4_H
    for k in range(G):
        assert _rel(v[:, k * C:(k + 1) * C], rv[:, k * C:(k + 1) * C]) \
            <= TOL_F16_VATT
    for name, x, y, tol in zip(("dqh", "dwv", "dws"), got, want,
                               (G * TOL_F16_K5, G * TOL_F16_K5, TOL_F16_K5)):
        assert torch.isfinite(x).all(), name
        assert _rel(x, y) <= tol, (name, _rel(x, y))


@pytest.mark.parametrize("int8", [False, True])
def test_attention_resident_f16_kernels_are_deterministic(dev, int8):
    store, rows, qh, wv, ws = _f16_resident_inputs(dev, 64, 196, 2048, 512,
                                                   256, 2, int8)
    kw = dict(n_valid=196, normalize=False)
    a = ar.attention_resident_fwd_f16(store, rows, qh, wv, ws, save_h=True,
                                      **kw)
    b = ar.attention_resident_fwd_f16(store, rows, qh, wv, ws, save_h=True,
                                      **kw)
    gv = torch.randn(256, 2 * 2048, device=dev)
    sga = torch.randn(a[1].shape, device=dev) * 0.1
    c = ar.attention_resident_bwd_f16(store, rows, a[2], ws, a[1], gv, sga,
                                      **kw)
    d = ar.attention_resident_bwd_f16(store, rows, a[2], ws, a[1], gv, sga,
                                      **kw)
    for x, y in zip(a + c, b + d):
        assert torch.equal(x, y)


def test_f16_kernels_take_the_bf16_launches(dev):
    """float16 takes the same fragments, tiles and shared memory as bf16:
    each float16 library's C side reports K1's, K3's, K4's and K5's launch
    shapes at the main path's and the serving batch."""
    f16 = torch.float16
    for B in (64, 256):
        assert (gru.gru_fwd_launch_config(B, 512, dev, f16)
                == gru.gru_fwd_launch_config(B, 512, dev))
        assert (gru.gru_bwd_launch_config(B, 512, dev, f16)
                == gru.gru_bwd_launch_config(B, 512, dev))
        for int8 in (False, True):
            assert (ar.score_launch_config(B * 200, 512, int8, f16)
                    == ar.score_launch_config(B * 200, 512, int8))
            splits = kernels.dwv_plan(B * 196, 2048, 512,
                                      kernels.sm_count(dev), int8)["splits"]
            assert (ar.dwv_launch_config(B * 196, 2048, 512, int8, splits,
                                         f16)
                    == ar.dwv_launch_config(B * 196, 2048, 512, int8,
                                            splits))
        for G in (1, 8):
            assert (ar.rows_launch_config(B, 196, G, 2048, 512, f16)
                    == ar.rows_launch_config(B, 196, G, 2048, 512))


def test_f16_model_trains_through_k1h_k3h_k4h_k5h(dev):
    """A float16 vqa_attention step on a float16 store: the forward runs
    K1h and K4h, the backward K3h and K5h, and no bf16 or float32 kernel
    runs."""
    from vqa_transfer_externaldata_torch.models.vqa_attention import (
        VQAAttentionModel)

    g = torch.Generator().manual_seed(4)
    model = VQAAttentionModel(64, 16, feature_dim=128, word_dim=32,
                              rnn_dim=64, fusion_dim=64, att_hidden=128,
                              answer_dim=32, n_cells=13,
                              store_prenormalized=True, dtype=torch.float16,
                              generator=g).to(dev)
    store, rows, *_ = _f16_resident_inputs(dev, 5, 13, 128, 128, 6, 1, False)
    q = torch.randint(4, 64, (6, 7), generator=g).to(dev)
    names = [(m, n) for m in (gru, ar) for n in dir(m)
             if hasattr(getattr(m, n), "launches")]
    before = {n: getattr(m, n).launches for m, n in names}
    out = model((store, rows), q, train=True,
                generator=torch.Generator(device=dev).manual_seed(1))
    out["logits"].float().square().mean().backward()
    torch.cuda.synchronize()
    moved = {n: getattr(m, n).launches - before[n] for m, n in names
             if getattr(m, n).launches != before[n]}
    assert moved == {"gru_fwd_f16": 1, "gru_bwd_f16": 3,
                     "attention_resident_fwd_f16": 2,
                     "attention_resident_bwd_f16": 3}
    for k, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), k


# ---------------------------------------------------------------------------
# The float16 kernels K2h, K8h (gathered attention) and K6h, K7h (BiGRU):
# K2's, K8's, K6's and K7's bodies built with float16 as their element type,
# held as K1h-K5h are: K2h's alpha 1e-5, v_att 2^-10 of each normalize
# mode's max|v_att| (bf16's, for the reason above), r 1e-6 relative; K8h
# 2^-12 of each output's largest value (K8's 2^-9 with float16's step) plus
# K8's per-entry room for ReLU flips (the products of two float16 values
# are exact in f32, as bf16's are, so the room is the same); K6h and K7h
# bit-equal to two K1h / K3h calls, h within TOL_F16_GRU and K7h's outputs
# within TOL_F16_K3 of their plain versions.
# ---------------------------------------------------------------------------

TOL_F16_K8 = 2.0 ** -12


def _f16_grid_inputs(dev, B, N, C, H, seed=1):
    """K2h/K8h's inputs: K2's grid, W_v and ws, with the grid and W_v in
    float16, and one cell holding 300 when N > 3 (its square overflows
    float16, so its r is 0 in the kernel and in the plain version)."""
    v, qh, wv, ws = _k2_inputs(dev, B, N, C, H, seed)
    v = v.half()
    if N > 3:
        v[0, 3, 5] = 300.0
    return v, qh, wv.half(), ws


@pytest.mark.parametrize("shape", [(1, 1, 128, 128), (3, 129, 256, 384),
                                   (8, 196, 2048, 512),
                                   (256, 196, 2048, 512)])
@pytest.mark.parametrize("normalize", [True, False])
def test_attention_f16_kernels_match_plain(dev, shape, normalize):
    """K2h and K8h against their plain versions on a float16 grid, through
    the dispatch of attention_fwd / attention_bwd, K8h fed the same ds and
    K2h's r; the planted cell's r is 0 on both sides. Only the float16
    kernels' counters move: 2 launches for K2h, 4 for K8h."""
    B, N, C, H = shape
    v, qh, wv, ws = _f16_grid_inputs(dev, B, N, C, H)
    names = ("attention_fwd_f16", "attention_bwd_f16", "attention_fwd",
             "attention_bwd", "attention_fwd_f32", "attention_bwd_f32")
    before = [getattr(attention, n).launches for n in names]
    va, al, r = attention.attention_fwd(v, qh, wv, ws, normalize=normalize)
    rv, ra, rr = attention.attention_fwd_reference(v, qh, wv, ws, normalize)
    g = torch.Generator(device=dev).manual_seed(2)
    ds = (torch.randn(B, N, generator=g, device=dev) * ra).contiguous()
    got = attention.attention_bwd(v, qh, wv, ws, ds, r, normalize)
    want = attention.attention_bwd_reference(v, qh, wv, ws, ds, r, normalize)
    torch.cuda.synchronize()
    assert [getattr(attention, n).launches - c
            for n, c in zip(names, before)] == [2, 4, 0, 0, 0, 0]
    assert torch.isfinite(va).all() and torch.isfinite(al).all()
    assert (va - rv).abs().max().item() <= 2.0 ** -10 * rv.abs().max().item()
    assert (al - ra).abs().max().item() <= 1e-5
    assert _rel_err(r, rr) <= 1e-6
    if normalize and N > 3:
        assert r[0, 3].item() == 0.0 and rr[0, 3].item() == 0.0
    a_dqh, a_dwv, _ = _k8_allowance(v, qh, wv, ws, ds, r, normalize)
    for name, a, b, allow in zip(("dqh", "dwv", "dws"), got, want,
                                 (a_dqh, a_dwv, 0.0)):
        assert torch.isfinite(a).all(), name
        limit = TOL_F16_K8 * b.abs().max().item() + allow
        assert ((a - b).abs() <= limit).all(), (name, _rel_err(a, b))


@pytest.mark.parametrize("normalize", [True, False])
def test_attention_f16_kernels_are_deterministic(dev, normalize):
    v, qh, wv, ws = _f16_grid_inputs(dev, 256, 196, 2048, 512)
    a = attention.attention_fwd_f16(v, qh, wv, ws, normalize=normalize)
    b = attention.attention_fwd_f16(v, qh, wv, ws, normalize=normalize)
    ds = (torch.randn(256, 196, device=dev) * a[1]).contiguous()
    c = attention.attention_bwd_f16(v, qh, wv, ws, ds, a[2], normalize)
    d = attention.attention_bwd_f16(v, qh, wv, ws, ds, a[2], normalize)
    for x, y in zip(a + c, b + d):
        assert torch.equal(x, y)


def test_attention_f16_kernels_take_the_bf16_launches(dev):
    """K2h's score launch and K8h's dz launch as their libraries' C sides
    set them equal K2's and K8's at the serving and the training batch."""
    f16 = torch.float16
    for B in (8, 64, 256):
        assert (attention.score_launch_config(B, 196, 512, f16)
                == attention.score_launch_config(B, 196, 512))
        assert (attention.dz_launch_config(B, 196, 512, f16)
                == attention.dz_launch_config(B, 196, 512))


def test_gathered_op_float16_grads_go_through_k2h_k8h(dev):
    """The autograd op on a float16 grid launches K2h forward and K8h
    backward, and its parameter gradients agree with the explicit
    backward's (bwd_kernel=False) to cosine 0.999."""
    g = torch.Generator(device=dev).manual_seed(11)
    B, N, C, H = 16, 49, 256, 128
    v = torch.randn(B, N, C, generator=g, device=dev).relu().half()
    params = [torch.randn(B, H, generator=g, device=dev) * 0.5,
              torch.randn(C, H, generator=g, device=dev) * 0.05,
              torch.randn(H, generator=g, device=dev) * 0.05]
    wa = torch.randn(B, C, generator=g, device=dev)
    wb = torch.randn(B, N, generator=g, device=dev)
    grads = []
    for bwd_kernel in (True, False):
        ins = [p.clone().requires_grad_() for p in params]
        counts = (attention.attention_fwd_f16.launches,
                  attention.attention_bwd_f16.launches)
        va, al = attention.spatial_attention(v, *ins, normalize=True,
                                             bwd_kernel=bwd_kernel,
                                             feature_grad=False)
        ((va * wa).sum() + (al * wb).sum()).backward()
        assert (attention.attention_fwd_f16.launches - counts[0],
                attention.attention_bwd_f16.launches - counts[1]) == (
                    2, kernels.ATTENTION_BWD_LAUNCHES if bwd_kernel else 0)
        grads.append([t.grad for t in ins])
    for a, b in zip(*grads):
        cos = torch.nn.functional.cosine_similarity(
            a.flatten(), b.flatten(), dim=0).item()
        assert cos >= 0.999, cos


@pytest.mark.parametrize("shape", [(1, 2, 64), (7, 20, 64), (26, 64, 512),
                                   (26, 256, 512)])
def test_bigru_f16_kernels_match_plain_and_two_k1h_k3h(dev, shape):
    """K6h and K7h on float16 U_h through the dispatch of bigru_fwd /
    bigru_bwd against their plain versions and bit-equal to two K1h / K3h
    calls on the same inputs, K7h fed K6h's hseqs; one launch for K6h, three
    for K7h, and no bf16 or float32 kernel."""
    T, B, H = shape
    gxf, gxb, lens, uhf, uhb, bhnf, bhnb = _bigru_inputs(dev, T, B, H)
    uhf, uhb = uhf.half(), uhb.half()
    args = (gxf, gxb, lens, uhf, uhb, bhnf, bhnb)
    names = ("bigru_fwd_f16", "bigru_bwd_f16", "bigru_fwd", "bigru_bwd",
             "bigru_fwd_f32", "bigru_bwd_f32")
    before = [getattr(gru, n).launches for n in names]
    got = gru.bigru_fwd(*args)
    want = gru.bigru_reference(*args)
    g = torch.Generator(device=dev).manual_seed(8)
    ghTf = torch.randn(B, H, generator=g, device=dev)
    ghTb = torch.randn(B, H, generator=g, device=dev)
    bargs = (gxf, gxb, got[2], got[3], lens, uhf, uhb, bhnf, bhnb, ghTf,
             ghTb)
    got7 = gru.bigru_bwd(*bargs)
    want7 = gru.bigru_bwd_reference(*bargs)
    torch.cuda.synchronize()
    assert [getattr(gru, n).launches - c
            for n, c in zip(names, before)] == [1, 3, 0, 0, 0, 0]
    (hTf, hsf), (hTb, hsb) = (gru.gru_fwd_f16(gxf, lens, uhf, bhnf),
                              gru.gru_fwd_f16(gxb, lens, uhb, bhnb,
                                              reverse=True))
    one_f = gru.gru_bwd_f16(gxf, got[2], lens, uhf, bhnf, ghTf)
    one_b = gru.gru_bwd_f16(gxb, got[3], lens, uhb, bhnb, ghTb, reverse=True)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, (hTf, hTb, hsf, hsb)):
        assert (a - b).abs().max().item() <= TOL_F16_GRU
        assert torch.equal(a, c)
    ones = (one_f[0], one_b[0], one_f[1], one_b[1], one_f[2], one_b[2])
    for name, a, b, c in zip(("dgxf", "dgxb", "duhf", "duhb", "dbhnf",
                              "dbhnb"), got7, want7, ones):
        assert torch.isfinite(a).all(), name
        assert _rel(a, b) <= TOL_F16_K3, (name, _rel(a, b))
        assert torch.equal(a, c), name


def test_bigru_f16_kernels_are_deterministic_and_take_the_bf16_launches(
        dev):
    gxf, gxb, lens, uhf, uhb, bhnf, bhnb = _bigru_inputs(dev, 26, 256, 512)
    args = (gxf, gxb, lens, uhf.half(), uhb.half(), bhnf, bhnb)
    a = gru.bigru_fwd_f16(*args)
    b = gru.bigru_fwd_f16(*args)
    ghT = torch.randn(256, 512, device=dev)
    bargs = (gxf, gxb, a[2], a[3], lens, *args[3:], ghT, ghT)
    c = gru.bigru_bwd_f16(*bargs)
    d = gru.bigru_bwd_f16(*bargs)
    for x, y in zip(a + c, b + d):
        assert torch.equal(x, y)
    f16 = torch.float16
    for B in (64, 256):
        assert (gru.bigru_fwd_launch_config(B, 512, dev, f16)
                == gru.bigru_fwd_launch_config(B, 512, dev))
        assert (gru.bigru_bwd_launch_config(B, 512, dev, f16)
                == gru.bigru_bwd_launch_config(B, 512, dev))


def test_f16_stage1_encoder_and_gathered_model_go_through_k6h_k7h_k2h_k8h(
        dev):
    """A float16 BiGRU encoder step runs K6h forward and K7h backward, and a
    float16 vqa_attention step on a gathered float16 grid runs K1h, K2h,
    K3h and K8h: no bf16 or float32 kernel."""
    from vqa_transfer_externaldata_torch.models.vqa_attention import (
        VQAAttentionModel)

    names = [(m, n) for m in (gru, attention) for n in dir(m)
             if hasattr(getattr(m, n), "launches")]

    def moved(before):
        return {n: getattr(m, n).launches - before[n] for m, n in names
                if getattr(m, n).launches != before[n]}

    g = torch.Generator().manual_seed(5)
    enc = gru.BiGRUEncoder(32, 64, dtype=torch.float16, generator=g).to(dev)
    x = torch.randn(7, 6, 32, device=dev).half()
    mask = torch.ones(6, 7, device=dev)
    mask[1, 3:] = 0
    before = {n: getattr(m, n).launches for m, n in names}
    enc(x, mask).float().square().sum().backward()
    torch.cuda.synchronize()
    assert moved(before) == {"bigru_fwd_f16": 1, "bigru_bwd_f16": 3}

    model = VQAAttentionModel(64, 16, feature_dim=128, word_dim=32,
                              rnn_dim=64, fusion_dim=64, att_hidden=128,
                              answer_dim=32, n_cells=13,
                              dtype=torch.float16, generator=g).to(dev)
    v = torch.randn(6, 13, 128, device=dev).relu().half()
    q = torch.randint(4, 64, (6, 7), generator=g).to(dev)
    before = {n: getattr(m, n).launches for m, n in names}
    out = model(v, q, train=True,
                generator=torch.Generator(device=dev).manual_seed(1))
    out["logits"].float().square().mean().backward()
    torch.cuda.synchronize()
    assert moved(before) == {"gru_fwd_f16": 1, "gru_bwd_f16": 3,
                             "attention_fwd_f16": 2,
                             "attention_bwd_f16": 4}
    for k, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), k


# ---------------------------------------------------------------------------
# Widths: every 16-bit wrapper (K1-K8 in bf16 and float16, K4/K5 on int8
# codes) at widths off its kernels' multiples, which the wrappers zero-pad
# (H to 16 for K1/K6, 64 for K3/K7, 128 for the attention kernels; C to 32
# for K2/K4, 128 for K5/K8), against its plain version at the limits above
# (float16's scaled by its step, 1/8); and the GRU's step form
# (csrc/gru_wide_step.cuh) where the persistent kernels cannot run, K6/K7
# in it bit-equal to two K1/K3 calls.
# ---------------------------------------------------------------------------

WIDTH_H = (8, 24, 40, 100, 600)
WIDTH_C = (16, 48, 100, 300)
DTYPES16 = (torch.bfloat16, torch.float16)


def _step(dtype):
    """float16's limits are bf16's with its step: 1/8."""
    return 1.0 if dtype == torch.bfloat16 else 0.125


def _gru_width_case(dev, T, B, H, dtype):
    """K1, K3, K6 and K7 (their float16 builds on float16) at (T, B, H):
    each against its plain version, K6/K7 bit-equal to two K1/K3 calls,
    and each wrapper's launches counted on the form its route takes."""
    gxf, gxb, lens, uhf, uhb, bhnf, bhnb = _bigru_inputs(dev, T, B, H)
    uhf, uhb = uhf.to(dtype), uhb.to(dtype)
    f16 = dtype == torch.float16
    step = _step(dtype)
    fwd_name = kernels.name16("gru_fwd", dtype)
    Hf = kernels.round_up(H, kernels.GRU_FWD_PAD)
    Hb = kernels.round_up(H, kernels.GRU_BWD_PAD)
    fwd_form = gru._fwd_route(fwd_name, B, Hf, dev)
    bwd_form = gru._bwd_route(kernels.name16("gru_bwd", dtype), B, Hb, dev, 1)
    counter = {("fwd", "persistent"): gru.gru_fwd_f16 if f16 else gru.gru_fwd,
               ("fwd", "step"): gru.gru_fwd_wide_f16 if f16
               else gru.gru_fwd_wide,
               ("bwd", "persistent"): gru.gru_bwd_f16 if f16 else gru.gru_bwd,
               ("bwd", "step"): gru.gru_bwd_wide_f16 if f16
               else gru.gru_bwd_wide}
    g = torch.Generator(device=dev).manual_seed(9)
    ghTf = torch.randn(B, H, generator=g, device=dev)
    ghTb = torch.randn(B, H, generator=g, device=dev)
    outs = {}
    for d, (gx, uh, bhn, ghT) in enumerate(((gxf, uhf, bhnf, ghTf),
                                            (gxb, uhb, bhnb, ghTb))):
        rev = bool(d)
        c = counter[("fwd", fwd_form)]
        before = c.launches
        hT, hseq = gru.gru_fwd(gx, lens, uh, bhn, reverse=rev)
        torch.cuda.synchronize()
        assert c.launches == before + (1 if fwd_form == "persistent" else T)
        rT, rseq = gru.gru_reference(gx, lens, uh, bhn, reverse=rev)
        assert hseq.shape == rseq.shape and torch.isfinite(hseq).all()
        assert (hseq - rseq).abs().max().item() <= 2e-3 * step
        assert (hT - rT).abs().max().item() <= 2e-3 * step
        c = counter[("bwd", bwd_form)]
        before = c.launches
        got = gru.gru_bwd(gx, rseq, lens, uh, bhn, ghT, reverse=rev)
        torch.cuda.synchronize()
        assert c.launches == before + (
            3 if bwd_form == "persistent"
            else kernels.gru_step_plan(T, B, Hb, True)["launches"])
        want = gru.gru_bwd_reference(gx, rseq, lens, uh, bhn, ghT,
                                     reverse=rev)
        for name, a, b in zip(("dgx", "duh", "dbhn"), got, want):
            assert a.shape == b.shape and torch.isfinite(a).all(), name
            assert _rel_err(a, b) <= TOL_K3 * step, (name, _rel_err(a, b))
        outs[d] = (hT, hseq, rseq, got)
    k6 = gru.bigru_fwd(gxf, gxb, lens, uhf, uhb, bhnf, bhnb)
    k7 = gru.bigru_bwd(gxf, gxb, outs[0][2], outs[1][2], lens, uhf, uhb,
                       bhnf, bhnb, ghTf, ghTb)
    torch.cuda.synchronize()
    for a, b in zip(k6, (outs[0][0], outs[1][0], outs[0][1], outs[1][1])):
        assert torch.equal(a, b)
    for i, a in enumerate(k7):
        assert torch.equal(a, outs[i % 2][3][i // 2]), i
    return fwd_form, bwd_form


@pytest.mark.parametrize("H", WIDTH_H)
@pytest.mark.parametrize("dtype", DTYPES16)
def test_gru_kernels_take_every_width(dev, H, dtype):
    """K1/K3/K6/K7 (bf16) and K1h/K3h/K6h/K7h (float16) at widths off 16
    and 64: 600 pads to 608 forward (past kernels.GRU_FWD_STEP_ABOVE: the
    step form) and to 640 backward (past the persistent kernel's shared
    memory: the step form)."""
    forms = _gru_width_case(dev, 7, 20, H, dtype)
    Hf = kernels.round_up(H, kernels.GRU_FWD_PAD)
    assert forms == ("step" if Hf > kernels.GRU_FWD_STEP_ABOVE
                     else "persistent", "step" if H > 576 else "persistent")


@pytest.mark.parametrize("H", [100, 600, 1024, 2400])
@pytest.mark.parametrize("dtype", DTYPES16)
def test_gru_step_form_at_the_wide_models(dev, H, dtype):
    """At B = 256, T = 26: a 1024-unit question GRU and Skip-Thought's 2400
    units (both forms the step form, U_h through L2), and the odd widths
    100 (the persistent kernels) and 600 (the step forms, padded to 608
    and 640), one and two directions against the plain versions, each of
    K6/K7's directions bit-equal to a K1/K3 call; two calls of the step
    form bit-equal."""
    forms = _gru_width_case(dev, 26, 256, H, dtype)
    Hf = kernels.round_up(H, kernels.GRU_FWD_PAD)
    assert forms == ("step" if Hf > kernels.GRU_FWD_STEP_ABOVE
                     else "persistent", "step" if H > 576 else "persistent")
    gx, lens, uh, bhn = _gru_inputs(dev, 26, 256, H, seed=5)
    uh = uh.to(dtype)
    a = gru.gru_fwd_wide(gx, lens, uh, bhn)
    b = gru.gru_fwd_wide(gx, lens, uh, bhn)
    ghT = torch.randn(256, H, generator=torch.Generator(device=dev)
                      .manual_seed(6), device=dev)
    c = gru.gru_bwd_wide(gx, a[1], lens, uh, bhn, ghT, reverse=True)
    d = gru.gru_bwd_wide(gx, a[1], lens, uh, bhn, ghT, reverse=True)
    torch.cuda.synchronize()
    for x, y in zip(a + c, b + d):
        assert torch.equal(x, y)


@pytest.mark.parametrize("H", [64, 100, 512, 600, 1024])
@pytest.mark.parametrize("dtype", DTYPES16)
def test_gru_step_form_where_both_forms_run(dev, H, dtype):
    """The step form called directly (gru_fwd_wide, gru_bwd_wide and their
    two-direction and float16 twins) at widths the persistent kernels also
    take and at odd ones: against the plain version, the plan's launches
    (T and T + 4), two calls bit-equal, K6/K7's step form bit-equal to two
    K1/K3 step-form calls."""
    T, B = 26, 64
    gxf, gxb, lens, uhf, uhb, bhnf, bhnb = _bigru_inputs(dev, T, B, H)
    uhf, uhb = uhf.to(dtype), uhb.to(dtype)
    f16 = dtype == torch.float16
    fw = gru.gru_fwd_wide_f16 if f16 else gru.gru_fwd_wide
    bw = gru.gru_bwd_wide_f16 if f16 else gru.gru_bwd_wide
    before = (fw.launches, bw.launches)
    hT, hseq = gru.gru_fwd_wide(gxf, lens, uhf, bhnf)
    again = gru.gru_fwd_wide(gxf, lens, uhf, bhnf)
    _, rseq = gru.gru_reference(gxf, lens, uhf, bhnf)
    ghT = torch.randn(B, H, generator=torch.Generator(device=dev)
                      .manual_seed(2), device=dev)
    got = gru.gru_bwd_wide(gxf, rseq, lens, uhf, bhnf, ghT)
    got2 = gru.gru_bwd_wide(gxf, rseq, lens, uhf, bhnf, ghT)
    want = gru.gru_bwd_reference(gxf, rseq, lens, uhf, bhnf, ghT)
    torch.cuda.synchronize()
    Hb = kernels.round_up(H, kernels.GRU_BWD_PAD)
    assert (fw.launches, bw.launches) == (
        before[0] + 2 * T,
        before[1] + 2 * kernels.gru_step_plan(T, B, Hb, True)["launches"])
    assert (hseq - rseq).abs().max().item() <= 2e-3 * _step(dtype)
    assert torch.equal(hseq, again[1]) and torch.equal(hT, again[0])
    for name, a, b, c in zip(("dgx", "duh", "dbhn"), got, want, got2):
        assert _rel_err(a, b) <= TOL_K3 * _step(dtype), name
        assert torch.equal(a, c), name
    hb = gru.gru_fwd_wide(gxb, lens, uhb, bhnb, reverse=True)
    k6 = gru.bigru_fwd_wide(gxf, gxb, lens, uhf, uhb, bhnf, bhnb)
    for a, b in zip(k6, (hT, hb[0], hseq, hb[1])):
        assert torch.equal(a, b)
    gb = gru.gru_bwd_wide(gxb, hb[1], lens, uhb, bhnb, ghT, reverse=True)
    k7 = gru.bigru_bwd_wide(gxf, gxb, rseq, hb[1], lens, uhf, uhb, bhnf,
                            bhnb, ghT, ghT)
    for i, a in enumerate(k7):
        assert torch.equal(a, (got, gb)[i % 2][i // 2]), i


def _width_grid(dev, B, N, C, H, dtype):
    v, qh, wv, ws = _k2_inputs(dev, B, N, C, H)
    return v.to(dtype), qh, wv.to(dtype), ws


@pytest.mark.parametrize("C", WIDTH_C)
@pytest.mark.parametrize("H", WIDTH_H)
@pytest.mark.parametrize("dtype", DTYPES16)
def test_gathered_attention_kernels_take_every_width(dev, C, H, dtype):
    """K2/K8 (K2h/K8h) at C and H off 32 and 128: against their plain
    versions at phase 7's limits (K8 with its ReLU-flip room), normalize on
    and off, 2 and 4 launches a call."""
    B, N = 3, 13
    v, qh, wv, ws = _width_grid(dev, B, N, C, H, dtype)
    f16 = dtype == torch.float16
    fwd = attention.attention_fwd_f16 if f16 else attention.attention_fwd
    bwd = attention.attention_bwd_f16 if f16 else attention.attention_bwd
    for normalize in (True, False):
        before = (fwd.launches, bwd.launches)
        va, al, r = attention.attention_fwd(v, qh, wv, ws,
                                            normalize=normalize)
        rv, ra, rr = attention.attention_fwd_reference(v, qh, wv, ws,
                                                       normalize)
        ds = (torch.randn(B, N, generator=torch.Generator(device=dev)
                          .manual_seed(3), device=dev) * ra).contiguous()
        got = attention.attention_bwd(v, qh, wv, ws, ds, rr, normalize)
        want = attention.attention_bwd_reference(v, qh, wv, ws, ds, rr,
                                                 normalize)
        torch.cuda.synchronize()
        assert (fwd.launches, bwd.launches) == (before[0] + 2,
                                                before[1] + 4)
        assert va.shape == (B, C) and torch.isfinite(va).all()
        assert (va - rv).abs().max().item() <= (
            2.0 ** -10 * rv.abs().max().item())
        assert (al - ra).abs().max().item() <= 1e-5
        assert _rel_err(r, rr) <= 1e-6
        a_dqh, a_dwv, _ = _k8_allowance(v, qh, wv, ws, ds, rr, normalize)
        tol = TOL_K5 * _step(dtype)
        for name, a, b, allow in zip(("dqh", "dwv", "dws"), got, want,
                                     (a_dqh, a_dwv, 0.0)):
            assert a.shape == b.shape and torch.isfinite(a).all(), name
            limit = tol * b.abs().max().item() + allow
            assert ((a - b).abs() <= limit).all(), (name, _rel_err(a, b))


@pytest.mark.parametrize("C", WIDTH_C)
@pytest.mark.parametrize("H", WIDTH_H)
@pytest.mark.parametrize("rows", ["bf16", "f16", "int8"])
def test_resident_attention_kernels_take_every_width(dev, C, H, rows):
    """K4/K5 on bf16 rows, K4h/K5h on float16 rows, and both on int8 codes
    at C and H off 32 and 128, G = 1 and 2: a store off the multiple is
    read through the batch's padded rows (resident_pad_store); against
    their plain versions at phase 5's limits."""
    dtype = torch.float16 if rows == "f16" else torch.bfloat16
    M, n_valid, B = 5, 13, 6
    store, idx, qh, _, _ = _resident_inputs(dev, M, n_valid, C, H, B)
    g = torch.Generator(device=dev).manual_seed(4)
    if rows == "int8":
        store = _int8_codes(store)[0]
    else:
        store = store.to(dtype)
    wv = ((torch.rand(C, H, generator=g, device=dev) * 2 - 1)
          * (6.0 / (C + H)) ** 0.5).to(dtype)
    step = _step(dtype)
    for G in (1, 2):
        ws = torch.randn(H, G, generator=g, device=dev) * 0.05
        ws = ws if G > 1 else ws[:, 0].contiguous()
        for normalize in ((False,) if rows == "int8" else (True, False)):
            kw = dict(n_valid=n_valid, normalize=normalize)
            va, al, h = ar.attention_resident_fwd(store, idx, qh, wv, ws,
                                                  save_h=True, **kw)
            rv, ra, rh = ar.attention_resident_fwd_reference(
                store, idx, qh, wv, ws, save_h=True, **kw)
            gv = torch.randn(B, G * C, generator=g, device=dev)
            sga = torch.randn(ra.shape, generator=g, device=dev)
            got = ar.attention_resident_bwd(store, idx, rh, ws, ra, gv, sga,
                                            **kw)
            want = ar.attention_resident_bwd_reference(store, idx, rh, ws,
                                                       ra, gv, sga, **kw)
            torch.cuda.synchronize()
            assert va.shape == (B, G * C) and h.shape == rh.shape
            for k in range(G):
                a, b = va[:, k * C:(k + 1) * C], rv[:, k * C:(k + 1) * C]
                assert (a - b).abs().max().item() <= (
                    2.0 ** -10 * b.abs().max().item())
            assert (al - ra).abs().max().item() <= 1e-5
            assert _rel_err(h.float(), rh.float()) <= TOL_K4_H * step
            for name, a, b in zip(("dqh", "dwv", "dws"), got, want):
                assert a.shape == b.shape and torch.isfinite(a).all(), name
                limit = TOL_K5 * step * (G if name != "dws" else 1)
                assert _rel_err(a, b) <= limit, (name, _rel_err(a, b))


@pytest.mark.parametrize("C", [100, 300])
@pytest.mark.parametrize("int8", [False, True])
def test_channel_padded_store_matches_the_unpadded_one(dev, C, int8):
    """The op on a store padded to 128 channels at upload
    (prenormalize_store's ``channels``, as the Trainer uploads it) against
    the op on the same store unpadded (padded by the wrappers call by
    call): v_att [B, C] and the gradients of qh, W_v [C, H] and ws agree
    within K4's and K5's limits, and an int8 store keeps its scale."""
    import numpy as np
    rng = np.random.default_rng(0)
    grid = rng.random((6, 13, C)).astype(np.float32)
    H, B = 100, 8
    q = "int8" if int8 else ""
    flat, s0 = ar.prenormalize_store(grid, torch.bfloat16, q, device=dev)
    wide, s1 = ar.prenormalize_store(grid, torch.bfloat16, q, device=dev,
                                     channels=kernels.STORE_CHANNELS)
    assert s0 == s1 and wide.shape[2] == kernels.round_up(C, 128)
    assert torch.equal(wide[..., :C], flat)
    assert not wide[..., C:].any()
    g = torch.Generator(device=dev).manual_seed(5)
    rows = torch.randint(0, 6, (B,), generator=g, device=dev,
                         dtype=torch.int32)
    qh = torch.randn(B, H, generator=g, device=dev).requires_grad_()
    wv = (torch.randn(C, H, generator=g, device=dev) * 0.1).requires_grad_()
    ws = (torch.randn(H, generator=g, device=dev) * 0.1).requires_grad_()
    res = []
    for store, scale in ((flat, s0), (wide, s1)):
        va, al = ar.spatial_attention_resident(
            store, rows, qh.bfloat16(), wv, ws, n_valid=13, normalize=False,
            store_scale=scale)
        grads = torch.autograd.grad(va.square().sum(), (qh, wv, ws))
        res.append((va, al) + grads)
    torch.cuda.synchronize()
    for name, a, b in zip(("v_att", "alpha", "dqh", "dwv", "dws"), *res):
        assert a.shape == b.shape, name
        assert _rel_err(a, b) <= TOL_K4_H, (name, _rel_err(a, b))


# ---------------------------------------------------------------------------
# The float32 products' cp.async ring (csrc/fp32_ring.cuh) at every copy
# width: K4f, K5f, K2f and K8f on rows whose pitch is not 16-byte aligned
# ---------------------------------------------------------------------------

# Channels: 16, 48, 100 and 300 (the widths sweep's) and 25 and 50, which
# give f32 rows 4- and 8-byte copies and f16 or int8 rows element-by-element
# ones (ops/kernels.py::f32_copy_width); units: 8, 100, 600 (16-byte rows of
# W_v and dz), 6 (8-byte) and 101 (4-byte).
RING_CHANNELS = [16, 25, 48, 50, 100, 300]
RING_UNITS = [8, 100, 600, 6, 101]


@pytest.mark.parametrize("rows_dtype", [torch.float32, torch.float16,
                                        torch.int8])
@pytest.mark.parametrize("C", RING_CHANNELS)
@pytest.mark.parametrize("H", RING_UNITS)
def test_attention_resident_f32_ring_widths_match_plain(dev, rows_dtype, C,
                                                        H):
    """K4f and K5f at G = 2 against their plain versions where the rows'
    pitch C takes each copy width: 37 questions of 29 valid cells (1184
    cells, not a multiple of the 128-cell tile; K5f's 1073 valid cells split
    with a ragged last split and a ragged last 16-cell chunk when the
    card's split rule gives two). Two calls give the same bits."""
    normalize = rows_dtype != torch.int8
    store, rows, qh, wv, ws = _f32_resident_inputs(dev, 9, 29, C, H, 37, 2,
                                                   rows_dtype)
    kw = dict(n_valid=29, normalize=normalize)
    es = store.element_size()
    assert ar.f32_score_plan(store, wv)["a_width"] == \
        kernels.f32_copy_width(C * es, store.data_ptr())
    f0 = ar.attention_resident_fwd_f32.launches
    b0 = ar.attention_resident_bwd_f32.launches
    v, a, h = ar.attention_resident_fwd_f32(store, rows, qh, wv, ws,
                                            save_h=True, **kw)
    v2, a2, h2 = ar.attention_resident_fwd_f32(store, rows, qh, wv, ws,
                                               save_h=True, **kw)
    rv, ra, rh = ar.attention_resident_fwd_reference(store, rows, qh, wv,
                                                     ws, save_h=True, **kw)
    gen = torch.Generator(device=dev).manual_seed(3)
    gv = torch.randn(37, 2 * C, generator=gen, device=dev)
    sga = torch.randn(ra.shape, generator=gen, device=dev) * 0.1
    got = ar.attention_resident_bwd_f32(store, rows, rh, ws, ra, gv, sga,
                                        **kw)
    again = ar.attention_resident_bwd_f32(store, rows, rh, ws, ra, gv, sga,
                                          **kw)
    want = ar.attention_resident_bwd_reference(store, rows, rh, ws, ra, gv,
                                               sga, **kw)
    torch.cuda.synchronize()
    assert ar.attention_resident_fwd_f32.launches == f0 + 2 * (2 + normalize)
    assert ar.attention_resident_bwd_f32.launches == b0 + 6
    assert _rel(a, ra) <= TOL_F32 and _rel(h, rh) <= TOL_F32
    for k in range(2):
        assert _rel(v[:, k * C:(k + 1) * C], rv[:, k * C:(k + 1) * C]) \
            <= TOL_F32
    for name, x, y, tol in zip(("dqh", "dwv", "dws"), got, want,
                               (2 * TOL_F32, 2 * TOL_F32, TOL_F32)):
        assert torch.isfinite(x).all(), name
        assert _rel(x, y) <= tol, (name, _rel(x, y))
    for x, y in zip((v, a, h) + got, (v2, a2, h2) + again):
        assert torch.equal(x, y)


@pytest.mark.parametrize("C", RING_CHANNELS)
@pytest.mark.parametrize("H", RING_UNITS)
@pytest.mark.parametrize("offset", [0, 1])
def test_attention_f32_ring_widths_match_plain(dev, C, H, offset):
    """K2f and K8f against their plain versions where v's pitch C (and, at
    offset 1, v's start 4 bytes past an allocation's) takes each copy
    width: 37 questions of 29 cells (1073 cells: K8f's dW_v split with a
    ragged last split and a ragged last chunk when the card's rule gives
    two). K8f within TOL_F32 plus its ReLU-flip allowance; two calls give
    the same bits."""
    B, N = 37, 29
    v0, qh, wv, ws, ds = _f32_grid_inputs(dev, B, N, C, H)
    v = torch.empty(B * N * C + offset, device=dev)[offset:].view(B, N, C)
    v.copy_(v0)
    assert attention.f32_score_plan(v, wv)["a_width"] == \
        kernels.f32_copy_width(C * 4, v.data_ptr())
    f0, b0 = attention.attention_fwd_f32.launches, \
        attention.attention_bwd_f32.launches
    va, al, r = attention.attention_fwd_f32(v, qh, wv, ws, normalize=True)
    va2, al2, r2 = attention.attention_fwd_f32(v, qh, wv, ws, normalize=True)
    rv, ra, rr = attention.attention_fwd_reference(v, qh, wv, ws, True)
    got = attention.attention_bwd_f32(v, qh, wv, ws, ds, r, True)
    again = attention.attention_bwd_f32(v, qh, wv, ws, ds, r, True)
    want = attention.attention_bwd_reference(v, qh, wv, ws, ds, r, True)
    torch.cuda.synchronize()
    assert attention.attention_fwd_f32.launches == f0 + 6
    assert attention.attention_bwd_f32.launches == b0 + 6
    assert _rel(r, rr) <= 1e-6
    assert _rel(va, rv) <= TOL_F32 and _rel(al, ra) <= TOL_F32
    a_dqh, a_dwv, _ = _k8_allowance(v, qh, wv, ws, ds, r, True)
    for name, a, b, allow in zip(("dqh", "dwv", "dws"), got, want,
                                 (a_dqh, a_dwv, 0.0)):
        assert torch.isfinite(a).all(), name
        limit = TOL_F32 * b.abs().max().item() + allow
        assert ((a - b).abs() <= limit).all(), (name, _rel(a, b))
    for x, y in zip((va, al, r) + got, (va2, al2, r2) + again):
        assert torch.equal(x, y)


def test_f32_ring_refuses_a_plan_the_rows_do_not_allow(dev, monkeypatch):
    """A plan whose copy width the rows' alignment does not allow (16 bytes
    on f16 rows 600 bytes apart) or whose shared bytes are not the C side's
    layout is refused by the C entry before anything launches: the wrapper
    raises and counts no launch."""
    store, rows, qh, wv, ws = _f32_resident_inputs(dev, 3, 13, 300, 100, 4,
                                                   1, torch.float16)
    good = ar.f32_score_plan(store, wv)
    assert good["a_width"] == 8
    kw = dict(n_valid=13, normalize=False)
    for bad in ({**good, "a_width": 16},
                {**good, "smem_bytes": good["smem_bytes"] + 16},
                {**good, "stages": good["stages"] + 1}):
        monkeypatch.setattr(ar, "f32_score_plan", lambda s, w, p=bad: p)
        n0 = ar.attention_resident_fwd_f32.launches
        with pytest.raises(RuntimeError, match="attention_resident_fwd_f32"):
            ar.attention_resident_fwd_f32(store, rows, qh, wv, ws, **kw)
        assert ar.attention_resident_fwd_f32.launches == n0
