"""The launch plan of the dW_v GEMM that K5, K8 and the probe P2 share
(``csrc/attention_dwv.cuh``), chosen in one place,
``ops/kernels.py::dwv_plan``, from which the three wrappers take their split
of the cells. Pure arithmetic on shapes: it runs here on the CPU; the card
tests (``tests/test_torch_kernels_cuda.py``) hold the C side to it."""

import pytest

from vqa_transfer_externaldata_torch.ops import kernels

SMS = 132  # an H100 SXM's streaming multiprocessors
SMEM_OPTIN = 232448  # the dynamic shared memory a block of it may take


def _check_split(plan: dict, K: int) -> None:
    """Every split but the last is a whole number of 64-cell chunks, the
    last one holds at least one cell, and the splits cover the K cells."""
    per = plan["chunks_per_split"] * kernels.DWV_CHUNK
    splits = plan["splits"]
    assert plan["grid"][2] == splits >= 1
    assert (splits - 1) * per < K <= splits * per


@pytest.mark.parametrize("what,K,int8", [("K5", 256 * 196, False),
                                         ("K5 int8", 256 * 196, True),
                                         ("K8", 256 * 196, False),
                                         ("P2", 256 * 200, False)])
def test_dwv_plan_at_the_main_shapes(what, K, int8):
    """C=2048, H=512: 16 x 2 tiles of 128 x 256 in 4 splits of 196 (K5,
    K8) or 200 (P2) chunks, 128 blocks: one wave of 132 SMs."""
    plan = kernels.dwv_plan(K, 2048, 512, SMS, int8)
    assert plan["tile"] == [128, 256] and plan["stages"] == 4
    assert plan["splits"] == 4
    assert plan["chunks_per_split"] == K // 256
    assert plan["grid"] == [2, 16, 4]
    gx, gy, gz = plan["grid"]
    assert gx * gy * gz <= SMS
    assert 48 * 1024 < plan["smem_bytes"] <= SMEM_OPTIN
    assert plan["smem_bytes"] == (230400 if int8 else 197632)
    _check_split(plan, K)


def test_dwv_plan_at_a_tiny_shape():
    """65 cells (5 questions of 13) make two chunks: one split, the second
    chunk one cell long; H=128 takes the 128-unit tile and 5 stages."""
    plan = kernels.dwv_plan(65, 128, 128, SMS)
    assert plan["splits"] == 1 and plan["chunks_per_split"] == 2
    assert plan["tile"] == [128, 128] and plan["stages"] == 5
    assert plan["grid"] == [1, 1, 1]
    _check_split(plan, 65)


def test_dwv_plan_over_a_sweep_of_shapes():
    """Over cells, widths and row types: no split is empty, none but a lone
    one holds fewer than DWV_MIN_CHUNKS chunks, the grid is one wave
    wherever the tiles alone fit in one, and the ring fits a block."""
    for K in (1, 63, 64, 65, 255, 256, 257, 980, 1764, 4097, 50176, 51200,
              262144):
        for C in (128, 256, 2048, 4096):
            for H in (128, 256, 384, 512, 1024):
                for int8 in (False, True):
                    plan = kernels.dwv_plan(K, C, H, SMS, int8)
                    _check_split(plan, K)
                    bn = plan["tile"][1]
                    assert bn == (256 if H % 256 == 0 else 128)
                    assert plan["grid"][:2] == [H // bn, C // 128]
                    if plan["splits"] > 1:
                        assert (plan["chunks_per_split"]
                                >= kernels.DWV_MIN_CHUNKS)
                    tiles = (H // bn) * (C // 128)
                    if tiles <= SMS:
                        assert tiles * plan["splits"] <= SMS
                    assert plan["smem_bytes"] <= SMEM_OPTIN


def test_dwv_plan_refuses_shapes_the_gemm_does_not_take():
    for K, C, H in [(0, 128, 128), (64, 96, 128), (64, 128, 192),
                    (64, 0, 128)]:
        with pytest.raises(ValueError, match="dwv_plan"):
            kernels.dwv_plan(K, C, H, SMS)


def test_dwv_gemm_is_one_header_of_k5_k8_and_p2():
    """K5, K8 and P2 include the one dW_v GEMM, so the build hash of each
    library covers it (and score_gemm.cuh's primitives that it runs); K5
    and P2 also include their shared rows stage, attention_rows.cuh."""
    for name in ("attention_resident_bwd", "attention_bwd",
                 "probe_bwd_ceiling"):
        rows = [] if name == "attention_bwd" else ["attention_rows.cuh"]
        assert [p.name for p in kernels.sources(name)] == [
            f"{name}.cu", "attention_dwv.cuh", *rows, "score_gemm.cuh",
            "store_rows.cuh", "elem16.cuh"]


def test_dwv_gemm_runs_on_wgmma_alone():
    """The dW_v header issues its products through wgmma on transposed
    operands (score_gemm.cuh's wrappers with tnsp 1): no WMMA is left."""
    text = (kernels.CSRC / "attention_dwv.cuh").read_text()
    assert "mma.h" not in text and "wmma" not in text
    assert "score_gemm::mma<BN, 1, E>" in text
