"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use by ``nvcc`` for Hopper (``sm_90a``) into its own shared library under
``<repo>/build/torch_kernels/``, then opened with ``ctypes``. The library
name carries a hash of the source and of every header it includes from
``csrc/`` (step kernels that two libraries share live in such headers), so
an edited kernel or header is rebuilt and a stale library is never loaded.
Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Mapping, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every file it includes with ``#include
    "..."`` that exists beside its includer, recursively, each once."""
    found: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = path.parent / inc.decode()
            if dep.exists():
                todo.append(dep.resolve())
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha1()
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _nvcc_run(cmd: List[str]) -> Tuple[int, str, float]:
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    return proc.returncode, proc.stdout, time.perf_counter() - t0


def build(names: Sequence[str]) -> Dict[str, Tuple[str, float]]:
    """Compile every missing library in ``names``, one ``nvcc`` each, all
    started together. Returns ``{name: (ptxas report, nvcc's wall
    seconds)}`` for the ones built here (empty for libraries that were
    already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if not out.exists():
            jobs[name] = (out.with_suffix(f".{os.getpid()}.tmp"), out)
    if not jobs:
        return {}
    nvcc = _nvcc()
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        runs = {name: pool.submit(_nvcc_run, [
            nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")])
            for name, (tmp, _) in jobs.items()}
    reports, failed = {}, []
    for name, run in runs.items():
        rc, text, seconds = run.result()
        if rc != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{text}")
            continue
        tmp, out = jobs[name]
        os.replace(tmp, out)  # atomic: a concurrent build never sees half
        reports[name] = (text, seconds)
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (building it if needed).
    Every library exports ``const char* cuda_error_string(int)``."""
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of CUDA ``device``."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


DWV_TILE = 128  # channels of a dW_v tile; C and H are its multiples
DWV_CHUNK = 64  # cells of a chunk of the dW_v GEMM's ring
DWV_MIN_CHUNKS = 4  # the fewest chunks a split of the cells takes


def dwv_plan(K: int, C: int, H: int, sms: int, int8: bool = False) -> dict:
    """The launch of the dW_v GEMM of ``csrc/attention_dwv.cuh`` (K5, K8
    and P2) over ``K`` cells at ``C`` x ``H`` (multiples of 128) on a card
    of ``sms`` SMs, bf16 rows or int8 codes: its tile (channels x units:
    256 units where 256 divides H, else 128), ring stages, dynamic shared
    memory in bytes, the split of the cells, the chunks of 64 cells a split
    and the grid (unit tiles, channel tiles, splits). The cells are split
    so that the grid fills one wave of the SMs, a split keeping at least
    ``DWV_MIN_CHUNKS`` chunks; every split but the last is a whole number of
    chunks and none is empty. The C side (``attn_dwv::plan``) derives the
    same tile, stages, memory and chunks from the splits passed to it."""
    if K < 1 or C < DWV_TILE or H < DWV_TILE or C % DWV_TILE or H % DWV_TILE:
        raise ValueError(f"dwv_plan needs K >= 1 and C, H positive multiples "
                         f"of {DWV_TILE}, got K={K}, C={C}, H={H}")
    bn = 256 if H % 256 == 0 else 128
    stages = 4 if bn == 256 else 5
    # A (128 channels), dzr (bn units) and the raw int8 codes of a chunk.
    stage = 2 * DWV_CHUNK * (DWV_TILE + bn) + (DWV_CHUNK * DWV_TILE
                                               if int8 else 0)
    tiles = (C // DWV_TILE) * (H // bn)
    chunks = -(-K // DWV_CHUNK)
    want = max(1, min(sms // tiles, chunks // DWV_MIN_CHUNKS))
    splits = -(-chunks // -(-chunks // want))  # no split left empty
    return {"tile": [DWV_TILE, bn], "stages": stages,
            "smem_bytes": 1024 + stages * stage, "splits": splits,
            "chunks_per_split": -(-chunks // splits),
            "grid": [H // bn, C // DWV_TILE, splits]}


SCORE_TILE = 128  # cells of a tile of score_gemm.cuh's mainloop (its rows)
SCORE_CHANNELS = 32  # C's multiple: half a 64-channel chunk is zero-filled
SCORE_UNITS = 128  # H's multiple: a tile's 128 or 256 units


def score_plan(B: int, N: int, C: int, H: int) -> dict:
    """The launch of the score tile of ``csrc/score_tile.cuh`` (K2's score
    launch; K4's score launch and K8's dz stage take the same tiles) for
    ``B`` questions of ``N`` cells at ``C`` channels (a multiple of
    ``SCORE_CHANNELS``) x ``H`` units (a multiple of ``SCORE_UNITS``):
    ``SCORE_TILE``-cell x BN-unit tiles over all B*N cells (BN 256 where it
    divides H, else 128), the ring's stages, the dynamic shared memory in
    bytes (the ring of 64-channel chunks of the rows and of W_v^T, 1024 B to
    align it and 4 B a tile row), the grid (unit tiles, fastest, then cell
    tiles) and ``n_part``, the partial scores a cell: one a unit tile,
    summed in order by the wsum launch. The C side
    (``attention_fwd_score_config``) derives the same launch and refuses
    another ``n_part``."""
    if (B < 1 or N < 1 or C < SCORE_CHANNELS or H < SCORE_UNITS
            or C % SCORE_CHANNELS or H % SCORE_UNITS):
        raise ValueError(f"score_plan needs B, N >= 1, C a positive multiple "
                         f"of {SCORE_CHANNELS} and H of {SCORE_UNITS}, got "
                         f"B={B}, N={N}, C={C}, H={H}")
    bn = 256 if H % 256 == 0 else 128
    stages = 4 if bn == 256 else 5
    return {"tile": [SCORE_TILE, bn], "stages": stages,
            "smem_bytes": 1024 + stages * 2 * 64 * (SCORE_TILE + bn)
            + 4 * SCORE_TILE,
            "grid": [H // bn, -(-(B * N) // SCORE_TILE)], "n_part": H // bn}


ATTENTION_BWD_LAUNCHES = 4  # K8 a call: dz, fold, dW_v GEMM, reduce


def dz_plan(B: int, N: int, C: int, H: int) -> dict:
    """The launch of K8's dz stage (``csrc/attention_bwd.cu``: the
    recomputed score GEMM on ``score_gemm.cuh``'s mainloop and its
    epilogue) for ``B`` questions of ``N`` cells at ``C`` x ``H``
    (multiples of 128): :func:`score_plan`'s tile, stages, dynamic shared
    memory and grid, then the epilogue's bytes inside the ring (the tile's
    f32 products, rows padded by 8 floats, then ds and r a cell) and the
    slots a tile: the most questions that one tile's cells can span,
    ceil(127 / N) + 1, at most B. Tile t's slot s holds the dqh and dws
    partials of question t * SCORE_TILE // N + s; ``partials`` is the shape
    [tiles, slots, H] of each of the two partial buffers, which the fold
    sums per question in tile order. The C side (``dz_shape``) derives the
    same launch and refuses other slots."""
    if (B < 1 or N < 1 or C < DWV_TILE or H < DWV_TILE or C % DWV_TILE
            or H % DWV_TILE):
        raise ValueError(f"dz_plan needs B, N >= 1 and C, H positive "
                         f"multiples of {DWV_TILE}, got B={B}, N={N}, C={C}, "
                         f"H={H}")
    plan = score_plan(B, N, C, H)
    del plan["n_part"]
    bn = plan["tile"][1]
    tiles = plan["grid"][1]
    slots = min(B, -(-(SCORE_TILE - 1) // N) + 1)
    return {**plan,
            "epilogue_bytes": 4 * (SCORE_TILE * (bn + 8) + 2 * SCORE_TILE),
            "slots": slots, "partials": [tiles, slots, H]}


ROWS_THREADS = 256  # threads of a block of the rows stage (K5, P2)
ROWS_UNITS = 8  # hidden units a thread of it takes (16 bytes of bf16)
SMEM_OPTIN = 232448  # dynamic shared memory a block of an H100 may take


def rows_plan(B: int, n_valid: int, G: int, C: int, H: int) -> dict:
    """The launch of K5's rows stage (``csrc/attention_rows.cuh``, the
    per-question pass; P2 takes its grid and threads) for ``B`` questions
    of ``n_valid`` cells, ``G`` glimpses (1..8), ``C`` channels and ``H``
    hidden units (multiples of ``DWV_TILE``, as K5 and P2 need): one block
    of ``ROWS_THREADS`` a question, whose dynamic shared memory holds the G
    bf16 cotangent rows [G, C], then ds [n_valid, G] and r [n_valid] in
    f32 (``ValueError`` above ``SMEM_OPTIN``); and the second pass's
    threads: ``cell_lanes`` neighbours of a warp (a power of two) take cells
    side by side for each ``ROWS_UNITS`` units, and ``unit_passes`` passes
    of at most ``ROWS_THREADS`` such groups cover H. The C side
    (``attn_rows::plan``) derives the same launch."""
    if (B < 1 or n_valid < 1 or not 1 <= G <= 8 or C < DWV_TILE
            or H < DWV_TILE or C % DWV_TILE or H % DWV_TILE):
        raise ValueError(f"rows_plan needs B, n_valid >= 1, 1 <= G <= 8 "
                         f"and C, H positive multiples of {DWV_TILE}, got "
                         f"B={B}, n_valid={n_valid}, G={G}, C={C}, H={H}")
    smem = 2 * G * C + 4 * (G + 1) * n_valid
    if smem > SMEM_OPTIN:
        raise ValueError(
            f"rows_plan: {n_valid} cells of G={G} glimpses at C={C} need "
            f"{smem} B of shared memory, over a block's {SMEM_OPTIN} B")
    lanes = min(H // ROWS_UNITS, ROWS_THREADS)
    cell_lanes = 1
    while 2 * cell_lanes * lanes <= ROWS_THREADS:
        cell_lanes *= 2
    return {"grid": [B], "threads": ROWS_THREADS, "smem_bytes": smem,
            "cell_lanes": cell_lanes,
            "unit_passes": -(-(H // ROWS_UNITS) // lanes)}


GRU_FWD_UNITS = 16  # hidden units a block of K1/K6 owns
GRU_FWD_ROWS = (16, 64)  # batch rows a block of K1/K6 takes, fewest first


def gru_fwd_plan(B: int, H: int, sms: int, per_sm: Mapping[int, int],
                 directions: int = 1) -> dict:
    """The launch of the persistent kernel of ``csrc/gru_fwd_step.cuh``
    (K1 with one direction, K6 with two) at batch ``B`` and width ``H`` (a
    multiple of 16) on a card of ``sms`` SMs, where ``per_sm[rows]`` of its
    blocks of each tiling of ``GRU_FWD_ROWS`` are resident per SM (0 where
    the block's shared memory does not fit): the batch ``rows`` a block
    takes, the b-tiles, the grid (H / 16 j-tiles, rows of blocks,
    directions a launch) and the ``launches`` a call. 16 rows where every
    b-tile of every direction is resident at once, since a step is shorter
    the fewer rows of h_prev a block reads; else 64 rows, where a row of
    every direction's j-tiles fits, with as many rows of blocks as fit
    beside each other, each walking b-tiles by, by + grid_y, ... in every
    step; else 16 rows the same way. Block (jx, by, d) takes direction d.
    Where no tiling has a row of both directions' j-tiles resident at once
    but one has a row of one direction's, the plan takes one direction a
    launch (grid z 1) and 2 launches, one a chain, of the same kernel.
    The grid is cooperative, so it never exceeds sms x per_sm[rows];
    where no tiling has even one direction's row of j-tiles resident it
    raises. The C side (``seq_grid``) derives the same grid from the rows
    passed to it."""
    if B < 1 or H < 16 or H % 16 or sms < 1 or directions not in (1, 2):
        raise ValueError(f"gru_fwd_plan needs B >= 1, H a positive multiple "
                         f"of 16, sms >= 1 and 1 or 2 directions, got B={B}, "
                         f"H={H}, sms={sms}, directions={directions}")
    jt = H // GRU_FWD_UNITS
    for z in range(directions, 0, -1):
        resident = {r: per_sm.get(r, 0) * sms // (z * jt)
                    for r in GRU_FWD_ROWS}
        fits = [r for r in GRU_FWD_ROWS if resident[r] >= 1]
        if fits:
            break
    else:
        raise ValueError(f"gru_fwd_plan: no tiling has a row of {jt} "
                         f"j-tiles resident at once at H={H} on {sms} SMs "
                         f"(blocks per SM by rows: {dict(per_sm)})")
    small = GRU_FWD_ROWS[0]
    rows = small if resident[small] >= -(-B // small) else fits[-1]
    tiles = -(-B // rows)
    return {"rows": rows, "b_tiles": tiles,
            "grid": [jt, min(tiles, resident[rows]), z],
            "launches": directions // z}


GRU_BWD_UNITS = 16  # hidden units a block of K3/K7's step kernel owns
GRU_BWD_ROWS = 64  # batch rows of a b-tile of K3/K7's step kernel


def gru_bwd_plan(B: int, H: int, sms: int, per_sm: int,
                 directions: int = 1) -> dict:
    """The launch of the persistent BPTT step kernel of
    ``csrc/gru_bwd_step.cuh`` (K3 with one direction, K7 with two) at
    batch ``B`` and width ``H`` (a multiple of 64) on a card of ``sms``
    SMs, ``per_sm`` of its blocks resident per SM: the 64-row b-tiles and
    the grid (H / 16 j-tiles, rows of blocks, directions). Every
    direction's j-tiles take as many rows of blocks as are resident beside
    each other, at most one per b-tile; block (jx, by, d) walks b-tiles by,
    by + rows, ... of direction d in every step. The grid is cooperative,
    so it never exceeds sms x per_sm blocks; where not even one row of
    every direction's j-tiles is resident at once it raises. The C side
    (``bptt_run``) derives the same grid from the rows passed to it."""
    if (B < 1 or H < 64 or H % 64 or sms < 1 or per_sm < 0
            or directions not in (1, 2)):
        raise ValueError(f"gru_bwd_plan needs B >= 1, H a positive multiple "
                         f"of 64, sms >= 1, per_sm >= 0 and 1 or 2 "
                         f"directions, got B={B}, H={H}, sms={sms}, "
                         f"per_sm={per_sm}, directions={directions}")
    jt = H // GRU_BWD_UNITS
    resident = per_sm * sms // (directions * jt)
    if resident < 1:
        raise ValueError(f"gru_bwd_plan: {directions} x {jt} j-tiles cannot "
                         f"be resident at once at H={H} on {sms} SMs with "
                         f"{per_sm} blocks per SM")
    tiles = -(-B // GRU_BWD_ROWS)
    return {"b_tiles": tiles,
            "grid": [jt, min(tiles, resident), directions]}


GRU_FWD_PAD = 16  # H's multiple of K1/K6 (both forms): a block's 16 units
GRU_BWD_PAD = 64  # H's multiple of K3/K7 (both forms): the dU_h GEMM's
GRU_STEP_PAD = 16  # H's multiple of the step form, forward and BPTT
GRU_STEP_TALL = 256  # rows of a forward or gh tile (batch rows, saved states)
GRU_STEP_ROWS = 128  # batch rows of a carry tile; of a forward block's cell
GRU_STEP_UNITS = 40  # units of a forward or gh tile: 3 x 40 of its 128 columns
GRU_STEP_CARRY_UNITS = 128  # units of a carry tile (one gate's product)
GRU_STEP_CLUSTER = 3  # blocks of a carry tile: one a gate
GRU_STEP_SPLIT = 2  # blocks of a forward tile: one a half of gh's K
GRU_STEP_DUH_TILE = 256  # the BPTT's copies of h and G pad H to this (dU_h)
# The widest H (padded to GRU_FWD_PAD) at which the forward takes the
# persistent K1/K6; above it the step form. chip_smoke.py's phase 30
# (widths_gru_crossover) times both at T = 26 in bf16 on an H100 80GB HBM3
# at 700 W (PERF.md §6), persistent / step ms at B = 256: 0.5759 /
# 0.5711 and 0.5916 / 0.5933 at 768, 0.5984 / 0.5979 and 0.6143 / 0.5801
# at 832, 1.5746 / 0.6062 and 1.5853 / 0.6028 at 896 (16-row blocks from
# 864 on), in two runs; at B = 64 the persistent K1 is the faster up to
# 1024 in both (0.3026-0.3072 / 0.4709-0.4820 at 832). At 832 the forms
# are within the runs' spread at B = 256 and the persistent K1 is a third
# faster at B = 64; past it the step form wins at both batches.
GRU_FWD_STEP_ABOVE = 832


def round_up(n: int, multiple: int) -> int:
    """``n`` rounded up to a multiple of ``multiple``."""
    return -(-n // multiple) * multiple


def gru_fwd_route(B: int, H: int, sms: int, per_sm: Mapping[int, int],
                  directions: int = 1) -> str:
    """The form of the 16-bit GRU forward (K1 with one direction, K6 with
    two) at batch ``B`` and width ``H`` (a multiple of ``GRU_FWD_PAD``) on
    a card of ``sms`` SMs with ``per_sm[rows]`` persistent blocks resident
    per SM by tiling (0 where a block's U_h slice does not fit in shared
    memory): "persistent" up to ``GRU_FWD_STEP_ABOVE`` units where
    :func:`gru_fwd_plan` plans a launch (some tiling has a row of one
    direction's H / 16 j-tiles resident at once), else "step", the form of
    ``csrc/gru_wide_step.cuh`` (one launch a timestep on ``wgmma``, U_h
    read through L2), which takes any such H. A function of the shapes and
    the occupancy alone."""
    if B < 1 or H < GRU_FWD_PAD or H % GRU_FWD_PAD or sms < 1 or (
            directions not in (1, 2)):
        raise ValueError(f"gru_fwd_route needs B >= 1, H a positive multiple "
                         f"of {GRU_FWD_PAD}, sms >= 1 and 1 or 2 directions, "
                         f"got B={B}, H={H}, sms={sms}, "
                         f"directions={directions}")
    jt = H // GRU_FWD_UNITS
    resident = any(per_sm.get(r, 0) * sms // jt >= 1 for r in GRU_FWD_ROWS)
    return ("persistent" if resident and H <= GRU_FWD_STEP_ABOVE
            else "step")


def gru_bwd_route(B: int, H: int, sms: int, per_sm: int,
                  directions: int = 1) -> str:
    """The form of the 16-bit GRU BPTT (K3 with one direction, K7 with
    two) at batch ``B`` and width ``H`` (a multiple of ``GRU_BWD_PAD``) on
    a card of ``sms`` SMs with ``per_sm`` persistent step blocks resident
    per SM (0 where U_h's slices and the ring do not fit in a block's
    shared memory, above H = 576 on an H100): "persistent" where
    :func:`gru_bwd_plan` plans a launch (a row of every direction's
    j-tiles resident at once), else "step", the launches of
    ``csrc/gru_wide_step.cuh``, which take any such H. A function of the
    shapes and the occupancy alone."""
    if B < 1 or H < GRU_BWD_PAD or H % GRU_BWD_PAD or sms < 1 or (
            per_sm < 0 or directions not in (1, 2)):
        raise ValueError(f"gru_bwd_route needs B >= 1, H a positive multiple "
                         f"of {GRU_BWD_PAD}, sms >= 1, per_sm >= 0 and 1 or 2 "
                         f"directions, got B={B}, H={H}, sms={sms}, "
                         f"per_sm={per_sm}, directions={directions}")
    jt = H // GRU_BWD_UNITS
    return ("persistent" if per_sm * sms // (directions * jt) >= 1
            else "step")


# The float32 GRU's persistent kernels (csrc/gru_seq_f32.cuh): K1f's
# recurrence and K3f's chain, a block of GRU_F32_THREADS owning
# GRU_F32_UNITS hidden units for the call and walking b-tiles of
# GRU_F32_ROWS rows; U_h's slice resident in its shared memory beside a
# ring of stages of the step's streamed operand (forward h_prev, chain g).
GRU_F32_UNITS = 16  # hidden units a block owns (tail units masked)
GRU_F32_ROWS = 64  # batch rows of a b-tile (tail rows masked)
GRU_F32_PAIR_ROWS = 128  # K6f's b-tile where a block would walk two of 64
GRU_F32_FWD_CHUNK, GRU_F32_FWD_STAGES = 64, 2  # h_prev columns a stage
GRU_F32_BWD_CHUNK, GRU_F32_BWD_STAGES = 32, 4  # g columns a stage
GRU_F32_FWD_THREADS, GRU_F32_BWD_THREADS = 256, 128  # a block
GRU_F32_BWD_LAUNCHES = 4  # K3f a call: gh, the chain, dU_h, db_hn


def gru_f32_smem(H: int, backward: bool = False,
                 rows: int = GRU_F32_ROWS) -> int:
    """The dynamic shared memory of a block of the float32 GRU's persistent
    kernel at width ``H`` with b-tiles of ``rows`` rows (the C side's
    ``fwd_smem`` / ``bwd_smem``): forward, U_h's 48 columns [48][H' + 4]
    with H' = H rounded up to a stage; backward (K3f's chain), U_h's 16
    rows [16][3H' + 4] with 3H' = 3H rounded up to a stage; then the ring
    [stages][rows][chunk + 4], all f32."""
    if H < 1:
        raise ValueError(f"gru_f32_smem needs H >= 1, got H={H}")
    if backward:
        cols, depth = GRU_F32_UNITS, round_up(3 * H, GRU_F32_BWD_CHUNK)
        chunk, stages = GRU_F32_BWD_CHUNK, GRU_F32_BWD_STAGES
    else:
        cols, depth = 3 * GRU_F32_UNITS, round_up(H, GRU_F32_FWD_CHUNK)
        chunk, stages = GRU_F32_FWD_CHUNK, GRU_F32_FWD_STAGES
    return 4 * (cols * (depth + 4) + stages * rows * (chunk + 4))


def gru_f32_route(B: int, H: int, sms: int, per_sm: int,
                  backward: bool = False, directions: int = 1) -> str:
    """The form of K1f (``backward`` False) or K3f at batch ``B`` and any
    width ``H`` with ``directions`` chains (2: K6f, K7f) on a card of
    ``sms`` SMs with ``per_sm`` persistent blocks resident per SM (the
    occupancy query's; 0 where a block's shared memory does not fit):
    "persistent" where :func:`gru_f32_plan` plans a launch (the block's U_h
    slice and ring within ``SMEM_OPTIN``, and a row of ceil(H / 16) unit
    tiles of every chain resident at once, else of one chain, which then
    takes a launch of its own), else "step", which takes any shape: one
    launch a timestep of ``csrc/gru_step_f32.cuh`` forward, the BPTT's
    step form of ``csrc/gru_bptt_f32.cuh`` backward (T + 4 launches,
    :func:`gru_f32_launches`). A function of the shapes and the occupancy
    alone."""
    if (B < 1 or H < 1 or sms < 1 or per_sm < 0
            or directions not in (1, 2)):
        raise ValueError(f"gru_f32_route needs B, H, sms >= 1, per_sm >= 0 "
                         f"and 1 or 2 directions, got B={B}, H={H}, "
                         f"sms={sms}, per_sm={per_sm}, "
                         f"directions={directions}")
    return ("persistent" if gru_f32_smem(H, backward) <= SMEM_OPTIN
            and _gru_f32_chains(H, sms, per_sm, directions)
            else "step")


def _gru_f32_chains(H: int, sms: int, per_sm: int, directions: int) -> int:
    """The chains one persistent launch takes: ``directions`` where a row of
    every chain's ceil(H / 16) unit tiles is resident at once, else 1
    where one chain's is, else 0."""
    jt = -(-H // GRU_F32_UNITS)
    for z in range(directions, 0, -1):
        if per_sm * sms // (z * jt) >= 1:
            return z
    return 0


def gru_f32_plan(B: int, H: int, sms: int, per_sm: int,
                 backward: bool = False, directions: int = 1,
                 per_sm_pair: int = 0) -> dict:
    """The persistent launch of K1f (``backward`` False) or of K3f's chain
    with ``directions`` chains (2: K6f, K7f's chain) at batch ``B`` and
    width ``H`` on a card of ``sms`` SMs, ``per_sm`` of its blocks resident
    per SM: the ``rows`` of a b-tile, the ``b_tiles``, the ``grid``
    (ceil(H / 16) unit tiles, rows of blocks, z chains a launch), its
    ``smem_bytes`` and ``threads`` a block and the ``launches`` a call:
    forward directions / z; backward 3 + directions / z (every step's gh
    of all chains, the chains' cooperative launches, dU_h and db_hn of all
    chains). z is ``directions`` where a row of every chain's unit tiles
    is resident at once, else 1: one launch a chain. Each unit tile takes
    as many rows of blocks as are resident beside each other, at most one
    per b-tile; block (jx, by, d) walks b-tiles by, by + rows, ... of chain
    d in every step. K6f (forward, two directions) takes b-tiles of
    ``GRU_F32_PAIR_ROWS`` rows (``FwdPairTile``: 8 rows x one unit's 3
    gates a thread, fewer shared loads an FFMA) where their block fits,
    ``per_sm_pair`` of them resident per SM with the same z, and a block's
    walk over them does no more than the 64-row walk's work (two 64-row
    b-tiles a 128-row one): at B = 256, H = 512 on an H100 each block
    takes one 128-row b-tile a step where it would take two of 64. The
    grid is cooperative, so it never exceeds sms x per_sm (per_sm_pair)
    blocks; where :func:`gru_f32_route` takes the step form it raises. The
    C side (``persist_grid``) derives the same grid from its own occupancy
    query for the rows it is given."""
    if gru_f32_route(B, H, sms, per_sm, backward, directions) != "persistent":
        raise ValueError(
            f"gru_f32_plan: no persistent launch at B={B}, H={H} on {sms} "
            f"SMs with {per_sm} blocks per SM ({gru_f32_smem(H, backward)} "
            f"B of shared memory a block, {SMEM_OPTIN} B at most)")
    jt = -(-H // GRU_F32_UNITS)
    z = _gru_f32_chains(H, sms, per_sm, directions)
    rows, smem = GRU_F32_ROWS, gru_f32_smem(H, backward)
    tiles = -(-B // rows)
    grid_y = min(tiles, per_sm * sms // (z * jt))
    pair_smem = gru_f32_smem(H, False, GRU_F32_PAIR_ROWS)
    resident = per_sm_pair * sms // (z * jt)
    if (not backward and directions == 2 and resident >= 1
            and pair_smem <= SMEM_OPTIN):
        pair_tiles = -(-B // GRU_F32_PAIR_ROWS)
        pair_y = min(pair_tiles, resident)
        if 2 * -(-pair_tiles // pair_y) <= -(-tiles // grid_y):
            rows, smem = GRU_F32_PAIR_ROWS, pair_smem
            tiles, grid_y = pair_tiles, pair_y
    chain_launches = directions // z
    return {"rows": rows, "b_tiles": tiles, "grid": [jt, grid_y, z],
            "smem_bytes": smem,
            "threads": (GRU_F32_BWD_THREADS if backward
                        else GRU_F32_FWD_THREADS),
            "launches": (GRU_F32_BWD_LAUNCHES - 1 + chain_launches
                         if backward else chain_launches)}


def gru_f32_launches(T: int, B: int, H: int, sms: int, per_sm: int,
                     backward: bool = False, directions: int = 1,
                     per_sm_pair: int = 0) -> int:
    """The launches a call over ``T`` steps of K1f (``backward`` False) or
    K3f, with ``directions`` 2 of K6f or K7f, at batch ``B`` and width
    ``H`` on a card of ``sms`` SMs with ``per_sm`` (``per_sm_pair``) blocks
    resident per SM: :func:`gru_f32_plan`'s where :func:`gru_f32_route`
    takes the persistent form; in the step form (every chain in each
    launch) T forward (``csrc/gru_step_f32.cuh``), and backward
    (``csrc/gru_bptt_f32.cuh``) the step lists, every live row-step's gh,
    one carry a step, dU_h and db_hn: T + 4."""
    if T < 1:
        raise ValueError(f"gru_f32_launches needs T >= 1, got T={T}")
    if gru_f32_route(B, H, sms, per_sm, backward, directions) == "step":
        return T + GRU_F32_STEP_BWD_LAUNCHES if backward else T
    return gru_f32_plan(B, H, sms, per_sm, backward, directions,
                        per_sm_pair)["launches"]


# The float32 BPTT's step form (csrc/gru_bptt_f32.cuh): the carry's block
# of GRU_F32_CARRY_THREADS owns GRU_F32_CARRY_LANES x TU units of one chain
# (TU from GRU_F32_CARRY_UNITS, :func:`gru_f32_carry_plan`) for every live
# row of a step, in passes of GRU_F32_CARRY_PASS list positions
# (:func:`gru_f32_carry_pass`: rows ty + 32 i of a pass, i below 1 .. 8,
# the fewest that cover it), its operands on a ring of
# GRU_F32_CARRY_STAGES stages of GRU_F32_CARRY_CHUNK k (more for a pass of
# fewer rows); two blocks an SM.
GRU_F32_STEP_BWD_LAUNCHES = 4  # besides the T carries: lists, gh, dU_h, db_hn
GRU_F32_CARRY_THREADS = 128
GRU_F32_CARRY_LANES = 4  # unit lanes: units tx + 4 e of the block's
GRU_F32_CARRY_PASS = 256  # list positions a pass: 32 row groups x 8 rows
GRU_F32_CARRY_CHUNK, GRU_F32_CARRY_STAGES = 32, 2
GRU_F32_CARRY_UNITS = (3, 5)  # units a thread: the C side's instances


def gru_f32_carry_pass(rows: int) -> Tuple[int, int]:
    """(row groups, rows a thread) of a carry pass over ``rows`` list
    positions (1 .. GRU_F32_CARRY_PASS): the threads / 4 row groups, each
    thread the fewest rows that cover the pass."""
    if not 1 <= rows <= GRU_F32_CARRY_PASS:
        raise ValueError(f"gru_f32_carry_pass: 1 .. {GRU_F32_CARRY_PASS} "
                         f"rows, got {rows}")
    groups = GRU_F32_CARRY_THREADS // GRU_F32_CARRY_LANES
    return groups, -(-rows // groups)


def gru_f32_carry_smem() -> int:
    """The carry block's dynamic shared memory (the C side's
    ``carry_smem``): the pass's row pointers, then the ring's stages of
    [pass rows + 4 x the most units a thread][chunk + 4] floats."""
    rows = GRU_F32_CARRY_PASS + GRU_F32_CARRY_LANES * max(
        GRU_F32_CARRY_UNITS)
    return (8 * GRU_F32_CARRY_PASS
            + 4 * GRU_F32_CARRY_STAGES * rows * (GRU_F32_CARRY_CHUNK + 4))


def gru_f32_carry_stages(rows: int) -> int:
    """The ring's stages in a pass of ``rows`` staged rows (the C side's
    ``stages``): as many stages of [rows + 4 x the most units a
    thread][chunk + 4] floats as the ring of :func:`gru_f32_carry_smem`
    holds, so a pass of few rows keeps as many bytes in flight as a whole
    one."""
    if not 1 <= rows <= GRU_F32_CARRY_PASS:
        raise ValueError(f"gru_f32_carry_stages: 1 .. {GRU_F32_CARRY_PASS}"
                         f" rows, got {rows}")
    pitch = GRU_F32_CARRY_CHUNK + 4
    umax = GRU_F32_CARRY_LANES * max(GRU_F32_CARRY_UNITS)
    ring = GRU_F32_CARRY_STAGES * (GRU_F32_CARRY_PASS + umax) * pitch
    return ring // ((rows + umax) * pitch)


def gru_f32_carry_plan(B: int, H: int, sms: int, directions: int = 1
                       ) -> dict:
    """The carry launch of the float32 BPTT's step form at batch ``B`` and
    width ``H`` with ``directions`` chains on a card of ``sms`` SMs: the
    ``units`` a thread (TU), the ``unit_tiles`` (ceil(H / 4 TU)), the
    ``grid`` (unit tiles, 1, directions: a block a chain), ``threads``,
    ``smem_bytes`` and the ring's ``stages`` at each pass height. A block
    takes every live row of its step, so the blocks' work is even; TU is
    the one of ``GRU_F32_CARRY_UNITS`` whose blocks take the least time on
    the busiest SM, ceil(blocks / sms) x TU, the narrower on a tie (more
    blocks to share an SM): at H = 2400 on 132 SMs 5 (120 blocks a chain),
    at 1100 3 for one chain, 5 for two."""
    if B < 1 or H < 1 or sms < 1 or directions not in (1, 2):
        raise ValueError(f"gru_f32_carry_plan needs B, H, sms >= 1 and 1 or "
                         f"2 directions, got B={B}, H={H}, sms={sms}, "
                         f"directions={directions}")
    lanes = GRU_F32_CARRY_LANES

    def cost(tu: int) -> Tuple[int, int]:
        blocks = directions * -(-H // (lanes * tu))
        return (-(-blocks // sms) * tu, tu)

    tu = min(GRU_F32_CARRY_UNITS, key=cost)
    tiles = -(-H // (lanes * tu))
    heights = {gru_f32_carry_pass(n)[1] * gru_f32_carry_pass(n)[0]
               for n in range(1, GRU_F32_CARRY_PASS + 1)}
    return {"units": tu, "unit_tiles": tiles, "grid": [tiles, 1, directions],
            "threads": GRU_F32_CARRY_THREADS,
            "smem_bytes": gru_f32_carry_smem(),
            "stages": {h: gru_f32_carry_stages(h) for h in sorted(heights)}}


def gru_f32_lists_ints(T: int, B: int) -> int:
    """The int32 scratch of the step form's lists at ``T`` steps and batch
    ``B`` (the C side's ``StepLists``): rows [T, B], the counts [T], the
    packed row-steps [max(T - 1, 1) B] and their count."""
    return T * B + T + max(T - 1, 1) * B + 1


def gru_f32_step_lists(lens, T: int) -> dict:
    """What the step form's lists launch (``gru_f32_lists_kernel``) writes
    for lengths ``lens`` [B] over ``T`` steps, in numpy: ``rows`` [T, B]
    (step t's live rows, t < lens[b], in ascending b, then its dead ones),
    ``cnt`` [T], the packed ``rowsteps`` (t - 1) B + b of every b live at
    step t = 1 .. T - 1 in that order, and their count ``m``. The forward chain reads entry
    r B + b as its step r + 1 (h_prev hseq[r]), the reverse chain as its
    step r (h_prev hseq[r + 1], not zero where b is live at step r + 1):
    the row-steps whose h_prev is not zero."""
    import numpy as np

    lens = np.asarray(lens, dtype=np.int64)
    B = lens.shape[0]
    if T < 1 or B < 1:
        raise ValueError(f"gru_f32_step_lists needs T, B >= 1, got T={T}, "
                         f"B={B}")
    live = np.arange(T)[:, None] < lens[None, :]  # [T, B]
    cnt = live.sum(axis=1)
    rows = np.stack([np.concatenate([np.flatnonzero(live[t]),
                                     np.flatnonzero(~live[t])])
                     for t in range(T)])
    steps = [(t - 1) * B + np.flatnonzero(live[t]) for t in range(1, T)]
    flat = np.concatenate(steps) if steps else np.zeros(0, np.int64)
    return {"rows": rows, "cnt": cnt, "rowsteps": flat, "m": len(flat)}


def gru_step_plan(T: int, B: int, H: int, backward: bool,
                  directions: int = 1) -> dict:
    """The launches of the step form (``csrc/gru_wide_step.cuh``) over
    ``T`` steps at batch ``B`` and width ``H`` (a multiple of
    ``GRU_STEP_PAD``).

    Forward: every step's ``grid`` (2 x ceil(H / 40), 256-row b-tiles,
    directions) in ``cluster``s of two along x: cluster (jx, by, d) takes
    the units 40 jx.. (the r, z and n columns of each: 120 of a tile's 128
    columns) and rows 256 by.. of direction d, block 2 jx + h one half h of
    gh's K (``split_k``: the K of half 0, half 1 the rest) and, with the
    halves' sums added, the cell of rows 256 by + 128 h ..; T launches a
    call, both directions in each.

    Backward: the copy of the pre-step states in the 16-bit type; the
    ``gh_grid`` of every step's gh at once (the forward's unit tiles by
    256-row tiles of the (T - 1) B saved states, at least one); one carry
    launch a step on ``grid`` (ceil(H / 128) unit tiles, 128-row b-tiles,
    3 x directions) in ``cluster``s of three along z, block (jx, by,
    3 d + g) the product of gate g for units 128 jx.. and rows 128 by.. of
    direction d and the gate backward of that tile's 16-row groups q with
    q % 3 == g (its dgh_n one partial of db_hn: ``partials`` a step); then
    the dU_h GEMM of each direction and the db_hn sum: T + 3 + directions
    launches a call. ``Hq``, H rounded up to ``GRU_STEP_DUH_TILE``, is the
    width of the BPTT's copies of the states and gate cotangents, whose
    zero units the dU_h GEMM's tiles take."""
    if T < 1 or B < 1 or H < GRU_STEP_PAD or H % GRU_STEP_PAD or (
            directions not in (1, 2)):
        raise ValueError(f"gru_step_plan needs T, B >= 1, H a positive "
                         f"multiple of {GRU_STEP_PAD} and 1 or 2 directions, "
                         f"got T={T}, B={B}, H={H}, directions={directions}")
    unit_tiles = -(-H // GRU_STEP_UNITS)
    if not backward:
        half0 = -(-H // (GRU_STEP_SPLIT * 64)) * 64
        return {"grid": [GRU_STEP_SPLIT * unit_tiles,
                         -(-B // GRU_STEP_TALL), directions],
                "cluster": [GRU_STEP_SPLIT, 1, 1],
                "split_k": half0, "launches": T}
    b_tiles = -(-B // GRU_STEP_ROWS)
    return {"Hq": round_up(H, GRU_STEP_DUH_TILE),
            "gh_grid": [unit_tiles,
                        max(1, -(-((T - 1) * B) // GRU_STEP_TALL)),
                        directions],
            "grid": [-(-H // GRU_STEP_CARRY_UNITS), b_tiles,
                     GRU_STEP_CLUSTER * directions],
            "cluster": [1, 1, GRU_STEP_CLUSTER],
            "partials": GRU_STEP_CLUSTER * b_tiles,
            "launches": T + 3 + directions}


# The widths of the 16-bit attention kernels (K2/K8 gathered, K4/K5
# resident): C and H are zero-padded to these multiples by the wrappers
# (ops/attention.py, ops/attention_resident.py), and a resident store's
# channels to STORE_CHANNELS once at upload.
ATTENTION_UNITS = SCORE_UNITS  # H's multiple of every 16-bit attention kernel
ATTENTION_FWD_CHANNELS = SCORE_CHANNELS  # C's of K2 and K4
ATTENTION_BWD_CHANNELS = DWV_TILE  # C's of K8 and K5 (the dW_v tile)
STORE_CHANNELS = DWV_TILE  # a resident store's channels: K4's and K5's


def store_channel_multiple(device: torch.device, dtype: torch.dtype) -> int:
    """The multiple a gather-free resident store's channel axis is padded
    to at upload: ``STORE_CHANNELS`` for a CUDA store that the 16-bit
    kernels K4/K5 (K4h/K5h) read, a bf16 or float16 model's, so that no
    call pads it; 1 (none) on the CPU and for a float32 model, whose
    kernels K4f/K5f take any C."""
    half = dtype in (torch.bfloat16, torch.float16)
    return STORE_CHANNELS if device.type == "cuda" and half else 1


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a kernel entry returned a CUDA error code (the entries
    return ``cudaGetLastError()`` right after their launches)."""
    if rc != 0:
        msg = lib.cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} at launch ({msg})")


def expect(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    """Raise unless ``x`` is a contiguous tensor of ``dtype`` and
    ``shape`` on ``device`` — what a kernel wrapper checks before it
    passes a pointer on."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# The dtypes every kernel takes: bf16 (K1-K8), float16 (K1h-K8h) and
# float32 (K1f-K8f), the model dtypes of config.py's dtype_of.
KERNEL_DTYPES = (torch.bfloat16, torch.float16, torch.float32)


def kernel_dtype(what: str, name: str, x: torch.Tensor) -> torch.dtype:
    """The dtype of ``x`` (named ``name``), which picks the kernel that
    ``what`` launches: bf16 (K1-K8), float16 (K1h-K8h) or float32
    (K1f-K8f). Another dtype raises ``TypeError`` naming the three."""
    if x.dtype not in KERNEL_DTYPES:
        names = ", ".join(str(d) for d in KERNEL_DTYPES)
        raise TypeError(f"{what}: {name} must be one of {names}, got "
                        f"{x.dtype}")
    return x.dtype


def name16(name: str, dtype: torch.dtype) -> str:
    """The library of the 16-bit kernel ``name`` for ``dtype``: ``name``
    itself in bf16, ``<name>_f16`` in float16 (the same source built with
    float16 as its element type, ``csrc/elem16.cuh``)."""
    return f"{name}_f16" if dtype == torch.float16 else name


F32_TILE = 128  # cells and units (channels) of a K4f/K5f/K8f product tile


def f32_dwv_splits(K: int, C: int, H: int, sms: int) -> int:
    """The splits of the K cells of K5f's and K8f's dW_v product: as many
    as fit two blocks of ``F32_TILE``-square tiles on each of ``sms`` SMs
    (one wave, no ragged second one), each split but the last keeping at
    least 512 cells, none empty under the C side's rule (a split takes
    ceil(K / splits) cells rounded up to 8). A function of the shapes and
    the card alone, so two calls sum in the same order."""
    tiles = -(-C // F32_TILE) * -(-H // F32_TILE)
    want = max(1, min(2 * sms // tiles, K // 512))
    return -(-K // (8 * -(-K // (8 * want))))


# The float32 attention products' tile loop (csrc/fp32_ring.cuh): K4f's and
# K2f's score launch, K8f's dz launch (A K-major: [cells, C] by the cell),
# K5f's and K8f's dW_v launch (A MN-major: the cells are k).
F32_RING_CHUNK = 16  # k a chunk
F32_RING_STAGES = 4  # chunks in the cp.async ring
F32_RING_WIDE_PITCH = F32_TILE + 4  # floats a k row of the widened A
F32_RING_SMEM_PER_SM = 233472  # an H100 SM's shared memory (228 KB)
F32_RING_BLOCK_RESERVED = 1024  # the runtime's share of it a block


def f32_copy_width(pitch_bytes: int, address: int) -> int:
    """The bytes a ``cp.async`` of the ring copies from rows ``pitch_bytes``
    apart starting at ``address``: the largest of 16, 8 and 4 that divides
    both, else 0 (the rows copied element by element, synchronously)."""
    for width in (16, 8, 4):
        if pitch_bytes % width == 0 and address % width == 0:
            return width
    return 0


def f32_ring_plan(elem_bytes: int, a_kmajor: bool, a_pitch_bytes: int,
                  a_address: int, b_pitch_bytes: int, b_address: int,
                  b_listed: bool = False) -> dict:
    """The launch plan of one product on ``csrc/fp32_ring.cuh``'s loop,
    from the shapes and the base addresses: A's rows of ``elem_bytes``
    elements (4 f32, 2 f16, 1 int8 codes) ``a_pitch_bytes`` apart from
    ``a_address``, K-major (``a_kmajor``: a cell's channels are k) or
    MN-major (the cells are k); B f32 [K, N] rows ``b_pitch_bytes`` apart
    from ``b_address``. Returns the copy widths ``a_width`` (16, 8, 4, or
    0: element by element) and ``b_width`` (16, 8 or 4), ``chunk`` and
    ``stages``, whether A is widened into its f32 slots (``a_widened``:
    all but f32 MN-major rows) and ``smem_bytes``, the block's dynamic
    shared memory (the C side's ``fp32_ring::Layout``, which refuses
    another plan): with ``b_listed`` (MN-major A only: the GRU's dU_h,
    whose B rows come through an index) a slot of B's row pointers a
    stage too. ``ValueError`` where B is not 4-byte aligned or two blocks
    would not fit on an SM."""
    if elem_bytes not in (1, 2, 4):
        raise ValueError(f"f32_ring_plan: rows of {elem_bytes}-byte "
                         "elements (f32, f16 or int8 codes only)")
    if b_listed and a_kmajor:
        raise ValueError("f32_ring_plan: B's rows come through an index "
                         "only beside MN-major A")
    wa = f32_copy_width(a_pitch_bytes, a_address)
    wb = f32_copy_width(b_pitch_bytes, b_address)
    if wb == 0:
        raise ValueError(f"f32_ring_plan: B's rows ({b_pitch_bytes} B "
                         f"apart from {b_address:#x}) are not f32-aligned")
    k, s, t = F32_RING_CHUNK, F32_RING_STAGES, F32_TILE
    widened = not (elem_bytes == 4 and not a_kmajor)
    smem = (s * (t * k * elem_bytes + k * t * 4)
            + (2 * k * F32_RING_WIDE_PITCH * 4 if widened else 0)
            + 8 * (t if a_kmajor else s * k)
            + (8 * s * k if b_listed else 0))
    if 2 * (smem + F32_RING_BLOCK_RESERVED) > F32_RING_SMEM_PER_SM:
        raise ValueError(f"f32_ring_plan: {smem} B of shared memory a block "
                         "leave no room for two blocks an SM")
    return {"a_width": wa, "b_width": wb, "chunk": k, "stages": s,
            "a_widened": widened, "smem_bytes": smem}
