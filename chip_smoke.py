#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper).

    python3 chip_smoke.py [--out results.json]

Run from the repository root. Phases (any failure exits non-zero):

1. the card's name and power limit; build every CUDA kernel of the port
   from ``vqa_transfer_externaldata_torch/csrc`` with nvcc (one process per
   source, all started together), timed, with each nvcc's own time;
2. K1 ``gru_fwd`` against its plain PyTorch version on the card
   (B=64, T=26, H=512, random lengths, forward and reverse);
3. K2 ``attention_fwd`` against its plain version on the card
   (B=64, N=196, C=2048, H=512, bf16, normalize on and off), two calls
   bit-equal, and its alpha and r bit-equal to K4's on the identity store
   (store v, rows 0..B-1: the same score tile of ``score_tile.cuh`` on the
   same rows);
4. K1 ``gru_fwd`` and K3 ``gru_bwd`` against their plain versions at the
   training shape (B=256, T=26, H=512, lengths 1..26, forward and
   reverse), both versions of K3 fed K1's hseq; the grid, resident blocks
   per SM and shared memory of K3's persistent step launch (against
   ``kernels.gru_bwd_plan``'s), and K1's
   persistent launch at the training and the serving batch (the grid that
   the C side derives from the plan's rows against
   ``kernels.gru_fwd_plan``'s);
5. K4 ``attention_resident_fwd`` and K5 ``attention_resident_bwd`` against
   their plain versions at the training shape (a 512-image store of
   200x2048 bf16 cells, 196 valid, B=256 with repeated rows, H=512),
   normalize on and off, K5 fed the same saved h; the shape of K4's score
   launch (tile, ring stages, shared memory, grid) and its nvcc time, of
   K5's dW_v launch (the same, and the split) against
   ``kernels.dwv_plan``, and of K5's rows launch (grid, threads, shared
   memory, the second pass's lanes at G=1 and G=8) against
   ``kernels.rows_plan``; then
   both at G=2 and G=8 glimpses on the same store;
6. K6 ``bigru_fwd`` and K7 ``bigru_bwd`` against their plain versions at
   the stage-1 shape (B=256, T=26, H=512, lengths 1..26), and against two
   K1 calls and two K3 calls on the same inputs (K7 fed K6's hseqs); K6's
   persistent launch (grid, launches, resident blocks per SM, shared
   memory) against ``kernels.gru_fwd_plan``'s with two directions, and
   K7's against ``kernels.gru_bwd_plan``'s; what ptxas reports for the
   persistent forward kernel of K1's and K6's builds and for the
   persistent step kernel of K3's and K7's (registers, spills, warnings);
7. K2's checks of phase 3 at the gathered training shape (B=256, N=196,
   C=2048, H=512); K8 ``attention_bwd`` against its plain version there
   (normalize on and off, both fed the same ds and K2's r), and the
   gathered op's gradients under K8 against the explicit backward;
8. full-width ``vqa_attention`` serving through ``Predictor`` at batch 64:
   host-feature requests, a padded short request, and ids-only requests
   against a staged 256-image store; launch counts of K1 and K2 over that
   run; logits against the plain path on the card;
9. full-width stage-2 training through ``Trainer.fit_resident`` at batch
   256 on ``synthetic_vqa_joined`` (4096 questions over 512 images, a
   0.42 GB bf16 store) with the lagged in-loop evaluation of a
   1024-question val split every 10 steps and a checkpoint every 10 (2
   kept): the first step's loss and gradients against the plain path on
   the card, launch counts of K1 and K3-K5 over the run, finite losses,
   median step time and questions/s, the val records, the checkpoints
   kept, a profiler window over 5 more steps of ``fit_resident``; then the
   resident evaluator (K4) against the streamed ``evaluate`` (K2),
   ``cli.eval`` on the run directory (its ``results_val.json`` and its
   ``vqa_accuracy`` against ``evaluate_split``), and the trained
   ``params_final.pt`` served by ``Predictor``;
10. the same training on the gathered resident path
   (``train.resident_fused_attention`` false: K1, K2, K3, K8): first step
   against the plain path, launch counts, step times, a profiler window,
   then 10 steps with the explicit backward and 10 with K8 (the A/B);
11. streamed training through ``cli.train`` (``train.device_data_cache``
   false, the flat layout, 1024 questions of float32 grids, 10 steps):
   finite losses, launch counts, step times;
12. full-width stage-1 training of ``vlmap_description`` with the
   bidirectional phrase encoder through ``Trainer.fit_resident`` at batch
   256 on ``synthetic_vlmap_desc`` (4096 regions, 512 candidates): the
   first step's loss and gradients against the plain path on the card,
   launch counts of K6 (one a step) and K7 (and none of K1/K3) over the
   run, finite
   losses, median step time and regions/s and a profiler window over 5
   more steps; then 10 steps with the dense candidate loss (finite
   losses, first-step loss against the plain path, launch counts);
13. the transfer: stage 1's ``params_final.pt`` through ``cli.train
   --train.pretrained_param_path`` into full-width stage-2 training of
   ``vqa_attention`` (1024 questions, 10 steps, the transferred tables
   frozen): the word table arrives bit for bit and every answer row is
   its word's row; finite losses; launch counts of K1 and K3-K5;
14. ``vqa_attention2`` (two glimpses) at full width through
   ``Trainer.fit_resident`` at batch 256 on the gather-free store (K1, K3,
   K4 and K5 at G=2), 30 steps: the first step against the plain path,
   launch counts, finite losses, step times, a profiler window over 5
   more steps; the resident evaluator (K4 at G=2) against the gathered one
   (``spatial_attention_multi``) on the 1024-question val split; requests
   served through ``Predictor``;
15. ``vqa_baseline`` through ``cli.train`` (resident, pool5 on the device,
   no grid; 1024 questions, 10 steps) transfer-initialized from stage 1's
   parameters with the word table frozen: the table arrives bit for bit
   and the warning that the answer-space half does not apply is logged;
   no kernel launches; a profiler window over 5 steps of
   ``fit_resident``; ``cli.eval`` on the run; requests served with pool5
   through ``cli.predict`` from a feature store file;
16. K4 and K5 on int8 rows (the codes of phase 5's store, normalized
   per cell and quantized with one global scale) at G=1, 2 and 8 against
   their plain versions on the same codes, and the op on the int8 store
   against the op on the bf16 store of the same normalized grid (v_att's
   relative quantization error);
17. stage-2 training with ``train.store_quantize int8`` at full width
   through ``Trainer.fit_resident`` (the main path's corpus, steps and
   lagged in-loop evaluation): the first step against the plain path on
   the same int8 store, launch counts of K1, K3 and the int8 K4/K5,
   finite losses, step times, a profiler window over 5 more steps, the
   uploaded store's bytes against the bf16 store's; then the resident
   evaluator on the int8 val store against the one on a bf16 store;
18. the H100 probes P1 (``tools.probe_mxu_rows``, Q = 1..4) and P2
   (``tools.probe_bwd_ceiling``) through their ``run()`` entries: each
   against its plain version, its time, TFLOP/s and cuBLAS's time;
19. times: each kernel, its plain version and the PyTorch library call
   where there is one (median of CUDA-event timings after warm-up, L2
   flushed between runs), and the bound from this run's shapes; K1 at
   the training batch and at the serving batch, each also at T=1 for its
   time a step, and K1's two tilings (16 and 64 rows a block) against each
   other at B = 1, 8, 64 and 256 (bit-equal), and K6's at B = 8, 64 and
   256 (bit-equal); K4 and K5 at G=1 and
   G=2 on bf16 rows and at G=1 on int8 rows, and K4's score launch alone
   at G=1 (its device time from the profiler) with its TFLOP/s; the dW_v
   launch alone (``attention_dwv.cuh``) inside K5 at G=1 on bf16 and int8
   rows and inside K8, with its TFLOP/s, beside cuBLAS on the same product
   (the rows gathered apart, the gather timed); K8's dz launch alone (the
   recomputed score GEMM on ``score_gemm.cuh``'s mainloop with a dense row
   source) with its TFLOP/s and bound, beside cuBLAS on the same [B*N, C]
   x [C, H] product; K2 at B=8 (the Predictor's default batch), 64 and
   256 (phase 7's inputs), with its bound, its score launch alone (the
   score tile of ``score_tile.cuh``) at each batch, and at B=256 its
   TFLOP/s and bound beside cuBLAS on the same product (the dz launch's)
   and its wsum launch alone beside its bytes bound; the rows launch alone
   (``attention_rows.cuh``) inside K5 at G=1, 2 and 8 on bf16 rows and at
   G=1 on int8 rows and inside P2, each beside its bytes bound; the
   gathered op's whole backward with K8 and with the explicit math; K6
   against two K1 calls and K7 against two K3 calls on phase 6's inputs,
   each in turns in one call (each pair runs one persistent body, K6 and
   K7 both chains in one launch);
20. the real-data path at full width through the port's entry points:
   official-schema VQA v2 JSON (4096 train and 1024 val questions over
   512 COCO-like image ids, more than 2000 distinct answers, 10% of the
   answer table held out of training), Visual Genome region descriptions
   (4096 regions over the same images), a 300-d GloVe text file for every
   other word, and two raw feature stores (512 images of 14x14x2048 f16
   grids; 4096 regions, pool5 with a 1x1 grid), all written from a seed;
   the three ``cli.preprocess`` subcommands (timed); ``cli.train`` stage 1
   (``vlmap_description``, bidirectional, streamed with resampled
   negatives: K6/K7) and stage 2 transfer-initialized from it (gather-free
   resident with its lagged in-loop evaluation: K1/K3/K4/K5), each with
   its first step against the plain path, launch counts and median step;
   ``cli.eval`` on host batches (K1/K2: ``results_val.json`` answers every
   val question, the per-type and OOV accuracies, the types' weighted mix
   equal to the overall accuracy) and ``cli.predict`` on three val
   questions by image id (K1/K2) against ``Predictor``;
21. the paper's OOV-answer claim (the CPU test's protocol) at the
   smallest widths every kernel takes in bf16: stage 1 ``vlmap``, the
   transfer, stage 2 from the transferred and from a fresh answer table
   (frozen; K1/K3/K2/K8), launch counts, JAX's thresholds;
22. the raw-image model ``vqa_end2end`` at full width (ResNet-101 at 448
   pixels, bf16, config.py's head), its weights from a seeded
   torchvision-format checkpoint the phase writes: the backbone alone at
   batch 32 against the same weights in float32 on the card, its time,
   images/s, conv MACs and bound; ``cli.train`` on 512 synthetic uint8
   images held on the card (``train.device_data_cache``, batch 32, 10
   steps; the checkpoint grafted by ``load_resnet_backbone``) with its
   first step against the plain path, launch counts (K1, K3, K2, K8), the
   backbone's parameters and BatchNorm statistics unchanged, a profiler
   window over 5 steps; ``cli.eval`` on the run (the resident evaluator:
   K1/K2) and ``Predictor`` on 8 uint8 images (K1/K2, logits against the
   plain path, p50); then, where PIL imports, seeded JPEGs through
   ``cli.extract`` (whole images and ``--regions`` crops, read back with
   ``FeatureStore``), ``cli.train`` streamed through
   ``ImageQuestionDataset`` and ``cli.predict --image``.

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores
# and HBM3 bandwidth. The bound of a kernel is the larger of its bytes over
# the memory rate and its operations over the peak for their type.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# Tolerances (max abs error, kernel vs its plain version on the card):
# K1: h in (-1, 1). Sums of 512 products run in another order, and when the
#     f32 state differs in its last bit its bf16 rounding ahead of the
#     hidden matmul can flip, moving one product by one bf16 ulp.
TOL_GRU = 2e-3
# K2 alpha (~1/196 each): f32 sums of 2048 products in another order.
TOL_ALPHA = 1e-5
# K2 v_att, relative to max|v_att| of the plain version, in each normalize
#     mode: the weights w = p*r are rounded to bf16, and where the f32 p*r
#     differ in their last bit a weight may round the other way, moving its
#     term w*v/d by one bf16 ulp, at most 2^-7 of the term. As v >= 0 every
#     term is at most v_att; the limit lets flipped terms carry 1/8 of it.
TOL_VATT_REL = 2.0 ** -10
# K2's per-cell norm r (the residual K8 reuses), relative to max|r|: the
#     same bf16 squares summed in f32 in another order.
TOL_R_REL = 1e-6
# Logits (cos * 10 + bias): activations are bf16 between layers, so a last-
#     bit difference out of a kernel can flip a bf16 rounding (2^-8) that the
#     following layers carry to the logits.
TOL_LOGITS = 5e-2

# K3 (dgx, dU_h, db_hn), relative to the largest |value| of each plain
#     output: the step recomputes gh with sums in another order, so a gate
#     cotangent may round to the other bf16 neighbour (2^-8 of itself)
#     ahead of the U_h^T product and dU_h, and the carried dh picks such
#     flips up step after step. A wrong step, gate or mask moves an output
#     by a large share of the largest value.
TOL_K3_REL = 2.0 ** -8
# K4's saved h, relative to max|h|: h is stored in bf16, and where the f32
#     z differs in its last bits h rounds to the neighbouring bf16 value,
#     at most 2^-8 of itself. (v_att and alpha as K2's.)
TOL_K4_H_REL = 2.0 ** -7
# K5 (dqh, dW_v, dws), relative to the largest |value| of each plain
#     output, both fed the same saved h and alpha: dalpha differs by the
#     order of 2048-term sums, and dz * r is rounded to bf16 ahead of the
#     dW_v product, where a last-bit difference flips one rounding (2^-8 of
#     one of the 50176 terms of a sum).
TOL_K5_REL = 2.0 ** -9
# K4/K5 with G glimpses. Each glimpse's softmax and weighted sum is the
#     single glimpse's computation with its own score column, and h does not
#     depend on G: alpha, h and each glimpse's v_att (relative to its own
#     max|v_att_g|) keep K4's limits, and each column of dws K5's 2^-9. dz
#     sums G glimpse terms before dqh and the one bf16(dz * r) ahead of
#     dW_v: each term may carry its own last-bit differences while the
#     largest value grows more slowly than their sum, so dqh and dW_v get G
#     times K5's limit (2^-6 at G=8; a wrong glimpse moves them by a large
#     share of their largest value).
GLIMPSE_CHECKS = (2, 8)
# K8 (dqh, dW_v, dws) against its plain version, fed the same ds and r:
#     K5's 2^-9 of each output's largest value, plus, entry by entry, what
#     units whose recomputed z lies within rounding of 0 can move it (each
#     version may put such a unit on the other side of the ReLU:
#     k8_allowance).
TOL_K8_REL = 2.0 ** -9
# Training, first step, kernels against the plain path on the card (same
#     dropout mask): the loss (about ln 2000 = 7.6) to 1e-2 absolute, as
#     last-bit differences out of the kernels ride through bf16 activations
#     and average over 256 questions; each parameter's gradient to cosine
#     0.999 (bf16 rounding flips move single entries by 2^-8 of themselves
#     and a ReLU unit at 0 may take the other side), the scalar
#     logit_scale to 1e-2 relative.
TOL_LOSS = 1e-2
GRAD_COS = 0.999
TOL_SCALAR_REL = 1e-2

B, T, H, D = 64, 26, 512, 300
GRID, C = 14, 2048
N = GRID * GRID
STORE_ROWS = 256
RUNS = 25
# Training: batch, synthetic corpus, and steps (warm-up, then timed).
B_TRAIN = 256
TRAIN_QUESTIONS, TRAIN_IMAGES = 4096, 512
WARMUP_STEPS, TIMED_STEPS, PROFILE_STEPS = 5, 25, 5
# Stage 1: regions of synthetic_vlmap_desc (bench_all.py's size), steps of
# the dense-loss run; the transfer's stage-2 run: questions and steps.
STAGE1_REGIONS, DENSE_STEPS = 4096, 10
TRANSFER_QUESTIONS, TRANSFER_STEPS = 1024, 10
# Stage-2 evaluation: the val split, the in-loop cadence and the checkpoints
# kept; the gathered path's backward A/B (steps each way); streamed
# training (questions of the flat layout, ~1.6 GB of float32 grids, steps).
VAL_QUESTIONS, EVAL_EVERY, KEEP_CHECKPOINTS = 1024, 10, 2
AB_STEPS = 10
STREAM_QUESTIONS, STREAM_STEPS = 1024, 10
# The probes' timed launches (the TPU probes' count).
PROBE_ITERS = 96
# vqa_baseline: questions of its corpus, its steps, and the images of the
# feature store file cli.predict reads.
BASELINE_QUESTIONS, BASELINE_STEPS, PREDICT_IMAGES = 1024, 10, 8
# Config overrides of the serving and training runs: none, the full width
# of config.py. (A rehearsal on the CPU shrinks the shapes above and here.)
MODEL_OVERRIDES: dict = {}
STAGE1_MODEL = {"model.model": "vlmap_description",
                "model.bidirectional_desc": True}
KERNELS = ["gru_fwd", "attention_fwd", "gru_bwd", "attention_resident_fwd",
           "attention_resident_bwd", "bigru_fwd", "bigru_bwd",
           "attention_bwd", "probe_mxu_rows", "probe_bwd_ceiling"]
# K4 and K5 on int8 rows: the glimpse counts checked against the plain
# versions (the limits are the bf16 rows', as the codes widen exactly to
# bf16), and the bound on v_att's relative quantization error against the
# bf16 store of the same grid (JAX's tests hold it under 1%; its config
# expects about 0.4%).
INT8_GLIMPSES = (1, 2, 8)
INT8_VATT_REL = 1e-2
# The profiler's name of the score tile of score_tile.cuh: K2's score
# launch and K4's.
SCORE_KERNEL = "score_tile::kernel"
# K2's whole call is also timed at the Predictor's default batch.
B_PREDICT = 8
# The real-data phase: VQA v2 questions (train, val) over COCO-like image
# ids, Visual Genome regions over the same images, the words the fixtures
# draw from and the distinct "other" answers of the train split (with
# yes/no and 0-10, more than REAL_TOP_K, so the answer table fills), the
# answers held out of training, each stage's steps, the in-loop cadence of
# stage 2 and the questions cli.predict answers.
REAL_TRAIN_QUESTIONS, REAL_VAL_QUESTIONS = 4096, 1024
REAL_IMAGES, REAL_REGIONS = 512, 4096
REAL_WORDS, REAL_OTHER_ANSWERS = 2400, 2300
REAL_TOP_K, REAL_HOLDOUT = 2000, 0.1
REAL_STAGE1_STEPS, REAL_STAGE2_STEPS, REAL_EVAL_EVERY = 10, 20, 10
REAL_PREDICT = 3
# The OOV phase: tools/oov_claim.py's protocol (the JAX tests' tiny config,
# 200 steps at batch 64 a stage) at the smallest widths every kernel
# wrapper takes in bf16: GRU 64 (K3: H % 64), attention hidden 128 and
# channels 128 (K2: H % 128, C % 32; K8: both % 128). The corpus is drawn
# at the tiny config's 32 channels and zero-padded: drawn at 128, its 21
# in-vocabulary concepts span a sixth of the space, and no map learned
# from them reaches the held-out answers (PERF.md §6).
OOV_WIDTHS = {"data.feature_dim": 128, "data.pool5_dim": 128,
              "model.rnn_dim": 64, "model.att_hidden": 128,
              "model.dtype": "bfloat16"}
OOV_CONCEPT_DIM = 32
# The raw-image phase (vqa_end2end): ResNet-101 (stages, stem width) at 448
# pixels in bf16 (a 14x14x2048 grid), the backbone's batch and its seed;
# the synthetic corpus (one uint8 image a question: 512 x 448 x 448 x 3 =
# 308 MB on the card), the training batch and steps, the serving batch;
# and the JPEG fixtures (if PIL imports on the card): images, region
# crops, streamed training steps.
E2E_STAGES, E2E_WIDTH, E2E_SIZE = "3,4,23,3", 64, 448
E2E_BATCH, E2E_IMAGES, E2E_STEPS, E2E_PREDICT = 32, 512, 10, 8
E2E_JPEGS, E2E_REGIONS, E2E_JPEG_STEPS = 64, 96, 4
# The backbone's bf16 grid and pool5 against the same weights in float32
#     on the card (TF32 off). Each of the 104 convolutions rounds its
#     output to bf16 (an error up to 2^-9 of a value, either sign), and the
#     residual chain carries these like a random walk: about sqrt(104) x
#     2^-9 / sqrt(3) = 1.2% of a value (measured on the CPU at 128 pixels:
#     0.85% in the mean, 1.1% of the largest entry, cosine 0.99996). The
#     limits are twice that and more: the mean |error| 2^-5 of the mean
#     |value|, the largest 2^-4 of the largest |value|, cosine 0.999. A
#     wrong layer (a dropped BatchNorm, a stride, a stem tap) moves the grid
#     by a large share of itself.
TOL_BACKBONE_MEAN, TOL_BACKBONE_MAX, BACKBONE_COS = 2.0 ** -5, 2.0 ** -4, 0.999


class PhaseError(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise PhaseError(msg)


def flush_l2(buf) -> None:
    buf.zero_()  # 128 MB write: evicts the 50 MB L2 between timed runs


def time_cuda(fn, buf, runs: int = RUNS, warmup: int = 3) -> float:
    """Median ms of ``fn()`` over ``runs`` CUDA-event timings."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        flush_l2(buf)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def bound(nbytes: float, flops: float) -> tuple:
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def plain_kernels():
    """Route the kernel wrappers to their plain versions (for the reference
    runs of the whole model on the card)."""
    from vqa_transfer_externaldata_torch.ops import (
        attention, attention_resident as ar, gru)

    saved = (attention.attention_fwd, gru.gru_fwd, gru.gru_bwd,
             ar.attention_resident_fwd, ar.attention_resident_bwd,
             gru.bigru_fwd, gru.bigru_bwd, attention.attention_bwd)
    attention.attention_fwd = (
        lambda v, qh, wv, ws, *, normalize:
        attention.attention_fwd_reference(v, qh, wv, ws, normalize))
    attention.attention_bwd = attention.attention_bwd_reference
    gru.gru_fwd = gru.gru_reference
    gru.gru_bwd = gru.gru_bwd_reference
    ar.attention_resident_fwd = ar.attention_resident_fwd_reference
    ar.attention_resident_bwd = ar.attention_resident_bwd_reference
    gru.bigru_fwd = gru.bigru_reference
    gru.bigru_bwd = gru.bigru_bwd_reference
    try:
        yield
    finally:
        (attention.attention_fwd, gru.gru_fwd, gru.gru_bwd,
         ar.attention_resident_fwd, ar.attention_resident_bwd,
         gru.bigru_fwd, gru.bigru_bwd, attention.attention_bwd) = saved


def launch_counters():
    """{kernel name: (its wrapper, the wrapper's count attribute)}. K4 and
    K5 count their launches on int8 rows apart."""
    from vqa_transfer_externaldata_torch.ops import (
        attention, attention_resident as ar, gru)
    from vqa_transfer_externaldata_torch.tools import (
        probe_bwd_ceiling as p2, probe_mxu_rows as p1)

    plain = {"gru_fwd": gru.gru_fwd, "attention_fwd": attention.attention_fwd,
             "gru_bwd": gru.gru_bwd,
             "attention_resident_fwd": ar.attention_resident_fwd,
             "attention_resident_bwd": ar.attention_resident_bwd,
             "bigru_fwd": gru.bigru_fwd, "bigru_bwd": gru.bigru_bwd,
             "attention_bwd": attention.attention_bwd,
             "probe_mxu_rows": p1.probe_mxu_rows,
             "probe_bwd_ceiling": p2.probe_bwd_ceiling}
    out = {name: (fn, "launches") for name, fn in plain.items()}
    for name in ("attention_resident_fwd", "attention_resident_bwd"):
        out[f"{name}[int8]"] = (plain[name], "launches_int8")
    return out


def reset_counts() -> None:
    for fn, attr in launch_counters().values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {name: getattr(fn, attr)
            for name, (fn, attr) in launch_counters().items()}


def check_launches(launches: dict, expected: dict, what: str) -> None:
    """``expected`` lists the kernels that ``what`` must launch, with their
    counts; every other kernel must not have launched."""
    want = {name: expected.get(name, 0) for name in launches}
    print(f"{what} launches: {launches}")
    check(launches == want, f"{what}: expected launches {want}, got "
          f"{launches}")


def rel_err(got, want) -> float:
    return ((got - want).abs().max().item()
            / max(want.abs().max().item(), 1e-30))


def phase_build(report: dict) -> None:
    from vqa_transfer_externaldata_torch.ops import kernels

    t0 = time.perf_counter()
    built = kernels.build(KERNELS)
    report["build_s"] = time.perf_counter() - t0
    for name, (text, _) in built.items():
        print(f"--- nvcc {name}.cu ---\n{text.strip()}", file=sys.stderr)
    report["ptxas"] = {name: text for name, (text, _) in built.items()}
    report["nvcc_s"] = {name: s for name, (_, s) in built.items()}
    print(f"built kernels in {report['build_s']:.1f} s (nvcc per source, "
          "all started together: " + ", ".join(
              f"{name} {s:.1f} s" for name, s in report["nvcc_s"].items())
          + ")")


def bptt_launch(config, batch: int, dev, what: str) -> dict:
    """The persistent BPTT step launch of K3 or K7 at ``batch`` x H
    (``kernels.gru_bwd_plan`` on the blocks per SM that the C side
    reports), printed."""
    launch = config(batch, H, dev)
    print(f"{what} persistent step launch at B={batch}, H={H}: grid "
          + " x ".join(map(str, launch["grid"])) + " blocks of 256 threads "
          f"(j-tiles x rows x directions) over {launch['b_tiles']} b-tiles, "
          f"{launch['blocks_per_sm']} resident per SM, "
          f"{launch['smem_bytes']} B of dynamic shared memory, H <= "
          f"{launch['max_width']}")
    return launch


def ptxas_entry(text: str, kernel: str) -> list:
    """The lines of an ``nvcc -Xptxas -v`` report about the entry function
    whose mangled name holds ``kernel`` (registers, spills, warnings)."""
    out, inside = [], False
    for line in text.splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line
        if inside or (kernel in line and "warning" in line.lower()):
            out.append(line.strip())
    return out


def phase_gru(report: dict, dev, gen) -> dict:
    import torch
    from vqa_transfer_externaldata_torch.ops import gru

    gx = torch.randn(T, B, 3 * H, generator=gen, device=dev) * 0.5
    lens = torch.randint(1, T + 1, (B,), generator=gen, device=dev,
                         dtype=torch.int32)
    lim = (6.0 / (4 * H)) ** 0.5  # glorot scale of U_h [H, 3H]
    uh = ((torch.rand(H, 3 * H, generator=gen, device=dev) * 2 - 1) * lim
          ).to(torch.bfloat16)
    bhn = torch.randn(H, generator=gen, device=dev) * 0.1
    err = 0.0
    for reverse in (False, True):
        hT, hseq = gru.gru_fwd(gx, lens, uh, bhn, reverse=reverse)
        rT, rseq = gru.gru_reference(gx, lens, uh, bhn, reverse=reverse)
        torch.cuda.synchronize()
        e = max((hT - rT).abs().max().item(), (hseq - rseq).abs().max().item())
        print(f"K1 gru_fwd reverse={reverse}: max abs err {e:.3e} "
              f"(tol {TOL_GRU})")
        check(bool(torch.isfinite(hseq).all()), "K1 output not finite")
        check(e <= TOL_GRU, f"K1 reverse={reverse} err {e} > {TOL_GRU}")
        err = max(err, e)
    return {"gx": gx, "lens": lens, "uh": uh, "bhn": bhn, "err": err}


def k2_checks(v, qh, wv, ws) -> list:
    """K2 against its plain version on v [B, N, C], normalize on and off;
    a second call bit-equal to the first; and K4 on the identity store
    (store v, rows 0..B-1, every cell valid, one glimpse), which runs the
    same score tile of score_tile.cuh on the same rows in the same order,
    giving K2's alpha and r bit for bit."""
    import torch
    from vqa_transfer_externaldata_torch.ops import (
        attention, attention_resident as ar)

    Bq, Nq = v.shape[:2]
    rows = torch.arange(Bq, dtype=torch.int32, device=v.device)
    checks = []
    for normalize in (True, False):
        va, al, r = attention.attention_fwd(v, qh, wv, ws,
                                            normalize=normalize)
        again = attention.attention_fwd(v, qh, wv, ws, normalize=normalize)
        _, al4, _, r4 = ar._launch_fwd(v, rows, qh, wv, ws, Nq, normalize,
                                       False)
        rv, ra, rr = attention.attention_fwd_reference(v, qh, wv, ws,
                                                       normalize)
        torch.cuda.synchronize()
        ev = (va - rv).abs().max().item()
        ea = (al - ra).abs().max().item()
        er = rel_err(r, rr)
        tol_v = TOL_VATT_REL * rv.abs().max().item()
        same = all(torch.equal(a, b) for a, b in zip((va, al, r), again))
        k4_alpha, k4_r = torch.equal(al, al4), torch.equal(r.reshape(-1), r4)
        print(f"K2 attention_fwd B={Bq} normalize={normalize}: max abs err "
              f"v_att {ev:.3e} (tol {tol_v:.3e} = 2^-10 * max|v_att|), "
              f"alpha {ea:.3e} (tol {TOL_ALPHA}), r {er:.3e} of max|r| (tol "
              f"{TOL_R_REL:.0e}); two calls bit-equal {same}; alpha and r "
              f"bit-equal to K4's on the identity store {k4_alpha} {k4_r}")
        check(er <= TOL_R_REL, f"K2 normalize={normalize} r err {er}")
        check(bool(torch.isfinite(va).all() and torch.isfinite(al).all()),
              "K2 output not finite")
        check(ev <= tol_v, f"K2 normalize={normalize} v_att err {ev} > "
              f"{tol_v}")
        check(ea <= TOL_ALPHA, f"K2 normalize={normalize} alpha err {ea} > "
              f"{TOL_ALPHA}")
        check(same, f"K2 B={Bq} normalize={normalize}: two calls differ")
        check(k4_alpha and k4_r, f"K2 B={Bq} normalize={normalize}: alpha "
              f"({k4_alpha}) or r ({k4_r}) differs from K4's on the "
              "identity store")
        checks.append({"batch": Bq, "normalize": normalize, "v_att_err": ev,
                       "v_att_tol": tol_v, "alpha_err": ea,
                       "alpha_tol": TOL_ALPHA, "r_rel_err": er,
                       "r_rel_tol": TOL_R_REL, "two_calls_bit_equal": same,
                       "k4_identity_store_alpha_bit_equal": k4_alpha,
                       "k4_identity_store_r_bit_equal": k4_r})
    return checks


def phase_attention(report: dict, dev, gen) -> dict:
    import torch

    # Post-ReLU grid features, each cell scaled by its own factor in
    # [1/4, 4], so that the cells' norms differ as real ones do and a
    # weight taken with another cell's norm shows in v_att.
    scale = torch.exp2(torch.rand(B, N, 1, generator=gen, device=dev) * 4 - 2)
    v = (torch.randn(B, N, C, generator=gen, device=dev).relu_() * scale).to(
        torch.bfloat16)
    qh = torch.randn(B, H, generator=gen, device=dev) * 0.5
    lim = (6.0 / (C + H)) ** 0.5
    wv = ((torch.rand(C, H, generator=gen, device=dev) * 2 - 1) * lim
          ).to(torch.bfloat16)
    ws = (torch.randn(H, generator=gen, device=dev) * 0.05).to(
        torch.bfloat16).float()
    checks = k2_checks(v, qh, wv, ws)
    return {"v": v, "qh": qh, "wv": wv, "ws": ws, "checks": checks}


def phase_gru_bwd(report: dict, dev, gen) -> dict:
    import torch
    from vqa_transfer_externaldata_torch.ops import gru, kernels

    Bt = B_TRAIN
    gx = torch.randn(T, Bt, 3 * H, generator=gen, device=dev) * 0.5
    lens = torch.randint(1, T + 1, (Bt,), generator=gen, device=dev,
                         dtype=torch.int32)
    lens[0], lens[1] = T, 1  # the longest and the shortest question
    lim = (6.0 / (4 * H)) ** 0.5  # glorot scale of U_h [H, 3H]
    uh = ((torch.rand(H, 3 * H, generator=gen, device=dev) * 2 - 1) * lim
          ).to(torch.bfloat16)
    bhn = torch.randn(H, generator=gen, device=dev) * 0.1
    ghT = torch.randn(Bt, H, generator=gen, device=dev) * 0.05
    err, checks, hseq_fwd, err1 = 0.0, [], None, 0.0
    for reverse in (False, True):
        # K1 at the training batch against its plain version; both K3 and
        # its plain version then take K1's hseq, as on the training path.
        hT, hseq = gru.gru_fwd(gx, lens, uh, bhn, reverse=reverse)
        rT, rseq = gru.gru_reference(gx, lens, uh, bhn, reverse=reverse)
        torch.cuda.synchronize()
        e1 = max((hT - rT).abs().max().item(),
                 (hseq - rseq).abs().max().item())
        print(f"K1 gru_fwd B={Bt} reverse={reverse}: max abs err {e1:.3e} "
              f"(tol {TOL_GRU})")
        check(bool(torch.isfinite(hseq).all()), "K1 output not finite")
        check(e1 <= TOL_GRU, f"K1 B={Bt} reverse={reverse} err {e1} > "
              f"{TOL_GRU}")
        err1 = max(err1, e1)
        got = gru.gru_bwd(gx, hseq, lens, uh, bhn, ghT, reverse=reverse)
        want = gru.gru_bwd_reference(gx, hseq, lens, uh, bhn, ghT,
                                     reverse=reverse)
        torch.cuda.synchronize()
        for name, a, b in zip(("dgx", "duh", "dbhn"), got, want):
            e, rel = (a - b).abs().max().item(), rel_err(a, b)
            print(f"K3 gru_bwd reverse={reverse} {name}: max abs err "
                  f"{e:.3e}, {rel:.3e} of max|{name}| (tol {TOL_K3_REL:.3e})")
            check(bool(torch.isfinite(a).all()), f"K3 {name} not finite")
            check(rel <= TOL_K3_REL, f"K3 reverse={reverse} {name} relative "
                  f"err {rel} > {TOL_K3_REL}")
            checks.append({"reverse": reverse, "output": name,
                           "max_abs_err": e, "rel_err": rel,
                           "rel_tol": TOL_K3_REL})
            err = max(err, e)
        if not reverse:
            hseq_fwd = hseq
    launch = bptt_launch(gru.gru_bwd_launch_config, Bt, dev, "K3")
    report["gru_bwd_launch"] = launch
    # K1's persistent launch at the training and the serving batch: the
    # grid that the C side derives from the plan's rows and its occupancy
    # query, against the plan's on the same blocks per SM.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k1_launch = {}
    for batch in (Bt, B):
        lk = gru.gru_fwd_launch_config(batch, H, dev)
        plan = kernels.gru_fwd_plan(batch, H, sms, lk["per_sm_by_rows"])
        print(f"K1 persistent launch at B={batch}, H={H}: 16 units x "
              f"{lk['rows']} rows a block, grid {lk['grid'][0]} x "
              f"{lk['grid'][1]} blocks of 256 threads, "
              f"{lk['blocks_per_sm']} resident per SM, "
              f"{lk['smem_bytes']} B of dynamic shared memory")
        check(lk["rows"] == plan["rows"] and lk["grid"] == plan["grid"],
              f"K1 launch {lk} differs from kernels.gru_fwd_plan {plan}")
        k1_launch[str(batch)] = lk
    report["gru_fwd_launch"] = k1_launch
    return {"gx": gx, "hseq": hseq_fwd, "lens": lens, "uh": uh, "bhn": bhn,
            "ghT": ghT, "err": err, "checks": checks, "k1_err": err1,
            "launch": launch, "k1_launch": k1_launch}


def phase_resident(report: dict, dev, gen) -> dict:
    import torch
    from vqa_transfer_externaldata_torch.ops import (
        attention_resident as ar, kernels)

    M, Bt, n_valid = TRAIN_IMAGES, B_TRAIN, N
    Np = n_valid + (-n_valid) % 8
    # Post-ReLU cells, each scaled by its own factor in [1/4, 4] (a norm
    # taken from another cell shows), zero past n_valid as the padded store.
    store = torch.zeros(M, Np, C, dtype=torch.bfloat16, device=dev)
    for lo in range(0, M, 64):
        m = min(64, M - lo)
        scale = torch.exp2(torch.rand(m, n_valid, 1, generator=gen,
                                      device=dev) * 4 - 2)
        store[lo:lo + m, :n_valid] = (torch.randn(
            m, n_valid, C, generator=gen, device=dev).relu_() * scale).to(
                torch.bfloat16)
    rows = torch.randint(0, M, (Bt,), generator=gen, device=dev,
                         dtype=torch.int32)
    rows[1] = rows[2] = rows[0]  # questions that share an image
    qh = torch.randn(Bt, H, generator=gen, device=dev) * 0.5
    lim = (6.0 / (C + H)) ** 0.5
    wv = ((torch.rand(C, H, generator=gen, device=dev) * 2 - 1) * lim
          ).to(torch.bfloat16)
    ws = (torch.randn(H, generator=gen, device=dev) * 0.05).to(
        torch.bfloat16).float()
    g = torch.randn(Bt, C, generator=gen, device=dev) * 0.01
    sga = torch.randn(Bt, Np, generator=gen, device=dev) * 0.1
    checks4, checks5 = [], []
    for normalize in (True, False):
        kw = dict(n_valid=n_valid, normalize=normalize)
        va, al, h = ar.attention_resident_fwd(store, rows, qh, wv, ws,
                                              save_h=True, **kw)
        rv, ra, rh = ar.attention_resident_fwd_reference(
            store, rows, qh, wv, ws, save_h=True, **kw)
        torch.cuda.synchronize()
        ev = (va - rv).abs().max().item()
        ea = (al - ra).abs().max().item()
        eh = (h.float() - rh.float()).abs().max().item()
        rh_err = rel_err(h.float(), rh.float())
        tol_v = TOL_VATT_REL * rv.abs().max().item()
        print(f"K4 attention_resident_fwd normalize={normalize}: v_att "
              f"{ev:.3e} (tol {tol_v:.3e}), alpha {ea:.3e} (tol "
              f"{TOL_ALPHA}), h {eh:.3e} = {rh_err:.3e} of max|h| (tol "
              f"{TOL_K4_H_REL:.3e})")
        check(bool(torch.isfinite(va).all() and torch.isfinite(al).all()),
              "K4 output not finite")
        check(ev <= tol_v, f"K4 normalize={normalize} v_att err {ev}")
        check(ea <= TOL_ALPHA, f"K4 normalize={normalize} alpha err {ea}")
        check(rh_err <= TOL_K4_H_REL, f"K4 normalize={normalize} h err "
              f"{rh_err}")
        check(al[:, n_valid:].abs().max().item() == 0.0,
              "K4 gave padded cells weight")
        checks4.append({"normalize": normalize, "v_att_err": ev,
                        "v_att_tol": tol_v, "alpha_err": ea,
                        "alpha_tol": TOL_ALPHA, "h_err": eh,
                        "h_rel_err": rh_err, "h_rel_tol": TOL_K4_H_REL})
        # K5 and its plain version from the same saved h and alpha.
        got = ar.attention_resident_bwd(store, rows, rh, ws, ra, g, sga, **kw)
        want = ar.attention_resident_bwd_reference(store, rows, rh, ws, ra, g,
                                                   sga, **kw)
        torch.cuda.synchronize()
        for name, a, b in zip(("dqh", "dwv", "dws"), got, want):
            e, rel = (a - b).abs().max().item(), rel_err(a, b)
            print(f"K5 attention_resident_bwd normalize={normalize} {name}: "
                  f"max abs err {e:.3e}, {rel:.3e} of max|{name}| (tol "
                  f"{TOL_K5_REL:.3e})")
            check(bool(torch.isfinite(a).all()), f"K5 {name} not finite")
            check(rel <= TOL_K5_REL, f"K5 normalize={normalize} {name} "
                  f"relative err {rel} > {TOL_K5_REL}")
            checks5.append({"normalize": normalize, "output": name,
                            "max_abs_err": e, "rel_err": rel,
                            "rel_tol": TOL_K5_REL})
    # The score launch's shape at this batch (bf16 rows; int8 codes add a
    # slot of raw codes to each ring stage).
    cells = Bt * Np
    launch = ar.score_launch_config(cells, H, False)
    smem8 = ar.score_launch_config(cells, H, True)["smem_bytes"]
    launch["smem_bytes_int8"] = smem8
    launch["nvcc_s"] = report.get("nvcc_s", {}).get("attention_resident_fwd")
    nvcc = launch["nvcc_s"]
    print(f"K4 score launch at B={Bt}, Np={Np}, C={C}, H={H}: tiles of "
          f"{launch['tile'][0]} cells x {launch['tile'][1]} columns (BN "
          f"{launch['tile'][1]}), 256 threads, a ring of {launch['stages']} "
          f"stages of 64 channels, {launch['smem_bytes']} B of dynamic shared "
          f"memory ({smem8} B on int8 rows), grid {launch['grid'][0]} x "
          f"{launch['grid'][1]} (column tiles fastest); nvcc "
          f"attention_resident_fwd.cu "
          + ("already built" if nvcc is None else f"{nvcc:.1f} s"))
    report["score_launch"] = launch
    # K5's dW_v launch at this batch as the C side sets it, held against
    # the split that the wrappers take from kernels.dwv_plan.
    K = Bt * n_valid
    plan = kernels.dwv_plan(K, C, H, kernels.sm_count(dev))
    dwv = ar.dwv_launch_config(K, C, H, False, plan["splits"])
    check(dwv == plan, f"K5's dW_v launch {dwv} is not dwv_plan's {plan}")
    dwv["smem_bytes_int8"] = ar.dwv_launch_config(
        K, C, H, True, plan["splits"])["smem_bytes"]
    print(f"K5 dW_v launch over {K} cells, C={C}, H={H}: tiles of "
          f"{dwv['tile'][0]} channels x {dwv['tile'][1]} units, a ring of "
          f"{dwv['stages']} stages of 64 cells, {dwv['smem_bytes']} B of "
          f"dynamic shared memory ({dwv['smem_bytes_int8']} B on int8 rows), "
          f"{dwv['splits']} splits of {dwv['chunks_per_split']} chunks, grid "
          f"{' x '.join(map(str, dwv['grid']))}")
    report["dwv_launch"] = dwv
    # K5's rows launch (the per-question pass) as the C side sets it,
    # held against kernels.rows_plan.
    rows_launch = {}
    for G in (1, 8):
        plan = kernels.rows_plan(Bt, n_valid, G, C, H)
        got = ar.rows_launch_config(Bt, n_valid, G, C, H)
        check(got == plan, f"K5's rows launch at G={G} {got} is not "
              f"rows_plan's {plan}")
        print(f"K5 rows launch at B={Bt}, {n_valid} cells, G={G}: one "
              f"block a question, grid {plan['grid'][0]} x "
              f"{plan['threads']} threads, {plan['smem_bytes']} B of dynamic "
              f"shared memory, {plan['cell_lanes']} cell lanes, "
              f"{plan['unit_passes']} unit pass(es)")
        rows_launch[f"g{G}"] = plan
    report["rows_launch"] = rows_launch
    return {"store": store, "rows": rows, "qh": qh, "wv": wv, "ws": ws,
            "h": rh, "alpha": ra, "g": g, "sga": sga, "n_valid": n_valid,
            "checks4": checks4, "checks5": checks5,
            "err4": max(max(c["v_att_err"], c["alpha_err"], c["h_err"])
                        for c in checks4),
            "err5": max(c["max_abs_err"] for c in checks5)}


def phase_resident_multi(report: dict, dev, gen, k45: dict) -> dict:
    """K4 and K5 at G glimpses (GLIMPSE_CHECKS) against their plain
    versions on phase_resident's store and rows, normalize on and off, K5
    fed the plain version's saved h and alpha."""
    import torch
    from vqa_transfer_externaldata_torch.ops import attention_resident as ar

    store, rows, qh, wv = k45["store"], k45["rows"], k45["qh"], k45["wv"]
    n_valid = k45["n_valid"]
    Bt, Np = rows.shape[0], store.shape[1]
    checks4, checks5, keep = [], [], {}
    for G in GLIMPSE_CHECKS:
        ws = (torch.randn(H, G, generator=gen, device=dev) * 0.05).to(
            torch.bfloat16).float()
        g = torch.randn(Bt, G * C, generator=gen, device=dev) * 0.01
        sga = torch.randn(Bt, Np, G, generator=gen, device=dev) * 0.1
        for normalize in (True, False):
            kw = dict(n_valid=n_valid, normalize=normalize)
            va, al, h = ar.attention_resident_fwd(store, rows, qh, wv, ws,
                                                  save_h=True, **kw)
            rv, ra, rh = ar.attention_resident_fwd_reference(
                store, rows, qh, wv, ws, save_h=True, **kw)
            torch.cuda.synchronize()
            check(tuple(va.shape) == (Bt, G * C) and tuple(al.shape) ==
                  (Bt, Np, G), f"K4 G={G} shapes {va.shape}, {al.shape}")
            # Each glimpse's v_att against its own largest value.
            d3 = (va - rv).abs().reshape(Bt, G, C).amax(dim=(0, 2))
            m3 = rv.abs().reshape(Bt, G, C).amax(dim=(0, 2))
            v_share = (d3 / (TOL_VATT_REL * m3)).max().item()
            ev = (va - rv).abs().max().item()
            ea = (al - ra).abs().max().item()
            eh = (h.float() - rh.float()).abs().max().item()
            rh_err = rel_err(h.float(), rh.float())
            print(f"K4 attention_resident_fwd G={G} normalize={normalize}: "
                  f"v_att {ev:.3e} (worst glimpse at {v_share:.3f} of 2^-10 "
                  f"* its max|v_att_g|), alpha {ea:.3e} (tol {TOL_ALPHA}), "
                  f"h {rh_err:.3e} of max|h| (tol {TOL_K4_H_REL:.3e})")
            check(bool(torch.isfinite(va).all() and torch.isfinite(al).all()),
                  f"K4 G={G} output not finite")
            check(v_share <= 1.0, f"K4 G={G} normalize={normalize} v_att "
                  f"at {v_share} of its limit")
            check(ea <= TOL_ALPHA, f"K4 G={G} normalize={normalize} alpha "
                  f"err {ea}")
            check(rh_err <= TOL_K4_H_REL, f"K4 G={G} normalize={normalize} "
                  f"h err {rh_err}")
            check(al[:, n_valid:].abs().max().item() == 0.0,
                  f"K4 G={G} gave padded cells weight")
            checks4.append({"glimpses": G, "normalize": normalize,
                            "v_att_err": ev, "v_att_share_of_limit": v_share,
                            "alpha_err": ea, "alpha_tol": TOL_ALPHA,
                            "h_err": eh, "h_rel_err": rh_err,
                            "h_rel_tol": TOL_K4_H_REL})
            got = ar.attention_resident_bwd(store, rows, rh, ws, ra, g, sga,
                                            **kw)
            want = ar.attention_resident_bwd_reference(store, rows, rh, ws,
                                                       ra, g, sga, **kw)
            torch.cuda.synchronize()
            check(tuple(got[2].shape) == (H, G), f"K5 G={G} dws shape")
            for name, a, b in zip(("dqh", "dwv", "dws"), got, want):
                if name == "dws":  # each glimpse's column on its own
                    rel = ((a - b).abs().amax(0) / b.abs().amax(0).clamp_min(
                        1e-30)).max().item()
                    tol = TOL_K5_REL
                else:
                    rel, tol = rel_err(a, b), G * TOL_K5_REL
                e = (a - b).abs().max().item()
                print(f"K5 attention_resident_bwd G={G} normalize="
                      f"{normalize} {name}: max abs err {e:.3e}, {rel:.3e} "
                      f"of max|{name}| (tol {tol:.3e})")
                check(bool(torch.isfinite(a).all()), f"K5 G={G} {name} not "
                      "finite")
                check(rel <= tol, f"K5 G={G} normalize={normalize} {name} "
                      f"relative err {rel} > {tol}")
                checks5.append({"glimpses": G, "normalize": normalize,
                                "output": name, "max_abs_err": e,
                                "rel_err": rel, "rel_tol": tol})
        if G == 2:  # the glimpses2 path's count, kept for the times
            keep.update(ws=ws, h=rh, alpha=ra, g=g, sga=sga)
        else:  # kept for the rows launch's time at G=8
            keep["g8"] = {"ws": ws, "h": rh, "alpha": ra, "g": g, "sga": sga}
    return {**keep, "checks4": checks4, "checks5": checks5,
            "err4": max(max(c["v_att_err"], c["alpha_err"], c["h_err"])
                        for c in checks4),
            "err5": max(c["max_abs_err"] for c in checks5)}


def int8_codes(store):
    """The int8 codes of ``store`` normalized per cell with one global
    scale, as ``prenormalize_store(quantize="int8")`` makes them (here on
    the card): (codes, scale, the bf16 store of the same normalized
    grid)."""
    import torch

    f = store.float()
    f = f * (1.0 / torch.sqrt((f * f).sum(-1, keepdim=True) + 1e-12))
    scale = (f.abs().max().item() or 1.0) / 127.0
    codes = torch.clamp(torch.round(f / scale), -127, 127).to(torch.int8)
    return codes, scale, f.to(store.dtype)


def phase_resident_int8(report: dict, dev, gen, k45: dict) -> dict:
    """K4 and K5 on int8 rows at G in INT8_GLIMPSES against their plain
    versions on the same codes (normalize off: an int8 store is
    prenormalized), under the bf16 rows' limits; then the op on the int8
    store with its scale against the op on the bf16 store of the same
    normalized grid."""
    import torch
    from vqa_transfer_externaldata_torch.ops import attention_resident as ar

    rows, qh, n_valid = k45["rows"], k45["qh"], k45["n_valid"]
    codes, scale, normed = int8_codes(k45["store"])
    # The op hands the kernels W_v with the store's scale folded in
    # (bf16(W_v * scale)), so z has the normalized store's size.
    wv = (k45["wv"].float() * scale).to(torch.bfloat16)
    Bt, Np = rows.shape[0], codes.shape[1]
    kw = dict(n_valid=n_valid, normalize=False)
    checks4, checks5, keep = [], [], {}
    for G in INT8_GLIMPSES:
        ws = (torch.randn(H, G, generator=gen, device=dev) * 0.05).to(
            torch.bfloat16).float()
        if G == 1:
            ws = ws[:, 0].contiguous()
        g = torch.randn(Bt, G * C, generator=gen, device=dev) * 0.01
        sga = torch.randn(Bt, Np, G, generator=gen, device=dev) * 0.1
        if G == 1:
            sga = sga[:, :, 0].contiguous()
        va, al, h = ar.attention_resident_fwd(codes, rows, qh, wv, ws,
                                              save_h=True, **kw)
        rv, ra, rh = ar.attention_resident_fwd_reference(
            codes, rows, qh, wv, ws, save_h=True, **kw)
        torch.cuda.synchronize()
        d3 = (va - rv).abs().reshape(Bt, G, C).amax(dim=(0, 2))
        m3 = rv.abs().reshape(Bt, G, C).amax(dim=(0, 2))
        v_share = (d3 / (TOL_VATT_REL * m3)).max().item()
        ev = (va - rv).abs().max().item()
        ea = (al - ra).abs().max().item()
        eh = (h.float() - rh.float()).abs().max().item()
        rh_err = rel_err(h.float(), rh.float())
        print(f"K4[int8] attention_resident_fwd G={G}: v_att {ev:.3e} (worst "
              f"glimpse at {v_share:.3f} of 2^-10 * its max|v_att_g|), alpha "
              f"{ea:.3e} (tol {TOL_ALPHA}), h {rh_err:.3e} of max|h| (tol "
              f"{TOL_K4_H_REL:.3e})")
        check(bool(torch.isfinite(va).all() and torch.isfinite(al).all()),
              f"K4[int8] G={G} output not finite")
        check(v_share <= 1.0, f"K4[int8] G={G} v_att at {v_share} of its "
              "limit")
        check(ea <= TOL_ALPHA, f"K4[int8] G={G} alpha err {ea}")
        check(rh_err <= TOL_K4_H_REL, f"K4[int8] G={G} h err {rh_err}")
        check(al[:, n_valid:].abs().max().item() == 0.0,
              f"K4[int8] G={G} gave padded cells weight")
        checks4.append({"glimpses": G, "v_att_err": ev,
                        "v_att_share_of_limit": v_share, "alpha_err": ea,
                        "alpha_tol": TOL_ALPHA, "h_err": eh,
                        "h_rel_err": rh_err, "h_rel_tol": TOL_K4_H_REL})
        got = ar.attention_resident_bwd(codes, rows, rh, ws, ra, g, sga, **kw)
        want = ar.attention_resident_bwd_reference(codes, rows, rh, ws, ra, g,
                                                   sga, **kw)
        torch.cuda.synchronize()
        for name, a, b in zip(("dqh", "dwv", "dws"), got, want):
            if name == "dws":  # each glimpse's column on its own
                a2, b2 = a.reshape(H, G), b.reshape(H, G)
                rel = ((a2 - b2).abs().amax(0) / b2.abs().amax(0).clamp_min(
                    1e-30)).max().item()
                tol = TOL_K5_REL
            else:
                rel, tol = rel_err(a, b), G * TOL_K5_REL
            e = (a - b).abs().max().item()
            print(f"K5[int8] attention_resident_bwd G={G} {name}: max abs "
                  f"err {e:.3e}, {rel:.3e} of max|{name}| (tol {tol:.3e})")
            check(bool(torch.isfinite(a).all()), f"K5[int8] G={G} {name} not "
                  "finite")
            check(rel <= tol, f"K5[int8] G={G} {name} relative err {rel} > "
                  f"{tol}")
            checks5.append({"glimpses": G, "output": name, "max_abs_err": e,
                            "rel_err": rel, "rel_tol": tol})
        if G == 1:  # the int8 training path's count, kept for the times
            keep = {"ws": ws, "h": rh, "alpha": ra, "g": g, "sga": sga}
    # The op on the codes with their scale against the op on the bf16
    # store of the same normalized grid, from the same parameters.
    wvf = k45["wv"].float()
    ws1 = keep["ws"]
    with torch.no_grad():
        va_q, _ = ar.spatial_attention_resident(
            codes, rows, qh.to(torch.bfloat16), wvf, ws1, n_valid=n_valid,
            store_scale=scale)
        va_f, _ = ar.spatial_attention_resident(
            normed, rows, qh.to(torch.bfloat16), wvf, ws1, n_valid=n_valid)
    quant = (torch.linalg.vector_norm(va_q - va_f)
             / torch.linalg.vector_norm(va_f)).item()
    row_mb = {"int8": codes.numel() / 1e6, "bf16": normed.numel() * 2 / 1e6}
    print(f"int8 store (scale {scale:.6g}): v_att against the bf16 store of "
          f"the same grid, relative error {quant:.4%} (bound "
          f"{INT8_VATT_REL:.0%}); store {row_mb['int8']:.1f} MB against "
          f"{row_mb['bf16']:.1f} MB in bf16")
    check(quant <= INT8_VATT_REL, f"int8 v_att quantization error {quant}")
    return {**keep, "codes": codes, "scale": scale, "wv": wv,
            "checks4": checks4,
            "checks5": checks5, "vatt_quant_rel_err": quant,
            "store_mb": row_mb,
            "err4": max(max(c["v_att_err"], c["alpha_err"], c["h_err"])
                        for c in checks4),
            "err5": max(c["max_abs_err"] for c in checks5)}


def k8_allowance(v, qh, wv, ws, ds, r, normalize: bool) -> tuple:
    """What ReLU flips may move K8's outputs against its plain version, per
    entry. Both recompute z = (v . W_v) r + qh with f32 sums of the same
    exact bf16 products in another order, which differ by less than 2^-12
    of the sum of the terms' magnitudes (C u <= 2^-13 for each order, at
    C=2048). A unit whose plain |z| is within that may take the other side
    of the ReLU in one version: it moves dqh_bk by at most |ds_n ws_k| and
    dW_v[:, k] by |v_n| |ds_n ws_k| r_n, and dws not at all (relu(z) is
    ~0 there). Returns (dqh allowance [B, H], dW_v allowance [C, H],
    number of such units)."""
    import torch

    vf = v.float()
    z = vf @ wv.float()
    mag = vf.abs() @ wv.float().abs()
    if normalize:
        z, mag = z * r[:, :, None], mag * r[:, :, None]
    z = z + qh[:, None, :]
    unsure = (z.abs() <= 2.0 ** -12 * (mag + qh.abs()[:, None, :])).float()
    del z, mag
    flip = unsure * (ds[:, :, None] * ws).abs()
    rr = r if normalize else torch.ones_like(r)
    return (flip.sum(1),
            torch.einsum("bnc,bnh->ch", vf.abs(), flip * rr[:, :, None]),
            int(unsure.sum().item()))


def phase_attention_bwd(report: dict, dev, gen) -> dict:
    """K2's checks (``k2_checks``) at the gathered training shape; K8
    against its plain version there, fed the same ds and K2's r; then the
    op's parameter gradients under K8 against those under the explicit
    backward (bwd_kernel=False)."""
    import torch
    from vqa_transfer_externaldata_torch.ops import attention

    Bt = B_TRAIN
    scale = torch.exp2(torch.rand(Bt, N, 1, generator=gen, device=dev) * 4
                       - 2)
    v = (torch.randn(Bt, N, C, generator=gen, device=dev).relu_() * scale
         ).to(torch.bfloat16)
    del scale
    qh = torch.randn(Bt, H, generator=gen, device=dev) * 0.5
    lim = (6.0 / (C + H)) ** 0.5
    wv = ((torch.rand(C, H, generator=gen, device=dev) * 2 - 1) * lim
          ).to(torch.bfloat16)
    ws = (torch.randn(H, generator=gen, device=dev) * 0.05).to(
        torch.bfloat16).float()
    k2 = k2_checks(v, qh, wv, ws)  # K2 at the training batch, which K8 reads
    checks, err, keep = [], 0.0, {}
    for normalize in (True, False):
        va, al, r = attention.attention_fwd(v, qh, wv, ws,
                                            normalize=normalize)
        ds = (torch.randn(Bt, N, generator=gen, device=dev) * al
              ).contiguous()
        got = attention.attention_bwd(v, qh, wv, ws, ds, r, normalize)
        want = attention.attention_bwd_reference(v, qh, wv, ws, ds, r,
                                                 normalize)
        torch.cuda.synchronize()
        a_dqh, a_dwv, unsure = k8_allowance(v, qh, wv, ws, ds, r, normalize)
        for name, a, b, allow in zip(("dqh", "dwv", "dws"), got, want,
                                     (a_dqh, a_dwv, 0.0)):
            e, rel = (a - b).abs().max().item(), rel_err(a, b)
            limit = TOL_K8_REL * b.abs().max().item() + allow
            worst = ((a - b).abs() / limit).max().item()
            print(f"K8 attention_bwd normalize={normalize} {name}: max abs "
                  f"err {e:.3e} ({rel:.3e} of max|{name}|); worst entry at "
                  f"{worst:.3f} of its limit (2^-9 of max|{name}| + what "
                  f"{unsure} units near z=0 can move it)")
            check(bool(torch.isfinite(a).all()), f"K8 {name} not finite")
            check(worst <= 1.0, f"K8 normalize={normalize} {name}: an "
                  f"entry at {worst} of its limit")
            checks.append({"normalize": normalize, "output": name,
                           "max_abs_err": e, "rel_err": rel,
                           "rel_tol": TOL_K8_REL, "units_near_zero": unsure,
                           "worst_share_of_limit": worst})
            err = max(err, e)
        if normalize:  # the main path's mode, kept for the times
            keep = {"v_att": va, "alpha": al, "r": r, "ds": ds}
    # The op's gradients, K8 against the explicit backward, under a loss
    # that drives v_att and alpha along random directions.
    wa = torch.randn(Bt, C, generator=gen, device=dev)
    wb = torch.randn(Bt, N, generator=gen, device=dev)
    grads = []
    for bwd_kernel in (True, False):
        ins = [t.clone().requires_grad_() for t in (qh, wv.float(), ws)]
        o, a2 = attention.spatial_attention(v, *ins, normalize=True,
                                            bwd_kernel=bwd_kernel,
                                            feature_grad=False)
        ((o * wa).sum() + (a2 * wb).sum()).backward()
        grads.append([t.grad for t in ins])
    cos = {name: torch.nn.functional.cosine_similarity(
        a.flatten(), b.flatten(), 0).item()
        for name, a, b in zip(("dqh", "dwv", "dws"), *grads)}
    print(f"gathered op grads, K8 vs the explicit backward: cosines {cos} "
          f"(bound {GRAD_COS})")
    check(min(cos.values()) >= GRAD_COS, f"op grads K8 vs explicit {cos}")
    g = (wa * 0.01).contiguous()
    ga = (wb * 0.01).contiguous()
    return {"v": v, "qh": qh, "wv": wv, "ws": ws, **keep, "g": g, "ga": ga,
            "checks": checks, "err": err, "op_grad_cos": cos,
            "k2_checks": k2}


def phase_bigru(report: dict, dev, gen) -> dict:
    """K6 and K7 against their plain versions at the stage-1 shape, and
    against K1 and K3 run once per direction on the same inputs: the same
    persistent kernels with a direction axis, so the same bits."""
    import torch
    from vqa_transfer_externaldata_torch.ops import gru, kernels

    Bt = B_TRAIN
    lens = torch.randint(1, T + 1, (Bt,), generator=gen, device=dev,
                         dtype=torch.int32)
    lens[0], lens[1] = T, 1  # the longest and the shortest phrase
    lim = (6.0 / (4 * H)) ** 0.5  # glorot scale of U_h [H, 3H]
    gx, uh, bhn, ghT = [], [], [], []
    for _ in range(2):  # forward chain, then backward chain
        gx.append(torch.randn(T, Bt, 3 * H, generator=gen, device=dev) * 0.5)
        uh.append(((torch.rand(H, 3 * H, generator=gen, device=dev) * 2 - 1)
                   * lim).to(torch.bfloat16))
        bhn.append(torch.randn(H, generator=gen, device=dev) * 0.1)
        ghT.append(torch.randn(Bt, H, generator=gen, device=dev) * 0.05)
    args = (gx[0], gx[1], lens, uh[0], uh[1], bhn[0], bhn[1])
    got = gru.bigru_fwd(*args)
    want = gru.bigru_reference(*args)
    (hTf, hsf), (hTb, hsb) = (gru.gru_fwd(gx[0], lens, uh[0], bhn[0]),
                              gru.gru_fwd(gx[1], lens, uh[1], bhn[1],
                                          reverse=True))
    torch.cuda.synchronize()
    names6 = ("hTf", "hTb", "hseqf", "hseqb")
    err6 = max((a - b).abs().max().item() for a, b in zip(got, want))
    diff6 = max((a - b).abs().max().item()
                for a, b in zip(got, (hTf, hTb, hsf, hsb)))
    print(f"K6 bigru_fwd B={Bt}: max abs err {err6:.3e} (tol {TOL_GRU}) "
          f"over {names6}; against two K1 calls {diff6:.3e} (must be 0)")
    check(all(bool(torch.isfinite(a).all()) for a in got),
          "K6 output not finite")
    check(err6 <= TOL_GRU, f"K6 err {err6} > {TOL_GRU}")
    check(diff6 == 0.0, f"K6 differs from two K1 calls by {diff6}")
    # K6's persistent launch: the grid and launches that the C side derives
    # from the plan's rows and its own instance's occupancy, against the
    # plan's with two directions on the same blocks per SM.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    launch6 = gru.bigru_fwd_launch_config(Bt, H, dev)
    plan6 = kernels.gru_fwd_plan(Bt, H, sms, launch6["per_sm_by_rows"], 2)
    print(f"K6 persistent launch at B={Bt}, H={H}: 16 units x "
          f"{launch6['rows']} rows a block, grid "
          + " x ".join(map(str, launch6["grid"])) + " blocks of 256 threads "
          f"(j-tiles x rows x directions), {launch6['launches']} launch(es) "
          f"a call over {launch6['b_tiles']} b-tiles, "
          f"{launch6['blocks_per_sm']} resident per SM, "
          f"{launch6['smem_bytes']} B of dynamic shared memory")
    check(all(launch6[k] == plan6[k] for k in ("rows", "grid", "launches")),
          f"K6 launch {launch6} differs from kernels.gru_fwd_plan {plan6}")

    # K7 and its plain version, both fed K6's state sequences.
    hseqf, hseqb = got[2], got[3]
    bargs = (gx[0], gx[1], hseqf, hseqb, lens, uh[0], uh[1], bhn[0], bhn[1],
             ghT[0], ghT[1])
    got7 = gru.bigru_bwd(*bargs)
    want7 = gru.bigru_bwd_reference(*bargs)
    one_f = gru.gru_bwd(gx[0], hseqf, lens, uh[0], bhn[0], ghT[0])
    one_b = gru.gru_bwd(gx[1], hseqb, lens, uh[1], bhn[1], ghT[1],
                        reverse=True)
    torch.cuda.synchronize()
    ones = (one_f[0], one_b[0], one_f[1], one_b[1], one_f[2], one_b[2])
    checks, err7, diff7 = [], 0.0, 0.0
    for name, a, b, c in zip(("dgxf", "dgxb", "duhf", "duhb", "dbhnf",
                              "dbhnb"), got7, want7, ones):
        e, rel = (a - b).abs().max().item(), rel_err(a, b)
        d = (a - c).abs().max().item()
        print(f"K7 bigru_bwd {name}: max abs err {e:.3e}, {rel:.3e} of "
              f"max|{name}| (tol {TOL_K3_REL:.3e}); against K3 {d:.3e} "
              "(must be 0)")
        check(bool(torch.isfinite(a).all()), f"K7 {name} not finite")
        check(rel <= TOL_K3_REL, f"K7 {name} relative err {rel} > "
              f"{TOL_K3_REL}")
        check(d == 0.0, f"K7 {name} differs from K3 by {d}")
        checks.append({"output": name, "max_abs_err": e, "rel_err": rel,
                       "rel_tol": TOL_K3_REL, "diff_vs_k3": d})
        err7, diff7 = max(err7, e), max(diff7, d)
    launch = bptt_launch(gru.bigru_bwd_launch_config, Bt, dev, "K7")
    # What ptxas says of the persistent kernels in each build: every
    # instance picks its direction's arguments at run time.
    ptxas = {kernel: {name: ptxas_entry(report["ptxas"].get(name, ""),
                                        kernel) for name in names}
             for kernel, names in (("gru_seq_kernel", ("gru_fwd",
                                                       "bigru_fwd")),
                                   ("gru_bptt_kernel", ("gru_bwd",
                                                        "bigru_bwd")))}
    for kernel, by_name in ptxas.items():
        for name, lines in by_name.items():
            print(f"ptxas on {kernel} in {name}.cu: " + " | ".join(lines))
    return {"args": args, "bargs": bargs, "err6": err6, "diff6": diff6,
            "err7": err7, "diff7": diff7, "checks7": checks,
            "launch6": launch6, "launch7": launch,
            "ptxas_seq": ptxas["gru_seq_kernel"],
            "ptxas_bptt": ptxas["gru_bptt_kernel"]}


def write_run(train_dir: str) -> None:
    """A synthetic full-width run: config.json + a seeded random init."""
    import torch
    from vqa_transfer_externaldata_torch.config import Config
    from vqa_transfer_externaldata_torch.models.zoo import build_model
    from vqa_transfer_externaldata_torch.utils.checkpoint import save_params

    cfg = Config().replace_flat({"data.synthetic": True, **MODEL_OVERRIDES})
    with open(os.path.join(train_dir, "config.json"), "w") as fh:
        fh.write(cfg.to_json())
    gen = torch.Generator().manual_seed(123)
    save_params(os.path.join(train_dir, "params_final.pt"),
                build_model(cfg, generator=gen).module.state_dict())


def phase_serving(report: dict, dev) -> dict:
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.serving import Predictor

    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        write_run(tmp)
        pred = Predictor(tmp, batch_size=B)  # default device: CUDA
    check(pred.device.type == dev.type, f"Predictor picked {pred.device}")
    vocab = len(pred.word_vocab) - 4
    questions = [" ".join(f"w{w}" for w in rng.integers(0, vocab, n))
                 for n in rng.integers(1, T + 1, B)]
    feats = np.maximum(rng.standard_normal((B, N, C), np.float32), 0)
    store = np.maximum(rng.standard_normal((STORE_ROWS, GRID, GRID, C),
                                           np.float32), 0).astype(np.float16)
    pred.stage_store(store)
    idx = rng.integers(0, STORE_ROWS, B)
    short = 5 * B // 8  # a request shorter than the batch: padded, trimmed

    # --- the main path: counts from 0 -----------------------------------
    reset_counts()
    ans_host = pred.answer(feats, questions)
    ans_short = pred.answer(feats[:short], questions[:short])
    ans_idx = pred.answer_indexed(idx, questions)
    launches = read_counts()
    # Three forwards: K1 one persistent launch each, K2 two; the training
    # kernels do not run.
    check_launches(launches, {"gru_fwd": 3, "attention_fwd": 3 * 2},
                   "serving")
    check(len(ans_host) == B and len(ans_short) == short
          and len(ans_idx) == B, "wrong number of answers")
    check(ans_short == ans_host[:short], "padding changed the answers")
    direct = pred.answer(store.reshape(STORE_ROWS, N, C)[idx], questions)
    check(ans_idx == direct, "answer_indexed differs from answer()")
    try:
        pred.answer_indexed(np.array([0, STORE_ROWS]), questions[:2])
        raise PhaseError("answer_indexed accepted an out-of-range row")
    except IndexError:
        pass

    # --- logits against the plain path on the card -----------------------
    v = torch.from_numpy(feats).to(torch.bfloat16).to(dev)
    q = torch.from_numpy(pred._encode_questions(questions)).to(dev)
    with torch.inference_mode():
        out = pred.model(v, q)
        with plain_kernels():
            ref = pred.model(v, q)
    lk, lr = out["logits"], ref["logits"]
    check(tuple(lk.shape) == (B, pred.cfg.data.num_answers),
          f"logits shape {tuple(lk.shape)}")
    check(bool(torch.isfinite(lk).all()), "logits not finite")
    err = (lk - lr).abs().max().item()
    top2 = lr.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > TOL_LOGITS
    agree = (lk.argmax(-1) == lr.argmax(-1)) | ~decided
    print(f"logits vs plain path: max abs err {err:.3e} (tol {TOL_LOGITS}); "
          f"argmax agrees on {int(decided.sum())} decided rows: "
          f"{bool(agree.all())}")
    check(err <= TOL_LOGITS, f"logits err {err} > {TOL_LOGITS}")
    check(bool(agree.all()), "argmax differs where the margin is decided")
    preds = [pred.answer_vocab.tokens[int(i)] for i in lr.argmax(-1)]
    check(all(a == p for a, p, d in zip(ans_host, preds, decided.tolist())
              if d), "Predictor answers differ from the plain path")

    # --- request latency -------------------------------------------------
    def p50(fn) -> float:
        for _ in range(3):
            fn()
        ts = []
        for _ in range(RUNS):
            t0 = time.perf_counter()
            fn()  # ends in a device->host copy of the predictions
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    report["predictor_p50_ms"] = {
        "answer_host_features": p50(lambda: pred.answer(feats, questions)),
        "answer_indexed": p50(lambda: pred.answer_indexed(idx, questions)),
    }
    print(f"Predictor p50 at batch {B}: {report['predictor_p50_ms']}")
    report["logits_max_abs_err"] = err
    report["profile"] = {
        "answer_host_features": profile_calls(
            lambda: pred.answer(feats, questions)),
        "answer_indexed": profile_calls(
            lambda: pred.answer_indexed(idx, questions)),
    }
    return launches


def check_first_step(spec, state, batch, dev, what: str,
                     frozen=lambda name: False) -> dict:
    """The first training step of ``spec``'s model on ``batch`` with the
    kernels and with their plain versions on the card, under one dropout
    mask: the loss to TOL_LOSS, each gradient to cosine GRAD_COS (a scalar
    to TOL_SCALAR_REL relative). Only a parameter that ``frozen`` names
    may go without a gradient, and then on both paths."""
    import torch

    names = list(state.params)

    def loss_and_grads():
        gen = torch.Generator(device=dev).manual_seed(7)
        outs = spec.module(*spec.inputs(batch), train=True, generator=gen)
        loss, _ = spec.loss(outs, batch)
        # A frozen backbone run under no_grad gets no gradient; the
        # others are checked below.
        grads = torch.autograd.grad(loss, [state.params[k] for k in names],
                                    allow_unused=True)
        return loss.item(), dict(zip(names, grads))

    lk, gk = loss_and_grads()
    with plain_kernels():
        lp, gp = loss_and_grads()
    grad_checks = {}
    for k in names:
        if gk[k] is None or gp[k] is None:
            check(frozen(k), f"{what}: the loss does not reach the live "
                  f"parameter {k}")
            check(gk[k] is None and gp[k] is None,
                  f"{what}: grad {k} reaches the loss on one path only")
            continue
        a, b = gk[k].flatten().float(), gp[k].flatten().float()
        if a.numel() == 1:
            rel = ((a - b).abs() / b.abs().clamp_min(1e-30)).item()
            grad_checks[k] = {"rel_err": rel}
            check(rel <= TOL_SCALAR_REL, f"{what}: grad {k} rel err {rel}")
        else:
            cos = torch.nn.functional.cosine_similarity(a, b, 0).item()
            grad_checks[k] = {"cos": cos}
            check(cos >= GRAD_COS, f"{what}: grad {k} cosine {cos} < "
                  f"{GRAD_COS}")
    worst = min(v.get("cos", 1.0) for v in grad_checks.values())
    frozen = len(names) - len(grad_checks)
    print(f"{what} first step: loss {lk:.6f} (kernels) vs {lp:.6f} "
          f"(plain), tol {TOL_LOSS}; lowest gradient cosine {worst:.6f} "
          f"(bound {GRAD_COS})"
          + (f"; {frozen} frozen parameters get no gradient" if frozen
             else ""))
    check(abs(lk - lp) <= TOL_LOSS, f"{what}: loss {lk} vs plain {lp}")
    return {"loss_kernels": lk, "loss_plain": lp, "loss_tol": TOL_LOSS,
            "grad_cos_bound": GRAD_COS, "grads": grad_checks,
            "params_without_grad": frozen}


def read_steps(train_dir: str, steps: int, what: str, unit: str,
               warmup: Optional[int] = None, first: int = 0,
               batch: int = B_TRAIN) -> dict:
    """Losses (all finite) and step times of a run logged every step: each
    record's rate spans the steps since the last one (one, or two at the
    final drain), on the host clock between waits for the device to
    finish each step. The median over the steps after ``warmup`` (counted
    from ``first``, the step the run started from); ``batch`` rows a
    step."""
    import numpy as np

    warmup = WARMUP_STEPS if warmup is None else warmup
    with open(os.path.join(train_dir, "metrics.jsonl")) as fh:
        recs = [r for r in map(json.loads, fh)
                if "train/loss" in r and r["step"] > first]
    losses = [r["train/loss"] for r in recs]
    check(len(recs) == steps and all(np.isfinite(losses)),
          f"{what}: {len(recs)} records, losses {losses}")
    step_ms = [1e3 / r["train/steps_per_sec"] for r in recs
               if r["step"] > first + warmup and "train/steps_per_sec" in r]
    check(len(step_ms) >= (steps - warmup) * 4 // 5,
          f"{what}: only {len(step_ms)} timed steps")
    med = statistics.median(step_ms)
    print(f"{what}: median step {med:.3f} ms over {len(step_ms)} steps = "
          f"{batch * 1e3 / med:.1f} {unit}/s; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}")
    return {"losses": losses, "timed_steps": len(step_ms),
            "step_ms_median": med, f"{unit}_per_sec": batch * 1e3 / med,
            "step_ms_all": step_ms}


def stage2_config(train_dir: str, steps: int, **over):
    from vqa_transfer_externaldata_torch.config import Config

    return Config().replace_flat({
        "data.synthetic": True, "data.synthetic_layout": "joined",
        "data.synthetic_size": TRAIN_QUESTIONS,
        "train.device_data_cache": True, "train.batch_size": B_TRAIN,
        "train.max_steps": steps, "train.log_every": 1,
        "train.train_dir": train_dir, **over, **MODEL_OVERRIDES})


def phase_training(report: dict, dev) -> dict:
    """Stage-2 training at full width through Trainer.fit_resident on the
    gather-free store, with the lagged in-loop evaluation of a 1024-question
    val split every EVAL_EVERY steps and periodic checkpoints; then the
    evaluators and cli.eval on the run."""
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.models.zoo import build_model
    from vqa_transfer_externaldata_torch.serving import PARAMS_FILE, Predictor
    from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
    from vqa_transfer_externaldata_torch.utils.checkpoint import save_params

    steps = WARMUP_STEPS + TIMED_STEPS
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        cfg = stage2_config(tmp, steps, **{
            "train.eval_every": EVAL_EVERY,
            "train.checkpoint_every": EVAL_EVERY,
            "train.keep_checkpoints": KEEP_CHECKPOINTS})
        t0 = time.perf_counter()
        ds = load_dataset(cfg, "train")
        val_cfg = cfg.replace_flat({"data.synthetic_size": VAL_QUESTIONS})
        val = load_dataset(val_cfg, "val")
        grid = ds.store.grid
        check(grid.shape == (TRAIN_IMAGES, N, C) and ds.size ==
              TRAIN_QUESTIONS and val.size == VAL_QUESTIONS,
              f"corpus {grid.shape}, {ds.size} questions, val {val.size}")
        spec = build_model(cfg, generator=torch.Generator().manual_seed(
            cfg.train.seed))
        model = spec.module
        trainer = Trainer(cfg, spec, train_dir=tmp)  # default device: CUDA
        check(trainer.device.type == dev.type, f"Trainer on {trainer.device}")
        state = trainer.init_state()
        out["setup_s"] = time.perf_counter() - t0

        # --- the first step against the plain path (same dropout mask) ---
        data, make_batch, nbytes = trainer._prepare_resident(ds)
        out["store_gb"] = data["grid"].numel() * 2 / 1e9
        idx0 = next(ds.index_batches(B_TRAIN, seed=cfg.train.seed))
        batch = make_batch(torch.from_numpy(idx0).to(dev))
        out["first_step"] = check_first_step(spec, state, batch, dev,
                                             "stage 2")
        del data, make_batch, batch  # free this copy of the store

        # --- the main path: counts from 0 --------------------------------
        reset_counts()
        t0 = time.perf_counter()
        state = trainer.fit_resident(ds, state, eval_ds=val)
        torch.cuda.synchronize()
        out["fit_s"] = time.perf_counter() - t0
        launches = read_counts()
        # A step: K1 one persistent launch, K3 three (the persistent
        # step kernel, the dU_h GEMM, the db_hn sum), K4 two, K5 three. An
        # evaluation: K1 and K4 over each of the val split's batches.
        evals = steps // EVAL_EVERY
        eval_batches = evals * -(-VAL_QUESTIONS // B_TRAIN)
        check_launches(launches, {
            "gru_fwd": steps + eval_batches,
            "gru_bwd": 3 * steps,
            "attention_resident_fwd": 2 * (steps + eval_batches),
            "attention_resident_bwd": 3 * steps},
            f"stage-2 training over {steps} steps with {evals} evaluations")
        check(state.step == steps, f"trained {state.step} steps")
        out.update(launches=launches,
                   **read_steps(tmp, steps, "stage-2 training", "questions"))
        with open(os.path.join(tmp, "metrics.jsonl")) as fh:
            val_recs = [r for r in map(json.loads, fh) if "val/loss" in r]
        check([r["step"] for r in val_recs] ==
              list(range(EVAL_EVERY, steps + 1, EVAL_EVERY)) and
              all(np.isfinite(r["val/loss"]) for r in val_recs),
              f"in-loop evaluations: {val_recs}")
        print(f"in-loop evaluations (lagged): {val_recs}")
        out["val_records"] = val_recs
        kept = trainer.ckpt.all_steps()
        print(f"checkpoints kept: {kept} (every {EVAL_EVERY} steps, keep "
              f"{KEEP_CHECKPOINTS})")
        check(kept == [steps - EVAL_EVERY, steps],
              f"checkpoints kept {kept}")
        out["checkpoints_kept"] = kept

        # --- a profiler window of PROFILE_STEPS more steps ---------------
        state, out["profile"] = profile_fit(trainer, ds, state,
                                            PROFILE_STEPS)

        # --- evaluation: the evaluators and the eval CLI (which restores
        # the latest checkpoint: this state's) -----------------------------
        trainer.ckpt.save(state.step, state, force=True)
        with open(os.path.join(tmp, "config.json"), "w") as fh:
            fh.write(cfg.to_json())
        out["evaluation"] = check_evaluation(trainer, state, val, tmp, dev)

        # --- serve the trained run ---------------------------------------
        save_params(os.path.join(tmp, PARAMS_FILE), model.state_dict())
        pred = Predictor(tmp, batch_size=64)
        check(pred.device.type == dev.type, f"Predictor picked {pred.device}")
        sel = np.arange(64)
        qs = [" ".join(pred.word_vocab.tokens[i] for i in row if i)
              for row in ds.arrays["q_ids"][sel]]
        pred.stage_store(grid)
        answers = pred.answer_indexed(ds.arrays["image_index"][sel], qs)
        check(len(answers) == 64 and all(a in pred.answer_vocab.tokens
                                         for a in answers),
              "the trained run's answers are not answer tokens")
        v = torch.from_numpy(np.asarray(grid[ds.arrays["image_index"][sel]],
                                        np.float32)).to(dev)
        q = torch.from_numpy(pred._encode_questions(qs)).to(dev)
        with torch.inference_mode():
            served = pred.model(v, q)["logits"]
            trained = model(v, q)["logits"]
        e = (served - trained).abs().max().item()
        print(f"served the trained run: {len(answers)} answers, logits of "
              f"the served model vs the trainer's {e:.3e}")
        check(bool(torch.isfinite(served).all()) and e == 0.0,
              f"served logits differ from the trained model's by {e}")
        trainer.close()
    return out


def check_evaluation(trainer, state, val, run_dir: Optional[str], dev,
                     streamed_kernels: Optional[dict] = None) -> dict:
    """On the trained run: the resident evaluator (K4) against the streamed
    evaluate() (K2 over host batches, or ``streamed_kernels`` a batch) on
    the same parameters, and, given ``run_dir``, cli.eval on the run
    directory against evaluate_split. The two evaluators' logits differ in
    their last bits (K4 reads the store normalized at upload, the gathered
    attention normalizes the grid itself), so predictions must agree
    wherever the top two logits are more than TOL_LOGITS apart, and the
    accuracies may differ by the share of rows where they are not."""
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.cli import eval as eval_cli
    from vqa_transfer_externaldata_torch.parallel.evaler import (
        evaluate_split, padded_batches)

    out = {}
    reset_counts()
    t0 = time.perf_counter()
    m_res, p_res = trainer.evaluate_resident(state, val)
    out["resident_s"] = time.perf_counter() - t0
    res_launches = read_counts()
    reset_counts()
    t0 = time.perf_counter()
    m_str, p_str = trainer.evaluate(state,
                                    padded_batches(val, B_TRAIN)[0])
    out["streamed_s"] = time.perf_counter() - t0
    str_launches = read_counts()
    n_batches = -(-VAL_QUESTIONS // B_TRAIN)
    check_launches(res_launches, {"gru_fwd": n_batches,
                                  "attention_resident_fwd": 2 * n_batches},
                   "resident evaluation")
    per_batch = streamed_kernels or {"gru_fwd": 1, "attention_fwd": 2}
    check_launches(str_launches, {k: n * n_batches
                                  for k, n in per_batch.items()},
                   "streamed evaluation")
    p_str = p_str[:VAL_QUESTIONS]
    t0 = time.perf_counter()
    val.take(np.arange(B_TRAIN))  # one host batch: store rows to float32
    out["streamed_take_ms_per_batch"] = (time.perf_counter() - t0) * 1e3
    # Margins of the top two logits, from the resident path.
    data, make_batch, _ = trainer._prepare_resident(val)
    margins = []
    with torch.no_grad():
        for lo in range(0, VAL_QUESTIONS, B_TRAIN):
            idx = torch.arange(lo, min(lo + B_TRAIN, VAL_QUESTIONS),
                               device=dev)
            b = make_batch(idx)
            top2 = trainer.model(*trainer.spec.inputs(b))["logits"].topk(
                2, dim=-1).values
            margins.append((top2[:, 0] - top2[:, 1]).cpu())
    del data, make_batch
    margin = torch.cat(margins).numpy()
    differ = p_res != p_str
    undecided = int((margin <= TOL_LOGITS).sum())
    print(f"evaluators: resident {m_res} vs streamed {m_str}; "
          f"{int(differ.sum())} of {VAL_QUESTIONS} predictions differ, "
          f"{undecided} rows have top-2 logits within {TOL_LOGITS}")
    check(bool((margin[differ] <= TOL_LOGITS).all()),
          "the evaluators disagree on a decided row")
    check(abs(m_res["loss"] - m_str["loss"]) <= TOL_LOSS,
          f"eval loss {m_res['loss']} vs {m_str['loss']}")
    for k in ("accuracy", "vqa_accuracy"):
        check(abs(m_res[k] - m_str[k]) <= undecided / VAL_QUESTIONS + 1e-9,
              f"eval {k} {m_res[k]} vs {m_str[k]}")
    out.update(resident=m_res, streamed=m_str, preds_differ=int(
        differ.sum()), undecided_rows=undecided,
        resident_launches=res_launches, streamed_launches=str_launches)
    if run_dir is None:
        return out

    # --- cli.eval on the run directory ----------------------------------
    want, _ = evaluate_split(trainer, state, val)
    t0 = time.perf_counter()
    got = eval_cli.main(["--train.train_dir", run_dir,
                         "--data.synthetic_size", str(VAL_QUESTIONS)])
    out["cli_eval_s"] = time.perf_counter() - t0
    with open(os.path.join(run_dir, "results_val.json")) as fh:
        rows = json.load(fh)
    print(f"cli.eval: {got}; results_val.json holds {len(rows)} rows; "
          f"evaluate_split's vqa_accuracy {want['vqa_accuracy']}")
    check(len(rows) == VAL_QUESTIONS, f"results_val.json: {len(rows)} rows")
    check(got["vqa_accuracy"] == want["vqa_accuracy"],
          f"cli.eval vqa_accuracy {got['vqa_accuracy']} vs evaluate_split "
          f"{want['vqa_accuracy']}")
    out.update(cli_eval=got, evaluate_split=want, results_rows=len(rows))
    return out


def phase_gathered(report: dict, dev) -> dict:
    """Stage-2 training on the gathered resident path
    (``train.resident_fused_attention`` false): the store is kept as it is
    and each step gathers its [B, N, C] grid, so the attention runs K2
    forward and K8 backward. First step against the plain path, launch
    counts, step times, a profiler window; then the step with the explicit
    backward in place of K8 (bwd_kernel=False) and with K8 again."""
    import functools

    import torch
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.models import vqa_attention
    from vqa_transfer_externaldata_torch.models.zoo import build_model
    from vqa_transfer_externaldata_torch.ops import attention, kernels
    from vqa_transfer_externaldata_torch.parallel.trainer import Trainer

    steps = WARMUP_STEPS + TIMED_STEPS
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gathered_") as tmp:
        cfg = stage2_config(tmp, steps,
                            **{"train.resident_fused_attention": False})
        ds = load_dataset(cfg, "train")
        spec = build_model(cfg, generator=torch.Generator().manual_seed(
            cfg.train.seed))
        trainer = Trainer(cfg, spec, train_dir=tmp)  # default device: CUDA
        check(not spec.module.store_prenormalized, "gathered store changed")
        state = trainer.init_state()
        data, make_batch, nbytes = trainer._prepare_resident(ds)
        check(tuple(data["grid"].shape) == (TRAIN_IMAGES, N, C) and
              data["grid"].dtype == torch.bfloat16,
              f"gathered store {tuple(data['grid'].shape)}")
        out["store_gb"] = data["grid"].numel() * 2 / 1e9
        idx0 = next(ds.index_batches(B_TRAIN, seed=cfg.train.seed))
        batch = make_batch(torch.from_numpy(idx0).to(dev))
        check(tuple(batch["features"].shape) == (B_TRAIN, N, C),
              "gathered batch shape")
        out["first_step"] = check_first_step(spec, state, batch, dev,
                                             "stage 2 (gathered)")
        del data, make_batch, batch

        # --- this run's path: counts from 0 ------------------------------
        reset_counts()
        state = trainer.fit_resident(ds, state)
        torch.cuda.synchronize()
        launches = read_counts()
        # A step: K1 and K3 as on the main path, K2 two launches, K8 its
        # four (kernels.ATTENTION_BWD_LAUNCHES).
        check_launches(launches, {
            "gru_fwd": steps, "gru_bwd": 3 * steps,
            "attention_fwd": 2 * steps,
            "attention_bwd": kernels.ATTENTION_BWD_LAUNCHES * steps},
            f"gathered stage-2 training over {steps} steps")
        out.update(launches=launches,
                   **read_steps(tmp, steps, "gathered stage-2 training",
                                "questions"))
        state, out["profile"] = profile_fit(trainer, ds, state,
                                            PROFILE_STEPS)

        # --- the backward A/B: explicit math, then K8 --------------------
        ab = {}
        for tag, bwd_kernel in (("explicit", False), ("k8", True)):
            first = state.step
            saved = vqa_attention.spatial_attention
            vqa_attention.spatial_attention = functools.partial(
                attention.spatial_attention, bwd_kernel=bwd_kernel)
            try:
                before = attention.attention_bwd.launches
                state = trainer.fit_resident(ds, state,
                                             max_steps=first + AB_STEPS)
                torch.cuda.synchronize()
                k8 = attention.attention_bwd.launches - before
            finally:
                vqa_attention.spatial_attention = saved
            check(k8 == (kernels.ATTENTION_BWD_LAUNCHES * AB_STEPS
                         if bwd_kernel else 0),
                  f"A/B {tag}: {k8} K8 launches")
            ab[tag] = read_steps(tmp, AB_STEPS, f"gathered step, {tag} "
                                 "backward", "questions", warmup=2,
                                 first=first)
        out["ab"] = ab
        trainer.close()
    return out


def phase_streamed(report: dict, dev) -> dict:
    """Stage-2 training through cli.train on streamed host batches
    (``train.device_data_cache`` false, the flat layout: a float32 grid per
    question): each step's [B, N, C] batch is cast to bf16 into a pinned
    buffer and copied to the card; the attention runs K2 and K8."""
    import torch
    from vqa_transfer_externaldata_torch.cli import train as train_cli
    from vqa_transfer_externaldata_torch.ops import kernels

    steps = STREAM_STEPS
    flags = {"data.synthetic": True, "data.synthetic_layout": "flat",
             "data.synthetic_size": STREAM_QUESTIONS,
             "train.device_data_cache": False, "train.batch_size": B_TRAIN,
             "train.max_steps": steps, "train.log_every": 1,
             **MODEL_OVERRIDES}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_streamed_") as tmp:
        argv = ["--train.train_dir", tmp] + cli_argv(flags)
        # --- this run's path: counts from 0 ------------------------------
        reset_counts()
        t0 = time.perf_counter()
        train_dir = train_cli.main(argv)  # default device: CUDA
        torch.cuda.synchronize()
        out = {"cli_s": time.perf_counter() - t0}
        launches = read_counts()
        check_launches(launches, {
            "gru_fwd": steps, "gru_bwd": 3 * steps,
            "attention_fwd": 2 * steps,
            "attention_bwd": kernels.ATTENTION_BWD_LAUNCHES * steps},
            f"streamed stage-2 training over {steps} steps")
        out["launches"] = launches
        out.update(read_steps(train_dir, steps, "streamed stage-2 training",
                              "questions", warmup=2))
        out["batch_mb_to_device"] = B_TRAIN * N * C * 2 / 1e6
    out["host_breakdown_ms"] = streamed_breakdown(flags, dev)
    return out


def streamed_breakdown(flags: dict, dev) -> dict:
    """Where a streamed step's host time goes, one batch at a time (medians
    of 3 after one warm-up batch): the dataset's gather of the batch rows
    (numpy, a fresh float32 array), the bf16 cast into the pinned staging
    buffer with the copy to the card enqueued, and the wait for that copy
    to finish."""
    import torch
    from vqa_transfer_externaldata_torch.config import Config
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.parallel.trainer import _Uploader

    ds = load_dataset(Config().replace_flat(flags), "train")
    upload = _Uploader(dev, torch.bfloat16)
    batches = ds.index_batches(B_TRAIN, seed=1)
    parts = {"take": [], "cast_and_enqueue": [], "copy_wait": []}
    for i in range(4):
        idx = next(batches)
        t0 = time.perf_counter()
        batch = ds.take(idx)
        t1 = time.perf_counter()
        upload(batch)
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if i:
            for k, a, b in (("take", t0, t1), ("cast_and_enqueue", t1, t2),
                            ("copy_wait", t2, t3)):
                parts[k].append((b - a) * 1e3)
    out = {k: statistics.median(v) for k, v in parts.items()}
    print(f"streamed batch on the host, ms: {out}")
    return out


def stage1_config(train_dir: str, steps: int, dense: bool = False):
    from vqa_transfer_externaldata_torch.config import Config

    return Config().replace_flat({
        **STAGE1_MODEL, "model.dense_candidate_loss": dense,
        "data.synthetic": True, "data.synthetic_size": STAGE1_REGIONS,
        "train.device_data_cache": True, "train.batch_size": B_TRAIN,
        "train.max_steps": steps, "train.log_every": 1,
        "train.train_dir": train_dir, **MODEL_OVERRIDES})


def phase_stage1(report: dict, dev, root: str) -> dict:
    """Stage-1 training of vlmap_description (bidirectional encoder, K6/K7)
    at full width through Trainer.fit_resident, then with the dense
    candidate loss. The first run's parameters are saved under ``root`` for
    the transfer phase."""
    import torch
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.models.zoo import build_model
    from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
    from vqa_transfer_externaldata_torch.serving import PARAMS_FILE
    from vqa_transfer_externaldata_torch.utils.checkpoint import save_params

    steps = WARMUP_STEPS + TIMED_STEPS
    out = {}
    for tag, dense, n_steps in (("gathered", False, steps),
                                ("dense", True, DENSE_STEPS)):
        run_dir = os.path.join(root, tag)
        cfg = stage1_config(run_dir, n_steps, dense)
        t0 = time.perf_counter()
        ds = load_dataset(cfg, "train", stage="vlmap_desc")
        out[f"data_s_{tag}"] = time.perf_counter() - t0
        check(ds.size == STAGE1_REGIONS and
              ds.arrays["candidates"].shape[1] == cfg.model.num_candidates,
              f"stage-1 corpus: {ds.size} regions")
        spec = build_model(cfg, generator=torch.Generator().manual_seed(
            cfg.train.seed))
        trainer = Trainer(cfg, spec, train_dir=run_dir)  # default: CUDA
        check(trainer.device.type == dev.type, f"Trainer on {trainer.device}")
        state = trainer.init_state()
        data, make_batch, nbytes = trainer._prepare_resident(ds)
        idx0 = next(ds.index_batches(B_TRAIN, seed=cfg.train.seed))
        batch = make_batch(torch.from_numpy(idx0).to(dev))
        run = {"uploaded_gb": nbytes / 1e9, "first_step": check_first_step(
            spec, state, batch, dev, f"stage 1 ({tag})")}
        del data, make_batch, batch

        # --- this run's path: counts from 0 ------------------------------
        reset_counts()
        t0 = time.perf_counter()
        state = trainer.fit_resident(ds, state)
        torch.cuda.synchronize()
        run["fit_s"] = time.perf_counter() - t0
        launches = read_counts()
        # K6: one persistent launch for all timesteps of both chains; K7:
        # the persistent step kernel, the dU_h GEMM and the db_hn sum, both
        # chains each.
        check_launches(launches, {"bigru_fwd": n_steps,
                                  "bigru_bwd": 3 * n_steps},
                       f"stage-1 training ({tag}) over {n_steps} steps")
        check(state.step == n_steps, f"stage 1 ({tag}): {state.step} steps")
        run["launches"] = launches
        run.update(read_steps(run_dir, n_steps, f"stage-1 training ({tag})",
                              "regions", warmup=2 if dense else None))
        if not dense:
            state, run["profile"] = profile_fit(trainer, ds, state,
                                                PROFILE_STEPS)
            out["params_path"] = os.path.join(run_dir, PARAMS_FILE)
            save_params(out["params_path"], spec.module.state_dict())
        trainer.close()
        out[tag] = run
    return out


def phase_transfer(report: dict, dev, stage1_params: str) -> dict:
    """Stage 1's parameters through ``cli.train --train.pretrained_param_path``
    into full-width stage-2 training, the transferred tables frozen so that
    the run's final parameters show what arrived."""
    import torch
    from vqa_transfer_externaldata_torch.cli import train as train_cli
    from vqa_transfer_externaldata_torch.config import Config
    from vqa_transfer_externaldata_torch.data.datasets import synthetic_vocabs
    from vqa_transfer_externaldata_torch.serving import PARAMS_FILE
    from vqa_transfer_externaldata_torch.utils.checkpoint import load_params
    from vqa_transfer_externaldata_torch.utils.vocab import tokenize

    steps = TRANSFER_STEPS
    flags = {"data.synthetic": True, "data.synthetic_layout": "joined",
             "data.synthetic_size": TRANSFER_QUESTIONS,
             "train.device_data_cache": True, "train.batch_size": B_TRAIN,
             "train.max_steps": steps, "train.log_every": 1,
             "train.freeze_params": "word_emb,answer_embedding",
             "train.pretrained_param_path": stage1_params, **MODEL_OVERRIDES}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_transfer_") as tmp:
        argv = ["--train.train_dir", tmp] + cli_argv(flags)
        # --- this run's path: counts from 0 ------------------------------
        reset_counts()
        t0 = time.perf_counter()
        train_dir = train_cli.main(argv)  # default device: CUDA
        torch.cuda.synchronize()
        out = {"cli_s": time.perf_counter() - t0}
        launches = read_counts()
        check_launches(launches, {
            "gru_fwd": steps, "gru_bwd": 3 * steps,
            "attention_resident_fwd": 2 * steps,
            "attention_resident_bwd": 3 * steps},
            f"stage-2 training after the transfer over {steps} steps")
        out["launches"] = launches
        out.update(read_steps(train_dir, steps, "stage-2 training after the "
                              "transfer", "questions", warmup=2))
        s1 = load_params(stage1_params)
        s2 = load_params(os.path.join(train_dir, PARAMS_FILE))
    words, ans = s1["word_emb.embedding"], s2["answer_embedding"]
    check(torch.equal(s2["word_emb.embedding"], words),
          "the word table did not arrive bit for bit")
    cfg = Config().replace_flat(flags)
    wv, av = synthetic_vocabs(cfg)
    seeded = 0
    for a, answer in enumerate(av.tokens):
        ids = [wv.token_to_id[t] for t in tokenize(answer)
               if t in wv.token_to_id]
        if ids:
            row = words[ids].mean(dim=0)
            check(torch.equal(ans[a], row),
                  f"answer row {a} ({answer!r}) is not its words' mean")
            seeded += 1
    print(f"transfer: word table {tuple(words.shape)} arrived bit for bit; "
          f"{seeded} of {len(av)} answer rows equal their words' mean (the "
          f"rest are specials with no word)")
    check(seeded >= len(av) - 4, f"only {seeded} answer rows seeded")
    out.update(word_table_exact=True, answer_rows_seeded=seeded,
               answer_rows=len(av))
    return out


def phase_glimpses2(report: dict, dev) -> dict:
    """vqa_attention2 (two glimpses) at full width through fit_resident on
    the gather-free store: K4 and K5 at G=2. First step against the plain
    path, launch counts, step times; the resident evaluator against the
    gathered one; requests served through Predictor (the gathered
    spatial_attention_multi, as in the JAX package)."""
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.models.zoo import build_model
    from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
    from vqa_transfer_externaldata_torch.serving import PARAMS_FILE, Predictor
    from vqa_transfer_externaldata_torch.utils.checkpoint import save_params

    steps = WARMUP_STEPS + TIMED_STEPS
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_g2_") as tmp:
        cfg = stage2_config(tmp, steps, **{"model.model": "vqa_attention2"})
        ds = load_dataset(cfg, "train")
        val = load_dataset(cfg.replace_flat(
            {"data.synthetic_size": VAL_QUESTIONS}), "val")
        spec = build_model(cfg, generator=torch.Generator().manual_seed(
            cfg.train.seed))
        model = spec.module
        check(model.glimpses == 2 and tuple(model.att_ws.shape) == (H, 2),
              f"vqa_attention2 att_ws {tuple(model.att_ws.shape)}")
        trainer = Trainer(cfg, spec, train_dir=tmp)  # default device: CUDA
        state = trainer.init_state()
        data, make_batch, _ = trainer._prepare_resident(ds)
        idx0 = next(ds.index_batches(B_TRAIN, seed=cfg.train.seed))
        batch = make_batch(torch.from_numpy(idx0).to(dev))
        check(isinstance(batch["features"], tuple), "vqa_attention2 did not "
              "take the gather-free path")
        out["first_step"] = check_first_step(spec, state, batch, dev,
                                             "vqa_attention2")
        del data, make_batch, batch

        # --- this run's path: counts from 0 ------------------------------
        reset_counts()
        state = trainer.fit_resident(ds, state)
        torch.cuda.synchronize()
        launches = read_counts()
        # A step: K1 and K3 as on the main path, K4 two launches and K5
        # three, each covering both glimpses.
        check_launches(launches, {
            "gru_fwd": steps, "gru_bwd": 3 * steps,
            "attention_resident_fwd": 2 * steps,
            "attention_resident_bwd": 3 * steps},
            f"vqa_attention2 training over {steps} steps")
        out.update(launches=launches,
                   **read_steps(tmp, steps, "vqa_attention2 training",
                                "questions"))
        state, out["profile"] = profile_fit(trainer, ds, state,
                                            PROFILE_STEPS)
        # The gathered evaluator: K1, then spatial_attention_multi.
        out["evaluation"] = check_evaluation(
            trainer, state, val, None, dev, streamed_kernels={"gru_fwd": 1})

        # --- requests served through Predictor ---------------------------
        save_params(os.path.join(tmp, PARAMS_FILE), model.state_dict())
        with open(os.path.join(tmp, "config.json"), "w") as fh:
            fh.write(cfg.to_json())
        pred = Predictor(tmp, batch_size=B)  # the serving batch
        sel = np.arange(B)
        qs = [" ".join(pred.word_vocab.tokens[i] for i in row if i)
              for row in val.arrays["q_ids"][sel]]
        feats = np.asarray(val.store.grid[val.arrays["image_index"][sel]],
                           np.float32).reshape(B, N, C)
        reset_counts()
        answers = pred.answer(feats, qs)
        check_launches(read_counts(), {"gru_fwd": 1}, "vqa_attention2 serving")
        v = torch.from_numpy(feats).to(dev)
        q = torch.from_numpy(pred._encode_questions(qs)).to(dev)
        with torch.inference_mode():
            served = pred.model(v, q)["logits"]
            trained = model(v, q)["logits"]
        e = (served - trained).abs().max().item()
        check(len(answers) == B and all(a in pred.answer_vocab.tokens
                                         for a in answers)
              and bool(torch.isfinite(served).all()) and e == 0.0,
              f"vqa_attention2 served: {len(answers)} answers, logits "
              f"{e} from the trainer's")
        print(f"vqa_attention2 served {len(answers)} answers; logits equal "
              "the trained model's")
        out["served_answers"] = len(answers)
        trainer.close()
    return out


def phase_training_int8(report: dict, dev) -> dict:
    """The main path with ``train.store_quantize int8``: stage-2 training at
    full width through fit_resident on the int8 store (K1, K3, and K4/K5 on
    int8 rows), with the lagged in-loop evaluation of the val split, which
    reads its own int8 store. First step against the plain path on the same
    int8 store, launch counts, step times, a profiler window, the stores'
    bytes; then the resident evaluator on the int8 val store against the
    one on a bf16 store, on the same parameters."""
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.models.zoo import build_model
    from vqa_transfer_externaldata_torch.parallel.trainer import Trainer

    steps = WARMUP_STEPS + TIMED_STEPS
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_int8_") as tmp:
        cfg = stage2_config(tmp, steps, **{
            "train.store_quantize": "int8", "train.eval_every": EVAL_EVERY,
            "train.checkpoint_every": 10 * steps})
        ds = load_dataset(cfg, "train")
        val = load_dataset(cfg.replace_flat(
            {"data.synthetic_size": VAL_QUESTIONS}), "val")
        spec = build_model(cfg, generator=torch.Generator().manual_seed(
            cfg.train.seed))
        trainer = Trainer(cfg, spec, train_dir=tmp)  # default device: CUDA
        state = trainer.init_state()
        t0 = time.perf_counter()
        data, make_batch, _ = trainer._prepare_resident(ds)
        out["upload_s"] = time.perf_counter() - t0
        store = data["grid"]
        Np = store.shape[1]
        check(store.dtype == torch.int8 and tuple(store.shape) ==
              (TRAIN_IMAGES, Np, C), f"int8 store {store.dtype} "
              f"{tuple(store.shape)}")
        out["store_bytes"] = {"int8": store.numel(),
                              "bf16": store.numel() * 2}
        idx0 = next(ds.index_batches(B_TRAIN, seed=cfg.train.seed))
        batch = make_batch(torch.from_numpy(idx0).to(dev))
        check(len(batch["features"]) == 3, "the int8 batch carries no scale")
        out["scale"] = scale = batch["features"][2]
        print(f"int8 store uploaded in {out['upload_s']:.2f} s: "
              f"{out['store_bytes']['int8'] / 1e6:.1f} MB (bf16: "
              f"{out['store_bytes']['bf16'] / 1e6:.1f} MB), scale {scale:.6g}")
        check(0.0 < scale < 1.0, f"int8 scale {scale}")
        out["first_step"] = check_first_step(spec, state, batch, dev,
                                             "stage 2 (int8 store)")
        del data, make_batch, batch, store

        # --- this run's path: counts from 0 ------------------------------
        reset_counts()
        state = trainer.fit_resident(ds, state, eval_ds=val)
        torch.cuda.synchronize()
        launches = read_counts()
        evals = steps // EVAL_EVERY
        n_batches = -(-VAL_QUESTIONS // B_TRAIN)
        check_launches(launches, {
            "gru_fwd": steps + evals * n_batches,
            "gru_bwd": 3 * steps,
            "attention_resident_fwd[int8]": 2 * (steps + evals * n_batches),
            "attention_resident_bwd[int8]": 3 * steps},
            f"int8-store training over {steps} steps with {evals} "
            "evaluations")
        out.update(launches=launches,
                   **read_steps(tmp, steps, "int8-store training",
                                "questions"))
        with open(os.path.join(tmp, "metrics.jsonl")) as fh:
            val_recs = [r for r in map(json.loads, fh) if "val/loss" in r]
        check(len(val_recs) == evals and all(np.isfinite(r["val/loss"])
                                             for r in val_recs),
              f"int8 in-loop evaluations: {val_recs}")
        out["val_records"] = val_recs
        state, out["profile"] = profile_fit(trainer, ds, state,
                                            PROFILE_STEPS)

        # --- the resident evaluator: int8 val store, then a bf16 one -----
        reset_counts()
        t0 = time.perf_counter()
        m_q, p_q = trainer.evaluate_resident(state, val)
        out["eval_int8_s"] = time.perf_counter() - t0
        check_launches(read_counts(), {
            "gru_fwd": n_batches,
            "attention_resident_fwd[int8]": 2 * n_batches},
            "int8 resident evaluation")
        bf16 = Trainer(cfg.replace_flat({"train.store_quantize": ""}), spec,
                       train_dir=os.path.join(tmp, "bf16_eval"))
        reset_counts()
        m_f, p_f = bf16.evaluate_resident(state, val)
        check_launches(read_counts(), {
            "gru_fwd": n_batches,
            "attention_resident_fwd": 2 * n_batches},
            "bf16 resident evaluation")
        bf16.close()
        agree = float((p_q == p_f).mean())
        print(f"resident evaluation, int8 val store {m_q} vs bf16 {m_f}: "
              f"{agree:.4f} of the predictions agree")
        check(np.isfinite(m_q["loss"]) and abs(m_q["loss"] - m_f["loss"])
              <= 0.05 * abs(m_f["loss"]), f"int8 eval loss {m_q['loss']} vs "
              f"bf16 {m_f['loss']}")
        out["evaluation"] = {"int8": m_q, "bf16": m_f,
                             "predictions_agree": agree}
        trainer.close()
    return out


def cli_argv(flags: dict) -> list:
    """``--section.field value`` for each of ``flags``."""
    argv = []
    for k, v in flags.items():
        argv += [f"--{k}", str(v).lower() if isinstance(v, bool) else str(v)]
    return argv


def real_data_words(n: int) -> list:
    """``n`` distinct two-syllable words (a seeded permutation of the 4900
    pairs of 70 syllables), each its own normalized answer."""
    import numpy as np
    from vqa_transfer_externaldata_torch.utils.metrics import normalize_answer

    syllables = [c + v for c in "bdfgklmnprstvz" for v in "aeiou"]
    pairs = [a + b for a in syllables for b in syllables]
    order = np.random.default_rng(17).permutation(len(pairs))
    words = [pairs[i] for i in order if normalize_answer(pairs[i])
             == pairs[i]]
    check(len(words) >= n, f"only {len(words)} words for {n}")
    return words[:n]


def write_real_data(root: str, word_dim: int) -> dict:
    """The real-data fixtures, written from a seed in the official schemas:
    VQA v2 questions and annotations (train and val) over REAL_IMAGES
    COCO-like image ids, with yes/no, number and other answers, the train
    split cycling through REAL_OTHER_ANSWERS other answers; Visual Genome
    region descriptions over the same images, whose words are the
    questions' and the answers'; a GloVe text file of ``word_dim``
    vectors for every other word. Returns their paths and the image ids."""
    import numpy as np

    rng = np.random.default_rng(23)
    words = real_data_words(REAL_WORDS)
    answers = words[:REAL_OTHER_ANSWERS]
    image_ids = 100000 + 37 * np.arange(REAL_IMAGES, dtype=np.int64)

    def word() -> str:
        return words[int(rng.integers(len(words)))]

    def split(n: int, qid0: int, cycle: bool) -> tuple:
        questions, annotations, other = [], [], 0
        for i in range(n):
            a, b = word(), word()
            kind = i % 8
            if kind == 0:
                q, qt, at = f"is the {a} {b}?", "is the", "yes/no"
                ans, alt = ("yes", "no")[::1 if rng.integers(2) else -1]
            elif kind == 1:
                q, qt, at = (f"how many {a} are there near the {b}?",
                             "how many", "number")
                ans, alt = (str(k) for k in rng.integers(0, 11, 2))
            else:
                q, qt = ((f"what color is the {a}?", "what color is the")
                         if kind == 2 else
                         (f"what is the {a} near the {b}?", "what is the"))
                at = "other"
                ans = answers[other % len(answers) if cycle
                              else int(rng.integers(len(answers)))]
                alt = answers[int(rng.integers(len(answers)))]
                other += 1
            qid = qid0 + i
            image = int(image_ids[rng.integers(REAL_IMAGES)])
            questions.append({"question_id": qid, "image_id": image,
                              "question": q})
            annotations.append({
                "question_id": qid, "image_id": image,
                "multiple_choice_answer": ans, "question_type": qt,
                "answer_type": at,
                "answers": [{"answer": ans}] * 7 + [{"answer": alt}] * 3})
        return {"questions": questions}, {"annotations": annotations}

    paths = {}
    for name, n, qid0, cycle in (("train", REAL_TRAIN_QUESTIONS, 1, True),
                                 ("val", REAL_VAL_QUESTIONS, 10 ** 7, False)):
        qs, anns = split(n, qid0, cycle)
        for kind, obj in (("questions", qs), ("annotations", anns)):
            paths[f"{name}_{kind}"] = os.path.join(root, f"{name}_{kind}.json")
            with open(paths[f"{name}_{kind}"], "w") as fh:
                json.dump(obj, fh)
    by_image: dict = {}
    for r in range(REAL_REGIONS):
        a, b, c = word(), word(), word()
        phrase = (f"a {a} {b}", f"{a} {b} on the {c}",
                  f"the {a} near a {b}")[r % 3]
        x, y, w, h = (int(v) for v in rng.integers(1, 300, 4))
        by_image.setdefault(int(image_ids[r % REAL_IMAGES]), []).append(
            {"region_id": r, "phrase": phrase, "x": x, "y": y, "width": w,
             "height": h})
    paths["regions"] = os.path.join(root, "region_descriptions.json")
    with open(paths["regions"], "w") as fh:
        json.dump([{"id": i, "regions": regs}
                   for i, regs in by_image.items()], fh)
    paths["glove"] = os.path.join(root, "glove.txt")
    glove_words = words[::2] + ["what", "is", "the", "color", "how", "many"]
    vectors = rng.normal(0.0, 0.4, (len(glove_words), word_dim))
    with open(paths["glove"], "w") as fh:
        for w, vec in zip(glove_words, vectors):
            fh.write(w + " " + " ".join(f"{x:.5f}" for x in vec) + "\n")
    paths["image_ids"] = image_ids
    return paths


def write_raw_store(path: str, ids, grid_hw: int, channels: int,
                    seed: int) -> None:
    """A feature store as the extractor's raw directory (``meta.json``,
    f16 [M, g, g, C] ``grid.f16.bin``, f32 [M, C] ``pool5.f32.bin``,
    ``image_ids.npy``), filled from a seed in chunks of 64 rows."""
    import numpy as np

    rng = np.random.default_rng(seed)
    m = len(ids)
    os.makedirs(path)
    grid = np.memmap(os.path.join(path, "grid.f16.bin"), dtype=np.float16,
                     mode="w+", shape=(m, grid_hw, grid_hw, channels))
    pool5 = np.memmap(os.path.join(path, "pool5.f32.bin"), dtype=np.float32,
                      mode="w+", shape=(m, channels))
    for lo in range(0, m, 64):
        hi = min(m, lo + 64)
        grid[lo:hi] = np.maximum(rng.standard_normal(
            (hi - lo, grid_hw, grid_hw, channels), np.float32), 0)
        pool5[lo:hi] = rng.standard_normal((hi - lo, channels), np.float32)
    grid.flush()
    pool5.flush()
    del grid, pool5
    np.save(os.path.join(path, "image_ids.npy"), np.asarray(ids, np.int64))
    with open(os.path.join(path, "meta.json"), "w") as fh:
        json.dump({"grid_shape": [m, grid_hw, grid_hw, channels],
                   "pool5_dim": channels}, fh)


def phase_real_data(report: dict, dev) -> dict:
    """The real-data path at the full width of config.py, through the
    port's entry points: fixtures in the official schemas and two raw
    feature stores written from a seed, the three ``cli.preprocess``
    subcommands, ``cli.train`` stage 1 (``vlmap_description``,
    bidirectional, on the region store with resampled negatives: streamed,
    K6/K7), ``cli.train`` stage 2 transfer-initialized from it (gather-free
    resident, K1/K3/K4/K5, with the lagged in-loop evaluation), ``cli.eval``
    on host batches (the lazy join, K1/K2) and ``cli.predict`` by image id
    (K1/K2). Each stage's first step is held against the plain path."""
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.cli import eval as eval_cli
    from vqa_transfer_externaldata_torch.cli import predict as predict_cli
    from vqa_transfer_externaldata_torch.cli import train as train_cli
    from vqa_transfer_externaldata_torch.cli.common import build_spec
    from vqa_transfer_externaldata_torch.cli.preprocess import (
        main as preprocess)
    from vqa_transfer_externaldata_torch.config import Config
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.data.features import (
        FeatureStore, JoinedDataset)
    from vqa_transfer_externaldata_torch.data.visualgenome import (
        CandidateResampler)
    from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
    from vqa_transfer_externaldata_torch.serving import PARAMS_FILE, Predictor
    from vqa_transfer_externaldata_torch.utils.vocab import Vocab

    widths = Config().replace_flat(MODEL_OVERRIDES)
    d, m = widths.data, widths.model
    device = ["--device", str(dev)]
    out: dict = {"sizes": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_real_") as root:
        t0 = time.perf_counter()
        fx = write_real_data(root, m.word_dim)
        out["fixtures_s"] = time.perf_counter() - t0
        images = os.path.join(root, "image_store")
        regions = os.path.join(root, "region_store")
        rng = np.random.default_rng(29)
        t0 = time.perf_counter()
        write_raw_store(images, rng.permutation(fx["image_ids"]), d.grid_h,
                        d.feature_dim, seed=31)
        write_raw_store(regions, np.arange(REAL_REGIONS), 1, d.pool5_dim,
                        seed=37)
        out["store_write_s"] = time.perf_counter() - t0
        out["sizes"]["store_bytes"] = {
            name: sum(os.path.getsize(os.path.join(p, f))
                      for f in os.listdir(p))
            for name, p in (("images", images), ("regions", regions))}

        # --- the three preprocessing subcommands -------------------------
        pre, vg = os.path.join(root, "vqa_v2"), os.path.join(root, "vg")
        glove = os.path.join(root, "glove_vocab.npz")
        vocab_json = os.path.join(pre, "vocab.json")
        secs = {}
        for tool, argv in (
                ("vqa_v2", ["--out_dir", pre,
                            "--train_questions", fx["train_questions"],
                            "--train_annotations", fx["train_annotations"],
                            "--val_questions", fx["val_questions"],
                            "--val_annotations", fx["val_annotations"],
                            "--top_k", str(REAL_TOP_K),
                            "--vocab_pad_to", str(d.vocab_size),
                            "--max_question_len", str(d.max_question_len),
                            "--answer_holdout_fraction", str(REAL_HOLDOUT),
                            "--feature_path", images]),
                ("visualgenome", ["--out_dir", vg, "--region_descriptions",
                                  fx["regions"], "--vocab", vocab_json,
                                  "--num_tasks", str(m.num_tasks),
                                  "--num_candidates", str(m.num_candidates),
                                  "--min_word_count", "2",
                                  "--max_desc_len", str(d.max_question_len)]),
                ("glove", ["--out", glove, "--glove_txt", fx["glove"],
                           "--vocab", vocab_json, "--dim", str(m.word_dim),
                           "--pad_to", str(d.vocab_size)])):
            t0 = time.perf_counter()
            preprocess([tool] + argv)
            secs[tool] = time.perf_counter() - t0
        out["preprocess_s"] = secs
        print("real data: preprocessing " + ", ".join(
            f"{k} {v:.2f} s" for k, v in secs.items())
            + f"; fixtures {out['fixtures_s']:.2f} s, feature stores "
            f"{out['store_write_s']:.2f} s ({out['sizes']['store_bytes']} "
            "bytes)")
        answer_vocab = Vocab.load(os.path.join(pre, "answer_vocab.json"))
        word_vocab = Vocab.load(vocab_json)
        num_answers = len(answer_vocab)
        with open(os.path.join(pre, "oov_split.json")) as fh:
            oov_ids = json.load(fh)["oov_ids"]
        with open(os.path.join(vg, "vlmap_desc_meta.json")) as fh:
            vg_meta = json.load(fh)
        with open(fx["val_questions"]) as fh:
            val_questions = json.load(fh)["questions"]
        store = FeatureStore(images)
        val_arrays = np.load(os.path.join(pre, "vqa_val.npz"))
        check(num_answers == REAL_TOP_K + 4
              and len(word_vocab) <= d.vocab_size and len(oov_ids) ==
              round(REAL_HOLDOUT * REAL_TOP_K) and np.array_equal(
                  val_arrays["image_index"],
                  [store.index_of[q["image_id"]] for q in val_questions]),
              f"artifacts: {num_answers} answers, {len(word_vocab)} words, "
              f"{len(oov_ids)} held out")
        held = np.isin(val_arrays["answer_id"], oov_ids)
        out["sizes"].update(
            train_questions=REAL_TRAIN_QUESTIONS,
            val_questions=REAL_VAL_QUESTIONS, images=REAL_IMAGES,
            regions=REAL_REGIONS, words=len(word_vocab),
            answers=num_answers, held_out_answers=len(oov_ids),
            val_questions_held_out=int(held.sum()),
            blanks=vg_meta["num_examples"],
            visual_words=vg_meta["num_words"],
            tasks=vg_meta["task_names"][:2] + ["..."])
        print(f"real data: {out['sizes']}")

        # --- stage 1: vlmap_description on the region store --------------
        steps1 = REAL_STAGE1_STEPS
        s1 = {**MODEL_OVERRIDES, **STAGE1_MODEL,
              "data.dataset_dir": vg, "data.feature_path": regions,
              "data.vocab_path": vocab_json, "data.glove_path": glove,
              "train.batch_size": B_TRAIN, "train.max_steps": steps1,
              "train.log_every": 1, "train.eval_every": steps1,
              "train.checkpoint_every": steps1}
        cfg1 = Config().replace_flat(s1)
        ds1 = load_dataset(cfg1, "train", stage="vlmap_desc")
        val1 = load_dataset(cfg1, "val", stage="vlmap_desc")
        check(isinstance(ds1, CandidateResampler)
              and isinstance(ds1.base, JoinedDataset),
              f"stage-1 split {type(ds1).__name__}")
        spec, _, _ = build_spec(cfg1, generator=torch.Generator().manual_seed(
            cfg1.train.seed))
        trainer = Trainer(cfg1, spec, train_dir=os.path.join(root, "chk1"),
                          device=str(dev))
        state = trainer.init_state()
        batch = trainer._uploader()(next(ds1.batches(
            B_TRAIN, seed=cfg1.train.seed)))
        check(tuple(batch["feature"].shape) == (B_TRAIN, d.pool5_dim),
              f"stage-1 feature {tuple(batch['feature'].shape)}")
        out["stage1_first_step"] = check_first_step(
            spec, state, batch, dev, "real-data stage 1")
        trainer.close()
        del trainer, state, batch, spec

        # --- this run's path: counts from 0 ------------------------------
        reset_counts()
        t0 = time.perf_counter()
        s1_dir = train_cli.main(device + cli_argv(s1) + [
            "--train.train_dir", os.path.join(root, "stage1")])
        torch.cuda.synchronize()
        out["stage1_cli_s"] = time.perf_counter() - t0
        eval1 = -(-len(val1) // B_TRAIN)
        out["stage1_launches"] = launches = read_counts()
        # K6 one launch a step and one an evaluation batch; K7 three a step.
        check_launches(launches, {"bigru_fwd": steps1 + eval1,
                                  "bigru_bwd": 3 * steps1},
                       f"real-data stage 1 over {steps1} steps and "
                       f"{eval1} evaluation batches")
        out["stage1"] = read_steps(s1_dir, steps1, "real-data stage 1 "
                                   "(streamed, resampled)", "regions",
                                   warmup=2)

        # --- stage 2: vqa_attention, transferred, gather-free ------------
        steps2, every = REAL_STAGE2_STEPS, REAL_EVAL_EVERY
        s2 = {**MODEL_OVERRIDES, "data.dataset_dir": pre,
              "data.feature_path": images, "data.vocab_path": vocab_json,
              "data.answer_vocab_path": os.path.join(pre, "answer_vocab.json"),
              "data.num_answers": num_answers,
              "train.device_data_cache": True, "train.batch_size": B_TRAIN,
              "train.max_steps": steps2, "train.log_every": 1,
              "train.eval_every": every, "train.checkpoint_every": steps2}
        cfg2 = Config().replace_flat(s2)
        ds2 = load_dataset(cfg2, "train")
        check(isinstance(ds2, JoinedDataset) and ds2.size ==
              REAL_TRAIN_QUESTIONS and ds2.store.grid.shape[0] ==
              REAL_IMAGES, f"stage-2 split {type(ds2).__name__}")
        spec, _, _ = build_spec(cfg2, generator=torch.Generator().manual_seed(
            cfg2.train.seed))
        trainer = Trainer(cfg2, spec, train_dir=os.path.join(root, "chk2"),
                          device=str(dev))
        state = trainer.init_state()
        _, make_batch, nbytes = trainer._prepare_resident(ds2)
        out["stage2_uploaded_gb"] = nbytes / 1e9
        idx0 = next(ds2.index_batches(B_TRAIN, seed=cfg2.train.seed))
        out["stage2_first_step"] = check_first_step(
            spec, state, make_batch(torch.from_numpy(idx0).to(dev)), dev,
            "real-data stage 2")
        trainer.close()
        del trainer, state, make_batch, spec

        reset_counts()
        t0 = time.perf_counter()
        s2_dir = train_cli.main(device + cli_argv(s2) + [
            "--train.pretrained_param_path",
            os.path.join(s1_dir, PARAMS_FILE),
            "--train.train_dir", os.path.join(root, "stage2")])
        torch.cuda.synchronize()
        out["stage2_cli_s"] = time.perf_counter() - t0
        eval2 = (steps2 // every) * -(-REAL_VAL_QUESTIONS // B_TRAIN)
        out["stage2_launches"] = launches = read_counts()
        check_launches(launches, {
            "gru_fwd": steps2 + eval2, "gru_bwd": 3 * steps2,
            "attention_resident_fwd": 2 * (steps2 + eval2),
            "attention_resident_bwd": 3 * steps2},
            f"real-data stage 2 over {steps2} steps and {eval2} evaluation "
            "batches")
        out["stage2"] = read_steps(s2_dir, steps2, "real-data stage 2 "
                                   "(gather-free, transferred)", "questions")
        with open(os.path.join(s2_dir, "metrics.jsonl")) as fh:
            recs = [r for r in map(json.loads, fh) if "val/loss" in r]
        check([r["step"] for r in recs] == list(range(every, steps2 + 1,
                                                      every))
              and all(np.isfinite(r["val/vqa_accuracy"]) for r in recs),
              f"in-loop evaluations: {recs}")

        # --- cli.eval on host batches: the lazy join, K1/K2 ---------------
        reset_counts()
        t0 = time.perf_counter()
        metrics = eval_cli.main(device + ["--train.train_dir", s2_dir,
                                          "--train.device_data_cache",
                                          "false"])
        out["eval_cli_s"] = time.perf_counter() - t0
        batches = -(-REAL_VAL_QUESTIONS // B_TRAIN)
        out["eval_launches"] = launches = read_counts()
        check_launches(launches, {"gru_fwd": batches,
                                  "attention_fwd": 2 * batches},
                       f"real-data cli.eval over {batches} batches")
        with open(os.path.join(s2_dir, "results_val.json")) as fh:
            results = json.load(fh)
        check(sorted(r["question_id"] for r in results) == sorted(
            q["question_id"] for q in val_questions)
              and all(r["answer"] in answer_vocab.token_to_id
                      for r in results),
              f"results_val.json: {len(results)} rows")
        types = json.load(open(os.path.join(pre, "types.json")))
        counts = np.bincount(val_arrays["answer_type_id"],
                             minlength=len(types["answer_types"]))
        mix = sum(int(counts[t]) * metrics[
            "vqa_accuracy_answer_type/" + name.replace("/", "_")]
            for t, name in enumerate(types["answer_types"]) if counts[t])
        check({"vqa_accuracy_answer_type/yes_no",
               "vqa_accuracy_answer_type/number",
               "vqa_accuracy_answer_type/other",
               "vqa_accuracy_oov_answers",
               "vqa_accuracy_in_vocab_answers"} <= set(metrics)
              and abs(mix / counts.sum() - metrics["vqa_accuracy"]) < 1e-6
              and all(np.isfinite(v) for v in metrics.values()),
              f"cli.eval metrics: {metrics}")
        out["eval_metrics"] = metrics
        print(f"real-data cli.eval: {len(results)} results; {metrics}")

        # --- cli.predict by image id --------------------------------------
        picked = val_questions[:REAL_PREDICT]
        argv = device + ["--train_dir", s2_dir, "--feature_path", images]
        for q in picked:
            argv += ["--image_id", str(q["image_id"]), "--question",
                     q["question"]]
        reset_counts()
        answers = predict_cli.main(argv)
        out["predict_launches"] = launches = read_counts()
        check_launches(launches, {"gru_fwd": 1, "attention_fwd": 2},
                       "real-data cli.predict")
        pred = Predictor(s2_dir, device=str(dev))
        rows = np.asarray([store.index_of[q["image_id"]] for q in picked])
        direct = pred.answer(store.gather(rows)["features"],
                             [q["question"] for q in picked])
        check(answers == direct and len(answers) == REAL_PREDICT,
              f"cli.predict answers {answers} vs Predictor {direct}")
        print(f"real-data cli.predict: {answers}")
        out["predict_answers"] = answers
        store.close()
    return out


def phase_oov(report: dict, dev) -> dict:
    """The paper's claim on the card: ``tools/oov_claim.py``'s protocol
    (the CPU test's, the JAX package's ``test_transfer_beats_scratch_on_
    oov_answers``) at OOV_WIDTHS, the smallest widths every kernel wrapper
    takes in bf16, the corpus drawn at OOV_CONCEPT_DIM channels and
    zero-padded: stage 1 ``vlmap`` (no kernel), the transfer, stage 2 from
    the transferred and from a fresh answer table (frozen; K1/K3, K2/K8 on
    streamed batches, K1/K2 in the evaluations); JAX's thresholds."""
    from vqa_transfer_externaldata_torch.config import Config
    from vqa_transfer_externaldata_torch.tools import oov_claim

    cfg = Config().replace_flat({**oov_claim.TINY, **OOV_WIDTHS})
    with tempfile.TemporaryDirectory(prefix="chip_smoke_oov_") as tmp:
        # --- this run's path: counts from 0 ------------------------------
        reset_counts()
        out = oov_claim.run(cfg, device=dev, train_dir=tmp,
                            concept_dim=OOV_CONCEPT_DIM)
        out["launches"] = launches = read_counts()
    steps, B = cfg.train.max_steps, cfg.train.batch_size
    evals = 2 * -(-oov_claim.CORPUS["n_val"] // B)
    check_launches(launches, {
        "gru_fwd": 2 * steps + evals, "gru_bwd": 6 * steps,
        "attention_fwd": 2 * (2 * steps + evals),
        "attention_bwd": 8 * steps},
        f"the OOV claim: stage 1, then two stage-2 runs of {steps} steps "
        "and their evaluations")
    out["widths"] = OOV_WIDTHS
    print(f"OOV claim on the card: OOV answers transfer "
          f"{out['oov_transfer']:.4f}, scratch {out['oov_scratch']:.4f}; "
          f"in-vocabulary transfer {out['in_vocab_transfer']:.4f}, scratch "
          f"{out['in_vocab_scratch']:.4f} (thresholds: in-vocab > 0.5, OOV "
          f"transfer > 0.3 and > 3 x max(scratch, "
          f"1/{cfg.data.num_answers})); seconds {out['seconds']}")
    check(out["meets_thresholds"],
          f"the OOV claim misses JAX's thresholds: {out}")
    return out


def e2e_grid_errors(got, want) -> dict:
    """Mean and largest |error| of ``got`` against ``want`` (float32),
    relative to the mean and the largest |value| of ``want``, and the
    cosine of the flattened tensors."""
    import torch

    a, b = got.float().flatten(), want.float().flatten()
    d = (a - b).abs()
    return {"mean_rel": (d.mean() / b.abs().mean()).item(),
            "max_rel": (d.max() / b.abs().max()).item(),
            "cos": torch.nn.functional.cosine_similarity(a, b, 0).item()}


def write_jpegs(root: str, n: int, seed: int) -> tuple:
    """``n`` seeded COCO-named JPEGs (train2014) of 480 x 640 pixels (the
    decoder resizes them) and the ids in their names."""
    import numpy as np
    from PIL import Image
    from vqa_transfer_externaldata_torch.data.ingest import coco_image_path

    rng = np.random.default_rng(seed)
    image_dir = os.path.join(root, "coco")
    os.makedirs(image_dir, exist_ok=True)
    ids = np.sort(rng.choice(np.arange(1, 600000), n, replace=False))
    # Smooth images (a coarse field upsampled), as photographs are: JPEG
    # keeps them close to what was drawn.
    for i in ids:
        coarse = rng.integers(0, 256, (15, 20, 3)).astype(np.uint8)
        Image.fromarray(coarse).resize((640, 480), Image.BILINEAR).save(
            coco_image_path(image_dir, "train2014", int(i)), quality=90)
    return image_dir, ids


def e2e_head_kernels(v, dev, buf) -> dict:
    """The end2end head's K2 and K8 on the backbone's bf16 grid ``v`` [B,
    196, 2048] (a view of its channels_last activations) at the training
    batch and at the serving one (its first E2E_PREDICT rows): K2's checks
    (``k2_checks``), K8 against its plain version in the path's mode
    (normalize on; K8's limits), and both times beside their plain
    versions' and their bounds."""
    import torch
    from vqa_transfer_externaldata_torch.ops import attention

    gen = torch.Generator(device=dev).manual_seed(67)
    Cv = v.shape[-1]
    qh_all = torch.randn(v.shape[0], H, generator=gen, device=dev) * 0.5
    lim = (6.0 / (Cv + H)) ** 0.5
    wv = ((torch.rand(Cv, H, generator=gen, device=dev) * 2 - 1) * lim
          ).to(torch.bfloat16)
    ws = (torch.randn(H, generator=gen, device=dev) * 0.05).to(
        torch.bfloat16).float()
    out = {}
    for Bq in (v.shape[0], E2E_PREDICT):
        vb, qh = v[:Bq], qh_all[:Bq]
        Nq = vb.shape[1]
        k2 = k2_checks(vb, qh, wv, ws)
        va, al, r = attention.attention_fwd(vb, qh, wv, ws, normalize=True)
        ds = (torch.randn(Bq, Nq, generator=gen, device=dev) * al
              ).contiguous()
        got = attention.attention_bwd(vb, qh, wv, ws, ds, r, True)
        want = attention.attention_bwd_reference(vb, qh, wv, ws, ds, r, True)
        torch.cuda.synchronize()
        a_dqh, a_dwv, unsure = k8_allowance(vb, qh, wv, ws, ds, r, True)
        k8 = []
        for name, a, b, allow in zip(("dqh", "dwv", "dws"), got, want,
                                     (a_dqh, a_dwv, 0.0)):
            limit = TOL_K8_REL * b.abs().max().item() + allow
            worst = ((a - b).abs() / limit).max().item()
            check(bool(torch.isfinite(a).all()) and worst <= 1.0,
                  f"K8 on the ResNet grid B={Bq} {name}: an entry at "
                  f"{worst} of its limit")
            k8.append({"output": name,
                       "max_abs_err": (a - b).abs().max().item(),
                       "rel_err": rel_err(a, b), "units_near_zero": unsure,
                       "worst_share_of_limit": worst})
        # The bounds: the grid once and W_v once; K2 its score GEMM and
        # weighted sum, K8 its two [B*N, C] x [C, H] GEMMs.
        nbytes = vb.numel() * 2 + wv.numel() * 2
        gemm = 2.0 * Bq * Nq * Cv * H
        b2, b8 = bound(nbytes, gemm + 2.0 * Bq * Nq * Cv), bound(nbytes,
                                                                  2 * gemm)
        t = {"k2": time_cuda(lambda: attention.attention_fwd(
                 vb, qh, wv, ws, normalize=True), buf),
             "k2_plain": time_cuda(lambda: attention.attention_fwd_reference(
                 vb, qh, wv, ws, True), buf),
             "k8": time_cuda(lambda: attention.attention_bwd(
                 vb, qh, wv, ws, ds, r, True), buf),
             "k8_plain": time_cuda(lambda: attention.attention_bwd_reference(
                 vb, qh, wv, ws, ds, r, True), buf)}
        out[Bq] = {"k2_checks": k2, "k8_checks": k8,
                   "k2": {"ms": t["k2"], "plain_ms": t["k2_plain"],
                          "bound_ms": b2[0], "bound_by": b2[1]},
                   "k8": {"ms": t["k8"], "plain_ms": t["k8_plain"],
                          "bound_ms": b8[0], "bound_by": b8[1]}}
        print(f"end2end head on the ResNet grid at B={Bq}: K2 {t['k2']:.4f} "
              f"ms (plain {t['k2_plain']:.4f}, bound {b2[0]:.4f}), K8 "
              f"{t['k8']:.4f} ms (plain {t['k8_plain']:.4f}, bound "
              f"{b8[0]:.4f}); K8's worst entry at "
              f"{max(c['worst_share_of_limit'] for c in k8):.3f} of its "
              "limit")
    return out


def phase_end2end(report: dict, dev) -> dict:
    """The raw-image model at the full width of config.py (phase 22; see
    the module docstring)."""
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.cli import eval as eval_cli
    from vqa_transfer_externaldata_torch.cli import train as train_cli
    from vqa_transfer_externaldata_torch.cli.common import (
        build_spec, load_resnet_backbone)
    from vqa_transfer_externaldata_torch.config import Config
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.models.end2end import (
        VQAEnd2EndModel)
    from vqa_transfer_externaldata_torch.ops import resnet
    from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
    from vqa_transfer_externaldata_torch.serving import PARAMS_FILE, Predictor
    from vqa_transfer_externaldata_torch.utils.checkpoint import load_params

    t_phase = time.perf_counter()
    device = ["--device", str(dev)]
    stages = tuple(int(x) for x in E2E_STAGES.split(","))
    out: dict = {"sizes": {"batch": E2E_BATCH, "image_size": E2E_SIZE,
                           "images": E2E_IMAGES, "stages": E2E_STAGES,
                           "width": E2E_WIDTH}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_e2e_") as root:
        # --- a seeded torchvision-format checkpoint ------------------------
        pth = os.path.join(root, "resnet101.pth")
        src = resnet.ResNetV1(stages, E2E_WIDTH, dtype=torch.float32,
                              stem="conv",
                              generator=torch.Generator().manual_seed(41))
        g = torch.Generator().manual_seed(43)
        with torch.no_grad():
            for m in src.modules():
                if isinstance(m, resnet.BatchNorm):
                    m.mean.normal_(0.0, 0.5, generator=g)
                    m.var.uniform_(0.5, 1.5, generator=g)
        torch.save(resnet.torchvision_state_dict(src), pth)
        del src
        flags = {**MODEL_OVERRIDES, "model.model": "vqa_end2end",
                 "model.resnet_checkpoint": pth,
                 "model.resnet_stages": E2E_STAGES,
                 "model.resnet_width": E2E_WIDTH,
                 "data.image_size": E2E_SIZE, "data.synthetic": True,
                 "data.synthetic_size": E2E_IMAGES,
                 "train.device_data_cache": True,
                 "train.batch_size": E2E_BATCH,
                 "train.max_steps": E2E_STEPS, "train.log_every": 1,
                 "train.eval_every": 10 ** 6,
                 "train.checkpoint_every": E2E_STEPS}
        cfg = Config().replace_flat(flags)
        backbone = load_resnet_backbone(cfg)

        # --- 1. the backbone alone: bf16 against float32 on the card ------
        nets = {}
        for dt in (torch.bfloat16, torch.float32):
            with torch.device("meta"):
                net = resnet.ResNetV1(stages, E2E_WIDTH, dtype=dt,
                                      stem=VQAEnd2EndModel.stem)
            net.load_state_dict(backbone, assign=True)
            nets[dt] = net.to(dev).eval()
        gen = torch.Generator(device=dev).manual_seed(47)
        images = torch.randint(0, 256, (E2E_BATCH, E2E_SIZE, E2E_SIZE, 3),
                               generator=gen, device=dev, dtype=torch.uint8)
        with torch.inference_mode():
            x = resnet.preprocess_images(images, E2E_SIZE)
            ob, of = nets[torch.bfloat16](x), nets[torch.float32](x)
        check(tuple(ob["grid"].shape) == (E2E_BATCH, E2E_SIZE // 32,
                                          E2E_SIZE // 32, 32 * E2E_WIDTH)
              and ob["grid"].dtype == torch.bfloat16
              and ob["grid"].is_contiguous(),
              f"backbone grid {tuple(ob['grid'].shape)} {ob['grid'].dtype}")
        errs = {k: e2e_grid_errors(ob[k], of[k]) for k in ("grid", "pool5")}
        out["backbone_vs_f32"] = errs
        print(f"end2end backbone at B={E2E_BATCH}, {E2E_SIZE}px: bf16 vs "
              f"float32 on the card {errs} (limits: mean "
              f"{TOL_BACKBONE_MEAN}, max {TOL_BACKBONE_MAX}, cosine "
              f"{BACKBONE_COS})")
        for k, e in errs.items():
            check(e["mean_rel"] <= TOL_BACKBONE_MEAN
                  and e["max_rel"] <= TOL_BACKBONE_MAX
                  and e["cos"] >= BACKBONE_COS
                  and bool(torch.isfinite(ob[k]).all()),
                  f"backbone {k} vs float32: {e}")
        buf = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
        v = ob["grid"].reshape(E2E_BATCH, -1, ob["grid"].shape[-1])
        check(v.is_contiguous() and v.data_ptr() == ob["grid"].data_ptr(),
              "the backbone's grid rows are not a view of its activations")
        out["head_kernels"] = e2e_head_kernels(v, dev, buf)
        del v
        macs = resnet.conv_macs(nets[torch.bfloat16], E2E_SIZE)
        with torch.inference_mode():
            ms = time_cuda(lambda: nets[torch.bfloat16](x), buf)
            ms_f32 = time_cuda(lambda: nets[torch.float32](x), buf)
            model_ms = time_cuda(
                lambda: nets[torch.bfloat16](resnet.preprocess_images(
                    images, E2E_SIZE)), buf)
        bound_ms = 2 * macs * E2E_BATCH / PEAK_BF16_FLOPS * 1e3
        out["backbone"] = {
            "ms": ms, "images_per_s": E2E_BATCH * 1e3 / ms,
            "with_preprocess_ms": model_ms, "f32_ms": ms_f32,
            "conv_gmac_per_image": macs / 1e9, "bound_ms": bound_ms,
            "bound_by": "operations",
            "tflops": 2 * macs * E2E_BATCH / ms / 1e9}
        print(f"end2end backbone bf16 at B={E2E_BATCH}: {ms:.3f} ms "
              f"({E2E_BATCH * 1e3 / ms:.1f} images/s; with the uint8 "
              f"resize/normalize {model_ms:.3f} ms; float32 {ms_f32:.3f} ms);"
              f" conv MACs {macs / 1e9:.2f} G an image; bound at "
              f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 {bound_ms:.3f} ms "
              f"= {out['backbone']['tflops']:.1f} TFLOP/s achieved")
        del nets, ob, of, x, buf

        # --- 2. cli.train on synthetic pixels held on the card -----------
        spec, _, _ = build_spec(cfg, generator=torch.Generator().manual_seed(
            cfg.train.seed))
        spec.module.resnet.load_state_dict(backbone)
        trainer = Trainer(cfg, spec, train_dir=os.path.join(root, "chk"),
                          device=str(dev))
        state = trainer.init_state()
        check(not any(k.startswith("resnet.") for k in state.opt_state.mu),
              "the frozen backbone carries Adam moments")
        ds = load_dataset(cfg, "train")
        check(ds.arrays["images"].shape == (E2E_IMAGES, E2E_SIZE, E2E_SIZE,
                                            3)
              and ds.arrays["images"].dtype == np.uint8,
              f"synthetic images {ds.arrays['images'].shape}")
        _, make_batch, nbytes = trainer._prepare_resident(ds)
        out["uploaded_gb"] = nbytes / 1e9
        idx0 = next(ds.index_batches(E2E_BATCH, seed=cfg.train.seed))
        batch = make_batch(torch.from_numpy(idx0).to(dev))
        check(batch["images"].dtype == torch.uint8,
              f"resident images {batch['images'].dtype}")
        out["first_step"] = check_first_step(spec, state, batch, dev,
                                             "end2end", trainer.tx.frozen)
        del batch, make_batch

        reset_counts()
        t0 = time.perf_counter()
        run_dir = train_cli.main(device + cli_argv(flags) + [
            "--train.train_dir", os.path.join(root, "run")])
        torch.cuda.synchronize()
        out["train_cli_s"] = time.perf_counter() - t0
        out["train_launches"] = launches = read_counts()
        # A step: K1 1, K3 3 (its launches a call), K2 2, K8 4.
        check_launches(launches, {
            "gru_fwd": E2E_STEPS, "gru_bwd": 3 * E2E_STEPS,
            "attention_fwd": 2 * E2E_STEPS,
            "attention_bwd": 4 * E2E_STEPS},
            f"end2end cli.train over {E2E_STEPS} steps")
        out["train"] = read_steps(run_dir, E2E_STEPS, "end2end cli.train "
                                  "(resident synthetic images)", "images",
                                  warmup=2, batch=E2E_BATCH)
        final = load_params(os.path.join(run_dir, PARAMS_FILE))
        same = all(torch.equal(final[f"resnet.{k}"], v)
                   for k, v in backbone.items())
        check(same and len(backbone) == sum(k.startswith("resnet.")
                                            for k in final),
              "the backbone's parameters or statistics changed in training")
        print(f"end2end: the backbone's {len(backbone)} parameters and "
              "BatchNorm statistics are bit-equal after training")
        state, out["profile"] = profile_fit(trainer, ds, state,
                                            PROFILE_STEPS)
        trainer.close()
        del trainer, state, ds, spec

        # --- 3. cli.eval, then Predictor on uint8 images -----------------
        reset_counts()
        t0 = time.perf_counter()
        metrics = eval_cli.main(device + ["--train.train_dir", run_dir])
        torch.cuda.synchronize()
        out["eval_cli_s"] = time.perf_counter() - t0
        batches = -(-E2E_IMAGES // E2E_BATCH)
        out["eval_launches"] = launches = read_counts()
        check_launches(launches, {"gru_fwd": batches,
                                  "attention_fwd": 2 * batches},
                       f"end2end cli.eval over {batches} batches")
        check(all(np.isfinite(v) for v in metrics.values())
              and 0.0 <= metrics["vqa_accuracy"] <= 1.0,
              f"end2end cli.eval metrics {metrics}")
        out["eval_metrics"] = metrics
        print(f"end2end cli.eval of {E2E_IMAGES} images in "
              f"{out['eval_cli_s']:.2f} s: {metrics}")

        pred = Predictor(run_dir, batch_size=E2E_PREDICT, device=str(dev))
        check(pred.visual_key == "images", f"Predictor reads "
              f"{pred.visual_key}")
        rng = np.random.default_rng(53)
        pix = rng.integers(0, 256, (E2E_PREDICT, E2E_SIZE, E2E_SIZE, 3)
                           ).astype(np.uint8)
        words = len(pred.word_vocab) - 4
        questions = [" ".join(f"w{w}" for w in rng.integers(0, words, n))
                     for n in rng.integers(1, T + 1, E2E_PREDICT)]
        reset_counts()
        answers = pred.answer(pix, questions)
        out["predict_launches"] = launches = read_counts()
        check_launches(launches, {"gru_fwd": 1, "attention_fwd": 2},
                       f"end2end Predictor at batch {E2E_PREDICT}")
        v = torch.from_numpy(pix).to(dev)
        q = torch.from_numpy(pred._encode_questions(questions)).to(dev)
        with torch.inference_mode():
            lk = pred.model(v, q)["logits"]
            with plain_kernels():
                lr = pred.model(v, q)["logits"]
        err = (lk - lr).abs().max().item()
        top2 = lr.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > TOL_LOGITS
        plain = [pred.answer_vocab.tokens[int(i)] for i in lr.argmax(-1)]
        check(err <= TOL_LOGITS and all(
            a == p for a, p, d in zip(answers, plain, decided.tolist())
            if d), f"end2end serving logits err {err}, answers {answers} "
            f"vs plain {plain}")
        ts = []
        for i in range(3 + RUNS):
            t0 = time.perf_counter()
            pred.answer(pix, questions)  # ends in a device->host copy
            if i >= 3:
                ts.append((time.perf_counter() - t0) * 1e3)
        out["predict_p50_ms"] = statistics.median(ts)
        out["predict_logits_err"] = err
        print(f"end2end Predictor: {E2E_PREDICT} uint8 images p50 "
              f"{out['predict_p50_ms']:.3f} ms; logits vs plain {err:.3e} "
              f"(tol {TOL_LOGITS}); {answers}")
        del pred

        # --- 4. JPEGs: host decode through PIL, where it imports ---------
        try:
            import PIL  # noqa: F401
            out["pil"] = True
        except ImportError:
            out["pil"] = False
        if not out["pil"]:
            print("end2end JPEG steps: PIL does not import on this machine; "
                  "cli.extract, ImageQuestionDataset and cli.predict --image "
                  "stay CPU-tested (tests/test_torch_extract.py, "
                  "tests/test_torch_end2end.py)")
        else:
            out.update(e2e_jpeg_steps(root, dev, flags, device))
    out["seconds"] = time.perf_counter() - t_phase
    print(f"end2end phase: {out['seconds']:.1f} s")
    return out


def e2e_jpeg_steps(root: str, dev, flags: dict, device: list) -> dict:
    """Phase 22's host-decode steps on seeded JPEGs: ``cli.extract`` of
    whole images and of region crops, ``cli.train`` streamed through
    ``ImageQuestionDataset``, ``cli.predict --image``."""
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.cli import extract as extract_cli
    from vqa_transfer_externaldata_torch.cli import predict as predict_cli
    from vqa_transfer_externaldata_torch.cli import train as train_cli
    from vqa_transfer_externaldata_torch.config import Config
    from vqa_transfer_externaldata_torch.data.datasets import (
        synthetic_vocabs)
    from vqa_transfer_externaldata_torch.data.features import FeatureStore
    from vqa_transfer_externaldata_torch.data.ingest import (
        _decode_pil, coco_image_path)
    from vqa_transfer_externaldata_torch.serving import Predictor

    out: dict = {}
    t0 = time.perf_counter()
    image_dir, ids = write_jpegs(root, E2E_JPEGS, seed=59)
    out["jpegs_write_s"] = time.perf_counter() - t0
    pth = flags["model.resnet_checkpoint"]
    g = E2E_SIZE // 32

    # --- cli.extract: whole images, then region crops ------------------
    rng = np.random.default_rng(61)
    regions = os.path.join(root, "region_meta.npz")
    xy = rng.integers(0, 400, (E2E_REGIONS, 2))
    wh = rng.integers(0, 240, (E2E_REGIONS, 2))
    np.savez(regions, image_id=rng.choice(ids, E2E_REGIONS).astype(np.int64),
             bbox=np.concatenate([xy, wh], 1).astype(np.int32))
    secs = {}
    for tag, extra, rows, want_ids in (
            ("images", [], E2E_JPEGS, ids),
            ("regions", ["--regions", regions], E2E_REGIONS,
             np.arange(E2E_REGIONS))):
        reset_counts()
        t0 = time.perf_counter()
        path = extract_cli.main(device + [
            "--image_dir", image_dir, "--out", os.path.join(root, tag),
            "--format", "raw", "--image_size", str(E2E_SIZE),
            "--batch_size", str(E2E_BATCH), "--torch_checkpoint", pth]
            + extra)
        torch.cuda.synchronize()
        secs[tag] = time.perf_counter() - t0
        check_launches(read_counts(), {}, f"end2end cli.extract ({tag})")
        store = FeatureStore(path)
        check(np.array_equal(store.image_ids, want_ids)
              and store.grid.shape == (rows, g, g, 32 * E2E_WIDTH)
              and store.pool5.shape == (rows, 32 * E2E_WIDTH)
              and np.isfinite(np.asarray(store.pool5)).all()
              and np.isfinite(store.gather(np.arange(min(rows, 8)))[
                  "features"]).all(),
              f"cli.extract {tag}: ids {store.image_ids[:4]}..., grid "
              f"{store.grid.shape}")
        store.close()
    out["extract_s"] = secs
    print(f"end2end cli.extract: {E2E_JPEGS} JPEGs {secs['images']:.2f} s, "
          f"{E2E_REGIONS} region crops {secs['regions']:.2f} s (raw stores "
          f"read back through FeatureStore)")

    # --- cli.train streamed through ImageQuestionDataset ---------------
    data_dir = os.path.join(root, "pre")
    os.makedirs(data_dir)
    cfg = Config().replace_flat(flags)
    words, answers = synthetic_vocabs(cfg)
    words.save(os.path.join(data_dir, "vocab.json"))
    answers.save(os.path.join(data_dir, "answer_vocab.json"))
    np.save(os.path.join(data_dir, "image_ids.npy"), ids.astype(np.int64))
    n_q, T_q = 4 * E2E_JPEGS, cfg.data.max_question_len
    q_ids = rng.integers(4, cfg.data.vocab_size, (n_q, T_q)).astype(np.int32)
    q_ids[:, 8:] = 0
    np.savez(os.path.join(data_dir, "vqa_train.npz"), q_ids=q_ids,
             image_index=rng.integers(0, E2E_JPEGS, n_q).astype(np.int32),
             answer_id=rng.integers(4, cfg.data.num_answers, n_q).astype(
                 np.int32))
    jflags = {**flags, "data.synthetic": False, "data.dataset_dir": data_dir,
              "data.image_dir": image_dir,
              "data.vocab_path": os.path.join(data_dir, "vocab.json"),
              "data.answer_vocab_path": os.path.join(data_dir,
                                                     "answer_vocab.json"),
              "train.max_steps": E2E_JPEG_STEPS,
              "train.checkpoint_every": E2E_JPEG_STEPS}
    reset_counts()
    t0 = time.perf_counter()
    run_dir = train_cli.main(device + cli_argv(jflags) + [
        "--train.train_dir", os.path.join(root, "jpeg_run")])
    torch.cuda.synchronize()
    out["jpeg_train_cli_s"] = time.perf_counter() - t0
    out["jpeg_train_launches"] = launches = read_counts()
    check_launches(launches, {
        "gru_fwd": E2E_JPEG_STEPS, "gru_bwd": 3 * E2E_JPEG_STEPS,
        "attention_fwd": 2 * E2E_JPEG_STEPS,
        "attention_bwd": 4 * E2E_JPEG_STEPS},
        f"end2end cli.train on JPEGs over {E2E_JPEG_STEPS} steps")
    out["jpeg_train"] = read_steps(run_dir, E2E_JPEG_STEPS, "end2end "
                                   "cli.train (streamed JPEGs)", "images",
                                   warmup=1, batch=E2E_BATCH)

    # --- cli.predict --image ---------------------------------------------
    paths = [coco_image_path(image_dir, "train2014", int(i)) for i in ids[:3]]
    argv = device + ["--train_dir", run_dir]
    for p in paths:
        argv += ["--image", p, "--question", "w5 w6 w7"]
    reset_counts()
    got = predict_cli.main(argv)
    out["jpeg_predict_launches"] = launches = read_counts()
    check_launches(launches, {"gru_fwd": 1, "attention_fwd": 2},
                   "end2end cli.predict --image")
    direct = Predictor(run_dir, batch_size=8, device=str(dev)).answer(
        np.stack([_decode_pil(p, E2E_SIZE) for p in paths]),
        ["w5 w6 w7"] * 3)
    check(got == direct and len(got) == 3,
          f"cli.predict --image {got} vs Predictor {direct}")
    print(f"end2end cli.predict --image: {got}")
    out["jpeg_predict_answers"] = got
    return out


@contextlib.contextmanager
def port_log_records():
    """(level name, message) of everything the port's logger says inside
    the block."""
    import logging

    seen = []
    handler = logging.Handler(logging.INFO)
    handler.emit = lambda r: seen.append((r.levelname, r.getMessage()))
    logger = logging.getLogger("vqa_torch")
    logger.addHandler(handler)
    try:
        yield seen
    finally:
        logger.removeHandler(handler)


def phase_baseline(report: dict, dev, stage1_params: str) -> dict:
    """vqa_baseline (no attention, no kernel) through cli.train on the
    resident store, transfer-initialized from stage 1 with the word table
    frozen, then cli.eval on the run and cli.predict on pool5."""
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.cli import eval as eval_cli
    from vqa_transfer_externaldata_torch.cli import predict as predict_cli
    from vqa_transfer_externaldata_torch.cli import train as train_cli
    from vqa_transfer_externaldata_torch.config import Config
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.models.zoo import build_model
    from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
    from vqa_transfer_externaldata_torch.serving import PARAMS_FILE, Predictor
    from vqa_transfer_externaldata_torch.utils.checkpoint import load_params

    steps = BASELINE_STEPS
    flags = {"model.model": "vqa_baseline", "data.synthetic": True,
             "data.synthetic_layout": "joined",
             "data.synthetic_size": BASELINE_QUESTIONS,
             "train.device_data_cache": True, "train.batch_size": B_TRAIN,
             "train.max_steps": steps, "train.log_every": 1,
             "train.freeze_params": "word_emb",
             "train.pretrained_param_path": stage1_params, **MODEL_OVERRIDES}
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_baseline_") as tmp:
        # What the resident upload holds: pool5 on the card, no grid.
        cfg = Config().replace_flat({**flags, "train.train_dir": tmp})
        trainer = Trainer(cfg, build_model(cfg), train_dir=tmp)
        ds = load_dataset(cfg, "train")
        data, make_batch, nbytes = trainer._prepare_resident(ds)
        batch = make_batch(torch.arange(B_TRAIN, device=dev))
        check("grid" not in data and data["store_pool5"].is_cuda
              and tuple(batch["pool5"].shape) == (B_TRAIN, C)
              and "features" not in batch,
              f"vqa_baseline's resident data: {sorted(data)}")
        out["uploaded_mb"] = nbytes / 1e6
        del data, make_batch, batch
        # A profiler window of PROFILE_STEPS steps from a fresh init.
        _, out["profile"] = profile_fit(trainer, ds, trainer.init_state(),
                                        PROFILE_STEPS)
        trainer.close()

        argv = ["--train.train_dir", os.path.join(tmp, "run")] + \
            cli_argv(flags)
        # --- this run's path: counts from 0 ------------------------------
        reset_counts()
        with port_log_records() as seen:
            t0 = time.perf_counter()
            train_dir = train_cli.main(argv)  # default device: CUDA
            torch.cuda.synchronize()
            out["cli_s"] = time.perf_counter() - t0
        check_launches(read_counts(), {}, "vqa_baseline training")
        warned = [m for lv, m in seen if lv == "WARNING"
                  and "no 'answer_embedding'" in m]
        check(len(warned) == 1, "the transfer into vqa_baseline did not warn")
        out.update(read_steps(train_dir, steps, "vqa_baseline training",
                              "questions", warmup=2))
        words = load_params(stage1_params)["word_emb.embedding"]
        trained = load_params(os.path.join(train_dir, PARAMS_FILE))
        check(torch.equal(trained["word_emb.embedding"], words),
              "the word table did not arrive bit for bit")
        print(f"vqa_baseline transfer: word table {tuple(words.shape)} "
              f"arrived bit for bit; warned: {warned[0]!r}")

        # --- cli.eval on the run -----------------------------------------
        t0 = time.perf_counter()
        got = eval_cli.main(["--train.train_dir", train_dir])
        out["cli_eval_s"] = time.perf_counter() - t0
        with open(os.path.join(train_dir, "results_val.json")) as fh:
            rows = json.load(fh)
        check(len(rows) == BASELINE_QUESTIONS and
              0.0 <= got["vqa_accuracy"] <= 1.0,
              f"cli.eval: {got}, {len(rows)} result rows")
        print(f"vqa_baseline cli.eval: {got}")

        # --- requests served with pool5 through cli.predict --------------
        rng = np.random.default_rng(3)
        store_path = os.path.join(tmp, "store.npz")
        ids = np.arange(100, 100 + PREDICT_IMAGES)
        pool5 = rng.standard_normal((PREDICT_IMAGES, C), np.float32)
        np.savez(store_path, image_ids=ids, pool5=pool5,
                 grid=np.zeros((PREDICT_IMAGES, GRID, GRID, C), np.float16))
        qs = ["w5 w6 w7", "w8", "w9 w10", "w11 w12 w13 w14"]
        pick = [3, 0, 7, 3]
        argv = ["--train_dir", train_dir, "--feature_path", store_path]
        for i, q in zip(pick, qs):
            argv += ["--image_id", str(ids[i]), "--question", q]
        reset_counts()
        answers = predict_cli.main(argv)
        check_launches(read_counts(), {}, "vqa_baseline serving")
        pred = Predictor(train_dir)
        direct = pred.answer(pool5[pick], qs)
        check(answers == direct and all(a in pred.answer_vocab.tokens
                                        for a in answers),
              f"cli.predict answers {answers} vs Predictor {direct}")
        print(f"vqa_baseline cli.predict on pool5: {answers}")
        out.update(cli_eval=got, predict_answers=answers,
                   word_table_exact=True, transfer_warning=warned[0])
    return out


def phase_probes(report: dict, dev) -> dict:
    """The H100 probes through their entries: P1 at Q = 1..4 and P2, each
    checked against its plain version inside ``run()`` (which raises on a
    disagreement), timed over PROBE_ITERS launches, with cuBLAS beside."""
    from vqa_transfer_externaldata_torch.tools import (
        probe_bwd_ceiling as p2, probe_mxu_rows as p1)

    reset_counts()
    try:
        r1 = p1.run(PROBE_ITERS)
        r2 = p2.run(PROBE_ITERS)
    except RuntimeError as e:
        raise PhaseError(str(e)) from e
    # Each Q of P1: its check, one warm-up and PROBE_ITERS timed launches;
    # P2 the same calls, three launches each.
    check_launches(read_counts(), {
        "probe_mxu_rows": len(p1.QS) * (PROBE_ITERS + 2),
        "probe_bwd_ceiling": 3 * (PROBE_ITERS + 2)}, "the probes")
    for q, t in r1["by_q"].items():
        print(f"P1 probe_mxu_rows Q={q}: {t['ms']:.4f} ms a call, "
              f"{t['us_per_question']:.3f} us/question, {t['tflops']:.1f} "
              f"TFLOP/s, {t['tiles_per_group']} tiles a group "
              f"({t['useful_rows']:.0%} useful rows)")
    print(f"P1 plain {r1['plain_ms']:.4f} ms; cuBLAS {r1['cublas_ms']:.4f} ms "
          f"+ gather {r1['cublas_gather_ms']:.4f} ms; Q=1 vs plain "
          f"{r1['rel_err_vs_plain']:.3e} of max|out|")
    print(f"P2 probe_bwd_ceiling: {r2['ms']:.4f} ms a call, "
          f"{r2['tflops']:.1f} TFLOP/s; plain {r2['plain_ms']:.4f} ms; "
          f"cuBLAS {r2['cublas_ms']:.4f} ms; dW_v {r2['dwv_rel_err']:.3e}, "
          f"dal {r2['dal_rel_err']:.3e} of their max")
    return {"probe_mxu_rows": r1, "probe_bwd_ceiling": r2,
            "launches": read_counts()}


def profile_calls(fn, n: int = 5, what: str = "requests") -> dict:
    """Device time by kernel over ``n`` calls of ``fn`` (torch.profiler),
    and the share of the host-clock wall time in which no kernel ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels, host = {}, {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and on_device(e):
            name = kernel_name(e.key)
            kernels[name] = kernels.get(name, 0.0) + us / n
        elif e.key.startswith("aten::") or e.key.startswith("autograd::"):
            host[e.key] = host.get(e.key, 0.0) + e.self_cpu_time_total / n
    return summarize(kernels, host, n, wall_us, what)


def on_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def kernel_name(key: str) -> str:
    return key.replace("void ", "").replace(
        "(anonymous namespace)::", "").split("(")[0][:100]


def summarize(kernels: dict, host: dict, n: int, wall_us: float,
              what: str) -> dict:
    busy = sum(kernels.values()) * n
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:20]
    top_host = sorted(host.items(), key=lambda kv: -kv[1])[:8]
    out = {"calls": n, "wall_ms_per_call": wall_us / n / 1e3,
           "kernel_ms_per_call": busy / n / 1e3 if busy else None,
           "device_idle_share": 1 - busy / wall_us if busy else None,
           "top_kernels_us_per_call": dict(top),
           "top_host_ops_self_us_per_call": dict(top_host)}
    print(f"profile of {n} {what}: {json.dumps(out)}")
    return out


def kernel_device_ms(fn, prefix: str, buf, runs: int = RUNS) -> float:
    """Device ms a call of ``fn`` spends in the kernels whose name starts
    with ``prefix`` (torch.profiler), L2 flushed before each of ``runs``
    calls, after warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            flush_l2(buf)
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0) or 0
             for e in prof.key_averages()
             if on_device(e) and kernel_name(e.key).startswith(prefix))
    check(us > 0, f"the profile shows no {prefix} launch")
    return us / runs / 1e3


def profile_fit(trainer, ds, state, steps: int) -> tuple:
    """Profile ``Trainer.fit_resident`` over ``steps`` more steps. Its
    upload of the store comes first and is left out: the window opens at
    the host start of the first step (its first ``index_select``, the batch
    lookup) and closes at the end of the last device event; the idle share
    is the part of that window in which nothing ran on the device. The
    run's closing checkpoint write is left out (not a step's work)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    save = trainer.ckpt.save
    trainer.ckpt.save = lambda *a, **kw: False
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state = trainer.fit_resident(ds, state,
                                         max_steps=state.step + steps)
            torch.cuda.synchronize()
    finally:
        trainer.ckpt.save = save
    events = list(prof.events())
    starts = [e.time_range.start for e in events
              if e.name == "aten::index_select" and not on_device(e)]
    check(bool(starts), "the profile holds no training step")
    t0 = min(starts)
    window = [e for e in events if e.time_range.start >= t0]
    device = [e for e in window if on_device(e)]
    check(bool(device), "the profile holds no device work")
    wall_us = max(e.time_range.end for e in device) - t0
    kernels, host = {}, {}
    for e in window:
        if on_device(e):
            name = kernel_name(e.name)
            kernels[name] = (kernels.get(name, 0.0)
                             + e.time_range.elapsed_us() / steps)
        elif e.name.startswith(("aten::", "autograd::")):
            host[e.name] = host.get(e.name, 0.0) + e.self_cpu_time_total / steps
    return state, summarize(kernels, host, steps, wall_us,
                            "fit_resident steps")


def phase_times(report: dict, k1: dict, k2: dict, k3: dict, k45: dict,
                k45g: dict, k45q: dict, k67: dict, k8: dict, dev) -> dict:
    import torch
    from vqa_transfer_externaldata_torch.ops import (
        attention, attention_resident as ar, gru, kernels)

    buf = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    times = {}
    # Library yardstick of K1: cuDNN GRU over packed sequences. It also does
    # the input projection x @ W_x, which the kernel receives done.
    lib_gru = torch.nn.GRU(D, H).to(dev, torch.bfloat16)
    lib_gru.flatten_parameters()

    def time_k1(k: dict) -> dict:
        gx, lens, uh, bhn = k["gx"], k["lens"], k["uh"], k["bhn"]
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            torch.randn(T, lens.shape[0], D, device=dev,
                        dtype=torch.bfloat16), lens.cpu(),
            enforce_sorted=False)
        with torch.inference_mode():
            lib_ms = time_cuda(lambda: lib_gru(packed), buf)
        # One step alone (the launch, U_h's load, one step): what the other
        # T - 1 steps add is the time of a step.
        ms = time_cuda(lambda: gru.gru_fwd(gx, lens, uh, bhn), buf)
        ms1 = time_cuda(lambda: gru.gru_fwd(gx[:1], lens, uh, bhn), buf)
        return {
            "kernel": ms, "one_step_ms": ms1,
            "step_us": (ms - ms1) / (T - 1) * 1e3,
            "plain": time_cuda(lambda: gru.gru_reference(gx, lens, uh, bhn),
                               buf),
            "library": lib_ms,
            "library_call": f"torch.nn.GRU({D}, {H}) in bfloat16 over a "
                            "packed sequence, input projection included",
        }

    # K1 at the training batch (the path that launches it most), and at the
    # serving batch.
    times["gru_fwd"] = time_k1(k3)
    k1_serving = time_k1(k1)
    # K1's two tilings at a single request, cli.predict's batch, the
    # serving and the training batch: the plan's rows against the other's,
    # which must give the same bits.
    tilings = {}
    for batch in (1, 8, B, B_TRAIN):
        gxb = torch.randn(T, batch, 3 * H, device=dev) * 0.5
        lensb = torch.randint(1, T + 1, (batch,), device=dev,
                              dtype=torch.int32)
        plan = gru.gru_fwd_launch_config(batch, H, dev)
        row = {"plan_rows": plan["rows"]}
        outs = {}
        for rows in kernels.GRU_FWD_ROWS:
            if plan["per_sm_by_rows"][rows] < 1:
                continue
            outs[rows] = gru._launch_fwd(gxb, lensb, k3["uh"], k3["bhn"],
                                         False, rows)[1]
            row[str(rows)] = time_cuda(
                lambda: gru._launch_fwd(gxb, lensb, k3["uh"], k3["bhn"],
                                        False, rows), buf)
        check(all(torch.equal(o, outs[plan["rows"]]) for o in outs.values()),
              f"K1's tilings disagree at B={batch}")
        tilings[str(batch)] = row
    times["gru_fwd"]["tilings_ms"] = tilings

    v, qh, wv, ws = k2["v"], k2["qh"], k2["wv"], k2["ws"]
    times["attention_fwd"] = {
        "kernel": time_cuda(
            lambda: attention.attention_fwd(v, qh, wv, ws, normalize=True),
            buf),
        "plain": time_cuda(
            lambda: attention.attention_fwd_reference(v, qh, wv, ws, True),
            buf),
        "library": None,
        "score_ms": kernel_device_ms(lambda: attention.attention_fwd(
            v, qh, wv, ws, normalize=True), SCORE_KERNEL, buf),
    }
    # K2 at the Predictor's default batch: the first questions of the same
    # inputs.
    v1, qh1 = v[:B_PREDICT].contiguous(), qh[:B_PREDICT].contiguous()
    times["attention_fwd"]["at_predict_batch"] = {
        "batch": B_PREDICT,
        "ms": time_cuda(lambda: attention.attention_fwd(
            v1, qh1, wv, ws, normalize=True), buf),
        "score_ms": kernel_device_ms(lambda: attention.attention_fwd(
            v1, qh1, wv, ws, normalize=True), SCORE_KERNEL, buf)}

    # K3 at the training shape, forward direction.
    gx3, hseq3, lens3 = k3["gx"], k3["hseq"], k3["lens"]
    uh3, bhn3, ghT3 = k3["uh"], k3["bhn"], k3["ghT"]
    times["gru_bwd"] = {
        "kernel": time_cuda(
            lambda: gru.gru_bwd(gx3, hseq3, lens3, uh3, bhn3, ghT3), buf),
        "plain": time_cuda(
            lambda: gru.gru_bwd_reference(gx3, hseq3, lens3, uh3, bhn3, ghT3),
            buf),
    }
    # Library yardstick: the backward of cuDNN's GRU over the same packed
    # lengths, which also takes the input projection's gradients (dx,
    # dW_x, db_x) that K3 leaves to the caller.
    lib3 = torch.nn.GRU(D, H).to(dev, torch.bfloat16)
    lib3.flatten_parameters()
    x3 = torch.randn(T, B_TRAIN, D, device=dev, dtype=torch.bfloat16,
                     requires_grad=True)
    _, h_n = lib3(torch.nn.utils.rnn.pack_padded_sequence(
        x3, lens3.cpu(), enforce_sorted=False))
    wrt = [x3, *lib3.parameters()]
    g_n = torch.randn_like(h_n)
    times["gru_bwd"]["library"] = time_cuda(
        lambda: torch.autograd.grad(h_n, wrt, g_n, retain_graph=True), buf)
    times["gru_bwd"]["library_call"] = (
        f"backward of torch.nn.GRU({D}, {H}) in bfloat16 over a packed "
        "sequence, input-projection gradients included")
    st, rows, nv = k45["store"], k45["rows"], k45["n_valid"]
    qh4, wv4, ws4 = k45["qh"], k45["wv"], k45["ws"]
    h5, al5, g5, sga5 = k45["h"], k45["alpha"], k45["g"], k45["sga"]
    kw = dict(n_valid=nv, normalize=False)  # the main path's mode
    times["attention_resident_fwd"] = {
        "kernel": time_cuda(lambda: ar.attention_resident_fwd(
            st, rows, qh4, wv4, ws4, save_h=True, **kw), buf),
        "plain": time_cuda(lambda: ar.attention_resident_fwd_reference(
            st, rows, qh4, wv4, ws4, save_h=True, **kw), buf),
        "library": None,
    }
    # The score launch alone, from the profiler over the same calls.
    times["attention_resident_fwd"]["score"] = kernel_device_ms(
        lambda: ar.attention_resident_fwd(st, rows, qh4, wv4, ws4,
                                          save_h=True, **kw),
        SCORE_KERNEL, buf)
    times["attention_resident_bwd"] = {
        "kernel": time_cuda(lambda: ar.attention_resident_bwd(
            st, rows, h5, ws4, al5, g5, sga5, **kw), buf),
        "plain": time_cuda(lambda: ar.attention_resident_bwd_reference(
            st, rows, h5, ws4, al5, g5, sga5, **kw), buf),
        "library": None,
    }

    # K4/K5 at G=2 (the glimpses2 path) on the same store and rows.
    ws2, h2, al2, g2, sga2 = (k45g[k] for k in ("ws", "h", "alpha", "g",
                                                "sga"))
    g2_times = {
        "attention_resident_fwd": {
            "kernel": time_cuda(lambda: ar.attention_resident_fwd(
                st, rows, qh4, wv4, ws2, save_h=True, **kw), buf),
            "plain": time_cuda(lambda: ar.attention_resident_fwd_reference(
                st, rows, qh4, wv4, ws2, save_h=True, **kw), buf),
            "library": None},
        "attention_resident_bwd": {
            "kernel": time_cuda(lambda: ar.attention_resident_bwd(
                st, rows, h2, ws2, al2, g2, sga2, **kw), buf),
            "plain": time_cuda(lambda: ar.attention_resident_bwd_reference(
                st, rows, h2, ws2, al2, g2, sga2, **kw), buf),
            "library": None},
    }

    def k1_bound(lens) -> tuple:
        # The row-steps that this run's lengths need read gx once; hseq
        # [T, B, H] and hT are written once.
        nlen, nb = int(lens.sum().item()), lens.shape[0]
        return bound(nlen * 3 * H * 4 + nb * 4 + H * 3 * H * 2 + H * 4
                     + T * nb * H * 4 + nb * H * 4,
                     2 * nlen * H * 3 * H), nlen

    times["gru_fwd"]["bound"], nlen = k1_bound(k3["lens"])
    k1_serving["bound"], nlen_serving = k1_bound(k1["lens"])
    times["gru_fwd"]["at_serving_batch"] = k1_serving

    def k2_bound(batch: int) -> tuple:
        # v, qh, W_v and ws read once, v_att and alpha written once; the
        # score GEMM and the weighted sum.
        return bound(batch * N * C * 2 + batch * H * 4 + C * H * 2 + H * 4
                     + batch * C * 4 + batch * N * 4,
                     2 * batch * N * C * H + 2 * batch * N * C)

    times["attention_fwd"]["bound"] = k2_bound(B)
    # K3: the live row-steps of this run's lengths read gx and hseq once;
    # dgx [T, B, 3H] and dU_h are written once. Each live row-step takes
    # three [H] x [H, 3H] products: the recomputed gh, the U_h^T product
    # and its share of dU_h.
    Bt, nl3 = B_TRAIN, int(lens3.sum().item())
    k3_bytes = (nl3 * 4 * H * 4 + Bt * 4 + H * 3 * H * 2 + H * 4
                + Bt * H * 4 + T * Bt * 3 * H * 4 + H * 3 * H * 4 + H * 4)
    k3_flops = 3 * 2 * nl3 * H * 3 * H
    times["gru_bwd"]["bound"] = bound(k3_bytes, k3_flops)
    # K4/K5 with G glimpses: each store row that the batch names is read
    # once (rows repeat), and the GEMMs run over the valid cells only: the
    # score GEMM (or dW_v) once, 2 B n C H, then per glimpse the weighted
    # sum (or dalpha), 2 B n C, and the score (or dz and dws), 2 (4) B n H.
    Np = st.shape[1]
    uniq = int(torch.unique(rows).numel())
    row_bytes = uniq * Np * C * 2

    # K4/K5 at G=1 on int8 rows: the codes of the same store, same rows.
    cq, wvq = k45q["codes"], k45q["wv"]
    wsq, hq, alq, gq, sgaq = (k45q[k] for k in ("ws", "h", "alpha", "g",
                                                "sga"))
    q_times = {
        "attention_resident_fwd": {
            "kernel": time_cuda(lambda: ar.attention_resident_fwd(
                cq, rows, qh4, wvq, wsq, save_h=True, **kw), buf),
            "plain": time_cuda(lambda: ar.attention_resident_fwd_reference(
                cq, rows, qh4, wvq, wsq, save_h=True, **kw), buf),
            "score": kernel_device_ms(lambda: ar.attention_resident_fwd(
                cq, rows, qh4, wvq, wsq, save_h=True, **kw),
                SCORE_KERNEL, buf),
            "library": None},
        "attention_resident_bwd": {
            "kernel": time_cuda(lambda: ar.attention_resident_bwd(
                cq, rows, hq, wsq, alq, gq, sgaq, **kw), buf),
            "plain": time_cuda(lambda: ar.attention_resident_bwd_reference(
                cq, rows, hq, wsq, alq, gq, sgaq, **kw), buf),
            "library": None},
    }

    def k45_bounds(G: int, row_bytes: int = row_bytes) -> tuple:
        k4_bytes = (row_bytes + Bt * 4 + Bt * H * 4 + C * H * 2 + G * H * 4
                    + Bt * G * C * 4 + Bt * Np * G * 4 + Bt * Np * H * 2)
        k4_flops = 2 * Bt * nv * C * (H + G) + 2 * G * Bt * nv * H
        k5_bytes = (row_bytes + Bt * 4 + Bt * Np * H * 2 + G * H * 4
                    + 2 * Bt * Np * G * 4 + Bt * G * C * 4 + Bt * H * 4
                    + C * H * 4 + G * H * 4)
        k5_flops = 2 * Bt * nv * C * (H + G) + 4 * G * Bt * nv * H
        return bound(k4_bytes, k4_flops), bound(k5_bytes, k5_flops)

    (times["attention_resident_fwd"]["bound"],
     times["attention_resident_bwd"]["bound"]) = k45_bounds(1)
    (g2_times["attention_resident_fwd"]["bound"],
     g2_times["attention_resident_bwd"]["bound"]) = k45_bounds(2)
    (q_times["attention_resident_fwd"]["bound"],
     q_times["attention_resident_bwd"]["bound"]) = k45_bounds(
         1, row_bytes=uniq * Np * C)  # one byte a code
    for name, t in g2_times.items():
        times[name]["at_g2"] = t
        times[f"{name}[int8]"] = q_times[name]
    # The score GEMM's rate: 2 B n C H operations over the valid cells.
    score_flops = 2 * Bt * nv * C * H
    for name in ("attention_resident_fwd", "attention_resident_fwd[int8]"):
        times[name]["score_tflops"] = (
            score_flops / (times[name]["score"] * 1e-3) / 1e12)
        print(f"{name} score launch at G=1: {times[name]['score']:.4f} ms, "
              f"{times[name]['score_tflops']:.1f} TFLOP/s")

    # K6/K7 at the stage-1 shape. Library yardstick: cuDNN's bidirectional
    # GRU over the same packed lengths, forward, and the backward with the
    # input projection's gradients, which the kernels leave to the caller.
    args, bargs = k67["args"], k67["bargs"]
    lens6 = args[2]
    lib6 = torch.nn.GRU(D, H, bidirectional=True).to(dev, torch.bfloat16)
    lib6.flatten_parameters()
    x6 = torch.randn(T, B_TRAIN, D, device=dev, dtype=torch.bfloat16,
                     requires_grad=True)
    packed6 = torch.nn.utils.rnn.pack_padded_sequence(
        x6, lens6.cpu(), enforce_sorted=False)
    with torch.inference_mode():
        lib6_ms = time_cuda(lambda: lib6(packed6), buf)
    _, h6 = lib6(packed6)
    wrt6 = [x6, *lib6.parameters()]
    g6 = torch.randn_like(h6)
    # K6 beside two K1 calls on the same inputs, in turns (K6, two K1, two
    # K1, K6): both run the persistent forward body, K6 both chains in one
    # launch of 2 b-tiles a block, K1 one chain a launch of 1.
    gxf6, gxb6, _, uhf6, uhb6, bhnf6, bhnb6 = args

    def k6_call():
        gru.bigru_fwd(*args)

    def two_k1():
        gru.gru_fwd(gxf6, lens6, uhf6, bhnf6)
        gru.gru_fwd(gxb6, lens6, uhb6, bhnb6, reverse=True)

    turns6 = [time_cuda(f, buf) for f in (k6_call, two_k1, two_k1, k6_call)]
    # K6's two tilings at cli.predict's batch, the serving and the stage-1
    # batch: the plan's rows against the other's, which must give the same
    # bits.
    tilings6 = {}
    for batch in (8, B, B_TRAIN):
        bargs6 = [torch.randn(T, batch, 3 * H, device=dev) * 0.5
                  for _ in range(2)]
        lensb = torch.randint(1, T + 1, (batch,), device=dev,
                              dtype=torch.int32)
        args_b = (bargs6[0], bargs6[1], lensb, uhf6, uhb6, bhnf6, bhnb6)
        plan = gru.bigru_fwd_launch_config(batch, H, dev)
        row = {"plan_rows": plan["rows"]}
        outs = {}
        for tiling in kernels.GRU_FWD_ROWS:
            if plan["per_sm_by_rows"][tiling] < 1:
                continue
            outs[tiling] = gru._launch_bigru_fwd(*args_b, tiling)
            row[str(tiling)] = time_cuda(
                lambda: gru._launch_bigru_fwd(*args_b, tiling), buf)
        check(all(torch.equal(a, b) for o in outs.values()
                  for a, b in zip(o, outs[plan["rows"]])),
              f"K6's tilings disagree at B={batch}")
        tilings6[str(batch)] = row
    times["bigru_fwd"] = {
        "kernel": (turns6[0] + turns6[3]) / 2,
        "two_k1": (turns6[1] + turns6[2]) / 2,
        "tilings_ms": tilings6,
        "plain": time_cuda(lambda: gru.bigru_reference(*args), buf),
        "library": lib6_ms,
        "library_call": f"torch.nn.GRU({D}, {H}, bidirectional=True) in "
                        "bfloat16 over a packed sequence, input projection "
                        "included",
    }
    # K7 beside two K3 calls on the same inputs, in turns (K7, two K3, two
    # K3, K7): both run the persistent BPTT body, K7 both chains in one
    # launch of 2 b-tiles a block, K3 one chain a launch of 1.
    (gxf, gxb, hsf, hsb, lens7, uhf, uhb, bhnf, bhnb, ghTf, ghTb) = bargs

    def k7_call():
        gru.bigru_bwd(*bargs)

    def two_k3():
        gru.gru_bwd(gxf, hsf, lens7, uhf, bhnf, ghTf)
        gru.gru_bwd(gxb, hsb, lens7, uhb, bhnb, ghTb, reverse=True)

    turns = [time_cuda(f, buf) for f in (k7_call, two_k3, two_k3, k7_call)]
    times["bigru_bwd"] = {
        "kernel": (turns[0] + turns[3]) / 2,
        "two_k3": (turns[1] + turns[2]) / 2,
        "plain": time_cuda(lambda: gru.bigru_bwd_reference(*bargs), buf),
        "library": time_cuda(lambda: torch.autograd.grad(
            h6, wrt6, g6, retain_graph=True), buf),
        "library_call": f"backward of torch.nn.GRU({D}, {H}, "
                        "bidirectional=True) in bfloat16 over a packed "
                        "sequence, input-projection gradients included",
    }
    # Both chains: each reads its live rows of gx and U_h, b_hn once and
    # writes its hseq and hT (K6), or reads gx and hseq over its live rows
    # and writes dgx, dU_h and db_hn (K7); lens is read once. Operations as
    # K1's and K3's for each direction.
    Bt, nl6 = B_TRAIN, int(lens6.sum().item())
    k6_bytes = Bt * 4 + 2 * (nl6 * 3 * H * 4 + H * 3 * H * 2 + H * 4
                             + T * Bt * H * 4 + Bt * H * 4)
    k7_bytes = Bt * 4 + 2 * (nl6 * 4 * H * 4 + H * 3 * H * 2 + H * 4
                             + Bt * H * 4 + T * Bt * 3 * H * 4
                             + H * 3 * H * 4 + H * 4)
    times["bigru_fwd"]["bound"] = bound(k6_bytes, 2 * 2 * nl6 * H * 3 * H)
    times["bigru_bwd"]["bound"] = bound(k7_bytes,
                                        2 * 3 * 2 * nl6 * H * 3 * H)
    # K8 at the gathered training shape (normalize on, the main path's
    # mode). Beside it: the op's whole backward with K8 (the score
    # cotangent from one bf16 batched GEMV, then K8) and with the explicit
    # math instead (bwd_kernel=False): the H100 A/B of the default.
    v8, qh8, wv8, ws8 = k8["v"], k8["qh"], k8["wv"], k8["ws"]
    ds8, r8, al8, va8 = k8["ds"], k8["r"], k8["alpha"], k8["v_att"]
    g8, ga8 = k8["g"], k8["ga"]

    def k8_backward():
        dalpha = attention._score_dot(v8, g8) * r8
        s8 = (g8 * va8).sum(-1) + (al8 * ga8).sum(-1)
        ds = (al8 * (dalpha + ga8 - s8[:, None])).contiguous()
        return attention.attention_bwd(v8, qh8, wv8, ws8, ds, r8, True)

    times["attention_bwd"] = {
        "kernel": time_cuda(lambda: attention.attention_bwd(
            v8, qh8, wv8, ws8, ds8, r8, True), buf),
        "plain": time_cuda(lambda: attention.attention_bwd_reference(
            v8, qh8, wv8, ws8, ds8, r8, True), buf),
        "op_backward_with_kernel": time_cuda(k8_backward, buf),
        "explicit_backward": time_cuda(lambda: attention.attention_bwd_math(
            v8, qh8, wv8, ws8, al8, va8, g8, ga8, normalize=True,
            feature_grad=False), buf),
        "library": None,
    }
    # Each input read once (v, qh, W_v, ws, ds, r), each output written
    # once; z recomputed and the dW_v GEMM, 2 B N C H operations each, plus
    # the elementwise dz, dqh and dws (a few per unit).
    Bt = B_TRAIN
    k8_bytes = (Bt * N * C * 2 + Bt * H * 4 + C * H * 2 + H * 4
                + 2 * Bt * N * 4 + Bt * H * 4 + C * H * 4 + H * 4)
    k8_flops = 2 * 2 * Bt * N * C * H + 6 * Bt * N * H
    times["attention_bwd"]["bound"] = bound(k8_bytes, k8_flops)
    # K8's dz launch alone (the recomputed score GEMM on score_gemm.cuh's
    # mainloop and its epilogue), from the profiler over whole calls, L2
    # flushed before each, with its TFLOP/s and its bound: 2 B N C H
    # operations against the grid and W_v read once and dzr and the
    # partials written once. Beside it cuBLAS on the same product,
    # v [B N, C] @ W_v [C, H] in bf16.
    dz_plan = kernels.dz_plan(Bt, N, C, H)
    dz_flops = 2 * Bt * N * C * H  # K2's score GEMM at Bt does the same
    dz_ms = kernel_device_ms(lambda: attention.attention_bwd(
        v8, qh8, wv8, ws8, ds8, r8, True), "attn_bwd_dz_kernel", buf)
    v8_rows = v8.view(Bt * N, C)
    dz_bound = bound(Bt * N * C * 2 + C * H * 2 + Bt * H * 4 + H * 4
                     + 2 * Bt * N * 4 + Bt * N * H * 2
                     + 2 * 4 * dz_plan["partials"][0]
                     * dz_plan["partials"][1] * H, dz_flops)
    times["attention_bwd"]["dz_stage"] = {
        "ms": dz_ms, "tflops": dz_flops / (dz_ms * 1e-3) / 1e12,
        "bound_ms": dz_bound[0], "bound_by": dz_bound[1],
        "launch": {k: dz_plan[k] for k in ("tile", "stages", "smem_bytes",
                                            "grid", "slots")},
        "library_ms": time_cuda(lambda: torch.matmul(v8_rows, wv8), buf),
        "library_call": f"torch.matmul([{Bt * N}, {C}] bf16, [{C}, {H}] "
                        "bf16) -> bf16"}
    # K2 at the gathered training batch on phase 7's inputs (normalize on):
    # the whole call, its plain version, its bound; its score launch alone
    # (the profiler over whole calls, L2 flushed before each) with its
    # TFLOP/s and its bound (the same product as K8's dz launch: the grid,
    # W_v, qh and ws read once, the partial scores and r written once), and
    # cuBLAS on that product (dz_stage's); its wsum launch alone beside its
    # bytes bound: v, the partial scores and r read once, v_att and alpha
    # written once.
    k2_plan = kernels.score_plan(Bt, N, C, H)
    k2t = {
        "kernel": time_cuda(lambda: attention.attention_fwd(
            v8, qh8, wv8, ws8, normalize=True), buf),
        "plain": time_cuda(lambda: attention.attention_fwd_reference(
            v8, qh8, wv8, ws8, True), buf),
        "score_ms": kernel_device_ms(lambda: attention.attention_fwd(
            v8, qh8, wv8, ws8, normalize=True), SCORE_KERNEL, buf),
        "score_bound": bound(Bt * N * C * 2 + C * H * 2 + Bt * H * 4 + H * 4
                             + (k2_plan["n_part"] + 1) * Bt * N * 4,
                             dz_flops),
        "score_library_ms": times["attention_bwd"]["dz_stage"]["library_ms"],
        "score_launch": k2_plan,
        "wsum_ms": kernel_device_ms(lambda: attention.attention_fwd(
            v8, qh8, wv8, ws8, normalize=True), "attn_wsum_kernel", buf),
        "wsum_bound": bound(Bt * N * C * 2 + (k2_plan["n_part"] + 2) * Bt * N
                            * 4 + Bt * C * 4, 2 * Bt * N * C),
        "bound": k2_bound(Bt)}
    k2t["score_tflops"] = dz_flops / (k2t["score_ms"] * 1e-3) / 1e12
    times["attention_fwd"]["at_training_batch"] = k2t
    # The dW_v launch alone (attention_dwv.cuh, shared by K5, K8 and P2),
    # from the profiler over whole calls, L2 flushed before each: K5 at G=1
    # on bf16 rows and on int8 codes, K8. Beside it cuBLAS on the same
    # product, v^T dzr over the valid cells: torch.matmul of the gathered
    # rows (transposed view) and a bf16 [K, H], the gather timed apart.
    dwv_flops = 2 * Bt * nv * C * H
    dwv = {}
    for key, fn in (
            ("attention_resident_bwd", lambda: ar.attention_resident_bwd(
                st, rows, h5, ws4, al5, g5, sga5, **kw)),
            ("attention_resident_bwd[int8]",
             lambda: ar.attention_resident_bwd(cq, rows, hq, wsq, alq, gq,
                                               sgaq, **kw)),
            ("attention_bwd", lambda: attention.attention_bwd(
                v8, qh8, wv8, ws8, ds8, r8, True))):
        ms = kernel_device_ms(fn, "attn_dwv::dwv_kernel", buf)
        dwv[key] = {"ms": ms, "tflops": dwv_flops / (ms * 1e-3) / 1e12}
    rows_l = rows.long()
    v_all = st[rows_l, :nv].reshape(Bt * nv, C)
    dz_all = h5[:, :nv].reshape(Bt * nv, H)
    lib_dwv = {
        "library_ms": time_cuda(lambda: torch.matmul(v_all.t(), dz_all),
                                buf),
        "library_gather_ms": time_cuda(
            lambda: st[rows_l, :nv].reshape(Bt * nv, C), buf),
        "library_call": f"torch.matmul([{C}, {Bt * nv}] bf16 (the gathered "
                        f"rows, transposed), [{Bt * nv}, {H}] bf16) -> bf16",
    }
    for key, t in dwv.items():
        t.update(lib_dwv)
        times[key]["dwv_stage"] = t
        print(f"{key} dW_v launch at G=1: {t['ms']:.4f} ms, "
              f"{t['tflops']:.1f} TFLOP/s; cuBLAS {t['library_ms']:.4f} ms "
              f"+ gather {t['library_gather_ms']:.4f} ms")
    report["rows_stage"] = rows_stage_times(k45, k45g, k45q, buf)
    report["bound_inputs"] = {"k1_live_steps": nlen,
                              "k1_live_steps_serving": nlen_serving,
                              "k3_live_steps": nl3, "k45_unique_rows": uniq,
                              "k67_live_steps_per_direction": nl6}
    for name, t in [*times.items(), ("gru_fwd at the serving batch",
                                     k1_serving),
                    *((f"{k} at G=2", t) for k, t in g2_times.items())]:
        print(f"{name}: kernel {t['kernel']:.4f} ms, plain "
              f"{t['plain']:.4f} ms, library {t['library']}, bound "
              f"{t['bound'][0]:.4f} ms ({t['bound'][1]})")
    for batch, t in ((B_TRAIN, times["gru_fwd"]), (B, k1_serving)):
        print(f"K1 at B={batch}: T={T} {t['kernel']:.4f} ms, T=1 "
              f"{t['one_step_ms']:.4f} ms, {t['step_us']:.2f} us a step")
    for batch, row in times["gru_fwd"]["tilings_ms"].items():
        print(f"K1 tilings at B={batch}, T={T}: " + ", ".join(
            f"{r} rows {row[str(r)]:.4f} ms" for r in (16, 64)
            if str(r) in row) + f" (the plan takes {row['plan_rows']})")
    print(f"K6 against two K1 calls in turns (both directions): K6 "
          f"{times['bigru_fwd']['kernel']:.4f} ms, two K1 calls "
          f"{times['bigru_fwd']['two_k1']:.4f} ms")
    for batch, row in times["bigru_fwd"]["tilings_ms"].items():
        print(f"K6 tilings at B={batch}, T={T}: " + ", ".join(
            f"{r} rows {row[str(r)]:.4f} ms" for r in (16, 64)
            if str(r) in row) + f" (the plan takes {row['plan_rows']})")
    print(f"K7 against two K3 calls in turns (both directions): K7 "
          f"{times['bigru_bwd']['kernel']:.4f} ms, two K3 calls "
          f"{times['bigru_bwd']['two_k3']:.4f} ms")
    t = times["attention_bwd"]["dz_stage"]
    print(f"K8 dz launch at B={Bt}, N={N}: {t['ms']:.4f} ms, "
          f"{t['tflops']:.1f} TFLOP/s, bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}); cuBLAS on the same product "
          f"{t['library_ms']:.4f} ms")
    print(f"K2 at B={Bt}: {k2t['kernel']:.4f} ms (plain {k2t['plain']:.4f}), "
          f"bound {k2t['bound'][0]:.4f} ms ({k2t['bound'][1]}); its score "
          f"launch {k2t['score_ms']:.4f} ms, {k2t['score_tflops']:.1f} "
          f"TFLOP/s, bound {k2t['score_bound'][0]:.4f} ms "
          f"({k2t['score_bound'][1]}), cuBLAS on the same product "
          f"{k2t['score_library_ms']:.4f} ms; its wsum launch "
          f"{k2t['wsum_ms']:.4f} ms, bound {k2t['wsum_bound'][0]:.4f} ms "
          f"({k2t['wsum_bound'][1]})")
    k2b = times["attention_fwd"]
    print(f"K2 by batch: B={B_PREDICT} "
          f"{k2b['at_predict_batch']['ms']:.4f} ms (score launch "
          f"{k2b['at_predict_batch']['score_ms']:.4f}), B={B} "
          f"{k2b['kernel']:.4f} ms (score launch {k2b['score_ms']:.4f}), "
          f"B={Bt} {k2t['kernel']:.4f} ms (score launch "
          f"{k2t['score_ms']:.4f})")
    print(f"gathered backward A/B: with K8 "
          f"{times['attention_bwd']['op_backward_with_kernel']:.4f} ms, "
          f"explicit {times['attention_bwd']['explicit_backward']:.4f} ms")
    return times


def rows_stage_times(k45: dict, k45g: dict, k45q: dict, buf) -> dict:
    """The rows launch alone (``attention_rows.cuh``), from the profiler
    over whole calls, L2 flushed before each: K5 at G=1, 2 and 8 on bf16
    rows and at G=1 on int8 codes (the main path's mode, normalize off),
    and P2's; each beside its bytes bound: every distinct store row's valid
    cells read once, h once, the cotangent dzr written once, and the small
    inputs (g, alpha, sga, rows) and outputs (dqh, dws partials; P2's dal)
    once."""
    import torch
    from vqa_transfer_externaldata_torch.ops import attention_resident as ar
    from vqa_transfer_externaldata_torch.tools import probe_bwd_ceiling as p2

    st, rows, nv = k45["store"], k45["rows"], k45["n_valid"]
    Bt = rows.shape[0]
    uniq = int(torch.unique(rows).numel())
    kw = dict(n_valid=nv, normalize=False)
    out = {}
    for key, store, k, G, row_bytes in (
            ("k5_g1", st, k45, 1, 2), ("k5_g2", st, k45g, 2, 2),
            ("k5_g8", st, k45g["g8"], 8, 2),
            ("k5_int8_g1", k45q["codes"], k45q, 1, 1)):
        args = (store, rows, k["h"], k["ws"], k["alpha"], k["g"], k["sga"])
        ms = kernel_device_ms(lambda: ar.attention_resident_bwd(*args, **kw),
                              "attn_res_bwd_rows_kernel", buf)
        nbytes = (uniq * nv * C * row_bytes + Bt * 4 + 2 * Bt * nv * H * 2
                  + G * H * 4 + Bt * G * C * 4 + 2 * Bt * nv * G * 4
                  + Bt * H * 4 + Bt * G * H * 4)
        flops = 2 * G * Bt * nv * C + 4 * G * Bt * nv * H
        b_ms, b_by = bound(nbytes, flops)
        out[key] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                    "bytes": nbytes, "share_of_bound": b_ms / ms}
    # P2 at its own sizes (p2.B questions of all p2.Np cells): dal and
    # bf16(h * 0.5).
    x = p2.make_inputs(torch.device("cuda", 0))
    ms = kernel_device_ms(lambda: p2.probe_bwd_ceiling(
        x["store"], x["rows"], x["h"], x["g"]), "probe_bwd_rows_kernel", buf)
    uniq2 = int(torch.unique(x["rows"]).numel())
    cells = p2.B * p2.Np
    nbytes = (uniq2 * p2.Np * p2.C * 2 + p2.B * 4 + 2 * cells * p2.H * 2
              + p2.B * p2.C * 2 + cells * 4)
    b_ms, b_by = bound(nbytes, 2 * cells * p2.C + cells * p2.H)
    out["p2"] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                 "bytes": nbytes, "share_of_bound": b_ms / ms}
    for key, t in out.items():
        print(f"{key} rows launch alone: {t['ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}, {t['bytes']} B), "
              f"{t['share_of_bound']:.1%} of it")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the full report as JSON here")
    args = ap.parse_args(argv)

    try:
        import torch
    except ImportError:
        print("chip_smoke: FAIL: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() != 1:
        print(f"chip_smoke: FAIL: {torch.cuda.device_count()} CUDA devices "
              "visible; it drives one card (set CUDA_VISIBLE_DEVICES to "
              "one)", file=sys.stderr)
        return 2
    try:
        import vqa_transfer_externaldata_torch as port
    except ImportError:
        port = None
    if port is None or not os.path.abspath(port.__file__).startswith(HERE):
        print("chip_smoke: FAIL: the vqa_transfer_externaldata_torch "
              "package must sit beside chip_smoke.py (run it from the "
              "repository root)", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 matmuls in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        print(f"chip_smoke: FAIL: nvidia-smi: {smi.stderr}", file=sys.stderr)
        return 1
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    gen = torch.Generator(device=dev).manual_seed(0)
    try:
        phase_build(report)
        k1 = phase_gru(report, dev, gen)
        k2 = phase_attention(report, dev, gen)
        k3 = phase_gru_bwd(report, dev, gen)
        k45 = phase_resident(report, dev, gen)
        k45g = phase_resident_multi(report, dev, gen, k45)
        k45q = phase_resident_int8(report, dev, gen, k45)
        k67 = phase_bigru(report, dev, gen)
        k8 = phase_attention_bwd(report, dev, gen)
        serving = phase_serving(report, dev)
        report["training"] = training = phase_training(report, dev)
        report["gathered"] = gathered = phase_gathered(report, dev)
        report["streamed"] = streamed = phase_streamed(report, dev)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_stage1_") as root:
            report["stage1"] = stage1 = phase_stage1(report, dev, root)
            report["transfer"] = transfer = phase_transfer(
                report, dev, stage1["params_path"])
            report["baseline"] = phase_baseline(report, dev,
                                                stage1["params_path"])
        report["glimpses2"] = glimpses2 = phase_glimpses2(report, dev)
        report["training_int8"] = training_int8 = phase_training_int8(
            report, dev)
        report["probes"] = probes = phase_probes(report, dev)
        times = phase_times(report, k1, k2, k3, k45, k45g, k45q, k67, k8,
                            dev)
        report["real_data"] = real_data = phase_real_data(report, dev)
        report["oov"] = oov = phase_oov(report, dev)
        report["end2end"] = end2end = phase_end2end(report, dev)
        torch.cuda.synchronize()
    except PhaseError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1

    # max_abs_err: the largest error of the kernel's outputs against its
    # plain version; each kernel also lists its checks beside their limits.
    # launches: the count of the path that runs the kernel (stage-2
    # training for K1 and K3; glimpses2 training, at G=2, for K4 and K5;
    # serving for K2; stage-1 training for K6 and K7; gathered stage-2
    # training for K8; int8-store training for K4 and K5 on int8 rows; the
    # probes' entries for P1 and P2), and every path's count under
    # launches_by_path. K1's times are at the training batch, and at the
    # serving batch under at_serving_batch. K4's and K5's times and bounds
    # are at G=2, and at G=1 under at_g1; on int8 rows at G=1; K4's score
    # launch alone at G=1 under score_ms_g1 and score_tflops_g1; the dW_v
    # launch alone of K5 at G=1 (bf16 and int8 rows) and of K8 under
    # dwv_stage_g1 / dwv_stage, with cuBLAS on the same product (library_ms
    # of the whole kernel stays null: no one PyTorch call computes it); K8's
    # dz launch alone under dz_stage, with cuBLAS on its product; K2's score
    # launch alone at the serving batch under score_ms, K2 at the
    # Predictor's default batch under at_predict_batch, and at the training
    # batch (its score launch alone with its bound and cuBLAS on its
    # product, its wsum launch alone with its bound) under
    # at_training_batch; the
    # rows launch alone of K5 (rows_stage_g1/g2/g8, int8 rows_stage_g1, the
    # launch's shape under rows_launch) and of P2 (rows_stage), each beside
    # its bytes bound.
    # P1's time is at Q=1, with every Q under by_q; its library call is
    # cuBLAS on the gathered rows, the gather timed apart. K6's time is
    # taken in turns with two K1 calls on its inputs (two_k1_ms), K7's with
    # two K3 calls (two_k3_ms); each lists its persistent launch and what
    # ptxas reports for its persistent kernel in both builds that run it,
    # and K6 its two tilings' times. K1 lists its persistent launch at both
    # batches, its time a step (T=26 against T=1) and the warnings of its
    # nvcc log.
    src = "vqa_transfer_externaldata_torch/csrc/"
    ref = "vqa_transfer_externaldata_tpu/ops/"
    k1_serving = times["gru_fwd"].pop("at_serving_batch")
    k2t = times["attention_fwd"].pop("at_training_batch")
    meta = {
        "gru_fwd": (ref + "gru.py:227", max(k1["err"], k3["k1_err"]), {
            "tol": TOL_GRU, "err_by_batch": {str(B): k1["err"],
                                             str(B_TRAIN): k3["k1_err"]},
            "persistent_launch": k3["k1_launch"],
            "nvcc_warnings": [
                line for line in report["ptxas"].get("gru_fwd",
                                                     "").splitlines()
                if "warning" in line.lower()],
            "step_us": times["gru_fwd"]["step_us"],
            "one_step_ms": times["gru_fwd"]["one_step_ms"],
            "tilings_ms": times["gru_fwd"]["tilings_ms"],
            "at_serving_batch": {
                "batch": B, "ms": k1_serving["kernel"],
                "step_us": k1_serving["step_us"],
                "one_step_ms": k1_serving["one_step_ms"],
                "plain_ms": k1_serving["plain"],
                "bound_ms": k1_serving["bound"][0],
                "bound_by": k1_serving["bound"][1],
                "library_ms": k1_serving["library"]}}),
        "attention_fwd": (
            ref + "attention.py:125",
            max(max(c["v_att_err"], c["alpha_err"])
                for c in k2["checks"] + k8["k2_checks"]),
            {"checks": k2["checks"] + k8["k2_checks"],
             "score_ms": times["attention_fwd"]["score_ms"],
             "at_predict_batch": times["attention_fwd"]["at_predict_batch"],
             "at_training_batch": {
                 "batch": B_TRAIN, "ms": k2t["kernel"],
                 "plain_ms": k2t["plain"], "score_ms": k2t["score_ms"],
                 "score_tflops": k2t["score_tflops"],
                 "score_bound_ms": k2t["score_bound"][0],
                 "score_bound_by": k2t["score_bound"][1],
                 "score_library_ms": k2t["score_library_ms"],
                 "score_library_call": times["attention_bwd"]["dz_stage"][
                     "library_call"],
                 "score_launch": k2t["score_launch"],
                 "wsum_ms": k2t["wsum_ms"],
                 "wsum_bound_ms": k2t["wsum_bound"][0],
                 "wsum_bound_by": k2t["wsum_bound"][1],
                 "bound_ms": k2t["bound"][0], "bound_by": k2t["bound"][1]}}),
        "gru_bwd": (ref + "gru.py:259", k3["err"], {
            "checks": k3["checks"], "persistent_launch": k3["launch"]}),
        "attention_resident_fwd": (
            ref + "attention_resident.py:150", max(k45["err4"], k45g["err4"]),
            {"glimpses": "1-8", "checks": k45["checks4"] + k45g["checks4"],
             "score_ms_g1": times["attention_resident_fwd"]["score"],
             "score_tflops_g1":
             times["attention_resident_fwd"]["score_tflops"],
             "score_launch": report["score_launch"]}),
        "attention_resident_bwd": (
            ref + "attention_resident.py:208", max(k45["err5"], k45g["err5"]),
            {"glimpses": "1-8", "checks": k45["checks5"] + k45g["checks5"],
             "dwv_stage_g1": times["attention_resident_bwd"]["dwv_stage"],
             "dwv_launch": report["dwv_launch"],
             "rows_stage_g1": report["rows_stage"]["k5_g1"],
             "rows_stage_g2": report["rows_stage"]["k5_g2"],
             "rows_stage_g8": report["rows_stage"]["k5_g8"],
             "rows_launch": report["rows_launch"]}),
        "bigru_fwd": (ref + "gru.py:474", k67["err6"], {
            "tol": TOL_GRU, "diff_vs_two_k1_calls": k67["diff6"],
            "persistent_launch": k67["launch6"],
            "ptxas_gru_seq_kernel": k67["ptxas_seq"],
            "two_k1_ms": times["bigru_fwd"]["two_k1"],
            "tilings_ms": times["bigru_fwd"]["tilings_ms"]}),
        "bigru_bwd": (ref + "gru.py:561", k67["err7"], {
            "checks": k67["checks7"],
            "diff_vs_two_k3_calls": k67["diff7"],
            "persistent_launch": k67["launch7"],
            "ptxas_gru_bptt_kernel": k67["ptxas_bptt"],
            "two_k3_ms": times["bigru_bwd"]["two_k3"]}),
        "attention_bwd": (ref + "attention.py:267", k8["err"], {
            "checks": k8["checks"], "op_grad_cos_vs_explicit":
            k8["op_grad_cos"],
            "op_backward_with_kernel_ms":
            times["attention_bwd"]["op_backward_with_kernel"],
            "explicit_backward_ms":
            times["attention_bwd"]["explicit_backward"],
            "dwv_stage": times["attention_bwd"]["dwv_stage"],
            "dz_stage": times["attention_bwd"]["dz_stage"]}),
        "attention_resident_fwd[int8]": (
            ref + "attention_resident.py:174", k45q["err4"], {
                "glimpses": "1-8", "checks": k45q["checks4"],
                "score_ms_g1": times["attention_resident_fwd[int8]"]["score"],
                "score_tflops_g1":
                times["attention_resident_fwd[int8]"]["score_tflops"],
                "vatt_quant_rel_err_vs_bf16_store":
                k45q["vatt_quant_rel_err"]}),
        "attention_resident_bwd[int8]": (
            ref + "attention_resident.py:235", k45q["err5"], {
                "glimpses": "1-8", "checks": k45q["checks5"],
                "dwv_stage_g1":
                times["attention_resident_bwd[int8]"]["dwv_stage"],
                "rows_stage_g1": report["rows_stage"]["k5_int8_g1"]}),
    }
    paths = {"serving": serving, "training": training["launches"],
             "gathered": gathered["launches"],
             "streamed": streamed["launches"],
             "stage1": stage1["gathered"]["launches"],
             "stage1_dense": stage1["dense"]["launches"],
             "transfer": transfer["launches"],
             "glimpses2": glimpses2["launches"],
             "training_int8": training_int8["launches"],
             "probes": probes["launches"],
             "real_data_stage1": real_data["stage1_launches"],
             "real_data_stage2": real_data["stage2_launches"],
             "real_data_eval": real_data["eval_launches"],
             "real_data_predict": real_data["predict_launches"],
             "oov": oov["launches"],
             "end2end_train": end2end["train_launches"],
             "end2end_eval": end2end["eval_launches"],
             "end2end_predict": end2end["predict_launches"]}
    if end2end["pil"]:
        paths.update(end2end_jpeg_train=end2end["jpeg_train_launches"],
                     end2end_jpeg_predict=end2end["jpeg_predict_launches"])
    main_path = {"attention_fwd": "serving", "bigru_fwd": "stage1",
                 "bigru_bwd": "stage1", "attention_bwd": "gathered",
                 "attention_resident_fwd": "glimpses2",
                 "attention_resident_bwd": "glimpses2",
                 "attention_resident_fwd[int8]": "training_int8",
                 "attention_resident_bwd[int8]": "training_int8"}
    for name in ("attention_resident_fwd", "attention_resident_bwd"):
        g1, g2 = times[name], times[name].pop("at_g2")
        meta[name][2]["at_g1"] = {
            "launches": paths["training"][name], "ms": g1["kernel"],
            "plain_ms": g1["plain"], "bound_ms": g1["bound"][0],
            "bound_by": g1["bound"][1], "library_ms": g1["library"]}
        times[name] = g2
    # K2 and K8 on the backbone's grid at phase 22's batches.
    for name, key in (("attention_fwd", "k2"), ("attention_bwd", "k8")):
        meta[name][2]["at_end2end_batches"] = {
            str(bq): {**hk[key], "checks": hk[f"{key}_checks"]}
            for bq, hk in end2end["head_kernels"].items()}
    kernels = []
    for name, (replaces, err, errs) in meta.items():
        t = times[name]
        path = main_path.get(name, "training")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"{src}{name.split('[')[0]}.cu",
            "replaces": replaces, "launches": paths[path][name],
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            "max_abs_err": err, **errs, "ms": t["kernel"],
            "plain_ms": t["plain"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library"],
        })
    # The probes: their runs' own checks, times and bounds.
    p1, p2 = probes["probe_mxu_rows"], probes["probe_bwd_ceiling"]
    for name, r, replaces, ms, extra in (
            ("probe_mxu_rows", p1, "tools/probe_mxu_rows.py:34",
             p1["by_q"][1]["ms"], {"by_q": p1["by_q"],
                                   "rel_err_vs_plain": p1["rel_err_vs_plain"],
                                   "library_gather_ms":
                                   p1["cublas_gather_ms"]}),
            ("probe_bwd_ceiling", p2, "tools/probe_bwd_ceiling.py:36",
             p2["ms"], {"tflops": p2["tflops"],
                        "dwv_rel_err": p2["dwv_rel_err"],
                        "dal_rel_err": p2["dal_rel_err"],
                        "rows_stage": report["rows_stage"]["p2"]})):
        b_ms, b_by = bound(r["bound"]["bytes"], r["bound"]["flops"])
        kernels.append({
            "name": name, "route": "cuda", "source": f"{src}{name}.cu",
            "replaces": replaces, "launches": paths["probes"][name],
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            "max_abs_err": r["max_abs_err"], **extra, "ms": ms,
            "plain_ms": r["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": r["cublas_ms"], "library_call": r["cublas_call"]})
    report["kernels"] = kernels
    report["library_calls"] = {k: times[k]["library_call"]
                               for k in ("gru_fwd", "gru_bwd", "bigru_fwd",
                                         "bigru_bwd")}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
