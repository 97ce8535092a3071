#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper).

    python3 chip_smoke.py [--out results.json]

Run from the repository root. Phases (any failure exits non-zero):

1. the card's name and power limit; build every CUDA kernel of the serving
   path from ``vqa_transfer_externaldata_torch/csrc`` with nvcc (one
   process per source, all started together), timed;
2. K1 ``gru_fwd`` against its plain PyTorch version on the card
   (B=64, T=26, H=512, random lengths, forward and reverse);
3. K2 ``attention_fwd`` against its plain version on the card
   (B=64, N=196, C=2048, H=512, bf16, normalize on and off);
4. full-width ``vqa_attention`` serving through ``Predictor`` at batch 64:
   host-feature requests, a padded short request, and ids-only requests
   against a staged 256-image store; launch counts of K1 and K2 over that
   run; logits against the plain path on the card;
5. times: each kernel, its plain version and the PyTorch library call
   (median of CUDA-event timings after warm-up, L2 flushed between runs),
   the bound from this run's shapes, and the Predictor's p50 latency.

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
# Logits (cos * 10 + bias): activations are bf16 between layers, so a last-
#     bit difference out of a kernel can flip a bf16 rounding (2^-8) that the
#     following layers carry to the logits.
TOL_LOGITS = 5e-2

B, T, H, D = 64, 26, 512, 300
GRID, C = 14, 2048
N = GRID * GRID
STORE_ROWS = 256
RUNS = 25


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
    run of the whole model on the card)."""
    from vqa_transfer_externaldata_torch.ops import attention, gru

    saved = attention.attention_fwd, gru.gru_fwd
    attention.attention_fwd = (
        lambda v, qh, wv, ws, *, normalize:
        attention.attention_fwd_reference(v, qh, wv, ws, normalize))
    gru.gru_fwd = gru.gru_reference
    try:
        yield
    finally:
        attention.attention_fwd, gru.gru_fwd = saved


def phase_build(report: dict) -> None:
    from vqa_transfer_externaldata_torch.ops import kernels

    t0 = time.perf_counter()
    ptxas = kernels.build(["gru_fwd", "attention_fwd"])
    report["build_s"] = time.perf_counter() - t0
    for name, text in ptxas.items():
        print(f"--- nvcc {name}.cu ---\n{text.strip()}", file=sys.stderr)
    report["ptxas"] = ptxas
    print(f"built kernels in {report['build_s']:.1f} s")


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


def phase_attention(report: dict, dev, gen) -> dict:
    import torch
    from vqa_transfer_externaldata_torch.ops import attention

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
    checks = []
    for normalize in (True, False):
        va, al = attention.attention_fwd(v, qh, wv, ws, normalize=normalize)
        rv, ra = attention.attention_fwd_reference(v, qh, wv, ws, normalize)
        torch.cuda.synchronize()
        ev = (va - rv).abs().max().item()
        ea = (al - ra).abs().max().item()
        tol_v = TOL_VATT_REL * rv.abs().max().item()
        print(f"K2 attention_fwd normalize={normalize}: max abs err v_att "
              f"{ev:.3e} (tol {tol_v:.3e} = 2^-10 * max|v_att|), alpha "
              f"{ea:.3e} (tol {TOL_ALPHA})")
        check(bool(torch.isfinite(va).all() and torch.isfinite(al).all()),
              "K2 output not finite")
        check(ev <= tol_v, f"K2 normalize={normalize} v_att err {ev} > "
              f"{tol_v}")
        check(ea <= TOL_ALPHA, f"K2 normalize={normalize} alpha err {ea} > "
              f"{TOL_ALPHA}")
        checks.append({"normalize": normalize, "v_att_err": ev,
                       "v_att_tol": tol_v, "alpha_err": ea,
                       "alpha_tol": TOL_ALPHA})
    return {"v": v, "qh": qh, "wv": wv, "ws": ws, "checks": checks}


def write_run(train_dir: str) -> None:
    """A synthetic full-width run: config.json + a seeded random init."""
    import torch
    from vqa_transfer_externaldata_torch.config import Config
    from vqa_transfer_externaldata_torch.models.zoo import build_model
    from vqa_transfer_externaldata_torch.utils.checkpoint import save_params

    cfg = Config().replace_flat({"data.synthetic": True})
    with open(os.path.join(train_dir, "config.json"), "w") as fh:
        fh.write(cfg.to_json())
    gen = torch.Generator().manual_seed(123)
    save_params(os.path.join(train_dir, "params_final.pt"),
                build_model(cfg, generator=gen).state_dict())


def phase_serving(report: dict, dev) -> dict:
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.ops import attention, gru
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
    gru.gru_fwd.launches = attention.attention_fwd.launches = 0
    ans_host = pred.answer(feats, questions)
    ans_short = pred.answer(feats[:short], questions[:short])
    ans_idx = pred.answer_indexed(idx, questions)
    launches = {"gru_fwd": gru.gru_fwd.launches,
                "attention_fwd": attention.attention_fwd.launches}
    print(f"serving launches: {launches}")
    # Three forwards: K1 launches one step kernel per timestep, K2 two.
    expected = {"gru_fwd": 3 * T, "attention_fwd": 3 * 2}
    check(launches == expected,
          f"expected launches {expected}, got {launches}")
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
        "answer_host_features": profile_requests(
            lambda: pred.answer(feats, questions)),
        "answer_indexed": profile_requests(
            lambda: pred.answer_indexed(idx, questions)),
    }
    return launches


def profile_requests(fn, n: int = 5) -> dict:
    """Device time by kernel over ``n`` requests (torch.profiler), and the
    share of the host-clock wall time in which no kernel ran."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            name = e.key.split("(")[0].replace("void ", "")
            name = name.replace("(anonymous namespace)::", "")[:100]
            if not name:  # "(anonymous namespace)::kernel(...)"
                name = e.key.split("::")[1].split("(")[0]
            kernels[name] = kernels.get(name, 0.0) + us / n
    busy = sum(kernels.values()) * n
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    out = {"requests": n, "wall_ms_per_request": wall_us / n / 1e3,
           "kernel_ms_per_request": busy / n / 1e3 if busy else None,
           "device_idle_share": 1 - busy / wall_us if busy else None,
           "top_kernels_us_per_request": dict(top)}
    print(f"profile of {n} requests: {json.dumps(out)}")
    return out


def phase_times(report: dict, k1: dict, k2: dict, dev) -> dict:
    import torch
    from vqa_transfer_externaldata_torch.ops import attention, gru

    buf = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    times = {}
    gx, lens, uh, bhn = k1["gx"], k1["lens"], k1["uh"], k1["bhn"]
    times["gru_fwd"] = {
        "kernel": time_cuda(lambda: gru.gru_fwd(gx, lens, uh, bhn), buf),
        "plain": time_cuda(lambda: gru.gru_reference(gx, lens, uh, bhn),
                           buf),
    }
    # Library yardstick: cuDNN GRU over packed sequences. It also does the
    # input projection x @ W_x, which the kernel receives done.
    lib_gru = torch.nn.GRU(D, H).to(dev, torch.bfloat16)
    lib_gru.flatten_parameters()
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        torch.randn(T, B, D, device=dev, dtype=torch.bfloat16), lens.cpu(),
        enforce_sorted=False)
    with torch.inference_mode():
        times["gru_fwd"]["library"] = time_cuda(lambda: lib_gru(packed), buf)
    times["gru_fwd"]["library_call"] = (
        f"torch.nn.GRU({D}, {H}) in bfloat16 over a packed sequence, input "
        "projection included")

    v, qh, wv, ws = k2["v"], k2["qh"], k2["wv"], k2["ws"]
    times["attention_fwd"] = {
        "kernel": time_cuda(
            lambda: attention.attention_fwd(v, qh, wv, ws, normalize=True),
            buf),
        "plain": time_cuda(
            lambda: attention.attention_fwd_reference(v, qh, wv, ws, True),
            buf),
        "library": None,
    }

    nlen = int(lens.sum().item())  # timesteps that do work in this run
    k1_bytes = (nlen * 3 * H * 4 + B * 4 + H * 3 * H * 2 + H * 4
                + T * B * H * 4 + B * H * 4)
    k1_flops = 2 * nlen * H * 3 * H
    k2_bytes = B * N * C * 2 + B * H * 4 + C * H * 2 + H * 4 + B * C * 4 \
        + B * N * 4
    k2_flops = 2 * B * N * C * H + 2 * B * N * C
    times["gru_fwd"]["bound"] = bound(k1_bytes, k1_flops)
    times["attention_fwd"]["bound"] = bound(k2_bytes, k2_flops)
    for name, t in times.items():
        print(f"{name}: kernel {t['kernel']:.4f} ms, plain "
              f"{t['plain']:.4f} ms, library {t['library']}, bound "
              f"{t['bound'][0]:.4f} ms ({t['bound'][1]})")
    return times


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
        launches = phase_serving(report, dev)
        times = phase_times(report, k1, k2, dev)
        torch.cuda.synchronize()
    except PhaseError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1

    # max_abs_err: the largest error of the kernel's outputs; K2 also
    # lists each output in each mode beside its own limit.
    meta = {
        "gru_fwd": ("vqa_transfer_externaldata_torch/csrc/gru_fwd.cu",
                    "vqa_transfer_externaldata_tpu/ops/gru.py:227",
                    k1["err"], {"tol": TOL_GRU}),
        "attention_fwd": (
            "vqa_transfer_externaldata_torch/csrc/attention_fwd.cu",
            "vqa_transfer_externaldata_tpu/ops/attention.py:125",
            max(max(c["v_att_err"], c["alpha_err"]) for c in k2["checks"]),
            {"checks": k2["checks"]}),
    }
    kernels = []
    for name, (source, replaces, err, errs) in meta.items():
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, **errs, "ms": t["kernel"],
            "plain_ms": t["plain"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library"],
        })
    report["kernels"] = kernels
    report["library_calls"] = {"gru_fwd": times["gru_fwd"]["library_call"]}
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
