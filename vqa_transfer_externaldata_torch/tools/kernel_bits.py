"""Fingerprints of the bf16 kernels' outputs (K1-K8, K4/K5 on int8 rows
too) and of the float32 kernels' (K1f-K8f, K4f/K5f on f32, f16 and int8
rows) at the main path's shapes on seeded inputs: a SHA-256 of each
output's bytes; and of the float32 BPTT's step forms (K3f both ways, K7f)
at STEP_H units, past the persistent kernels, where -0 and +0 count as
one value (``torch.equal``'s: a dead row's cotangents are +0 in one form
and +-0 in another). Two builds of the port that give the same
fingerprints on one card compute the same bits, which is how a change to
the kernels' shared sources is held to its parent commit.

Run it from the root of the checkout whose kernels it should build and run
(it imports ``vqa_transfer_externaldata_torch`` from the working
directory, so one copy of this file serves a checkout of another commit):

    python <path>/kernel_bits.py --out bits_a.json
    cd <other checkout> && python <path>/kernel_bits.py --out bits_b.json
    python <path>/kernel_bits.py --compare bits_a.json bits_b.json

``--compare`` prints each output that differs and exits 1 if any does.
The inputs come from a CUDA generator seeded with ``--seed``: compare
fingerprints taken on one machine with one torch build. Needs a CUDA
device; it raises without one.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import torch

B, T, H, N, C = 256, 26, 512, 196, 2048
NP, IMAGES = 200, 512  # the store's padded cells a row, and its rows
STEP_H = 1100  # the float32 GRU's step form: past its persistent kernels


def _digest(x: torch.Tensor) -> str:
    raw = x.detach().contiguous().view(-1).view(torch.uint8)
    return hashlib.sha256(raw.cpu().numpy().tobytes()).hexdigest()


def _digest_values(x: torch.Tensor) -> str:
    """_digest with -0 read as +0 (x + 0 is x but for -0)."""
    return _digest(x.detach() + 0.0)


def fingerprints(seed: int) -> dict:
    """{kernel call: {output: sha256}} of every bf16 and float32 kernel at
    the main path's shapes, and of the float32 BPTT's step forms."""
    return {**bf16_fingerprints(seed), **f32_fingerprints(seed),
            **f32_step_fingerprints(seed)}


def bf16_fingerprints(seed: int) -> dict:
    """{kernel call: {output: sha256}} of every bf16 kernel at the main
    path's shapes."""
    from vqa_transfer_externaldata_torch.ops import (
        attention, attention_resident as ar, gru)

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    out = {}

    def put(name, names, tensors):
        out[name] = {n: _digest(t) for n, t in zip(names, tensors)}

    lim = (6.0 / (4 * H)) ** 0.5
    gx = [torch.randn(T, B, 3 * H, generator=g, device=dev) * 0.5
          for _ in "fb"]
    uh = [((torch.rand(H, 3 * H, generator=g, device=dev) * 2 - 1) * lim
           ).to(bf) for _ in "fb"]
    bhn = [torch.randn(H, generator=g, device=dev) * 0.1 for _ in "fb"]
    ghT = [torch.randn(B, H, generator=g, device=dev) * 0.05 for _ in "fb"]
    lens = torch.randint(1, T + 1, (B,), generator=g, device=dev,
                         dtype=torch.int32)
    for reverse in (False, True):
        hT, hseq = gru.gru_fwd(gx[0], lens, uh[0], bhn[0], reverse=reverse)
        put(f"K1 reverse={reverse}", ("hT", "hseq"), (hT, hseq))
        put(f"K3 reverse={reverse}", ("dgx", "duh", "dbhn"), gru.gru_bwd(
            gx[0], hseq, lens, uh[0], bhn[0], ghT[0], reverse=reverse))
    args = (gx[0], gx[1], lens, uh[0], uh[1], bhn[0], bhn[1])
    k6 = gru.bigru_fwd(*args)
    put("K6", ("hTf", "hTb", "hseqf", "hseqb"), k6)
    put("K7", ("dgxf", "dgxb", "duhf", "duhb", "dbhnf", "dbhnb"),
        gru.bigru_bwd(gx[0], gx[1], k6[2], k6[3], lens, uh[0], uh[1],
                      bhn[0], bhn[1], ghT[0], ghT[1]))
    del gx, k6

    scale = torch.exp2(torch.rand(B, N, 1, generator=g, device=dev) * 4 - 2)
    v = (torch.randn(B, N, C, generator=g, device=dev).relu_() * scale
         ).to(bf)
    qh = torch.randn(B, H, generator=g, device=dev) * 0.5
    wv = ((torch.rand(C, H, generator=g, device=dev) * 2 - 1)
          * (6.0 / (C + H)) ** 0.5).to(bf)
    ws = (torch.randn(H, generator=g, device=dev) * 0.05).to(bf).float()
    for normalize in (True, False):
        va, al, r = attention.attention_fwd(v, qh, wv, ws,
                                            normalize=normalize)
        put(f"K2 normalize={normalize}", ("v_att", "alpha", "r"),
            (va, al, r))
        ds = (torch.randn(B, N, generator=g, device=dev) * al).contiguous()
        put(f"K8 normalize={normalize}", ("dqh", "dwv", "dws"),
            attention.attention_bwd(v, qh, wv, ws, ds, r, normalize))
    del v

    store = torch.zeros(IMAGES, NP, C, dtype=bf, device=dev)
    store[:, :N] = torch.randn(IMAGES, N, C, generator=g,
                               device=dev).relu_().to(bf)
    g32 = store.float()
    g32 = g32 / g32.norm(dim=-1, keepdim=True).clamp_min(1e-6)
    q_scale = g32.abs().max().item() / 127
    codes = (g32 / q_scale).round().to(torch.int8)
    del g32
    rows = torch.randint(0, IMAGES, (B,), generator=g, device=dev,
                         dtype=torch.int32)
    ws2 = torch.randn(H, 2, generator=g, device=dev) * 0.05
    for rows_type, st, w, cases in (
            ("bf16", store, wv, ((1, True), (1, False), (2, False))),
            ("int8", codes, (wv.float() * q_scale).to(bf),
             ((1, False), (2, False)))):
        for G, normalize in cases:
            wsg = ws2[:, 0].contiguous() if G == 1 else ws2
            kw = dict(n_valid=N, normalize=normalize)
            va, al, h = ar.attention_resident_fwd(st, rows, qh, w, wsg,
                                                  save_h=True, **kw)
            tag = f"{rows_type} rows G={G} normalize={normalize}"
            put(f"K4 {tag}", ("v_att", "alpha", "h"), (va, al, h))
            gv = torch.randn(B, G * C, generator=g, device=dev)
            sga = torch.randn(al.shape, generator=g, device=dev) * 0.1
            put(f"K5 {tag}", ("dqh", "dwv", "dws"),
                ar.attention_resident_bwd(st, rows, h, wsg, al, gv, sga,
                                          **kw))
    torch.cuda.synchronize()
    return out


def f32_fingerprints(seed: int) -> dict:
    """{kernel call: {output: sha256}} of every float32 kernel at the main
    path's shapes: K1f and K3f both ways, K6f and K7f, K2f and K8f with
    normalize on and off, K4f and K5f on f32, f16 and int8 rows at one and
    two glimpses (the saved h is K4f's score product's own output)."""
    from vqa_transfer_externaldata_torch.ops import (
        attention, attention_resident as ar, gru)

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    out = {}

    def put(name, names, tensors):
        out[name] = {n: _digest(t) for n, t in zip(names, tensors)}

    gx = [torch.randn(T, B, 3 * H, generator=g, device=dev) * 0.5
          for _ in "fb"]
    uh = [torch.randn(H, 3 * H, generator=g, device=dev) * H ** -0.5
          for _ in "fb"]
    bhn = [torch.randn(H, generator=g, device=dev) * 0.1 for _ in "fb"]
    ghT = [torch.randn(B, H, generator=g, device=dev) * 0.05 for _ in "fb"]
    lens = torch.randint(1, T + 1, (B,), generator=g, device=dev,
                         dtype=torch.int32)
    for reverse in (False, True):
        hT, hseq = gru.gru_fwd_f32(gx[0], lens, uh[0], bhn[0],
                                   reverse=reverse)
        put(f"K1f reverse={reverse}", ("hT", "hseq"), (hT, hseq))
        put(f"K3f reverse={reverse}", ("dgx", "duh", "dbhn"),
            gru.gru_bwd_f32(gx[0], hseq, lens, uh[0], bhn[0], ghT[0],
                            reverse=reverse))
    k6 = gru.bigru_fwd_f32(gx[0], gx[1], lens, uh[0], uh[1], bhn[0],
                           bhn[1])
    put("K6f", ("hTf", "hTb", "hseqf", "hseqb"), k6)
    put("K7f", ("dgxf", "dgxb", "duhf", "duhb", "dbhnf", "dbhnb"),
        gru.bigru_bwd_f32(gx[0], gx[1], k6[2], k6[3], lens, uh[0], uh[1],
                          bhn[0], bhn[1], ghT[0], ghT[1]))
    del gx, k6

    scale = torch.exp2(torch.rand(B, N, 1, generator=g, device=dev) * 4 - 2)
    v = torch.randn(B, N, C, generator=g, device=dev).relu_() * scale
    qh = torch.randn(B, H, generator=g, device=dev) * 0.5
    wv = (torch.rand(C, H, generator=g, device=dev) * 2 - 1) * (
        6.0 / (C + H)) ** 0.5
    ws = torch.randn(H, generator=g, device=dev) * 0.05
    for normalize in (True, False):
        va, al, r = attention.attention_fwd_f32(v, qh, wv, ws,
                                                normalize=normalize)
        put(f"K2f normalize={normalize}", ("v_att", "alpha", "r"),
            (va, al, r))
        ds = (torch.randn(B, N, generator=g, device=dev) * al).contiguous()
        put(f"K8f normalize={normalize}", ("dqh", "dwv", "dws"),
            attention.attention_bwd_f32(v, qh, wv, ws, ds, r, normalize))
    del v

    grid = torch.zeros(IMAGES, NP, C, device=dev)
    grid[:, :N] = torch.randn(IMAGES, N, C, generator=g, device=dev).relu_()
    unit = grid / grid.norm(dim=-1, keepdim=True).clamp_min(1e-6)
    q_scale = unit.abs().max().item() / 127
    codes = (unit / q_scale).round().to(torch.int8)
    del unit
    rows = torch.randint(0, IMAGES, (B,), generator=g, device=dev,
                         dtype=torch.int32)
    ws2 = torch.randn(H, 2, generator=g, device=dev) * 0.05
    for rows_type, st, w, cases in (
            ("f32", grid, wv, ((1, True), (1, False), (2, False))),
            ("f16", grid.half(), wv, ((1, True), (1, False), (2, False))),
            ("int8", codes, wv * q_scale, ((1, False), (2, False)))):
        for G, normalize in cases:
            wsg = ws2[:, 0].contiguous() if G == 1 else ws2
            kw = dict(n_valid=N, normalize=normalize)
            va, al, h = ar.attention_resident_fwd_f32(st, rows, qh, w, wsg,
                                                      save_h=True, **kw)
            tag = f"{rows_type} rows G={G} normalize={normalize}"
            put(f"K4f {tag}", ("v_att", "alpha", "h"), (va, al, h))
            gv = torch.randn(B, G * C, generator=g, device=dev)
            sga = torch.randn(al.shape, generator=g, device=dev) * 0.1
            put(f"K5f {tag}", ("dqh", "dwv", "dws"),
                ar.attention_resident_bwd_f32(st, rows, h, wsg, al, gv, sga,
                                              **kw))
    torch.cuda.synchronize()
    return out


def f32_step_fingerprints(seed: int) -> dict:
    """{kernel call: {output: sha256 of its values}} of the float32 BPTT's
    step forms at B x T x STEP_H with lengths 1 .. T: K3f both ways
    (``gru._gru_bwd32(..., form="step")``) on K1f's states, K7f's step form
    (``gru.bigru_bwd_f32(..., form="step")``) on K6f's."""
    from vqa_transfer_externaldata_torch.ops import gru

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    Hs, out = STEP_H, {}
    gx = [torch.randn(T, B, 3 * Hs, generator=g, device=dev) * 0.5
          for _ in "fb"]
    uh = [torch.randn(Hs, 3 * Hs, generator=g, device=dev) * Hs ** -0.5
          for _ in "fb"]
    bhn = [torch.randn(Hs, generator=g, device=dev) * 0.1 for _ in "fb"]
    ghT = [torch.randn(B, Hs, generator=g, device=dev) * 0.05 for _ in "fb"]
    lens = torch.randint(1, T + 1, (B,), generator=g, device=dev,
                         dtype=torch.int32)
    for reverse in (False, True):
        _, hseq = gru.gru_fwd_f32(gx[0], lens, uh[0], bhn[0],
                                  reverse=reverse)
        got = gru._gru_bwd32(gx[0], hseq, lens, uh[0], bhn[0], ghT[0],
                             reverse, "step")
        out[f"K3f step reverse={reverse}"] = {
            n: _digest_values(t) for n, t in zip(("dgx", "duh", "dbhn"),
                                                 got)}
    k6 = gru.bigru_fwd_f32(gx[0], gx[1], lens, uh[0], uh[1], bhn[0],
                           bhn[1])
    got = gru.bigru_bwd_f32(gx[0], gx[1], k6[2], k6[3], lens, uh[0], uh[1],
                            bhn[0], bhn[1], ghT[0], ghT[1], form="step")
    out["K7f step"] = {n: _digest_values(t) for n, t in zip(
        ("dgxf", "dgxb", "duhf", "duhb", "dbhnf", "dbhnb"), got)}
    torch.cuda.synchronize()
    return out


def compare(a: dict, b: dict) -> list:
    """The (call, output) pairs whose fingerprints differ or that one side
    lacks."""
    bad = []
    for call in sorted(set(a) | set(b)):
        outs = set(a.get(call, {})) | set(b.get(call, {}))
        for name in sorted(outs):
            if a.get(call, {}).get(name) != b.get(call, {}).get(name):
                bad.append((call, name))
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="write the fingerprints here (JSON)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"),
                    help="compare two fingerprint files")
    args = ap.parse_args(argv)
    if args.compare:
        a, b = (json.load(open(p)) for p in args.compare)
        bad = compare(a["fingerprints"], b["fingerprints"])
        total = sum(len(v) for v in a["fingerprints"].values())
        for call, name in bad:
            print(f"differs: {call} {name}")
        by_family = {}
        for call, outs in a["fingerprints"].items():
            fam = "float32" if call.split()[0].endswith("f") else "bf16"
            n, d = by_family.get(fam, (0, 0))
            by_family[fam] = (n + len(outs), d + sum(c == call for c, _ in
                                                     bad))
        print(json.dumps({"outputs": total, "differ": len(bad),
                          "by_family": {f: {"outputs": n, "differ": d}
                                        for f, (n, d) in by_family.items()},
                          "a": a["card"], "b": b["card"]}))
        return 1 if bad else 0
    sys.path.insert(0, os.getcwd())
    import vqa_transfer_externaldata_torch as port

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_bits needs a CUDA device")
    here = os.path.dirname(os.path.abspath(port.__file__))
    if not here.startswith(os.getcwd()):
        raise RuntimeError(f"imported the port from {here}, not from the "
                           f"working directory {os.getcwd()}")
    res = {"card": torch.cuda.get_device_name(0), "package": here,
           "seed": args.seed, "fingerprints": fingerprints(args.seed)}
    n = sum(len(v) for v in res["fingerprints"].values())
    print(f"kernel_bits: {n} outputs of {len(res['fingerprints'])} calls "
          f"from {here}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
