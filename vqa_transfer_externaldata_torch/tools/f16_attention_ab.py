"""Time the float16 gathered attention's training step of one checkout on
the card: ``spatial_attention``'s forward and backward (K2h, K8h and the
op's code around them, ``normalize`` on, no grid gradient) at the gathered
training shape, and phase 29's float16 gathered ``fit_resident`` and
streamed ``cli.train`` step times from that checkout's ``chip_smoke.py``.
Two checkouts are compared by running it once for each, in turns
(A, B, B, A), on one card:

    python vqa_transfer_externaldata_torch/tools/f16_attention_ab.py \
        --root <checkout> --out result.json

It imports the port and ``chip_smoke`` from ``--root`` (built there by
``chip_smoke.phase_build``) and passes ``train=True`` to the op where the
checkout's op takes it. The grid is ReLU'd normal noise times ``--scale``
(2000 by default: values past 256, whose float16 squares overflow, as a
ResNet-101 grid holds). Times are CUDA-event medians (``chip_smoke.
time_cuda``, the L2 flushed before each run). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", required=True, help="the checkout to time")
    p.add_argument("--out", default=None, help="also write the JSON here")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--cells", type=int, default=196)
    p.add_argument("--channels", type=int, default=2048)
    p.add_argument("--hidden", type=int, default=512)
    p.add_argument("--scale", type=float, default=2000.0)
    p.add_argument("--runs", type=int, default=25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no_phase29", action="store_true",
                   help="time the op only")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from vqa_transfer_externaldata_torch.ops import attention

    if not torch.cuda.is_available():
        raise SystemExit("f16_attention_ab: no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    cs.phase_build({})
    g = torch.Generator(device=dev).manual_seed(args.seed)
    B, N, C, H = args.batch, args.cells, args.channels, args.hidden
    v = (torch.randn(B, N, C, generator=g, device=dev).relu()
         * args.scale).to(torch.float16)
    qh = torch.randn(B, H, generator=g, device=dev).requires_grad_()
    wv = (torch.randn(C, H, generator=g, device=dev)
          * C ** -0.5).to(torch.float16).requires_grad_()
    ws = torch.randn(H, generator=g, device=dev).requires_grad_()
    takes_train = "train" in inspect.signature(
        attention.spatial_attention).parameters
    kw = {"normalize": True, "feature_grad": False,
          **({"train": True} if takes_train else {})}
    gv = torch.randn(B, C, generator=g, device=dev)

    def forward():
        return attention.spatial_attention(v, qh, wv, ws, **kw)

    def step():
        v_att, _ = forward()
        torch.autograd.grad(v_att, (qh, wv, ws), gv)

    buf = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    with torch.no_grad():
        fwd_ms = cs.time_cuda(forward, buf, runs=args.runs)
    step_ms = cs.time_cuda(step, buf, runs=args.runs)
    out = {"root": root, "card": card, "takes_train": takes_train,
           "shape": [B, N, C, H], "grid_max": float(v.abs().max()),
           "op_forward_ms": fwd_ms, "op_forward_backward_ms": step_ms}
    print(f"{root}: spatial_attention float16 [{B}, {N}, {C}] H={H}: "
          f"forward {fwd_ms:.4f} ms, forward and backward {step_ms:.4f} ms",
          flush=True)
    del v, buf
    torch.cuda.empty_cache()
    if not args.no_phase29:
        gathered = cs.f16_gathered_training(dev)
        streamed = cs.f16_streamed(dev)
        out["phase29"] = {
            name: {k: r[k] for k in ("step_ms_median", "step_ms_all")}
            for name, r in (("gathered", gathered), ("streamed", streamed))}
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
