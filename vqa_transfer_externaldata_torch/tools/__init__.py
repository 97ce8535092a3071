"""H100 probes of the port: the counterparts of the JAX package's TPU
probes in the repository's ``tools/`` (Pallas kernels that measured the
matrix unit's ceiling for the attention GEMMs). Each probe is a CUDA kernel
in ``csrc/`` with a plain PyTorch version beside it and a ``main()`` that
runs on the card (``python -m vqa_transfer_externaldata_torch.tools.<probe>``)
and raises without one. Beside them ``oov_claim`` runs the paper's
out-of-vocabulary answer protocol on the port (card or CPU)."""

from __future__ import annotations

from typing import Callable

import torch


def require_cuda(what: str) -> torch.device:
    """The card a probe runs on; raises without one (a probe measures the
    card, so it has no CPU mode)."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} measures a CUDA card and none is "
                           "visible")
    return torch.device("cuda", torch.cuda.current_device())


def loop_ms(fn: Callable[[torch.Tensor], object], rows: torch.Tensor,
            iters: int) -> float:
    """Mean ms of ``fn(rows)`` over ``iters`` launches timed with CUDA
    events, the rows rolled on the device between launches (so no launch
    repeats the previous one's lookup), after one launch to warm up."""
    fn(rows)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(rows)
        rows = torch.roll(rows, 1)
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


# A probe's kernel against its plain version on the card, as the largest
# error relative to the largest |value| of the plain output: both sum the
# same exact products of bf16 values in f32, in another order. The order
# moves a K-term sum by about K * 2^-24 of its terms' size, while the
# largest value of K random-signed terms is about 4 sqrt(K) of it: 2^-20 at
# K = 2048 and 2^-18 at K = 51200. The limit leaves a factor of 16 over the
# latter; a wrong row, cell or question moves an output by far more.
TOL_REL = 2.0 ** -14


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    return ((got - want).abs().max().item()
            / max(want.abs().max().item(), 1e-30))
