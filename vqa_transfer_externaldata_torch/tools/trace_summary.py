"""Summarize a ``torch.profiler`` Chrome trace of the port: device time a
step, the kernels and the host ops by self time, the window's idle share,
and whether the trace lost device events.

    python -m vqa_transfer_externaldata_torch.tools.trace_summary \\
        <train_dir>/profile [--steps N] [--top 12] [--cuda_event_ms MS]

The path is a trace file or a directory searched for the newest
``*.pt.trace.json.gz`` (the Trainer's window, ``--train.profile_steps``,
writes ``<train_dir>/profile/trace_<first>_<last>.pt.trace.json.gz``).
The steps and the window's CUDA-event time default to those of the
``.window.json`` the Trainer writes beside its trace.

- **device step ms**: the union of the kernel, memcpy and memset events
  (the CUDA streams' tracks) over the window, divided by ``--steps``;
- **kernels**: device time by kernel name; **host ops**: self time of each
  ``cpu_op`` event, its children subtracted by an interval sweep over each
  thread's track (:func:`self_times`, as the JAX repository's
  ``tools/trace_summary.py``);
- **the window**: its ``WINDOW_ANNOTATION`` span where it has one
  (``utils/tracing.py::TraceWindow``'s): the host's events inside it and
  the device records of the work they enqueued, matched by correlation id
  (:func:`device_events`; the card's clock is not the host's); else the
  whole trace, first to last event;
- **idle share**: the part of the window in which no device event ran;
- **lost events**: every kernel or graph the host launched in the window
  must have a device record of the same correlation id (those without
  one are listed with the host op that made them), and the trace's window
  must span at least ``MIN_WINDOW_SHARE`` of the window's time on CUDA
  events. Otherwise the summary says ``lost_events`` and reports no busy,
  step or idle figure.
- **clock gap**: the least time from a launch to its first device record.
  A record cannot start before its launch, so a negative gap is the least
  by which the card's clock stands behind the host's in the trace;
- **lost before the window**: the launches before the annotation (the
  settling launches of ``utils/tracing.py``) without a device record: the
  session's leading losses, which the settling launches must outnumber.

One JSON line on stdout, a table on stderr. The CUDA trace's track layout
is Kineto's: device events carry ``cat`` ``kernel``, ``gpu_memcpy`` or
``gpu_memset``, the host's runtime calls ``cuda_runtime``, both with
``args.correlation``.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

from vqa_transfer_externaldata_torch.utils.tracing import (
    TRACE_SUFFIX, WINDOW_ANNOTATION)

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# The host's calls that enqueue device work (their correlation ids are
# their device records').
CALL_CATS = ("cuda_runtime", "cuda_driver")
# Runtime calls that launch kernels and so must have a device record (the
# lower-level call the runtime makes for each is not counted again).
# Copies and sets are left out: a set of no bytes, which PyTorch makes,
# leaves no record.
LAUNCH_PREFIXES = ("cudaLaunch", "cudaGraphLaunch")
# A trace's window and the CUDA events around the same work agree within
# 2% (chip_smoke's windows on an H100); a window without an annotation
# (its first event to its last) short of this share of the CUDA-event
# time lost records at its end. (The device's busy total cannot be held to
# the CUDA-event time: it falls far below it wherever the host leaves the
# device idle.)
MIN_WINDOW_SHARE = 0.9


def find_trace(path: str) -> str:
    """``path`` if it is a file, else the newest trace under it."""
    if os.path.isfile(path):
        return path
    hits = glob.glob(os.path.join(path, "**", "*.trace.json.gz"),
                     recursive=True)
    if not hits:
        raise FileNotFoundError(f"no *.trace.json.gz under {path}")
    return max(hits, key=os.path.getmtime)


def load_events(trace_file: str) -> List[dict]:
    with gzip.open(trace_file, "rt") as fh:
        return json.load(fh).get("traceEvents", [])


def load_window(trace_file: str) -> dict:
    """The ``.window.json`` beside a trace the Trainer wrote, else {}."""
    stem = trace_file[:-len(TRACE_SUFFIX)] if trace_file.endswith(
        TRACE_SUFFIX) else os.path.splitext(trace_file)[0]
    try:
        with open(stem + ".window.json") as fh:
            return json.load(fh)
    except FileNotFoundError:
        return {}


def kernel_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces and
    arguments, at most 100 characters."""
    return name.replace("void ", "").replace(
        "(anonymous namespace)::", "").split("(")[0][:100]


def device_tracks(events: List[dict]) -> Dict[Tuple[int, int], List[dict]]:
    """The device's complete events by (pid, tid): one track a stream."""
    tracks: Dict[Tuple[int, int], List[dict]] = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            tracks[(e["pid"], e["tid"])].append(e)
    return dict(tracks)


def device_events(events: List[dict], start: float, end: float
                  ) -> List[dict]:
    """The device records of the work the host enqueued in [start, end]:
    those whose correlation id is that of a runtime or driver call made
    in it (a graph's kernels carry its launch's), and those of no call in
    the trace that start in it. Not by their own time: the card's clock
    and the host's differ in a trace by up to some milliseconds (on an
    H100, from -3 to +10 ms in one run), so the records of a window's
    first or last work can lie outside it."""
    calls = [e for e in events if e.get("ph") == "X"
             and e.get("cat") in CALL_CATS]
    made = {e.get("args", {}).get("correlation") for e in calls
            if start <= e["ts"] <= end}
    known = {e.get("args", {}).get("correlation") for e in calls}
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        c = e.get("args", {}).get("correlation")
        if c in made or (c not in known and start <= e["ts"] <= end):
            out.append(e)
    return out


def self_times(track: List[dict]) -> Dict[str, float]:
    """Per-name self time (us) for possibly-nested complete events.

    Sorted by (start, -dur), a stack of enclosing intervals attributes
    each event's duration to itself and subtracts it from its parent —
    one O(n log n) sweep, no tree construction.
    """
    track = sorted(track, key=lambda e: (e["ts"], -e.get("dur", 0.0)))
    out: collections.Counter = collections.Counter()
    stack: List[Tuple[float, str, float]] = []  # (end, name, self_us)
    for e in track:
        ts, dur = e["ts"], e.get("dur", 0.0)
        while stack and stack[-1][0] <= ts + 1e-9:
            end, name, self_us = stack.pop()
            out[name] += self_us
        if stack:
            end, name, self_us = stack[-1]
            stack[-1] = (end, name, self_us - dur)
        stack.append((ts + dur, e["name"], dur))
    for _, name, self_us in stack:
        out[name] += self_us
    return dict(out)


def union_us(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def summarize(path: str, steps: Optional[int] = None,
              top: Optional[int] = 12,
              cuda_event_ms: Optional[float] = None) -> dict:
    """The summary of the trace at ``path`` (a file, or the newest under a
    directory) over ``steps`` steps (default: its window file's), with all
    kernels and host ops when ``top`` is None. ``cuda_event_ms``: the
    window's time on CUDA events (default: its window file's)."""
    trace_file = find_trace(path)
    events = load_events(trace_file)
    window = load_window(trace_file)
    span = [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and e.get("name") == WINDOW_ANNOTATION]
    steps = steps if steps is not None else window.get("steps")
    if cuda_event_ms is None:
        cuda_event_ms = window.get("cuda_event_ms")
    lost_before = None
    if span:  # a TraceWindow's: what its annotation holds
        start = span[0]["ts"]
        end = start + span[0].get("dur", 0.0)
        recorded = {e.get("args", {}).get("correlation") for e in events
                    if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS}
        lost_before = sum(
            1 for e in events if e.get("ph") == "X"
            and e.get("cat") == "cuda_runtime" and e["ts"] < start
            and e.get("name", "").startswith(LAUNCH_PREFIXES)
            and e.get("args", {}).get("correlation") not in recorded)
        on_device = device_events(events, start, end)
        events = [e for e in events if e is not span[0]
                  and e.get("cat") not in DEVICE_CATS
                  and start <= e.get("ts", start) <= end] + on_device
    tracks = device_tracks(events)
    device = [e for track in tracks.values() for e in track]
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "cpu_op"]
    launches = [e for e in events if e.get("ph") == "X"
                and e.get("cat") == "cuda_runtime"
                and e.get("name", "").startswith(LAUNCH_PREFIXES)]
    if not span:
        timed = host + launches + device
        start = min((e["ts"] for e in timed), default=0.0)
        end = max((e["ts"] + e.get("dur", 0.0) for e in timed), default=0.0)
    busy_us = union_us([(e["ts"], e["ts"] + e.get("dur", 0.0))
                        for e in device])
    by_cat: collections.Counter = collections.Counter()
    kernels: collections.Counter = collections.Counter()
    calls: collections.Counter = collections.Counter()
    for e in device:
        by_cat[e["cat"]] += e.get("dur", 0.0)
        name = kernel_name(e["name"]) if e["cat"] == "kernel" else e["name"]
        kernels[name] += e.get("dur", 0.0)
        calls[name] += 1
    host_ops: collections.Counter = collections.Counter()
    threads: Dict[Tuple[int, int], List[dict]] = collections.defaultdict(list)
    for e in host:
        threads[(e["pid"], e["tid"])].append(e)
    for track in threads.values():
        host_ops.update(self_times(track))
    first = {}
    for e in device:
        c = e.get("args", {}).get("correlation")
        first[c] = min(first.get(c, e["ts"]), e["ts"])
    missing = [e for e in launches
               if e.get("args", {}).get("correlation") not in first]
    gaps = [first[e["args"]["correlation"]] - e["ts"] for e in launches
            if e.get("args", {}).get("correlation") in first]
    unmatched = collections.Counter(e["name"] for e in missing)
    # The host op that made each launch without a record: the innermost
    # cpu_op around it on its thread.
    by_op: collections.Counter = collections.Counter()
    for e in missing:
        around = [h for h in threads.get((e["pid"], e["tid"]), [])
                  if h["ts"] <= e["ts"] <= h["ts"] + h.get("dur", 0.0)]
        by_op[max(around, key=lambda h: h["ts"])["name"] if around
              else "(no host op)"] += 1
    span_us = (max(e["ts"] + e.get("dur", 0.0) for e in device)
               - min(e["ts"] for e in device)) if device else 0.0
    window_us = end - start
    lost = bool(missing) or (
        cuda_event_ms is not None
        and window_us / 1e3 < MIN_WINDOW_SHARE * cuda_event_ms)

    def ranked(c: collections.Counter) -> Dict[str, float]:
        items = sorted(c.items(), key=lambda kv: -kv[1])
        return {k: v / 1e3 for k, v in (items if top is None
                                          else items[:top])}

    out = {
        "trace": trace_file, "steps": steps,
        "window_ms": window_us / 1e3,
        "cuda_event_ms": cuda_event_ms,
        "device_span_ms": span_us / 1e3 if device else None,
        "launches": len(launches),
        "unmatched_launches": sum(unmatched.values()),
        "unmatched_by_name": dict(unmatched),
        "unmatched_by_op": dict(by_op),
        "unmatched_at_ms": sorted(round((e["ts"] - start) / 1e3, 3)
                                  for e in missing)[:10],
        "clock_gap_ms": min(gaps) / 1e3 if gaps else None,
        "lost_before_window": lost_before,
        "lost_events": lost,
        "device_busy_ms": None if lost or not device else busy_us / 1e3,
        "device_step_ms": (None if lost or not device or not steps
                           else busy_us / 1e3 / steps),
        "device_idle_share": (None if lost or not device or not window_us
                              else 1.0 - busy_us / window_us),
        "device_ms_by_kind": {k: v / 1e3 for k, v in by_cat.items()},
        "kernels_ms": ranked(kernels),
        "kernel_records": {k: calls[k] for k in ranked(kernels)},
        "host_ops_self_ms": ranked(host_ops),
    }
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("path", help="trace file or directory")
    ap.add_argument("--steps", type=int, default=None,
                    help="steps the trace spans (default: its window file)")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--cuda_event_ms", type=float, default=None,
                    help="the window's CUDA-event ms (default: its window "
                    "file)")
    args = ap.parse_args(argv)
    res = summarize(args.path, args.steps, args.top, args.cuda_event_ms)
    report(res)
    print(json.dumps(res), flush=True)
    return res


def report(res: dict) -> None:
    """:func:`summarize`'s result as a table on stderr."""
    err = sys.stderr
    print(f"trace: {res['trace']}", file=err)
    print(f"window {res['window_ms']:.3f} ms, steps {res['steps']}, "
          f"CUDA events {res['cuda_event_ms']} ms, device span "
          f"{res['device_span_ms']} ms, {res['launches']} launches "
          f"({res['unmatched_launches']} without a device record), clock "
          f"gap {res['clock_gap_ms']} ms, {res['lost_before_window']} "
          "launches before the window without a record", file=err)
    if res["lost_events"]:
        print("the window lost device events: no busy figure", file=err)
    elif res["device_busy_ms"] is None:
        print("no device events (a CPU run)", file=err)
    else:
        print(f"device busy {res['device_busy_ms']:.3f} ms"
              + (f" = {res['device_step_ms']:.4f} ms a step"
                 if res["device_step_ms"] is not None else "")
              + (f", idle {res['device_idle_share']:.1%}"
                 if res["device_idle_share"] is not None else ""), file=err)
    for title, table in (("kernels", res["kernels_ms"]),
                         ("host ops (self)", res["host_ops_self_ms"])):
        print(f"{title}:", file=err)
        for name, ms in table.items():
            print(f"  {ms:10.3f} ms  {name}", file=err)


if __name__ == "__main__":
    main()
