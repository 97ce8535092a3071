"""A ``torch.profiler`` window around some work and the Chrome trace it
writes: the Trainer's profiler window (``train.profile_steps``) records
through :class:`TraceWindow` and :func:`write_trace`, and
``tools/trace_summary.py`` reads what they write."""

from __future__ import annotations

import gzip
import json
import os
import shutil
import time
from typing import Optional

import torch

TRACE_SUFFIX = ".pt.trace.json.gz"
# The annotation around a window's work (:class:`TraceWindow`): the reader
# summarizes the host's work inside it and the device records of that work.
WINDOW_ANNOTATION = "profiler_window"
# A profiler session on CUDA loses device records at its start in two
# ways (an H100 with torch 2.11, chip_smoke's windows): the records of its
# first K launches, K growing with the process (0 in a fresh one, 6 to 22
# late in a run; 16 settling launches once let K4f's window lose its
# first call), and those that the trace's card clock, which can stand
# milliseconds behind the host's, puts before the session started (one
# window, its clock gap -6 ms, lost its first 353 launches). So a window
# first launches SETTLE_LAUNCHES small kernels outside its annotation,
# waits for them and lets SETTLE_S pass; it lets SETTLE_S pass again
# after the annotation, before the profiler stops, for a card clock that
# stands ahead. ``tools/trace_summary`` reports the settling launches that
# lost their records (``lost_before_window``) and the clock gap.
SETTLE_LAUNCHES, SETTLE_S = 512, 0.25


class TraceWindow:
    """``torch.profiler`` around one window of work on ``device``: host
    ops and, on CUDA, the card's kernels and copies. :meth:`open` drains
    the device, starts the profiler, lets it settle (``SETTLE_LAUNCHES``
    small kernels, a wait), then opens the ``WINDOW_ANNOTATION`` span and
    records a CUDA event; :meth:`close` records the closing event, waits
    for the device, closes the span, waits ``SETTLE_S`` on CUDA and stops
    the profiler, and returns the window's CUDA-event ms (None on the
    CPU). ``prof`` is then ready for :func:`write_trace`."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.prof = None
        self._span = None
        self._events = None

    def open(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        cuda = self.device.type == "cuda"
        activities = [ProfilerActivity.CPU]
        if cuda:
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = profile(activities=activities)
        self.prof.start()
        if cuda:
            settle = torch.empty(1, device=self.device)
            for _ in range(SETTLE_LAUNCHES):
                settle.zero_()
            torch.cuda.synchronize(self.device)
            time.sleep(SETTLE_S)
        self._span = record_function(WINDOW_ANNOTATION)
        self._span.__enter__()
        if cuda:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()

    def close(self) -> Optional[float]:
        event_ms = None
        if self._events is not None:
            self._events[1].record()
            self._events[1].synchronize()
            event_ms = self._events[0].elapsed_time(self._events[1])
        self._span.__exit__(None, None, None)
        if self._events is not None:
            time.sleep(SETTLE_S)
        self.prof.stop()
        self._span = self._events = None
        return event_ms


def write_trace(prof, directory: str, name: str,
                window: Optional[dict] = None) -> str:
    """Export ``prof`` (a stopped ``torch.profiler.profile``) as
    ``<directory>/<name>.pt.trace.json.gz`` and, with ``window``, write it
    as ``<name>.window.json`` beside it; returns the trace's path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, name + TRACE_SUFFIX)
    raw = os.path.join(directory, name + ".pt.trace.json")
    prof.export_chrome_trace(raw)
    with open(raw, "rb") as src, gzip.open(path, "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(raw)
    if window is not None:
        with open(os.path.join(directory, name + ".window.json"), "w") as fh:
            json.dump(window, fh)
    return path
