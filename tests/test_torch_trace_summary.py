"""The port's ``tools/trace_summary.py`` (a reader of torch.profiler Chrome
traces), ``utils/tracing.py`` (the window that writes them) and
``tools/profile_step.py``: the interval sweep against the JAX
repository's ``tools/trace_summary.py::self_times`` on the same event lists
(``tests/test_trace_summary.py``'s), ``summarize`` on synthetic Kineto
traces with and without lost device events, and profile_step's CPU run.
"""

import gzip
import json
import os
import sys
import tempfile

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from tools.trace_summary import self_times as jax_self_times  # noqa: E402
from vqa_transfer_externaldata_torch.tools import (  # noqa: E402
    profile_step, trace_summary as ts)
from vqa_transfer_externaldata_torch.utils import tracing  # noqa: E402


def _ev(name, ts_, dur):
    return {"name": name, "ts": ts_, "dur": dur, "ph": "X"}


@pytest.mark.parametrize("track", [
    [_ev("while", 0, 100), _ev("k1", 10, 30), _ev("k2", 45, 50)],
    [_ev("a", 0, 100), _ev("b", 10, 60), _ev("c", 20, 30), _ev("d", 80, 15)],
    [_ev("loop", 0, 50), _ev("k", 5, 10), _ev("k", 20, 10),
     _ev("loop", 60, 50), _ev("k", 70, 40)],
    [_ev("x", 0, 10), _ev("y", 10, 10)],
    [_ev("late", 7.5, 1.25), _ev("early", 0.5, 2.0), _ev("outer", 0, 20),
     _ev("inner", 7.5, 1.0)],
])
def test_self_times_equal_the_jax_tools(track):
    assert ts.self_times(track) == jax_self_times(track)


def _trace(tmp_path, events, window=None, name="trace_0_2"):
    d = tmp_path / "profile"
    d.mkdir(exist_ok=True)
    path = d / (name + tracing.TRACE_SUFFIX)
    with gzip.open(path, "wt") as fh:
        json.dump({"traceEvents": events}, fh)
    if window is not None:
        with open(d / (name + ".window.json"), "w") as fh:
            json.dump(window, fh)
    return str(d)


def _step_events(launch_ids, kernel_ids, t0=0.0):
    """Two host ops (one nested), their launches, and one 300 us kernel a
    recorded correlation id on stream 7 (and a 100 us copy on stream 8)."""
    out = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 1,
         "ts": t0, "dur": 100.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "pid": 1,
         "tid": 1, "ts": t0 + 10, "dur": 20.0},
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)", "pid": 1,
         "tid": 1, "ts": t0 - 500, "dur": 99999.0},
    ]
    for i, c in enumerate(launch_ids):
        out.append({"ph": "X", "cat": "cuda_runtime",
                    "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
                    "ts": t0 + 40 + i, "dur": 5.0,
                    "args": {"correlation": c}})
    for i, c in enumerate(kernel_ids):
        out.append({"ph": "X", "cat": "kernel",
                    "name": "void gru_seq_kernel<64>(float const*, int)",
                    "pid": 0, "tid": 7, "ts": t0 + 50 + 400 * i,
                    "dur": 300.0, "args": {"correlation": c}})
    out.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
                "pid": 0, "tid": 8, "ts": t0 + 100, "dur": 100.0,
                "args": {"correlation": 99}})
    out.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaMemsetAsync",
                "pid": 1, "tid": 1, "ts": t0 + 60, "dur": 1.0,
                "args": {"correlation": 98}})
    return out


def test_summarize_reads_a_kineto_trace(tmp_path):
    """Device busy is the union of the streams' events (the copy overlaps
    the first kernel); steps and the CUDA-event time come from the window
    file; kernels by cleaned name, host ops by self time; the Trace
    session event is not part of the window; a set with no device record
    (PyTorch's sets of no bytes) is not a lost event."""
    path = _trace(tmp_path, _step_events([1, 2], [1, 2]),
                  {"steps": 2, "cuda_event_ms": 0.75})
    res = ts.summarize(path, top=None)
    assert res["steps"] == 2 and res["cuda_event_ms"] == 0.75
    assert res["lost_events"] is False and res["unmatched_launches"] == 0
    assert res["launches"] == 2
    assert res["device_busy_ms"] == pytest.approx(0.6)
    assert res["device_step_ms"] == pytest.approx(0.3)
    assert res["device_span_ms"] == pytest.approx(0.7)
    assert res["window_ms"] == pytest.approx(0.75)
    assert res["device_idle_share"] == pytest.approx(1 - 0.6 / 0.75)
    assert res["kernels_ms"] == {"gru_seq_kernel<64>": pytest.approx(0.6),
                                 "Memcpy DtoH": pytest.approx(0.1)}
    assert res["host_ops_self_ms"] == {"aten::mm": pytest.approx(0.08),
                                       "aten::empty": pytest.approx(0.02)}
    assert res["device_ms_by_kind"] == {"kernel": pytest.approx(0.6),
                                        "gpu_memcpy": pytest.approx(0.1)}
    assert res["kernel_records"] == {"gru_seq_kernel<64>": 2,
                                     "Memcpy DtoH": 1}
    assert res["unmatched_by_op"] == {} and res["unmatched_at_ms"] == []
    assert res["clock_gap_ms"] == pytest.approx(0.01)
    assert res["lost_before_window"] is None  # no annotation
    assert ts.summarize(path, steps=3, top=1)["kernels_ms"] == {
        "gru_seq_kernel<64>": pytest.approx(0.6)}


@pytest.mark.parametrize("case", ["unmatched_launch", "short_window"])
def test_summarize_says_when_a_window_lost_events(tmp_path, case):
    """A launch without its device record (listed with the host op that
    made it), or a trace window shorter than MIN_WINDOW_SHARE of the
    window's CUDA-event time: the summary says so and gives no busy, step
    or idle figure."""
    if case == "unmatched_launch":
        events, event_ms = _step_events([1, 2, 3], [1, 2]), 0.75
    else:
        events, event_ms = _step_events([1, 2], [1, 2]), 0.75 / 0.85
    res = ts.summarize(_trace(tmp_path, events), steps=2,
                       cuda_event_ms=event_ms)
    assert res["lost_events"] is True
    assert res["device_busy_ms"] is res["device_step_ms"] is None
    assert res["device_idle_share"] is None
    if case == "unmatched_launch":
        assert res["unmatched_launches"] == 1
        assert res["unmatched_by_op"] == {"aten::mm": 1}
        assert res["unmatched_at_ms"] == [pytest.approx(0.042)]
    else:
        assert res["unmatched_launches"] == 0
    ok = ts.summarize(_trace(tmp_path, _step_events([1, 2], [1, 2]),
                             name="trace_2_4"),
                      steps=2, cuda_event_ms=0.75 / 0.95)
    assert ok["lost_events"] is False


def test_summarize_keeps_to_the_window_annotation(tmp_path):
    """A TraceWindow's trace: only what its annotation holds counts, so
    launches before it (here one without a device record, counted as
    lost before the window) and work after it are not the window's."""
    events = _step_events([1, 2], [1, 2], t0=1000.0) + [
        {"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW_ANNOTATION,
         "pid": 1, "tid": 1, "ts": 1000.0, "dur": 750.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 1, "ts": 10.0, "dur": 5.0,
         "args": {"correlation": 50}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::zero_", "pid": 1,
         "tid": 1, "ts": 5.0, "dur": 20.0},
        {"ph": "X", "cat": "kernel", "name": "late", "pid": 0, "tid": 7,
         "ts": 1900.0, "dur": 50.0, "args": {"correlation": 51}},
    ]
    res = ts.summarize(_trace(tmp_path, events), steps=2, top=None,
                       cuda_event_ms=0.75)
    assert res["lost_events"] is False and res["launches"] == 2
    assert res["window_ms"] == pytest.approx(0.75)
    assert res["device_busy_ms"] == pytest.approx(0.6)
    assert "late" not in res["kernels_ms"]
    assert res["lost_before_window"] == 1  # the launch before it
    assert set(res["host_ops_self_ms"]) == {"aten::mm", "aten::empty"}


def test_window_opens_at_its_annotation(tmp_path):
    """A window whose loop first waits on the host (the streamed loop
    gathering its next batches) spans its annotation: the wait is the
    window's, so its CUDA-event time is not taken for lost records, and
    the device is idle in it."""
    events = _step_events([1, 2], [1, 2], t0=1600.0) + [
        {"ph": "X", "cat": "user_annotation",
         "name": tracing.WINDOW_ANNOTATION, "pid": 1, "tid": 1,
         "ts": 1000.0, "dur": 1400.0}]
    res = ts.summarize(_trace(tmp_path, events), steps=2, top=None,
                       cuda_event_ms=1.35)
    assert res["lost_events"] is False
    assert res["window_ms"] == pytest.approx(1.4)
    assert res["device_busy_ms"] == pytest.approx(0.6)
    assert res["device_idle_share"] == pytest.approx(1 - 0.6 / 1.4)
    # A trace that lost its window's end still shows: the window falls
    # short of the CUDA-event time.
    late = ts.summarize(_trace(tmp_path, events, name="trace_9_9"),
                        steps=2, top=None, cuda_event_ms=2.0)
    assert late["lost_events"] is True and late["device_busy_ms"] is None


@pytest.mark.parametrize("offset", [-3000.0, 0.0, 10000.0])
def test_a_windows_records_are_those_of_its_launches(tmp_path, offset):
    """The card's clock is not the host's: a window's device records are
    those of the launches and copies inside its annotation, matched by
    correlation id wherever their own time puts them (on an H100 their
    offset to the host's clock ran from -3 to +10 ms), and not those of
    work launched before it."""
    events = _step_events([1, 2], [1, 2], t0=1000.0)
    for e in events:
        if e["cat"] in ts.DEVICE_CATS and e["args"]["correlation"] != 99:
            e["ts"] += offset
    events += [
        {"ph": "X", "cat": "user_annotation",
         "name": tracing.WINDOW_ANNOTATION, "pid": 1, "tid": 1,
         "ts": 1000.0, "dur": 750.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 1, "ts": 900.0, "dur": 5.0,
         "args": {"correlation": 50}},
        {"ph": "X", "cat": "kernel", "name": "earlier", "pid": 0, "tid": 7,
         "ts": 1010.0, "dur": 30.0, "args": {"correlation": 50}},
    ]
    res = ts.summarize(_trace(tmp_path, events), steps=2, top=None,
                       cuda_event_ms=0.75)
    assert res["lost_events"] is False and res["unmatched_launches"] == 0
    assert res["kernel_records"] == {"gru_seq_kernel<64>": 2,
                                     "Memcpy DtoH": 1}
    assert res["clock_gap_ms"] == pytest.approx((10.0 + offset) / 1e3)
    assert res["lost_before_window"] == 0
    # The copy (not moved) overlaps the first kernel only where the
    # clocks agree.
    assert res["device_busy_ms"] == pytest.approx(0.7 if offset else 0.6)
    assert res["window_ms"] == pytest.approx(0.75)


@pytest.mark.parametrize("offset", [-12000.0, 0.0, 5000.0])
def test_clock_gap_is_the_least_launch_to_record_time(tmp_path, offset):
    """The clock gap: the least time from a launch to its first device
    record, in ms; negative where the card's clock stands behind the
    host's. A launch without a record and a copy enter no gap."""
    events = _step_events([1, 2, 3], [1, 2], t0=1000.0)
    for e in events:
        if e["cat"] == "kernel":
            e["ts"] += offset
    events.append({"ph": "X", "cat": "kernel", "name": "second", "pid": 0,
                   "tid": 7, "ts": events[-4]["ts"] + 5000.0, "dur": 10.0,
                   "args": {"correlation": 1}})
    res = ts.summarize(_trace(tmp_path, events), steps=2, top=None)
    assert res["unmatched_launches"] == 1
    assert res["clock_gap_ms"] == pytest.approx((10.0 + offset) / 1e3)


def test_trace_window_on_the_cpu(tmp_path):
    """A TraceWindow on the CPU: no CUDA-event time, its annotation in the
    written trace, the ops inside it summarized."""
    import torch

    window = tracing.TraceWindow(torch.device("cpu"))
    torch.ones(8).sum()
    window.open()
    x = torch.ones(64, 64)
    for _ in range(3):
        x = x @ x / 64
    assert window.close() is None
    path = tracing.write_trace(window.prof, str(tmp_path), "w", {"steps": 3})
    res = ts.summarize(path, top=None)
    assert res["steps"] == 3 and res["cuda_event_ms"] is None
    assert "aten::mm" in res["host_ops_self_ms"]
    assert "aten::sum" not in res["host_ops_self_ms"]
    assert res["device_busy_ms"] is None and res["window_ms"] > 0


def test_summarize_of_a_cpu_trace_reports_no_device_figures(tmp_path):
    events = [e for e in _step_events([], []) if e["cat"] == "cpu_op"]
    res = ts.summarize(_trace(tmp_path, events), steps=2)
    assert res["lost_events"] is False
    assert res["device_busy_ms"] is res["device_step_ms"] is None
    assert res["device_span_ms"] is None and res["kernels_ms"] == {}
    assert res["clock_gap_ms"] is None


def test_main_prints_one_json_line(tmp_path, capsys):
    path = _trace(tmp_path, _step_events([1, 2], [1, 2]),
                  {"steps": 2, "cuda_event_ms": 0.8})
    ts.main([path, "--top", "1"])
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["steps"] == 2
    assert "gru_seq_kernel<64>" in err


def test_profile_step_runs_on_the_cpu(capsys, monkeypatch, tmp_path):
    """profile_step on the CPU (the smoke test of the JAX repository's
    tools/profile_step.py): 3 * 2 resident steps of vlmap at k = 2, the
    middle two profiled through the Trainer's window; one JSON line, no
    device figures."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    out = profile_step.main([
        "--device", "cpu", "--model.model", "vlmap", "--steps", "2",
        "--top", "3", "--size", "64", "--data.vocab_size", "64",
        "--data.pool5_dim", "32", "--model.num_candidates", "8"])
    printed = [line for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert json.loads(printed[-1]) == out
    assert out["model"] == "vlmap" and out["device"] == "cpu"
    assert out["steps"] == 2 and out["steps_per_call"] == 2
    assert out["trace"].startswith(str(tmp_path))
    assert out["trace"].endswith("trace_4_6.pt.trace.json.gz")
    assert out["device_step_ms"] is None and out["kernels_ms"] == {}
    assert 0 < len(out["host_ops_self_ms"]) <= 3
