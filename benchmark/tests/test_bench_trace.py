"""Reading a profiler trace into the per-layer metrics, on a small
synthetic Chrome trace: the window, the entry spans, the device records
matched to their launches, the busy union, the idle gaps."""

from __future__ import annotations

import json

import pytest

from benchmark import harness, trace
from benchmark.tests._tiny import REPO


def _ev(cat, name, ts, dur, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "ph": "X"}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace(tmp_path, lost=False):
    # A 1000 us window: two entry calls of 50 us, each launching a 300 us
    # kernel; a 40 us copy launched outside any entry; a launch whose
    # kernel was dropped where ``lost``.
    events = [
        _ev("user_annotation", "bench.window", 1000, 1000),
        _ev("user_annotation", "bench.entry", 1010, 50),
        _ev("cuda_runtime", "cudaLaunchKernel", 1040, 5, 1),
        _ev("kernel", "k1", 1100, 300, 1),
        _ev("user_annotation", "bench.entry", 1420, 50),
        _ev("cuda_runtime", "cudaLaunchKernel", 1450, 5, 2),
        _ev("kernel", "k1", 1500, 300, 2),
        _ev("cuda_runtime", "cudaMemcpyAsync", 1850, 5, 3),
        _ev("gpu_memcpy", "Memcpy DtoD", 1860, 40, 3),
        _ev("cuda_runtime", "cudaEventSynchronize", 1900, 80),
    ]
    if lost:
        events.append(_ev("cuda_runtime", "cudaLaunchKernel", 1460, 5, 9))
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_records_and_metrics(tmp_path):
    rec = trace.read(_trace(tmp_path), "bench.window", "bench.entry")
    assert rec["window"] == (1000, 2000)
    assert len(rec["entries"]) == 2
    # Only the kernels launched inside an entry: (300 + 300) us / 2 calls.
    assert trace.entry_device_ms(rec) == pytest.approx(0.3)
    busy = trace.busy_intervals(rec["device"], 1000, 2000)
    assert busy == [(1100, 1400), (1500, 1800), (1860, 1900)]
    spec = harness.load_spec(REPO)
    r = dict(trace=rec, cfg={}, work="matrix", batch=1, side=16,
             tissue_share=1.0, entry_host_us=[10.0, 30.0], fit_ms=5.0)
    read = {m["name"]: harness.reader(m["name"], REPO)(r)
            for m in spec["per_layer"]}
    assert read["device_idle_pct"] == pytest.approx(36.0)
    assert read["kernel_ms_per_batch"] == pytest.approx(0.3)
    assert read["entry_host_us"] == pytest.approx(20.0)
    assert 0.0 < read["kernel_roofline_pct"] <= 100.0
    b = trace.breakdown(rec)
    assert b["device_ops"][0] == ["k1", pytest.approx(600e-6)]
    assert b["idle_gaps"][0] == ["bench.entry", pytest.approx(100e-6)]
    assert len(b["idle_gaps"]) == 4


def test_a_trace_that_lost_a_kernel_is_refused(tmp_path):
    with pytest.raises(trace.LostRecords):
        trace.read(_trace(tmp_path, lost=True), "bench.window",
                   "bench.entry")


def test_an_untraced_run_reads_no_layer_metric():
    spec = harness.load_spec(REPO)
    r = dict(trace=None, fit_ms=5.0)
    names = {m["name"] for m in spec["per_layer"]
             if harness.reader(m["name"], REPO)(r) is not None}
    assert names == {"fit_ms"}
