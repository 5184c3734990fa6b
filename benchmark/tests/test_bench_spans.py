"""The readers of the program's own spans (``entry_prep_us``,
``entry_launch_us``, ``idle_in_program_pct``) on a small synthetic Chrome
trace: two K3 calls with their ``prep`` and ``launch`` spans around a
launch, one idle gap of the card inside a ``stain.*`` span and one
outside; and None on a trace without such spans."""

from __future__ import annotations

import json

import pytest

from benchmark import harness, trace
from benchmark.tests._tiny import REPO

READERS = ("entry_prep_us", "entry_launch_us", "idle_in_program_pct")


def _ev(cat, name, ts, dur, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "ph": "X"}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace(tmp_path, spans=True):
    # A 1000 us window; the card busy over [1000, 1300], [1400, 1700] and
    # [1800, 2000], so idle over (1300, 1400) and (1700, 1800). The first
    # K3 call's span holds the first gap whole; the second gap falls
    # between calls. A prep span before the window counts for nothing. The
    # port makes its kernel spans as fast record functions: cpu_op events.
    events = [
        _ev("user_annotation", "bench.window", 1000, 1000),
        _ev("cuda_runtime", "cudaLaunchKernel", 990, 5, 1),
        _ev("kernel", "matrix_apply_kernel", 1000, 300, 1),
        _ev("user_annotation", "bench.entry", 1285, 130),
        _ev("cpu_op", "stain.K3", 1290, 120),
        _ev("cpu_op", "stain.K3.prep", 1291, 60),
        _ev("cpu_op", "aten::empty_like", 1300, 10),
        _ev("cpu_op", "stain.K3.launch", 1360, 45),
        _ev("cuda_runtime", "cudaLaunchKernel", 1370, 5, 2),
        _ev("kernel", "matrix_apply_kernel", 1400, 300, 2),
        _ev("user_annotation", "bench.entry", 1495, 70),
        _ev("cpu_op", "stain.K3", 1500, 60),
        _ev("cpu_op", "stain.K3.prep", 1502, 40),
        _ev("cpu_op", "stain.K3.launch", 1545, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 1548, 5, 3),
        _ev("kernel", "matrix_apply_kernel", 1800, 200, 3),
        _ev("cuda_runtime", "cudaEventSynchronize", 1600, 150),
    ]
    if spans:
        events.append(_ev("cpu_op", "stain.K3.prep", 900, 50))
    else:
        events = [e for e in events if not e["name"].startswith("stain.")]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def _read(rec):
    return {n: harness.reader(n, REPO)(dict(trace=rec)) for n in READERS}


def test_readers_give_the_hand_computed_values(tmp_path):
    got = _read(trace.read(_trace(tmp_path), "bench.window", "bench.entry"))
    assert got["entry_prep_us"] == pytest.approx((60 + 40) / 2)
    assert got["entry_launch_us"] == pytest.approx((45 + 10) / 2)
    # 100 us of the 200 us of idle card lie inside the first K3 span.
    assert got["idle_in_program_pct"] == pytest.approx(50.0)


def test_readers_read_nothing_without_program_spans(tmp_path):
    rec = trace.read(_trace(tmp_path, spans=False), "bench.window",
                     "bench.entry")
    assert _read(rec) == dict.fromkeys(READERS)
    assert _read(None) == dict.fromkeys(READERS)


def test_a_busy_window_reads_no_idle_in_the_program(tmp_path):
    events = [_ev("user_annotation", "bench.window", 0, 100),
              _ev("cpu_op", "stain.K1", 10, 20),
              _ev("kernel", "k", 0, 100, 1)]
    path = tmp_path / "busy.json"
    path.write_text(json.dumps({"traceEvents": events}))
    rec = trace.read(str(path), "bench.window", "bench.entry")
    assert _read(rec)["idle_in_program_pct"] == 0.0


def test_the_readers_are_in_every_cell():
    spec = harness.load_spec(REPO)
    cells = [w["name"] for w in spec["workloads"]]
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in READERS:
        assert entries[name]["workloads"] == cells
        assert entries[name]["source"] == "device_trace"
