"""The cell ``flow-deploy`` at test sizes on the CPU: the port is correct,
the control (the reference with every layer through bfloat16) fails
``out_share_ne`` and at least one fit, and each planted fault fails
``out_max_u8``; the model-span readers on a small synthetic trace; the
work model's count against the port's own counter."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import calibrate, flow_weights, flow_work, harness, trace
from benchmark.tests._tiny import REPO, tiny_root

CELL = "flow-deploy"
SIDE = 32  # the published widths on 32x32 tiles: 0.3 GFLOP a tile

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tiny_root(tmp_path_factory.mktemp("tiny_flow"))
    mix = r / "benchmark/traffic/perslide-256-b64.json"
    mix.write_text(json.dumps(dict(json.loads(mix.read_text()), tile=SIDE)))
    conf = r / "benchmark/configs/resflow-capacity.json"
    c = json.loads(conf.read_text())
    c["target"]["side"] = SIDE
    conf.write_text(json.dumps(c))
    return r


def _run(root, program=None):
    r = harness.run_cell(CELL, 2 ** 31 + 23, 1.0, False, "cpu", root=root,
                         program=program)
    assert r["checks"]["checked_batches"] >= 1
    return r


def _method(root):
    return harness.method(harness.find_cell(harness.load_spec(root), CELL,
                                            root).cfg, root)


def _over(r):
    return {k for k, c in r["checks"].items() if isinstance(c, dict)
            and c["value"] > c["limit"]}


def test_the_port_is_correct(root):
    r = _run(root)
    assert r["correct"], r["checks"]
    assert {"tiles_per_s", "setup_s"} <= set(r["metrics"])


def test_the_control_fails(root):
    r = _run(root, calibrate.control(_method(root)))
    assert not r["correct"]
    over = _over(r)
    assert "out_share_ne" in over
    assert over & {"template_mu", "template_sigma", "slide_mu",
                   "slide_sigma", "mosaic_z"}


@pytest.mark.parametrize("fault", calibrate.FAULTS)
def test_each_fault_fails(root, fault):
    r = _run(root, calibrate.fault(_method(root), fault))
    assert not r["correct"]
    assert "out_max_u8" in _over(r)


def _ev(cat, name, ts, dur, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "ph": "X"}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace(tmp_path, spans=True):
    # Two transforms in a 1000 us window: each encode launches two kernels
    # (100 + 200 us, then 150 + 150 us), each transfer one (40 us, 60 us).
    events = [_ev("user_annotation", "bench.window", 1000, 1000)]
    for i, (t0, enc, tra) in enumerate([(1010, (100, 200), 40),
                                        (1500, (150, 150), 60)]):
        c = 10 * i
        events += [
            _ev("user_annotation", "bench.entry", t0, 80),
            _ev("user_annotation", "stain.flow", t0 + 1, 70),
            _ev("user_annotation", "stain.flow.encode", t0 + 2, 40),
            _ev("cuda_runtime", "cudaLaunchKernel", t0 + 5, 2, c + 1),
            _ev("kernel", "conv", t0 + 10, enc[0], c + 1),
            _ev("cuda_driver", "cuLaunchKernel", t0 + 20, 2, c + 2),
            _ev("kernel", "conv", t0 + 10 + enc[0], enc[1], c + 2),
            _ev("user_annotation", "stain.flow.transfer", t0 + 45, 20),
            _ev("cuda_runtime", "cudaLaunchKernel", t0 + 50, 2, c + 3),
            _ev("kernel", "transfer", t0 + 400, tra, c + 3),
        ]
    if not spans:
        events = [e for e in events if not e["name"].startswith("stain.")]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace.read(str(path), "bench.window", "bench.entry")


def _reads(rec):
    r = dict(trace=rec, batch=64, side=256,
             cfg=json.loads((REPO / "benchmark/configs/resflow-capacity.json")
                            .read_text()))
    return {n: harness.reader(n, REPO)(r) for n in (
        "flow_encode_ms_per_batch", "flow_transfer_ms_per_batch",
        "flow_roofline_pct")}


def test_the_model_readers_give_the_hand_computed_values(tmp_path):
    got = _reads(_trace(tmp_path))
    assert got["flow_encode_ms_per_batch"] == pytest.approx(0.3)
    assert got["flow_transfer_ms_per_batch"] == pytest.approx(0.05)
    cfg = json.loads((REPO / "benchmark/configs/resflow-capacity.json")
                     .read_text())
    bound, by = flow_work.encode_bound_ms(cfg, 64, 256)
    assert by == "operations"
    assert got["flow_roofline_pct"] == pytest.approx(100 * bound / 0.3)


def test_the_model_readers_read_nothing_without_the_spans(tmp_path):
    none = dict.fromkeys(("flow_encode_ms_per_batch",
                          "flow_transfer_ms_per_batch", "flow_roofline_pct"))
    assert _reads(_trace(tmp_path, spans=False)) == none
    assert _reads(None) == none


def test_the_work_model_is_the_ports_counter():
    from stainlib_tpu_torch.normalization.flow import conv_flops

    cfg = json.loads((REPO / "benchmark/configs/resflow-capacity.json")
                     .read_text())
    params, _ = flow_weights.draw(cfg, 1, "cpu")
    for side in (32, 256):
        assert conv_flops(params, cfg["n_scales"], side, side) == \
            flow_work.conv_flops(cfg, side)
