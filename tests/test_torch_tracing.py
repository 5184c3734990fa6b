"""The port's spans on the CPU: the gate (``utils.profiling.recording``),
``annotate``, the fit's spans and the kernel entries' spans.

* The gate is False outside a profiler session and in a scheduled
  session's warm-up step, True in its active step.
* With the gate off, ``annotate``, ``extractive.fit`` and a kernel entry
  make no span: ``record_function`` and torch's fast record function are
  made to raise here.
* Under a CPU ``torch.profiler.profile`` the Chrome trace holds
  ``stain.fit`` with ``stain.fit.matrix``, ``stain.fit.concentrations``
  and ``stain.fit.max_c`` nested in it, as ``user_annotation`` events.
* A kernel entry's wrapper, K3's, run on CPU tensors against a stand-in
  library (the kernels themselves need the card), gives ``stain.K3`` with
  ``prep`` then ``launch`` nested in it (``cpu_op`` events: fast record
  functions), the library's call inside ``launch``.
"""

import json
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from stainlib_tpu_torch.kernels import _build
from stainlib_tpu_torch.kernels import macenko_fused as mf
from stainlib_tpu_torch.normalization import extractive
from stainlib_tpu_torch.utils import profiling
from synth import he_patch

FIT_CHILDREN = ("stain.fit.matrix", "stain.fit.concentrations",
                "stain.fit.max_c")


def _refuse(*args, **kw):
    raise AssertionError("a span was made with no profiler recording")


@pytest.fixture
def no_spans(monkeypatch):
    """Every way to a span raises."""
    monkeypatch.setattr(profiling, "record_function", _refuse)
    monkeypatch.setattr(profiling, "_RecordFunctionFast", _refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _refuse)
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        _refuse)


def _events(prof, tmp_path, cat=None):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if cat is None or e.get("cat") == cat]


def _annotations(prof, tmp_path):
    return _events(prof, tmp_path, "user_annotation")


def _one(events, name):
    found = [e for e in events if e["name"] == name]
    assert len(found) == 1, (name, [e["name"] for e in events])
    return found[0]


def _inside(child, parent):
    return (parent["ts"] <= child["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"])


def test_gate_follows_the_recording_session():
    assert profiling.recording() is False
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        assert profiling.recording() is False  # the warm-up step
        prof.step()
        assert profiling.recording() is True
    assert profiling.recording() is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.recording() is True
    assert profiling.recording() is False


def test_annotate_in_a_warm_up_step_leaves_no_span(tmp_path):
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        with profiling.annotate("stain.warm"):
            torch.ones(4).sum()
        prof.step()
        with profiling.annotate("stain.active"):
            torch.ones(4).sum()
    names = {e["name"] for e in _annotations(prof, tmp_path)}
    assert "stain.active" in names and "stain.warm" not in names


def test_annotate_and_fit_make_no_span_when_off(no_spans):
    with profiling.annotate("stain.probe"):
        torch.ones(2).sum()
    p = extractive.fit(torch.from_numpy(he_patch(64, 64, seed=5)))
    assert p.stain_matrix_target.shape == (2, 3)


def test_fit_spans_nest_in_the_chrome_trace(tmp_path):
    target = torch.from_numpy(he_patch(64, 64, seed=6))
    want = extractive.fit(target)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = extractive.fit(target)
    assert torch.equal(got.stain_matrix_target, want.stain_matrix_target)
    assert torch.equal(got.max_c_target, want.max_c_target)
    spans = _annotations(prof, tmp_path)
    fit = _one(spans, "stain.fit")
    children = [_one(spans, n) for n in FIT_CHILDREN]
    assert all(_inside(c, fit) for c in children)
    for a, b in zip(children, children[1:]):  # in order, disjoint
        assert a["ts"] + a["dur"] <= b["ts"]


class _Library:
    """Stands in for the kernel library: K3's entry point records its call
    and makes one torch operation, so the trace shows where it ran."""

    def __init__(self):
        self.calls = 0

    def matrix_normalize_launch(self, *args):
        self.calls += 1
        torch.zeros(1).add_(1)
        return 0


@pytest.fixture
def library(monkeypatch):
    """K3's wrapper on CPU tensors against :class:`_Library`."""
    lib = _Library()
    monkeypatch.setattr(_build, "_lib", lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=None))
    x = torch.from_numpy(he_patch(32, 32, seed=7))[None]
    M = torch.tensor([[0.65, 0.70, 0.29], [0.07, 0.99, 0.11]])
    mc = torch.tensor([1.9, 1.0])

    def call():
        return mf._matrix_launch(x, False, M, mc, M, mc, 0.01)
    return lib, call


def test_kernel_entry_off_path_makes_no_span(library, no_spans):
    lib, call = library
    before = mf.matrix_launches
    for _ in range(1000):
        call()
    assert lib.calls == 1000 and mf.matrix_launches == before + 1000
    assert profiling.launch_span() is None


def test_kernel_entry_spans_nest(library, tmp_path):
    lib, call = library
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    assert lib.calls == 1 and profiling.launch_span() is None
    events = _events(prof, tmp_path, "cpu_op")
    k3, prep, launch = (_one(events, n) for n in
                        ("stain.K3", "stain.K3.prep", "stain.K3.launch"))
    assert _inside(prep, k3) and _inside(launch, k3)
    assert prep["ts"] + prep["dur"] <= launch["ts"]
    # The library's own operation ran inside the launch span; the wrapper's
    # output buffer was made inside prep.
    adds = [e for e in events if e.get("name") == "aten::add_"]
    assert len(adds) == 1 and _inside(adds[0], launch)
    empties = [e for e in events if e.get("name") == "aten::empty_like"]
    assert empties and all(_inside(e, prep) for e in empties)


def test_kernel_entry_that_fails_before_its_launch_closes_its_spans(
        library, tmp_path):
    _, call = library

    @profiling.kernel_entry("K0")
    def failing():
        raise ValueError("refused in prep")

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError):
            failing()
        assert profiling.launch_span() is None
        call()  # the next entry traces as usual
    spans = {e["name"] for e in _events(prof, tmp_path, "cpu_op")}
    assert {"stain.K0", "stain.K0.prep", "stain.K3", "stain.K3.prep",
            "stain.K3.launch"} <= spans
    assert "stain.K0.launch" not in spans
