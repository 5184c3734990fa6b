"""The kernel entries' spans on the card, K1-K10.

* One call of each entry inside ``utils.profiling.trace`` gives the span
  ``stain.K<n>`` with ``stain.K<n>.prep`` and then ``stain.K<n>.launch``
  nested in it (fast record functions: ``cpu_op`` events), the runtime
  launch of the entry's own kernel inside
  ``launch``, matched to the entry's kernel in the device records by its
  correlation id, and no launch that lost its kernel. The traced call's
  output equals an untraced call's.
* With no profiler recording, 1,000 calls of each entry run with every
  way to a span (``record_function``, the fast record function) made to
  raise.

Needs a CUDA device (marker ``cuda``; every test skips without one). The
card has no jax, so this file imports only torch, numpy and the port. On
the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_tracing_cuda.py
"""

import glob
import json

import pytest
import torch

from stainlib_tpu_torch.kernels import fused_stain as fs
from stainlib_tpu_torch.kernels import macenko_fused as mf
from stainlib_tpu_torch.kernels import reinhard_fused as rf
from stainlib_tpu_torch.kernels import vahadane_fused as vf
from stainlib_tpu_torch.normalization import extractive, reinhard
from stainlib_tpu_torch.utils import profiling
from synth import he_batch, he_patch

# Each entry: its kernel's name in the device records, and its call on a
# batch of 4 tiles of 256^2 (``x``: the tiles and the fitted values).
ENTRIES = {
    "K1": ("macenko_apply_kernel", lambda x: mf.macenko_normalize(
        x.rgb, x.M, x.mc, fit_stride=2, n_bisect=10)),
    "K2": ("vahadane_normalize_kernel", lambda x: vf.vahadane_normalize(
        x.rgb, x.M, x.mc, fit_stride=2, num_iters=8, n_bisect=10)),
    "K3": ("matrix_apply_kernel", lambda x: mf.normalize_with_matrix(
        x.rgb, x.M, x.mc, x.M, x.mc)),
    "K4": ("macenko_fit_kernel", lambda x: mf.macenko_fit_planar(x.planar)),
    "K5": ("reinhard_kernel", lambda x: rf.reinhard_normalize(
        x.rgb, x.means, x.stds)),
    "K6": ("macenko_augment_kernel", lambda x: mf.macenko_augment(
        x.rgb, x.alpha, x.beta)),
    "K7": ("augment_apply_kernel", lambda x: mf.augment_with_matrix(
        x.rgb, x.M, x.alpha, x.beta)),
    "K8": ("vahadane_dict_kernel", lambda x: vf.vahadane_stain_matrix_planar(
        x.planar)),
    "K9": ("fused_normalize_kernel", lambda x: fs.fused_normalize(
        x.rgb, x.M_tiles, x.M, x.mc)),
    "K10": ("eigenplane_kernel", lambda x: mf.eigenplane(x.planar)),
}


class _Inputs:
    def __init__(self, device):
        B = 4
        self.rgb = torch.from_numpy(he_batch(B, 256, 256, seed=120)).to(
            device)
        self.planar = mf.to_planar(self.rgb).contiguous()
        target = torch.from_numpy(he_patch(256, 256, seed=121))
        p = extractive.fit(target)
        self.M = p.stain_matrix_target.to(device, torch.float32).contiguous()
        self.mc = p.max_c_target.to(device, torch.float32).contiguous()
        self.M_tiles = self.M.expand(B, 2, 3).contiguous()
        r = reinhard.fit(target)
        self.means, self.stds = r.means.to(device), r.stds.to(device)
        self.alpha = torch.full((B, 2), 1.1, device=device)
        self.beta = torch.full((B, 2), 0.05, device=device)


@pytest.fixture(scope="module")
def inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return _Inputs(torch.device("cuda"))


def _refuse(*args, **kw):
    raise AssertionError("a span was made with no profiler recording")


def _leaves(out):
    return list(out) if isinstance(out, tuple) else [out]


def _inside(child, parent):
    return (parent["ts"] <= child["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"])


@pytest.mark.cuda
@pytest.mark.parametrize("k", list(ENTRIES))
def test_traced_entry_gives_its_span_tree(inputs, k, tmp_path):
    kernel, call = ENTRIES[k]
    want = call(inputs)  # builds and loads the library, warms the entry
    torch.cuda.synchronize()
    with profiling.trace(str(tmp_path)):
        got = call(inputs)
    assert all(torch.equal(a, b)
               for a, b in zip(_leaves(got), _leaves(want)))
    (path,) = glob.glob(str(tmp_path / "trace_*.json"))
    events = json.load(open(path))["traceEvents"]
    assert profiling.lost_device_records(events) == 0

    def one(name):
        found = [e for e in events if e.get("cat") == "cpu_op"
                 and e.get("name") == name]
        assert len(found) == 1, (name, len(found))
        return found[0]

    top, prep, launch = (one(f"stain.{k}"), one(f"stain.{k}.prep"),
                         one(f"stain.{k}.launch"))
    assert _inside(prep, top) and _inside(launch, top)
    assert prep["ts"] + prep["dur"] <= launch["ts"]
    ran = [e for e in events if e.get("cat") == "kernel"
           and kernel in e.get("name", "")]
    assert len(ran) == 1, [e.get("name") for e in events
                           if e.get("cat") == "kernel"]
    corr = ran[0]["args"]["correlation"]
    (runtime,) = [e for e in events if e.get("cat") == "cuda_runtime"
                  and e.get("args", {}).get("correlation") == corr]
    assert runtime["name"].startswith("cudaLaunch")
    assert _inside(runtime, launch)


@pytest.mark.cuda
@pytest.mark.parametrize("k", list(ENTRIES))
def test_entry_off_path_makes_no_span(inputs, k, monkeypatch):
    _, call = ENTRIES[k]
    want = call(inputs)
    monkeypatch.setattr(profiling, "record_function", _refuse)
    monkeypatch.setattr(profiling, "_RecordFunctionFast", _refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _refuse)
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        _refuse)
    assert not profiling.recording()
    for _ in range(1000):
        got = call(inputs)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b)
               for a, b in zip(_leaves(got), _leaves(want)))
