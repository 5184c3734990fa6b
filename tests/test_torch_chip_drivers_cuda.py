"""The port's validation and compile-check commands on the card
(``chip_smoke.py`` phases 69 and 71):
``scripts/torch_validate_gpu.py`` end to end, and
``torch_dryrun_multichip.entry()`` on the card against the CPU; and the
regression test of ``utils.profiling.trace`` late in a process (phase 63).

Needs a CUDA device (marker ``cuda``; every test skips without one). The
card has no jax, so this file imports only torch, numpy and the port. On
the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_chip_drivers_cuda.py

Tolerances: the validation script's own gates (max 4 u8, share > 1 below
1e-2; the sharded route exactly the direct one); ``entry()``'s functional
Macenko on the card against the CPU within 1 uint8 step on more than 99.9%
of the bytes; the trace: every kernel launch in it has its device kernel,
and it holds all three K1 kernels.
"""

import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str):
    path = ROOT / "scripts" / f"{name}.py"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_validate_gpu_ends_ok(card, capsys):
    assert _load("torch_validate_gpu").main(["--size", "64"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == f"device {torch.cuda.get_device_name(card)}"
    assert lines[-2] == "RESULT sharded-fused-vs-direct: max diff 0"
    assert lines[-1] == "VALIDATE-GPU-OK"


@pytest.mark.cuda
def test_entry_runs_on_the_card(card):
    dry = _load("torch_dryrun_multichip")
    fn, (params, batch) = dry.entry()
    assert batch.device.type == "cuda"
    assert params.stain_matrix_target.device.type == "cuda"
    got = fn(params, batch)
    assert got.device.type == "cuda" and got.dtype == torch.uint8
    fn_cpu, args_cpu = dry.entry(device="cpu")
    d = np.abs(got.cpu().numpy().astype(int)
               - fn_cpu(*args_cpu).numpy().astype(int))
    assert d.max() <= 1 and (d == 0).mean() > 0.999, (d.max(),
                                                     (d == 0).mean())


@pytest.mark.cuda
def test_trace_after_unprofiled_time_keeps_every_kernel(card, tmp_path):
    """A CUDA-only session, then about 30 s of unprofiled work and idle
    time on the card: a plain ``torch.profiler`` session there drops its
    first device records (PERF.md, section 6); ``trace`` takes them
    in its warm-up step, so its trace of three K1 calls is whole, and a
    trace that still lost a kernel raises and leaves no file (then the
    block is traced again, at most three times)."""
    from torch.profiler import ProfilerActivity, profile

    from stainlib_tpu_torch.kernels import macenko_fused as mf
    from stainlib_tpu_torch.normalization import extractive
    from stainlib_tpu_torch.utils import profiling
    from synth import he_batch, he_patch

    batch = torch.from_numpy(he_batch(64, 256, 256, seed=63)).to(card)
    p = extractive.fit(torch.from_numpy(he_patch(256, 256, seed=64)).to(card))

    def k1():
        return mf.macenko_normalize(batch, p.stain_matrix_target,
                                    p.max_c_target, fit_stride=2, n_bisect=10)

    with profile(activities=[ProfilerActivity.CUDA]):
        k1()
        torch.cuda.synchronize()
    big = torch.randn(4096, 4096, device=card)
    for _ in range(3):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 4:
            big @ big
        torch.cuda.synchronize()
        time.sleep(5)
    for attempt in range(3):  # trace refuses a trace that lost a kernel
        launches = mf.launches
        try:
            with profiling.trace(str(tmp_path)):
                with profiling.annotate("stain_k1_region"):
                    for _ in range(3):
                        k1()
            break
        except RuntimeError:
            assert not list(tmp_path.glob("trace_*.json"))
            if attempt == 2:
                raise
    assert mf.launches == launches + 3
    (path,) = tmp_path.glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "stain_k1_region" for e in events)
    assert profiling.lost_device_records(events) == 0
    assert sum(e.get("cat") == "kernel"
               and "macenko_apply_kernel" in e.get("name", "")
               for e in events) == 3
