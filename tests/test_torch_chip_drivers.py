"""The port's chip commands on the CPU: ``scripts/torch_validate_gpu.py``,
``scripts/torch_probe_kernels.py`` and ``torch_dryrun_multichip.entry``,
the twins of ``scripts/validate_tpu.py``, ``scripts/probe_kernels.py`` and
``__graft_entry__.entry`` (and the card-only
``scripts/torch_trace_loss_repro.py``, which must refuse to run here).

Every test runs with ``--device cpu`` / ``device="cpu"``, where the
kernels' entries take their plain versions, at a small size. Tolerances:

* the validation script's own gates (``validate_tpu.py:81``): max 4 u8,
  share > 1 below 1e-2; the sharded route exactly equal to the direct one;
* the functional outputs against JAX's ``extractive.transform`` on the same
  bytes, and ``entry()`` against ``__graft_entry__.entry()``: at most 1
  uint8 step apart, at least 99.9% identical (``test_torch_macenko.py``'s
  and ``test_torch_vahadane.py``'s parity budget);
* the kernels' plain versions against JAX's functional path, and the
  probe's fs=1 nb=14 Macenko entry against the port's: the TPU kernels'
  budget (``test_torch_macenko_kernel.py``, ``test_torch_vahadane_kernel.py``):
  <=1 u8 on >99.5% (Vahadane >99%) and max <=3 (Vahadane <=4).
"""

import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stainlib_tpu.normalization import extractive as jax_ex  # noqa: E402
from stainlib_tpu_torch.normalization import extractive, reinhard  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]

# The JAX grid's names (scripts/probe_kernels.py) with n_cands and T taken
# out; entries that differed only in them appear once.
PROBE_NAMES = {
    "macenko": [
        "macenko 256 nb=14", "macenko 256 nb=12", "macenko 256 nb=10",
        "macenko 256 fs=2 nb=14", "macenko 256 fs=2 nb=10",
        "macenko 256 fs=4 nb=14"],
    "macenko512": ["macenko 512"],
    "vahadane": [
        "vahadane 256 two-kernel (r3)", "vahadane 256 single-kernel it=12",
        "vahadane 256 single-kernel it=10", "vahadane 256 single-kernel it=8",
        "vahadane 256 single-kernel fs=2 it=12",
        "vahadane 256 single-kernel fs=2 it=8",
        "vahadane 256 single-kernel fs=4 it=12"],
    "vahadane-roofline": [
        "vahadane fs=2 it=2", "vahadane fs=2 it=4", "vahadane fs=2 it=8",
        "vahadane fs=2 it=12", "vahadane fs=2 it=8 nb=10",
        "vahadane fs=2 it=8 nb=14", "vahadane fs=2 it=6 nb=10",
        "vahadane fs=4 it=8 (estimation floor probe)",
        "macenko fs=2 nb=10 (same-structure, no BCD)",
        "fixed-matrix apply (reconstruction floor)"],
}
# Kernel (plain version) against the functional path: (share <=1, max).
KERNEL_BUDGET = {"macenko": (0.995, 3), "vahadane": (0.99, 4)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the plain versions' many small ops
    oversubscribe an xdist worker otherwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(path: Path):
    """A script as a module under its file name (the probe imports the
    validation script by that name)."""
    if path.stem in sys.modules:
        return sys.modules[path.stem]
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[path.stem] = module
    spec.loader.exec_module(module)
    return module


def _validate():
    return _load(ROOT / "scripts" / "torch_validate_gpu.py")


def _diff(got, want):
    return np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))


def _parity(got, want):
    d = _diff(got, want)
    assert d.max() <= 1 and (d == 0).mean() >= 0.999, (d.max(),
                                                      (d == 0).mean())


@pytest.mark.parametrize("n,h,w,seed", [(1, 64, 128, 1), (4, 64, 128, 2),
                                        (2, 256, 256, 3), (3, 40, 72, 9)])
def test_he_batch_is_validate_tpus(n, h, w, seed):
    want = _load(ROOT / "scripts" / "validate_tpu.py").he_batch(n, h, w, seed)
    got = _validate().he_batch(n, h, w, seed)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == (n, h, w, 3) and np.array_equal(got, want)


def test_validate_passes_every_gate(capsys):
    assert _validate().main(["--size", "64", "--batch", "2", "--iters", "2",
                             *CPU]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    results = [ln for ln in lines if ln.startswith("RESULT ")]
    assert [ln.split(":")[0] for ln in results] == [
        "RESULT macenko", "RESULT vahadane", "RESULT reinhard",
        "RESULT macenko-fast (fs=2 nb=10)",
        "RESULT vahadane-fast (fs=2 it=8 nb=10)",
        "RESULT sharded-fused-vs-direct"]
    for ln in results[:-1]:
        mx = int(ln.split("max diff ")[1].split(",")[0])
        frac = float(ln.split("frac>1 ")[1])
        assert mx <= 4 and frac < 1e-2, ln
    assert results[-1].endswith("max diff 0")
    step_ms = [float(ln.split(" tiles/s (")[1].split(" ms")[0]) for ln in lines
               if ln.startswith("THROUGHPUT ")]
    assert len(step_ms) == 6
    assert all(math.isfinite(t) and t > 0 for t in step_ms), step_ms
    assert lines[-1] == "VALIDATE-GPU-OK"


@pytest.mark.parametrize("method", ["macenko", "vahadane"])
def test_validation_outputs_match_jax(method):
    """The validation batch's functional outputs (the RESULT references)
    and the kernel entries' outputs against JAX's functional path."""
    vg = _validate()
    target, batch = vg.he_batch(1, 64, 128, seed=1)[0], vg.he_batch(
        4, 64, 128, seed=2)
    t_target, t_batch = torch.from_numpy(target), torch.from_numpy(batch)
    pairs = {label: (got, want) for label, got, want in vg.result_pairs(
        t_batch, extractive.fit(t_target, method="macenko"),
        extractive.fit(t_target, method="vahadane"), reinhard.fit(t_target))}
    jp = jax_ex.fit(jnp.asarray(target), method=method)
    jax_out = np.asarray(jax_ex.transform(jp, jnp.asarray(batch),
                                          method=method))
    got, want = pairs[method]
    _parity(want.numpy(), jax_out)
    share, top = KERNEL_BUDGET[method]
    d = _diff(got.numpy(), jax_out)
    assert (d <= 1).mean() > share and d.max() <= top, (d.max(),
                                                        (d <= 1).mean())


@pytest.mark.parametrize("family", list(PROBE_NAMES))
def test_probe_grid_names(family):
    probe = _load(ROOT / "scripts" / "torch_probe_kernels.py")
    assert [e[0] for e in probe.grid(family)] == PROBE_NAMES[family]
    default = [e[0] for e in probe.grid(None)]
    want = (PROBE_NAMES["macenko"] + PROBE_NAMES["macenko512"]
            + PROBE_NAMES["vahadane"])
    assert default == want  # the roofline family is --only


def test_probe_macenko_family(tmp_path, capsys):
    probe = _load(ROOT / "scripts" / "torch_probe_kernels.py")
    out = tmp_path / "probe.json"
    probe.run(probe.parse_args(["--only", "macenko", "--batch", "2",
                                "--iters", "1", "--out", str(out), *CPU]))
    res = json.loads(out.read_text())
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == res
    assert res["device"] == "cpu" and res["clock"] == "host clock"
    assert list(res["entries"]) == PROBE_NAMES["macenko"]
    for name, e in res["entries"].items():
        assert math.isfinite(e["tiles_per_s"]) and e["tiles_per_s"] > 0, name
        assert e["tiles_256"] == 2 and e["max_diff"] >= 0, name
        assert 0.0 <= e["frac_gt1"] <= 1.0, name
    e = res["entries"]["macenko 256 nb=14"]  # fs=1, nb=14: the functional
    assert e["max_diff"] <= 3 and e["frac_gt1"] < 0.005, e  # path's knobs


def test_entry_matches_graft_entry():
    import __graft_entry__ as graft

    fn, args = graft.entry()
    want = np.asarray(fn(*args))
    dry = _load(ROOT / "scripts" / "torch_dryrun_multichip.py")
    tfn, (params, batch) = dry.entry(device="cpu")
    assert batch.device.type == params.max_c_target.device.type == "cpu"
    got = tfn(params, batch)
    assert got.dtype == torch.uint8
    assert got.shape == want.shape == (4, 64, 64, 3)
    assert np.array_equal(batch.numpy(), np.asarray(args[1]))
    _parity(got.numpy(), want)


@pytest.mark.parametrize("command", ["validate", "probe", "entry", "repro"])
def test_commands_raise_without_cuda(command):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if command == "validate":
            _validate().main([])
        elif command == "probe":
            probe = _load(ROOT / "scripts" / "torch_probe_kernels.py")
            probe.run(probe.parse_args([]))
        elif command == "entry":
            _load(ROOT / "scripts" / "torch_dryrun_multichip.py").entry()
        else:
            _load(ROOT / "scripts" / "torch_trace_loss_repro.py").main([])


def test_commands_import_and_run_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.path.insert(0, 'scripts')\n"
        "import torch_validate_gpu, torch_probe_kernels\n"
        "import torch_dryrun_multichip, torch_trace_loss_repro\n"
        "torch_validate_gpu.main(['--batch', '1', '--iters', '1', "
        "'--device', 'cpu'])\n"
        "fn, args = torch_dryrun_multichip.entry('cpu'); fn(*args)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] == 'stainlib_tpu']\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "VALIDATE-GPU-OK"
