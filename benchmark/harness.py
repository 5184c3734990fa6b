"""One run of one cell: set-up, the closed loop, the traced sub-window, the
check against the plain reference, and the result line's contents.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``; its configuration in the file that entry names; its
traffic mix in ``traffic/<traffic>.json``; its method (the program's entry
and the reference) in ``methods/<method>.py``, the method named by the
configuration; the limits of its comparison in ``limits/<cell>.json``; and
each metric's reader in ``metrics/<metric>.py``. Adding a cell, a mix, a
configuration or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import random
import subprocess
import sys
import tempfile
import time
from collections import deque
from pathlib import Path
from typing import NamedTuple

import torch

from benchmark import tiles
from benchmark import trace as tr

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "stainlib_tpu")
TRACE_S = 2.0  # seconds of the traced sub-window
TRACE_TRIES = 3  # a trace that lost a launch's kernel is taken again
REF_BLOCK = 64  # tiles per call of the reference


class Cell(NamedTuple):
    name: str
    chips: int
    cfg: dict
    traffic: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json entries of this cell's metrics
    per_layer: list


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str):
    """The Python file ``path`` as a module (names may hold '-' or '.')."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no such file: {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(spec: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of the benchmark ``spec``, its files read."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    bench = root / "benchmark"

    def mine(m):
        return name in m.get("workloads", [name])

    return Cell(name=name, chips=w["chips"], cfg=_json(root / conf["file"]),
                traffic=_json(bench / "traffic" / f"{w['traffic']}.json"),
                limits=_json(bench / "limits" / f"{name}.json"),
                end_to_end=[m for m in spec["end_to_end"] if mine(m)],
                per_layer=[m for m in spec["per_layer"] if mine(m)])


def method(cfg: dict, root: Path = ROOT):
    return _module(root / "benchmark" / "methods" / f"{cfg['method']}.py",
                   f"benchmark_method_{cfg['method']}")


def reader(metric: str, root: Path = ROOT):
    """The ``read(rec)`` of ``metrics/<metric>.py``."""
    return _module(root / "benchmark" / "metrics" / f"{metric}.py",
                   f"benchmark_metric_{metric}").read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


# ---------------------------------------------------------------------------
# The clock of completions: CUDA events on the card, the host clock on the
# CPU (the tests' path: a CPU call returns when its work is done).
# ---------------------------------------------------------------------------

class _HostMark:
    def __init__(self):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_ms(self, later) -> float:
        return (later.t - self.t) * 1e3


class _EventMark:
    def __init__(self):
        self.ev = torch.cuda.Event(enable_timing=True)

    def record(self):
        self.ev.record()

    def synchronize(self):
        self.ev.synchronize()

    def elapsed_ms(self, later) -> float:
        return self.ev.elapsed_time(later.ev)


class Segment(NamedTuple):
    attempted: int  # entry calls made before the segment's end
    latencies_ms: list  # of each batch completed before the end
    host_us: list  # host time of each entry call
    seconds: float


def drive(call, batches, depth: int, device, n: int | None = None,
          seconds: float | None = None, keep=None,
          span: str | None = None) -> Segment:
    """A closed loop over the pool ``batches`` with ``depth`` batches in
    flight, from an idle card to a drained one: ``n`` batches, or as many
    as the card finishes in ``seconds`` (the batches in flight at the end
    finish, and count for nothing).

    A batch's latency is the card's time from the completion of the batch
    whose slot it took (the call follows that completion at once; for the
    first ``depth``, from the loop's start on an idle card) to its own
    completion, read from CUDA events, so the wait behind the batches in
    flight counts and a host stall shows. ``keep(k, out)`` sees each
    counted batch's output; ``span`` names a profiler annotation around
    each entry call."""
    mark = _EventMark if torch.device(device).type == "cuda" else _HostMark
    ring = [mark() for _ in range(2 * depth + 2)]
    start = mark()
    start.record()
    inflight: deque = deque()
    lat, host_us = [], []
    j = 0
    t0 = time.perf_counter()
    t_end = None if seconds is None else t0 + seconds
    stopping = False
    annotate = (torch.profiler.record_function if span
                else (lambda _name: contextlib.nullcontext()))
    while True:
        if not stopping and ((n is not None and j >= n) or (
                t_end is not None and time.perf_counter() >= t_end)):
            stopping = True
        if inflight and (stopping or len(inflight) == depth):
            k, out = inflight.popleft()
            ev = ring[k % len(ring)]
            ev.synchronize()
            if t_end is None or time.perf_counter() <= t_end:
                prev = start if k < depth else ring[(k - depth) % len(ring)]
                lat.append(prev.elapsed_ms(ev))
                if keep is not None:
                    keep(k % len(batches), out)
            continue
        if stopping:
            break
        h0 = time.perf_counter()
        with annotate(span):
            out = call(batches[j % len(batches)])
        host_us.append((time.perf_counter() - h0) * 1e6)
        ring[j % len(ring)].record()
        inflight.append((j, out))
        j += 1
    return Segment(j, lat, host_us,
                   seconds if seconds is not None else time.perf_counter()
                   - t0)


class Reservoir:
    """A seeded uniform sample of ``size`` of the window's outputs (kept by
    reference: the card copies nothing)."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng = size, random.Random(seed ^ 0xC4EC)
        self.items: list = []
        self.seen = 0

    def __call__(self, pool_index: int, out) -> None:
        if self.seen < self.size:
            self.items.append((pool_index, out))
        else:
            r = self.rng.randrange(self.seen + 1)
            if r < self.size:
                self.items[r] = (pool_index, out)
        self.seen += 1


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# The check.
# ---------------------------------------------------------------------------

def compare(fits: dict, ref_fits: dict, kept: list, ref_call, batches):
    """The numbers compared: each reference fit's largest gap relative to
    its largest value; over every byte of the sampled batches, the largest
    gap in uint8 and the share of bytes that differ at all."""
    nums = {}
    for key, r in ref_fits.items():
        p = fits[key].to(r.device, torch.float32)
        r = r.to(torch.float32)
        nums[key] = float((p - r).abs().max()
                          / torch.clamp_min(r.abs().max(), 1e-30))
    worst, differ, total = 0, 0, 0
    for idx, out in kept:
        x = batches[idx]
        want = torch.cat([ref_call(x[i:i + REF_BLOCK])
                          for i in range(0, x.shape[0], REF_BLOCK)])
        d = (out.to(torch.int16) - want.to(torch.int16)).abs()
        worst = max(worst, int(d.max()))
        differ += int((d > 0).sum())
        total += d.numel()
    nums["out_max_u8"] = float(worst)
    nums["out_share_ne"] = differ / total if total else float("nan")
    return nums


def judge(nums: dict, limits: dict) -> tuple:
    """(correct, {name: {value, limit}}): every number at or under its
    limit; a number without a limit, or NaN, fails."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in nums.items()}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


# ---------------------------------------------------------------------------
# A run.
# ---------------------------------------------------------------------------

def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"


def _traced(call, batches, depth, device, seconds, keep):
    """The traced sub-window: (segment, trace records), taken again where
    the profiler lost a launch's kernel."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        for attempt in range(TRACE_TRIES):
            with tr.profiled(path):
                with torch.profiler.record_function("bench.window"):
                    seg = drive(call, batches, depth, device,
                                seconds=seconds, keep=keep,
                                span="bench.entry")
            try:
                return seg, tr.read(path, "bench.window", "bench.entry")
            except tr.LostRecords as e:
                print(f"trace attempt {attempt + 1}: {e}", file=sys.stderr)
        raise tr.LostRecords(f"no whole trace in {TRACE_TRIES} tries")
    finally:
        tr.remove(path)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float | None = None, root: Path = ROOT,
             program=None, marks: dict | None = None) -> dict:
    """One run of cell ``name``: the result line as a dict, with
    ``checks`` last. ``program`` (tests, the control) replaces the
    method's program: ``program(cfg, traffic, target, mosaic)``.
    ``t_start`` is the process's start and ``marks`` the caller's own
    set-up times, for ``setup_split``."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = find_cell(load_spec(root), name, root)
    cfg, traffic = cell.cfg, cell.traffic
    meth = method(cfg, root)
    cuda = torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False  # the stated precision
    torch.backends.cudnn.allow_tf32 = False
    split = dict(marks or {}, to_harness_s=time.perf_counter() - t_start)

    def lap(key, t):
        split[key] = time.perf_counter() - t
        return time.perf_counter()

    t = time.perf_counter()
    torch.empty(1, device=device)
    _sync(device)
    t = lap("context_s", t)
    meth.load(device)
    t = lap("library_s", t)
    pool = tiles.make_pool(traffic, seed, device)
    target = tiles.make_target(cfg["target"], seed, device)
    mos = (tiles.mosaic(pool, traffic["mosaic_tiles"], seed)
           if traffic["estimation"] == "slide" else None)
    _sync(device)
    t = lap("pool_s", t)
    prog = (program or meth.program)(cfg, traffic, target, mos)
    _sync(device)
    fit_ms = (time.perf_counter() - t) * 1e3
    t = lap("fit_s", t)
    depth, batches = traffic["in_flight"], pool.batches
    drive(prog.call, batches, depth, device, n=traffic["warm_batches"])
    _sync(device)
    lap("warm_s", t)
    setup_s = time.perf_counter() - t_start

    keep = Reservoir(traffic["checked_batches"], seed)
    rec = dict(cell=name, batch=traffic["batch"], side=traffic["tile"],
               setup_s=setup_s, fit_ms=fit_ms, trace=None, cfg=cfg)
    pre = None
    if trace:
        traced_s = min(TRACE_S, seconds)
        pre = (drive(prog.call, batches, depth, device,
                     seconds=seconds - traced_s, keep=keep)
               if seconds > traced_s else None)
        seg, rec["trace"] = _traced(prog.call, batches, depth, device,
                                    traced_s, keep)
        # The entry's host time away from the profiler, which adds its
        # own cost to every operation it records.
        rec["entry_host_us"] = (pre or seg).host_us
        rec["tissue_share"] = sum(meth.tissue_share(cfg, b)
                                  for b in batches) / len(batches)
        rec["work"] = cfg["work"][traffic["estimation"]]
    else:
        seg = drive(prog.call, batches, depth, device, seconds=seconds,
                    keep=keep)
    attempted = seg.attempted + (pre.attempted if pre else 0)
    rec.update(completed=len(seg.latencies_ms),
               latencies_ms=seg.latencies_ms, window_s=seg.seconds)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    # The check, once the window has closed and the peak is read: the
    # program's state goes, the reference recomputes everything.
    fits = {k: v.detach().cpu() for k, v in prog.fits.items()}
    del prog
    ref = meth.reference(cfg, traffic, target, mos)
    nums = compare(fits, ref.fits, keep.items, ref.call, batches)
    correct, checks = judge(nums, cell.limits)
    correct = correct and bool(keep.items)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"], root)(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    # A call that fails raises and ends the run without a result, so every
    # batch called either completed or was still in flight at the close.
    result = {"correct": correct, "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": dev}
    if trace:
        w0, w1 = rec["trace"]["window"]
        busy = tr.busy_intervals(rec["trace"]["device"], w0, w1)
        dev["busy_s"] = sum(b - a for a, b in busy) * 1e-6
        dev["window_s"] = (w1 - w0) * 1e-6
        result["breakdown"] = tr.breakdown(rec["trace"])
        result["card"] = _power_limit() if cuda else "cpu"
    result["setup_split"] = split
    result["checks"] = dict(checks, checked_batches=len(keep.items))
    return result


def check_lines(result: dict) -> list:
    """The numbers compared beside their limits, one per line."""
    lines = []
    for k, c in result["checks"].items():
        if isinstance(c, dict):
            lines.append(f"check {k} {c['value']!r} limit {c['limit']!r}")
        else:
            lines.append(f"check {k} {c!r}")
    lines.append(f"correct {result['correct']}")
    return lines
