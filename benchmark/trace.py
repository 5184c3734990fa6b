"""Device traces of a traced run: a ``torch.profiler`` session with the
discipline of the port's ``utils/profiling.trace``, and its Chrome trace
read into plain records for the per-layer metrics.

The discipline (copied, since torch's profiler over CUPTI drops the first
device records of a session that follows unprofiled time): a discarded
warm-up step of 1,024 one-element fills, 50 ms of idle window on each side
of the block, every device synchronized before the window closes, and a
trace in which a kernel launch has no device kernel refused.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import time

import torch

WARM_LAUNCHES = 1024
MARGIN_S = 0.05
_LAUNCH = re.compile(r"^cuda(LaunchKernel|LaunchCooperativeKernel)")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class LostRecords(RuntimeError):
    """The profiler dropped the device records of some launches."""


def lost_device_records(events) -> int:
    """Kernel launches (``cuda_runtime`` events, by correlation id) that
    have no device kernel event."""
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") == "cuda_runtime"
                and _LAUNCH.match(e.get("name", ""))
                and "correlation" in e.get("args", {})}
    ran = {e["args"].get("correlation") for e in events
           if e.get("cat") == "kernel" and "args" in e}
    return len(launched - ran)


@contextlib.contextmanager
def profiled(path: str):
    """Profile the block on the card into the Chrome trace ``path``."""
    from torch.profiler import ProfilerActivity, profile, schedule

    sink = torch.empty(1, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        for _ in range(WARM_LAUNCHES):
            sink.zero_()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(MARGIN_S)
        yield
        torch.cuda.synchronize()
        time.sleep(MARGIN_S)
    prof.export_chrome_trace(path)


def read(path: str, window: str, entry: str) -> dict:
    """The trace's records: the ``window`` annotation's span (us), every
    ``entry`` annotation's span, every device activity (kernels, copies,
    fills) with the host time of the runtime call that launched it, and the
    host events, for naming idle gaps. Raises :class:`LostRecords` where a
    launch lost its kernel."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    lost = lost_device_records(events)
    if lost:
        raise LostRecords(f"the profiler dropped the device records of "
                          f"{lost} kernel launches")
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    win = [e for e in spans if e.get("name") == window]
    if len(win) != 1:
        raise ValueError(f"expected one {window!r} span, found {len(win)}")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    device = [dict(name=e.get("name", ""), cat=e["cat"], ts=e["ts"],
                   dur=e.get("dur", 0),
                   launch=launch_ts.get(e.get("args", {}).get("correlation")))
              for e in events if e.get("cat") in DEVICE_CATS]
    host = [dict(name=e.get("name", ""), ts=e["ts"], dur=e.get("dur", 0))
            for e in events if e.get("cat") in HOST_CATS and "dur" in e]
    entries = [(e["ts"], e["dur"]) for e in spans
               if e.get("name") == entry and w0 <= e["ts"] <= w1]
    return dict(window=(w0, w1), entries=entries, device=device, host=host)


def busy_intervals(device, w0, w1):
    """The union of the device activities' intervals inside [w0, w1], as
    sorted disjoint (start, end) pairs (us)."""
    spans = sorted((max(d["ts"], w0), min(d["ts"] + d["dur"], w1))
                   for d in device if d["ts"] + d["dur"] > w0
                   and d["ts"] < w1)
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged if b > a]


def entry_device_ms(rec: dict):
    """The device time (ms) of every activity that a runtime call inside
    an entry span launched, per entry call; None where none matched."""
    spans = sorted(rec["entries"])
    if not spans:
        return None
    starts = [s for s, _ in spans]
    total = 0.0
    for d in rec["device"]:
        t = d["launch"]
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][0] + spans[i][1]:
            total += d["dur"]
    return total * 1e-3 / len(spans) if total > 0.0 else None


def breakdown(rec: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the innermost host event under each gap's middle."""
    w0, w1 = rec["window"]
    by_name: dict = {}
    for d in rec["device"]:
        if w0 <= d["ts"] <= w1:
            by_name[d["name"]] = by_name.get(d["name"], 0.0) + d["dur"]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = busy_intervals(rec["device"], w0, w1)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    named = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        under = [h for h in rec["host"] if h["ts"] <= mid <= h["ts"] + h["dur"]]
        name = (min(under, key=lambda h: h["dur"])["name"] if under
                else "host idle")
        named.append([name, (b - a) * 1e-6])
    return dict(device_ops=[[n, t * 1e-6] for n, t in ops],
                idle_gaps=named)


def remove(path: str) -> None:
    with contextlib.suppress(FileNotFoundError):
        os.remove(path)
