"""Profiling and tracing helpers.

Port of the JAX package's ``utils/profiling.py`` on ``torch.profiler``.
The reference's observability is wall-clock prints (SURVEY.md section 5);
here the same counters exist (:mod:`stainlib_tpu_torch.utils.meters`) plus
device traces: ``trace`` records the host and, where a CUDA device is
present, the card's kernels and copies, and writes a Chrome trace (view it
in Perfetto or ``chrome://tracing``).
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function, schedule
from torch.utils._pytree import tree_leaves


# One-element fills launched in the discarded warm-up step of a trace on a
# CUDA device. torch's profiler (Kineto over CUPTI) drops the first device
# records of a session that follows unprofiled time: none in a fresh
# process, about one more for every ten seconds or so of unprofiled time
# after it, torch's own kernels as well as the port's (PERF.md, section
# 6). Records dropped in the warm-up step cost nothing.
WARM_LAUNCHES = 1024
# Seconds of idle window on each side of the block: the profiler's device
# timestamps stray by up to a few ms from the host clock late in a process
# (PERF.md, section 6), and it drops a kernel that seems to lie outside
# the window.
MARGIN_S = 0.05
_LAUNCH = re.compile(r"^cuda(LaunchKernel|LaunchCooperativeKernel)")


def lost_device_records(events) -> int:
    """Kernel launches in Chrome-trace ``events`` (``cuda_runtime``
    events, by correlation id) that have no device kernel event."""
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") == "cuda_runtime"
                and _LAUNCH.match(e.get("name", ""))
                and "correlation" in e.get("args", {})}
    ran = {e["args"].get("correlation") for e in events
           if e.get("cat") == "kernel" and "args" in e}
    return len(launched - ran)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block into ``log_dir``
    (``trace_<pid>_<n>.json``, a Chrome trace): CPU activity, and CUDA
    activity where a CUDA device is available.

    On a CUDA device the session opens with a warm-up step that the trace
    discards (:data:`WARM_LAUNCHES` fills and a synchronize, which take the
    records the profiler drops after unprofiled time), the block sits
    :data:`MARGIN_S` inside each end of the window, every device is
    synchronized before the window closes, and a trace in which a kernel
    launch has no device kernel is deleted and raises ``RuntimeError``
    rather than being kept: the caller may trace the block again."""
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    n = sum(1 for f in os.listdir(log_dir) if f.startswith("trace_"))
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json")
    if not cuda:
        with profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(path)
        return
    sink = torch.empty(1, device="cuda")
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        for _ in range(WARM_LAUNCHES):
            sink.zero_()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(MARGIN_S)
        yield
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)
        time.sleep(MARGIN_S)
    prof.export_chrome_trace(path)
    with open(path) as f:
        lost = lost_device_records(json.load(f).get("traceEvents", []))
    if lost:
        os.remove(path)
        raise RuntimeError(
            f"the profiler dropped the device records of {lost} kernel "
            "launches in this trace; the trace was not kept")


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside a trace (``record_function``)."""
    with record_function(name):
        yield


class StepTimer:
    """Blocking step timer: median/p50 wall time of steps.

    ``block=True`` synchronizes every CUDA device that holds a tensor of
    ``out["result"]`` (a tensor or a pytree of them) before the clock
    stops, so asynchronous launches don't hide device time (the pitfall of
    naive Python timing around CUDA work). The clock is the host's: the
    time includes dispatch.
    """

    def __init__(self, block: bool = True):
        self.block = block
        self.times: list[float] = []

    @contextlib.contextmanager
    def measure(self, result_getter=None):
        t0 = time.perf_counter()
        out = {}
        yield out
        if self.block and "result" in out:
            devices = {leaf.device for leaf in tree_leaves(out["result"])
                       if isinstance(leaf, torch.Tensor)
                       and leaf.device.type == "cuda"}
            for dev in devices:
                torch.cuda.synchronize(dev)
        self.times.append(time.perf_counter() - t0)

    def p50(self) -> Optional[float]:
        if not self.times:
            return None
        s = sorted(self.times)
        return s[len(s) // 2]
