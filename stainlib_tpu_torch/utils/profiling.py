"""Profiling and tracing helpers.

Port of the JAX package's ``utils/profiling.py`` on ``torch.profiler``.
The reference's observability is wall-clock prints (SURVEY.md section 5);
here the same counters exist (:mod:`stainlib_tpu_torch.utils.meters`) plus
device traces: ``trace`` records the host and, where a CUDA device is
present, the card's kernels and copies, and writes a Chrome trace (view it
in Perfetto or ``chrome://tracing``).

The port's own spans (``annotate``, ``kernel_entry``) exist only while a
torch profiler session records (:func:`recording`): ``trace``, any
caller's own ``torch.profiler.profile``. They are record functions of that
session, on the clock of its device records. With no session recording, a
span costs one read of torch's flag. ``annotate`` makes a
``record_function`` (a ``user_annotation`` event of the Chrome trace).
``kernel_entry``, whose spans wrap every kernel call, makes torch's fast
record functions (``cpu_op`` events), which cost a tenth as much under a
recording profiler, so a traced entry stays close to an untraced one.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import threading
import time
from typing import Iterator, Optional

import torch
from torch._C._profiler import _RecordFunctionFast
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
_autograd_profiler = torch.autograd.profiler


def recording() -> bool:
    """Whether a torch profiler session is recording: the gate of every
    span of the port. A read of torch's own flag, which its profiler sets
    when a session starts recording and clears when it stops; false in a
    scheduled session's wait and warm-up steps."""
    return _autograd_profiler._is_profiler_enabled


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
    """Named region inside a trace (``record_function``), made only while a
    profiler session records (:func:`recording`); for cold paths, since
    the context manager itself costs a little even when off."""
    if not recording():
        yield
        return
    with record_function(name):
        yield


class _Entry(threading.local):
    """The kernel entry that a recording profiler traces on this thread,
    until it launches: the name of its span, and its open prep span."""

    span: Optional[str] = None
    prep = None


_entry = _Entry()


def kernel_entry(kernel: str):
    """Decorator of kernel ``kernel``'s launch-level wrapper: the code
    between the public entry's checks and its return, which launches
    through ``kernels._build.launch``.

    While a profiler session records, a call runs inside the span
    ``stain.<kernel>``, its work up to the launch inside
    ``stain.<kernel>.prep`` and the launch itself inside
    ``stain.<kernel>.launch`` (:func:`launch_span`). Otherwise the wrapper
    runs as it is after one read of the gate: no span object, no profiler
    call."""
    span = f"stain.{kernel}"

    def wrap(fn):
        @functools.wraps(fn)
        def entry(*args, **kw):
            if not recording():
                return fn(*args, **kw)
            with _RecordFunctionFast(span):
                _entry.span = span
                _entry.prep = _RecordFunctionFast(span + ".prep")
                _entry.prep.__enter__()
                try:
                    return fn(*args, **kw)
                finally:
                    if _entry.prep is not None:  # no launch was reached
                        _entry.prep.__exit__(None, None, None)
                    _entry.span = _entry.prep = None
        return entry
    return wrap


def launch_span():
    """The span ``stain.<kernel>.launch`` of the kernel entry traced on
    this thread, to enter around its launch (``kernels._build.launch``),
    with its prep span closed; handed out once per entry, and None outside
    a traced kernel entry."""
    if _entry.span is None:
        return None
    _entry.prep.__exit__(None, None, None)
    span, _entry.span, _entry.prep = _entry.span, None, None
    return _RecordFunctionFast(span + ".launch")


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
