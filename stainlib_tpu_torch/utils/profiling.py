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
import os
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block into ``log_dir``
    (``trace_<pid>_<n>.json``, a Chrome trace): CPU activity, and CUDA
    activity where a CUDA device is available."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    n = sum(1 for f in os.listdir(log_dir) if f.startswith("trace_"))
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))


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
