"""Stall watchdog: failure *detection* for long training runs.

The port's own copy of the JAX package's ``utils/watchdog.py`` (pure
Python, so the same class). The reference has no failure detection at
all: a hung rank silently stalls the whole mpirun job (SURVEY.md section
5). A daemon thread fires a callback (default: log loudly) when no
heartbeat arrives within the timeout, e.g. when a CUDA step or an NCCL
collective deadlocks or the input pipeline starves. Recovery remains
checkpoint-restart.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class StallWatchdog:
    """``beat()`` every step; ``on_stall(seconds_since_beat)`` fires once per
    stall episode if the gap exceeds ``timeout_s``."""

    def __init__(self, timeout_s: float = 300.0,
                 on_stall: Optional[Callable[[float], None]] = None,
                 poll_s: float = 1.0):
        self.timeout_s = timeout_s
        self.poll_s = poll_s
        self.on_stall = on_stall or (
            lambda gap: print(f"[watchdog] no progress for {gap:.0f}s",
                              flush=True)
        )
        self._last = time.monotonic()
        self._fired = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stall_count = 0

    def beat(self) -> None:
        self._last = time.monotonic()
        self._fired = False

    def start(self) -> "StallWatchdog":
        def run():
            while not self._stop.wait(self.poll_s):
                gap = time.monotonic() - self._last
                if gap > self.timeout_s and not self._fired:
                    self._fired = True
                    self.stall_count += 1
                    self.on_stall(gap)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.poll_s)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
