"""Throughput/metric meters and rank-0 logging.

Port of the JAX package's ``utils/meters.py``: ``RunningAverageMeter(0.97)``
for batch time, bits-per-dim and grad norm (``train_img_horo.py:528-536``),
imgs/sec prints (``:728,862``), and the rank-0-gated logger (``:154-160``).
"""

from __future__ import annotations

import logging
import sys
import time
from typing import Optional

import torch.distributed as dist


class RunningAverageMeter:
    """Exponentially weighted running average (momentum form)."""

    def __init__(self, momentum: float = 0.97):
        self.momentum = momentum
        self.val: Optional[float] = None
        self.avg = 0.0

    def reset(self):
        self.val, self.avg = None, 0.0

    def update(self, val: float):
        if self.val is None:
            self.avg = float(val)
        else:
            self.avg = self.avg * self.momentum + float(val) * (1.0 - self.momentum)
        self.val = float(val)


class Throughput:
    """imgs/sec over a rolling window; ``total_batch / elapsed`` print parity."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self._count = 0

    def tick(self, n: int) -> float:
        self._count += n
        return self._count / max(time.perf_counter() - self._t0, 1e-9)

    def reset(self):
        self._t0 = time.perf_counter()
        self._count = 0


def get_logger(name: str = "stainlib_tpu_torch", logpath: Optional[str] = None,
               rank: Optional[int] = None, level=logging.INFO) -> logging.Logger:
    """File+console logger, silenced on non-zero ranks (the reference gates
    on ``hvd.rank() == 0``). ``rank`` defaults to the process group's rank,
    or 0 without a group."""
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    logger = logging.getLogger(name)
    logger.handlers.clear()
    logger.setLevel(level if rank == 0 else logging.CRITICAL)
    if rank == 0:
        fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if logpath:
            fh = logging.FileHandler(logpath)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    logger.propagate = False
    return logger
