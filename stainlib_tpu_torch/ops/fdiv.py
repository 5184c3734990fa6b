"""True division by a constant, on any device.

torch divides a CUDA tensor by a Python scalar as a multiply by the
scalar's reciprocal (``div_true_kernel_cuda``), which differs from the
quotient in the last bit for some inputs; on the CPU, and in the JAX
package, it divides. The port's divisions by constants go through
:func:`fdiv`, which divides by a 0-dim tensor on the operand's device, so
the port computes the same bits on the card as on the CPU.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _const(d: float, dtype, device):
    return torch.tensor(d, dtype=dtype, device=device)


def fdiv(x, d: float):
    """``x / d`` for a tensor ``x`` and a Python number ``d``, rounded once
    in ``x``'s dtype on every device."""
    return x / _const(float(d), x.dtype, x.device)
