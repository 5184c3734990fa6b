"""Arithmetic that rounds the same on every device.

* True division by a constant. torch divides a CUDA tensor by a Python
  scalar as a multiply by the scalar's reciprocal (``div_true_kernel_cuda``),
  which differs from the quotient in the last bit for some inputs; on the
  CPU, and in the JAX package, it divides. :func:`fdiv` divides by a 0-dim
  tensor on the operand's device.
* Transcendentals. CUDA's float32 ``powf``, ``logf``, ``expf``, ``cosf``,
  ``sinf``, ``atan2f`` and the CPU's differ in the last bit for some
  inputs; :func:`f64` evaluates in float64 and rounds once to float32,
  where the two round alike.
* Sums over a three-element axis. A reduction runs in another order on the
  card; :func:`sum3` adds left to right.

The port's functional ops use these, so they compute the same bits on the
card as on the CPU.
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


def f64(fn, *args):
    """``fn(*args)`` with its tensor arguments in float64, rounded once to
    float32."""
    return fn(*(a.double() if isinstance(a, torch.Tensor) else a
                for a in args)).float()


def sum3(x):
    """``x[..., 0] + x[..., 1] + x[..., 2]``, left to right."""
    return x[..., 0] + x[..., 1] + x[..., 2]
