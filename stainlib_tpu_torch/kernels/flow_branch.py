"""The flow's residual branch in the deploy encode, as hand-written kernels.

One iResBlock's ``x + g(x)`` (``models/resflow.IResBlock``, the branch
``models/flow_layers.lipschitz_apply``) for the published 3-1-3 branch:
conv 3x3 c -> hidden, ``silu / 1.1``, conv 1x1 hidden -> hidden,
``silu / 1.1``, conv 3x3 hidden -> c, each with its bias, SAME zero
padding, float32 NCHW.

Kernel source note (``csrc/flow_branch.cu``):

* Replaces no TPU kernel: the JAX package leaves the branch to XLA's
  convolutions. The port ran it as three cuDNN FP32 convolutions and six
  elementwise passes, each of which wrote or read a 128-channel tensor.
* Bound: FP32 FFMA arithmetic (18.7 GFLOP per 256^2 tile of the capacity
  flow), once the hidden activations stay on chip.
* Design: the last 3x3 convolution is a per-pixel projection hidden -> 9c
  followed by a gather of nine shifted taps (``conv3x3(h)(p) = sum_tap
  W3[tap] . h(p + d_tap)``, exact with zero padding). The branch kernel
  walks tiles of 128 pixels, one block of 256 threads per SM: the window
  of 9c inputs, h1, h2 and the taps ``t`` are register-tiled FFMA products
  from shared memory, h1 and h2 never leave it; it writes ``t`` as (B, 9c,
  H, W). The gather kernel adds the in-image taps, the last bias and the
  residual. A pack kernel, launched with the branch kernel, lays the
  weights out transposed and zero-padded to 128 hidden channels.

:func:`eligible` is ``IResBlock.forward``'s dispatch rule: the log-determinant
skipped, autograd off, a CUDA float32 contiguous input, and a branch of the
shapes the kernels are written for (:func:`supported`). Everything else
(training, ``inverse``, the exact log-determinant, the CPU) runs
``lipschitz_apply``. :func:`flow_branch` launches the kernels on a CUDA
tensor and runs the plain version :func:`flow_branch_plain` on a CPU one.
``launches`` counts the branches the kernels computed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Fused branches since import (or since a caller reset it); each is one
# call of the branch kernel's launcher (pack + branch) and one gather.
launches = 0

MAX_CHANNELS = 16
MAX_HIDDEN = 128


def packed_floats(c: int) -> int:
    """Room for the packed weights of ``c`` channels (``Layout`` in the
    source, which checks it): W1^T, b1, W2^T, b2 at 128 hidden, W3' at up
    to 144 tap columns."""
    return (9 * c * MAX_HIDDEN + 2 * MAX_HIDDEN + MAX_HIDDEN * MAX_HIDDEN
            + MAX_HIDDEN * 9 * MAX_CHANNELS)


def supported(weights) -> bool:
    """Whether the kernels are written for the branch ``weights``
    ``[(w1, b1), (w2, b2), (w3, b3)]``: kernels 3-1-3, 1 to 16 channels
    in and out, a hidden width that is a multiple of 32 up to 128."""
    if len(weights) != 3 or any(w.dim() != 4 for w, _ in weights):
        return False
    (w1, _), (w2, _), (w3, _) = weights
    hidden, c = w1.shape[0], w1.shape[1]
    return (tuple(w1.shape) == (hidden, c, 3, 3)
            and tuple(w2.shape) == (hidden, hidden, 1, 1)
            and tuple(w3.shape) == (c, hidden, 3, 3)
            and 1 <= c <= MAX_CHANNELS and 0 < hidden <= MAX_HIDDEN
            and hidden % 32 == 0)


def eligible(x, weights) -> bool:
    """Whether ``IResBlock.forward`` (with its log-determinant skipped)
    computes ``x + g(x)`` with the kernels: autograd off (no backward
    exists for them), ``x`` a contiguous CUDA float32 (B, c, H, W) tensor,
    the branch :func:`supported`."""
    return (not torch.is_grad_enabled() and x.is_cuda
            and x.dtype == torch.float32 and x.dim() == 4
            and x.is_contiguous() and supported(weights)
            and x.shape[1] == weights[0][0].shape[1])


def flow_branch_plain(x, weights):
    """Plain torch version of the kernels: ``x + g(x)`` by the same steps.
    The 3x3 out-convolution is the projection onto its nine taps (``w3``
    as (9c, hidden, 1, 1), row ``tap * c + c'``) and their gather by
    shifted adds, taps in (ky, kx) order after the bias, then the
    residual."""
    (w1, b1), (w2, b2), (w3, b3) = weights
    c, hidden = w3.shape[0], w3.shape[1]
    h, w = x.shape[-2:]
    a = F.silu(F.conv2d(x, w1, b1, padding=1)) / 1.1
    a = F.silu(F.conv2d(a, w2, b2)) / 1.1
    t = F.conv2d(a, w3.permute(2, 3, 0, 1).reshape(9 * c, hidden, 1, 1))
    t = F.pad(t, (1, 1, 1, 1))
    acc = b3[None, :, None, None]
    for tap in range(9):
        ky, kx = divmod(tap, 3)
        acc = acc + t[:, tap * c:(tap + 1) * c, ky:ky + h, kx:kx + w]
    return x + acc


def _check(x, weights):
    if not supported(weights):
        raise ValueError("the branch kernels take kernels 3-1-3, 1 to 16 "
                         "channels and a hidden width that is a multiple "
                         "of 32 up to 128")
    if x.dim() != 4 or x.shape[1] != weights[0][0].shape[1]:
        raise ValueError(f"expected (B, {weights[0][0].shape[1]}, H, W), "
                         f"got {tuple(x.shape)}")
    for v in [x] + [t for wb in weights for t in wb]:
        if v.dtype != torch.float32 or v.device != x.device:
            raise ValueError("the input and the weights must be float32 on "
                             "one device")
    if not x.is_contiguous():
        raise ValueError("the input must be contiguous NCHW")


def _launch(x, weights):
    global launches
    from stainlib_tpu_torch.kernels import _build

    (w1, b1), (w2, b2), (w3, b3) = [(w.contiguous(), b.contiguous())
                                    for w, b in weights]
    batch, c, h, w = x.shape
    dev = x.device
    pack = torch.empty(packed_floats(c), dtype=torch.float32, device=dev)
    t = torch.empty((batch, 9 * c, h, w), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    _build.launch("flow_branch_launch", dev, x.data_ptr(), w1.data_ptr(),
                  b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), w3.data_ptr(),
                  pack.data_ptr(), pack.numel(), t.data_ptr(), batch, c,
                  w1.shape[0], h, w)
    _build.launch("flow_gather_launch", dev, x.data_ptr(), t.data_ptr(),
                  b3.data_ptr(), out.data_ptr(), batch, c, h, w)
    launches += 1
    return out


def flow_branch(x, weights):
    """``x + g(x)`` for float32 ``x`` (B, c, H, W) and the branch's
    ``[(w1, b1), (w2, b2), (w3, b3)]`` (OIHW kernels): the kernels on a
    CUDA tensor, :func:`flow_branch_plain` on a CPU one."""
    _check(x, weights)
    if x.device.type == "cpu":
        return flow_branch_plain(x, weights)
    return _launch(x, weights)
