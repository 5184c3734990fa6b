"""Closed-form symmetric 3x3 eigendecomposition, batched and branch-free.

Port of the JAX package's ``ops/linalg3.py:16-72``, which replaces
``np.linalg.eigh`` on the 3x3 OD covariance of the Macenko extractor
(``stainlib/extraction/macenko_stain_extractor.py:22``): Smith's (1961)
trigonometric solve plus cross-product eigenvectors, deterministic, with
the 3x3 determinant written out by cofactors (no ``torch.linalg``).
"""

from __future__ import annotations

import math

import torch

from stainlib_tpu_torch.ops.fdiv import fdiv


def _cross(u, v):
    return torch.stack([
        u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
        u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
        u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0],
    ], dim=-1)


def _det3(M):
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                            - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                              - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                              - M[..., 1, 1] * M[..., 2, 0]))


def eigh3x3(A, eps: float = 1e-12):
    """Eigenvalues (ascending, (..., 3)) and unit eigenvectors (columns of
    (..., 3, 3)) of symmetric ``A`` — ``np.linalg.eigh``'s convention, so
    Macenko's ``V[:, [2, 1]]`` selection carries over. Column signs are
    fixed deterministically (largest-|.| component positive). Float32, as
    the JAX package's."""
    return _eigh3x3(torch.as_tensor(A).to(torch.float32), eps)


def eigh3x3_f64(A, eps: float = 1e-12):
    """:func:`eigh3x3` evaluated in float64 and rounded once to float32.
    The float32 solve's ``arccos``, ``cos`` and short sums round differently
    on the card and on the CPU; their float64 results round to the same
    float32, so a caller that needs both devices to agree takes this one."""
    w, V = _eigh3x3(torch.as_tensor(A).to(torch.float64), eps)
    return w.to(torch.float32), V.to(torch.float32)


def _eigh3x3(A, eps):
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    scale = torch.clamp_min(A.abs().amax((-2, -1), keepdim=True), eps)
    As = A / scale
    q = fdiv(torch.diagonal(As, dim1=-2, dim2=-1).sum(-1), 3.0)
    B = As - q[..., None, None] * eye
    p2 = fdiv((B * B).sum((-2, -1)), 6.0)
    p = torch.sqrt(torch.clamp_min(p2, eps * eps))
    detB = _det3(B / p[..., None, None])
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = fdiv(torch.arccos(r), 3.0)
    w2 = q + 2.0 * p * torch.cos(phi)  # largest
    w0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    w1 = 3.0 * q - w0 - w2
    w = torch.stack([w0, w1, w2], dim=-1)
    V = torch.stack([_eigvec(As, w[..., k], eps) for k in range(3)], dim=-1)
    return w * scale[..., 0, 0][..., None], V


def _eigvec(A, lam, eps):
    """Unit eigenvector of A for eigenvalue lam via the largest cross
    product of columns of (A - lam I); sign-fixed."""
    M = A - lam[..., None, None] * torch.eye(3, dtype=A.dtype,
                                             device=A.device)
    c0, c1, c2 = M[..., :, 0], M[..., :, 1], M[..., :, 2]
    x01, x02, x12 = _cross(c0, c1), _cross(c0, c2), _cross(c1, c2)
    n01 = (x01 * x01).sum(-1)
    n02 = (x02 * x02).sum(-1)
    n12 = (x12 * x12).sum(-1)
    best12 = (n12 >= n01) & (n12 >= n02)
    best02 = (~best12) & (n02 >= n01)
    v = torch.where(best12[..., None], x12,
                    torch.where(best02[..., None], x02, x01))
    # Degenerate fallback (repeated eigenvalue): e0.
    nv = torch.sqrt((v * v).sum(-1, keepdim=True))
    e0 = torch.zeros_like(v)
    e0[..., 0] = 1.0
    v = torch.where(nv > eps, v / torch.clamp_min(nv, eps), e0)
    idx = torch.argmax(v.abs(), dim=-1, keepdim=True)
    lead = torch.gather(v, -1, idx)[..., 0]
    return v * torch.where(lead < 0, -1.0, 1.0)[..., None]
