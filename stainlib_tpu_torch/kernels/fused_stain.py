"""Planar tile layout and the plain count-bisection percentile.

Port of the JAX package's ``kernels/fused_stain.py``: the layout helpers
``to_planar`` / ``from_planar`` (``:281-292``) and, as plain torch, the
``n_cands=1`` path of ``_multi_masked_percentile`` (``:43-146``) that the
fused stain kernels share. Here it serves the plain versions of those
kernels; the CUDA kernels carry their own copy of the same search
(``csrc/stain_common.cuh``). The search answers ``np.percentile``'s
linear rule (``stainlib/normalization/normalizer.py:36,46``).
"""

from __future__ import annotations

import torch

LANES = 128
BIG = 3.4e38


def to_planar(rgb):
    """(B, H, W, 3) -> (B, 3, H*W/128, 128) planar lane-aligned layout."""
    B, H, W, _ = rgb.shape
    n = H * W
    if n % LANES:
        raise ValueError(f"H*W = {H}*{W} is not a multiple of {LANES}")
    return rgb.permute(0, 3, 1, 2).reshape(B, 3, n // LANES, LANES)


def from_planar(planar, h, w):
    """Inverse of :func:`to_planar`."""
    return planar.reshape(planar.shape[0], 3, h, w).permute(0, 2, 3, 1)


def _multi_masked_percentile(searches, n_iters=14):
    """Several ``np.percentile(values[mask], q)`` searches, batched over
    tiles, by count bisection on the rank-floor order statistic with the
    exact successor recovered afterwards.

    ``searches``: list of ``(values (B, N), mask (B, N) bool or None,
    n_valid (B,), q, lo_init (B,), hi_init (B,))``. A masked search seeds
    its bracket from the masked data's own min/max (shared by searches on
    the same operand); an unmasked one starts from ``[lo_init, hi_init]``.
    Returns one (B,) percentile per search.
    """
    big = torch.tensor(BIG, dtype=torch.float32)
    ranks, fracs, operands, brackets = [], [], [], []
    cache = {}
    for values, mask, n_valid, q, lo0, hi0 in searches:
        rank_f = (q / 100.0) * torch.clamp_min(n_valid - 1.0, 0.0)
        rank_lo = torch.floor(rank_f)
        ranks.append(rank_lo)
        fracs.append(rank_f - rank_lo)
        if mask is None:
            vm, dlo, dhi = values, lo0, hi0
        else:
            key = (id(values), id(mask))
            if key not in cache:
                vm = torch.where(mask, values, big.to(values.device))
                valid = vm < BIG
                vmin = torch.where(valid, vm, hi0[:, None]).amin(-1)
                vmax = torch.where(valid, vm, lo0[:, None]).amax(-1)
                cache[key] = (vm, vmin, torch.maximum(vmax, vmin))
            vm, dlo, dhi = cache[key]
        operands.append(vm)
        brackets.append((dlo, dhi))

    for _ in range(n_iters):
        for i, (vm, (lo, hi), rank) in enumerate(
                zip(operands, brackets, ranks)):
            mid = 0.5 * (lo + hi)
            cnt = (vm <= mid[:, None]).sum(-1)
            take = cnt > rank  # v_(k) <= mid
            brackets[i] = (torch.where(take, lo, mid),
                           torch.where(take, mid, hi))

    results = []
    for vm, (_, hi_a), rank, frac in zip(operands, brackets, ranks, fracs):
        # v_(k) lies in (lo, hi_a]; v_(k+1) is in the same bracket iff
        # count(<= hi_a) exceeds rank+1, else it is the smallest value
        # above the bracket.
        cnt_hi = (vm <= hi_a[:, None]).sum(-1)
        succ = torch.where(vm > hi_a[:, None], vm,
                           big.to(vm.device)).amin(-1)
        v_b = torch.where(cnt_hi > rank + 1.0, hi_a, succ)
        results.append(hi_a * (1.0 - frac) + v_b * frac)
    return results
