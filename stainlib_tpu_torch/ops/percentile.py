"""Percentile and masked-percentile primitives with static shapes.

Port of the JAX package's ``ops/percentile.py``, which replaces the
reference's ``np.percentile`` sites (``macenko_stain_extractor.py:33-35``,
``normalizer.py:36,46``, ``stain_utils.py:64,193``) and its boolean
fancy-indexing (``OD[tissue_mask]``). Masks fold in as +inf sentinels, so
every shape stays static.

NumPy's default 'linear' interpolation throughout. Reduction axes up to
512^2 elements sort; longer ones use count bisection (``torch.quantile``
raises above 2^24 elements, and the masked form needs the sentinel anyway).
``masked_mean`` and ``mean_std`` port ``percentile.py:145-159``.
"""

from __future__ import annotations

import torch

from stainlib_tpu_torch.ops.fdiv import fdiv

_BISECT_THRESHOLD = 512 * 512
# Interior candidates per round: each round narrows the bracket 8x.
_BISECT_CANDS = 7
_BISECT_ROUNDS = 8  # 8 rounds * 3 bits = a 2^-24 bracket
_BIG = 3.4e38


def _percentile_bisect(values, mask, q, n_rounds=_BISECT_ROUNDS,
                       n_cands=_BISECT_CANDS):
    """np.percentile(values[mask], q) along the last axis by multi-candidate
    count bisection; both interpolation ranks are then snapped exactly to
    data values (max-in-bracket / min-above-bracket). ``q`` may be a scalar
    or an (m,) vector, stacked on a leading axis. An empty mask gives +inf.
    """
    v = torch.as_tensor(values).to(torch.float32)
    big = torch.tensor(_BIG, dtype=torch.float32, device=v.device)
    if mask is None:
        vm = v
        n = torch.full(v.shape[:-1], float(v.shape[-1]), dtype=torch.float32,
                       device=v.device)
    else:
        vm = torch.where(mask, v, big)
        n = mask.sum(-1).to(torch.float32)
    q = torch.as_tensor(q, dtype=torch.float32, device=v.device)
    scalar_q = q.ndim == 0
    qv = q.reshape(-1)
    rank = (fdiv(qv.reshape(qv.shape + (1,) * (v.ndim - 1)), 100.0)
            * torch.clamp_min(n - 1.0, 0.0))  # (m, *batch)
    rank_lo = torch.floor(rank)
    frac = rank - rank_lo

    lo = torch.where(vm < big, vm, big).amin(-1)
    hi = torch.where(vm < big, vm, -big).amax(-1)
    hi = torch.maximum(hi, lo)
    lo = lo.expand(rank.shape)
    hi = hi.expand(rank.shape)

    for _ in range(n_rounds):
        step = (hi - lo) / float(n_cands + 1)
        new_lo, new_hi = lo, hi
        # Ascending candidates: `take` is monotone in j, so the running
        # selects land on the tightest bracket.
        for j in range(1, n_cands + 1):
            mid = lo + step * float(j)
            cnt = (vm[None] <= mid[..., None]).sum(-1)
            take = cnt > rank_lo
            new_lo = torch.where(take, new_lo, mid)
            new_hi = torch.where(take, torch.minimum(new_hi, mid), new_hi)
        lo, hi = new_lo, new_hi
    hi_a = hi
    below = vm[None] <= hi_a[..., None]
    v_a = torch.where(below, vm[None], -big).amax(-1)
    cnt_hi = below.sum(-1)
    succ = torch.where(vm[None] > hi_a[..., None], vm[None], big).amin(-1)
    v_b = torch.where(cnt_hi > rank_lo + 1.0, v_a, succ)
    out = v_a * (1.0 - frac) + v_b * frac
    out = torch.where(n > 0.0, out, torch.inf)
    return out[0] if scalar_q else out


def _sorted_percentile(a, q):
    """jnp.percentile's linear rule on the last axis of ``a`` (NaN in a row
    propagates); q-leading output for vector ``q``."""
    a = torch.where(torch.isnan(a).any(-1, keepdim=True), torch.nan, a)
    a = torch.sort(a, dim=-1).values
    n = a.shape[-1]
    qf = fdiv(torch.as_tensor(q, dtype=torch.float32, device=a.device), 100.0)
    qr = qf * float(n - 1)
    low = torch.floor(qr)
    high = torch.ceil(qr)
    hw = qr - low
    lw = 1.0 - hw
    low = torch.clamp(low, 0, n - 1).to(torch.long)
    high = torch.clamp(high, 0, n - 1).to(torch.long)
    out = a[..., low] * lw + a[..., high] * hw
    return out if qf.ndim == 0 else torch.movedim(out, -1, 0)


def percentile(x, q, axis=None):
    """``np.percentile`` equivalent (linear interpolation). An int axis
    longer than 512^2 goes through count bisection instead of a sort."""
    x = torch.as_tensor(x).to(torch.float32)
    if isinstance(axis, int) and x.shape[axis] > _BISECT_THRESHOLD:
        return _percentile_bisect(torch.movedim(x, axis, -1), None, q)
    if axis is None:
        return _sorted_percentile(x.reshape(-1), q)
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    axes = tuple(ax % x.ndim for ax in axes)
    keep = [d for d in range(x.ndim) if d not in axes]
    a = x.permute(keep + list(axes)).reshape(
        [x.shape[d] for d in keep] + [-1])
    return _sorted_percentile(a, q)


def masked_percentile(values, mask, q):
    """Percentile of ``values[mask]`` along the last axis without dynamic
    shapes. ``q``: a scalar in [0,100] or an (m,) vector stacked on a
    leading axis. Masked-out entries sort to the end as +inf; the rank is
    taken against the valid count. An empty mask gives NaN on the sort path
    and +inf on the bisection path, as in the JAX package."""
    values = torch.as_tensor(values).to(torch.float32)
    if values.shape[-1] > _BISECT_THRESHOLD:
        return _percentile_bisect(values, mask, q)
    v = torch.sort(torch.where(mask, values, torch.inf), dim=-1).values
    n = mask.sum(-1).to(torch.float32)
    qa = torch.as_tensor(q, dtype=torch.float32, device=values.device)
    qv = qa.reshape(-1)
    rank = (fdiv(qv.reshape(qv.shape + (1,) * n.ndim), 100.0)
            * torch.clamp_min(n - 1.0, 0.0))  # (m, *batch)
    lo = torch.floor(rank).to(torch.long)
    hi = torch.ceil(rank).to(torch.long)
    frac = rank - lo.to(torch.float32)
    vb = v.expand(rank.shape + v.shape[-1:])
    v_lo = torch.gather(vb, -1, lo[..., None])[..., 0]
    v_hi = torch.gather(vb, -1, hi[..., None])[..., 0]
    out = v_lo * (1.0 - frac) + v_hi * frac
    return out[0] if qa.ndim == 0 else out


def masked_mean(values, mask, axis=None):
    """Mean over masked entries (``percentile.py:145-150``); 0 for an empty
    mask."""
    m = torch.as_tensor(mask).to(torch.float32)
    v = torch.as_tensor(values).to(torch.float32)
    n = m.sum(dim=axis)
    return (v * m).sum(dim=axis) / torch.clamp_min(n, 1.0)


def mean_std(values, axis=None):
    """Population mean and std (``percentile.py:153-159``), dividing by N
    as ``cv.meanStdDev`` does (``stain_utils.py:181``). Evaluated in
    float64 and rounded once to float32: a float32 sum runs in another
    order on the card than on the CPU."""
    v = torch.as_tensor(values).to(torch.float32).double()
    mu = v.mean(dim=axis)
    sd = torch.sqrt(torch.clamp_min((v * v).mean(dim=axis) - mu * mu, 0.0))
    return mu.float(), sd.float()
