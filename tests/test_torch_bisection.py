"""The staged kernels' percentile search by leaf histograms, mirrored in
numpy, against the sequential count bisection it replaces; and the passes,
histogram levels and chain lengths the wrappers derive from a plan.

On the card (``staged_percentile_pair`` in
``stainlib_tpu_torch/kernels/csrc/stain_common.cuh``) a pass takes L of the
bisection rounds at once: the tree of 2^L - 1 midpoints the rounds can
visit, one leaf count and leaf minimum per value between lo and hi, the
count at or below lo and the least value above hi, summed over the
cluster's blocks; one thread walks the tree on the prefix sums. The mirror
below is that algorithm step for step in float32 (the guess, its check and
the descent that find a value's leaf; the blocks' histograms; the suffix
minima that give the successor), and must give the sequential rounds' lo,
hi, count at or below hi and successor, bit for bit. Pure numpy: no card
needed.
"""

import numpy as np
import pytest

from stainlib_tpu_torch.kernels import macenko_fused as mf

F = np.float32
BIG = F(3.4e38)
HALF = F(0.5)


def _key(x):
    """The kernel's order key of float32 values (order_key)."""
    b = np.asarray(x, F).view(np.uint32)
    return np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)


def _value(k):
    """The float32 of an order key (key_value)."""
    k = np.uint32(k)
    return np.array(k & 0x7FFFFFFF if k & 0x80000000 else ~k,
                    np.uint32).view(F)[()]


def sequential(values, lo, hi, rank, iters):
    """The rounds one count pass each, then the count at or below hi and
    the least value above it (kBig where none)."""
    lo, hi, rank = F(lo), F(hi), F(rank)
    for _ in range(iters):
        mid = HALF * (lo + hi)
        if F(np.count_nonzero(values <= mid)) > rank:
            hi = mid
        else:
            lo = mid
    above = values[values > hi]
    return (lo, hi, int(np.count_nonzero(values <= hi)),
            min(BIG, above.min(initial=BIG)))


def _tree(lo, hi, L):
    """T[0] = lo, T[2^L] = hi, T[a + h] = 0.5f * (T[a] + T[a + 2h]), built
    level by level as the kernel's warp builds it."""
    n = 1 << L
    T = np.zeros(n + 1, F)
    T[0], T[n] = lo, hi
    step = n
    while step >= 2:
        for a in range(0, n, step):
            T[a + step // 2] = HALF * (T[a] + T[a + step])
        step //= 2
    return T


def _leaf(T, L, x, sc, off):
    """leaf_of on an array of values: the guess x * sc + off rounded by the
    1.5 * 2^23 addend, checked against its two thresholds, else the descent
    of L compares."""
    n = 1 << L
    with np.errstate(over="ignore", invalid="ignore"):
        r = (x.astype(np.float64) * sc + off).astype(F) + F(12582912.0)
    g = np.clip(r.view(np.int32).astype(np.int64) - 0x4B400000, 0, n - 1)
    ok = (T[g] < x) & ~(T[g + 1] < x)
    j = np.zeros(x.shape, int)
    for d in range(L - 1, -1, -1):
        j = np.where(T[j + (1 << d)] < x, j + (1 << d), j)
    return np.where(ok, g, j)


def _block_histogram(part, T, L, lo, hi, sc, off):
    """One block's pass: leaf counts and minima, the count at or below lo,
    the key of the least value above hi or kBig (NaN counted nowhere)."""
    n = 1 << L
    with np.errstate(invalid="ignore"):
        low, top = part <= lo, part > hi
        mid = ~low & (part <= hi)
    x = part[mid]
    j = _leaf(T, L, x, sc, off)
    assert np.array_equal(j, (T[None, 1:n] < x[:, None]).sum(1))
    cnt = np.zeros(n, np.uint32)
    mins = np.full(n, 0xFFFFFFFF, np.uint32)
    np.add.at(cnt, j, 1)
    np.minimum.at(mins, j, _key(x))
    return (cnt, mins, int(low.sum()),
            _key(np.minimum(part[top], BIG)).min(initial=_key(BIG)))


def histogram_search(values, lo, hi, rank, iters, levels, blocks=1):
    """The kernel's search over ``blocks`` blocks' shares of ``values``:
    max(1, ceil(iters / levels)) passes, the rounds dealt out evenly."""
    lo, hi, rank = F(lo), F(hi), F(rank)
    passes = mf.bisection_passes(iters, levels)
    parts = np.array_split(values, blocks)
    for p in range(passes):
        L = iters // passes + (1 if p < iters % passes else 0)
        n = 1 << L
        T = _tree(lo, hi, L)
        assert np.all(np.diff(T) >= 0)  # each midpoint inside its bracket
        with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
            sc = F(n) / F(hi - lo)
            off = -lo * sc - HALF
        hists = [_block_histogram(part, T, L, lo, hi, sc, off)
                 for part in parts]
        cnt = sum(h[0] for h in hists)  # ranks in order; sums are exact
        mins = np.minimum.reduce([h[1] for h in hists])
        below = sum(h[2] for h in hists)
        above = min(h[3] for h in hists)
        inc = np.cumsum(cnt)
        suf = np.minimum.accumulate(mins[::-1])[::-1]
        a = 0
        for d in range(L - 1, -1, -1):
            mid = a + (1 << d)
            if not F(below + inc[mid - 1]) > rank:
                a = mid
        lo, hi = T[a], T[a + 1]
    key = min(above, suf[a + 1]) if a + 1 < n else above
    return lo, hi, int(below + inc[a]), _value(key)


def _samples():
    """Random and adversarial samples with their brackets [lo, hi] as the
    kernels set them: an angle search's [min, max(max, min)] over the
    tissue values (kBig the masked pixels), a concentration search's
    [0, max]."""
    rng = np.random.default_rng(21)
    out = {}
    ang = rng.uniform(0.4, 3.1, 3000).astype(F)
    ang[rng.random(3000) < 0.2] = BIG
    tissue = ang[ang < BIG]
    out["angles"] = (ang, tissue.min(), max(tissue.max(), tissue.min()))
    conc = np.maximum(rng.normal(0.3, 0.4, 3000), 0).astype(F)
    out["concentrations"] = (conc, F(0), conc.max())
    # Values on the tree's midpoints, on lo and on hi, many times each.
    lo, hi = F(0.25), F(3.75)
    T = _tree(lo, hi, 8)
    ties = np.concatenate([np.repeat(T, 7), rng.choice(T, 500)]).astype(F)
    out["ties"] = (rng.permutation(ties), lo, hi)
    out["collapsed"] = (np.full(300, F(1.5)), F(1.5), F(1.5))
    out["background"] = (np.full(512, BIG), F(4), F(4))  # no tissue
    one = np.full(512, BIG)
    one[77] = F(2.2)
    out["one-pixel"] = (one, F(2.2), F(2.2))
    # A bracket a few ulps wide: ties among the thresholds, and a guess
    # that misses.
    base = F(1.0)
    ulps = base + np.arange(9, dtype=F) * np.spacing(base)
    out["narrow"] = (rng.choice(ulps, 800), ulps[0], ulps[8])
    # A bracket whose midpoints 0.5f * (lo + hi) round unlike other
    # expressions of the midpoint, with values on them.
    lo, hi = F(0.3), F(3.1)
    mids = rng.choice(_tree(lo, hi, 8), 300)
    spread = rng.uniform(lo, hi, 1500).astype(F)
    out["rounding"] = (np.concatenate([spread, mids]).astype(F), lo, hi)
    nan = conc.copy()
    nan[::97] = np.nan
    out["nan"] = (nan, F(0), np.nanmax(nan))
    return out


_SAMPLES = _samples()


@pytest.mark.parametrize("levels", range(1, 9))
@pytest.mark.parametrize("name", sorted(_SAMPLES))
def test_histogram_walk_equals_sequential_rounds(name, levels):
    """lo, hi, the count at or below hi and the successor: the sequential
    rounds' bits at every level count, for the kernels' round counts and
    the 1st, 50th and 99th percentiles, over one block and three."""
    values, lo, hi = _SAMPLES[name]
    n_valid = np.count_nonzero(values < BIG)
    for q in (0.01, 0.5, 0.99):
        rank = np.floor(F(q) * F(max(n_valid - 1, 0)))
        for iters in (0, 1, 5, 8, 10, 14):
            want = sequential(values, lo, hi, rank, iters)
            for blocks in (1, 3):
                got = histogram_search(values, lo, hi, rank, iters, levels,
                                       blocks)
                assert (np.asarray(got[:2], F).tobytes()
                        == np.asarray(want[:2], F).tobytes()), (q, iters)
                assert got[2] == want[2], (q, iters)
                assert F(got[3]).tobytes() == F(want[3]).tobytes(), (q, iters)


@pytest.mark.parametrize("iters,levels,passes", [
    (0, 8, 1), (8, 8, 1), (10, 8, 2), (14, 8, 2), (10, 4, 3), (8, 7, 2),
    (17, 8, 3)])
def test_bisection_passes(iters, levels, passes):
    """One reduction per ``levels`` rounds, at least one (the successor)."""
    assert mf.bisection_passes(iters, levels) == passes


def test_hist_levels_at_the_benchmark_shapes():
    """Eight levels wherever the stage lies in device memory or leaves the
    room (256 tiles of 256^2 and 64 of 512^2 at fit_stride=2, one image);
    fewer where a stage fills half an SM (K2's four blocks of 96 KB), and
    the static four where a stage leaves no room at all."""
    for n, batch in ((32768, 256), (131072, 64), (32768, 1)):
        plan = mf.cluster_plan(n, "K1", batch=batch)
        assert mf.hist_levels(plan) == 8
        g, sl, smem, levels = mf.staged_args(plan)
        assert (g, sl, levels) == (plan.g, plan.slice, 8)
        assert smem == plan.smem + mf.hist_bytes(8) == plan.smem + 10280
    assert mf.hist_levels(mf.cluster_plan(32768, "K2")) == 7
    full = mf.ClusterPlan(16, 17408, mf._SMEM_BLOCK - mf._SMEM_STATIC)
    assert mf.hist_levels(full) == 4 and mf.hist_bytes(4) == 0


@pytest.mark.parametrize("kernel,kw,want", [
    ("K1", dict(it_angle=8, it_conc=10), 6),  # was 12
    ("K1", dict(it_angle=10, it_conc=14), 7),  # was 14
    ("K4", dict(it_angle=10, it_conc=14), 7),  # was 14
    ("K6", dict(it_angle=10), 4),  # was 7
    ("K2", dict(it_angle=8, it_conc=10, num_iters=8), 14),  # was 20
    ("K8", dict(it_angle=10, num_iters=12), 16),  # was 19
    ("K9", dict(it_conc=14), 3),  # was 7
])
def test_chain_length(kernel, kw, want):
    """The dependent reductions per tile at eight levels; the counts of the
    three-round design in the comments."""
    assert mf.chain_length(kernel, 8, **kw) == want
