"""The traffic generator: deterministic per seed, the mixes' shapes,
background shares and centres, a non-empty tissue mask in every tile."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import tiles
from benchmark.reference import ops
from benchmark.tests._tiny import REPO, TINY

MIXES = sorted(p.stem for p in (REPO / "benchmark" / "traffic").glob("*.json"))


def _mix(name, **over):
    t = json.loads((REPO / "benchmark" / "traffic" / f"{name}.json")
                   .read_text())
    t.update(TINY, slides_per_batch=min(t["slides_per_batch"], 4), **over)
    return t


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_bytes(mix):
    t = _mix(mix)
    a = tiles.make_pool(t, 2 ** 31 + 5, "cpu")
    b = tiles.make_pool(t, 2 ** 31 + 5, "cpu")
    c = tiles.make_pool(t, 2 ** 31 + 6, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.batches, b.batches))
    assert not all(torch.equal(x, y) for x, y in zip(a.batches, c.batches))


@pytest.mark.parametrize("mix", MIXES)
def test_shapes_and_background_shares(mix):
    t = _mix(mix)
    pool = tiles.make_pool(t, 12345, "cpu")
    assert len(pool.batches) == t["pool_batches"]
    lo, hi = t["background"]
    for b, bg in zip(pool.batches, pool.background):
        assert b.shape == (t["batch"], t["tile"], t["tile"], 3)
        assert b.dtype == torch.uint8
        assert lo <= min(bg) and max(bg) <= hi
        # The band of background is white: no tissue in it.
        for tile, share in zip(b, bg):
            band = int(round(share * t["tile"]))
            mask = ops.tissue_mask(tile[:band]).mask
            assert not bool(mask.any())


@pytest.mark.parametrize("mix", MIXES)
def test_every_seed_the_same_work_in_another_order(mix):
    """The same multiset of background shares in every batch of every
    seed."""
    t = _mix(mix)
    shares = [sorted(bg) for s in (1, 2 ** 33 + 1)
              for bg in tiles.make_pool(t, s, "cpu").background]
    assert all(s == shares[0] for s in shares)


@pytest.mark.parametrize("mix", MIXES)
def test_every_tile_has_tissue(mix):
    t = _mix(mix, tile=256, batch=16, pool_batches=1)
    pool = tiles.make_pool(t, 99, "cpu")
    counts = ops.tissue_mask(pool.batches[0]).count
    assert int(counts.min()) > 0.3 * 256 * 256


def test_slides_cycle_over_the_listed_centres():
    g = torch.Generator().manual_seed(0)
    s = tiles.make_slides([0, 3], 0.0, 0.0, g, "cpu")
    want = torch.tensor([tiles.CENTERS[0][:2], tiles.CENTERS[3][:2]])
    want = want / torch.linalg.vector_norm(want, dim=-1, keepdim=True)
    assert torch.allclose(s.he, want)
    assert s.gain.tolist() == pytest.approx([1.0, 1.5])


def test_mosaic_stacks_distinct_tiles_of_the_pool():
    t = _mix("perslide-256-b256")
    pool = tiles.make_pool(t, 7, "cpu")
    m = tiles.mosaic(pool, 4, 7)
    assert m.shape == (4 * t["tile"], t["tile"], 3)
    flat = torch.cat(pool.batches)
    rows = m.reshape(4, t["tile"], t["tile"], 3)
    assert all(any(torch.equal(r, f) for f in flat) for r in rows)
