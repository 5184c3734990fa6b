"""The port's copy of the synthetic cohorts, byte for byte the JAX
package's.

Every public function of ``stainlib_tpu_torch.data.synthetic`` returns the
same bytes as ``stainlib_tpu.data.synthetic`` for the same arguments
(exact equality: the module is numpy, scipy and PIL only), and the
properties ``tests/test_synthetic_acquisition.py`` pins hold for the copy.
"""

import numpy as np
import pytest

from stainlib_tpu.data import synthetic as ref
from stainlib_tpu_torch.data import synthetic as syn


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_constants_equal():
    assert syn.N_CENTERS == ref.N_CENTERS and syn.COHORTS == ref.COHORTS
    assert (syn.SEG_BACKGROUND, syn.SEG_STROMA, syn.SEG_NUCLEI,
            syn.N_SEG_CLASSES) == (ref.SEG_BACKGROUND, ref.SEG_STROMA,
                                   ref.SEG_NUCLEI, ref.N_SEG_CLASSES)
    assert syn._CENTERS == ref._CENTERS
    assert syn._ACQ_CENTERS == ref._ACQ_CENTERS


@pytest.mark.parametrize("cohort", ["bl", "acquisition", "acquisition-clean"])
@pytest.mark.parametrize("center", [0, 3])
def test_center_tiles_byte_equal(cohort, center):
    args = (center, 3, 24, 40)
    kw = dict(seed=5, background_frac=0.2, cohort=cohort)
    _same(syn.center_tiles_with_masks(*args, **kw),
          ref.center_tiles_with_masks(*args, **kw))
    _same(syn.center_tiles(*args, **kw), ref.center_tiles(*args, **kw))


@pytest.mark.parametrize("cohort", ["bl", "acquisition"])
def test_multi_center_batches_byte_equal(cohort):
    got = syn.multi_center_batches(range(3), 4, 4, 16, 16, seed=2,
                                   cohort=cohort)
    _same(got, ref.multi_center_batches(range(3), 4, 4, 16, 16, seed=2,
                                        cohort=cohort))
    assert len(got[0]) == 3 and got[0][0].shape == (4, 16, 16, 3)


def test_domain_tasks_byte_equal():
    _same(syn.stain_domain_task(6, seed=1, size=32),
          ref.stain_domain_task(6, seed=1, size=32))
    _same(syn.two_domain_task(6, seed=1, size=21),
          ref.two_domain_task(6, seed=1, size=21))


def test_private_helpers_byte_equal():
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    _same(syn._smooth_field(rng_a, 20, 12), ref._smooth_field(rng_b, 20, 12))
    x = np.linspace(0, 1, 11)
    _same(syn._filmic(x, 1.3, 0.7), ref._filmic(x, 1.3, 0.7))


# The counterparts of tests/test_synthetic_acquisition.py, on the copy.


def _od_rank_ratio(tiles, masks):
    px = tiles[masks > 0]
    px = px[(px >= 10).all(-1)]
    od = -np.log(px.astype(np.float64) / 255.0)
    s = np.linalg.svd(od, compute_uv=False)
    return float(s[2] / s[1])


def test_masks_and_tissue_identical_across_cohorts():
    for c in range(syn.N_CENTERS):
        tb, mb = syn.center_tiles_with_masks(c, 4, 48, 48, seed=3,
                                             cohort="bl")
        ta, ma = syn.center_tiles_with_masks(c, 4, 48, 48, seed=3,
                                             cohort="acquisition")
        np.testing.assert_array_equal(mb, ma)
        assert np.abs(tb.astype(int) - ta.astype(int)).mean() > 5.0


def test_acquisition_deterministic():
    a = syn.center_tiles_with_masks(2, 3, 32, 32, seed=7,
                                    cohort="acquisition")
    b = syn.center_tiles_with_masks(2, 3, 32, 32, seed=7,
                                    cohort="acquisition")
    _same(a, b)
    np.testing.assert_array_equal(
        syn.center_tiles(2, 3, 32, 32, seed=7, cohort="acquisition"), a[0])


def test_acquisition_breaks_beer_lambert_rank2():
    for c in range(syn.N_CENTERS):
        tb, mb = syn.center_tiles_with_masks(c, 8, 64, 64, seed=3,
                                             cohort="bl")
        ta, ma = syn.center_tiles_with_masks(c, 8, 64, 64, seed=3,
                                             cohort="acquisition")
        rb, ra = _od_rank_ratio(tb, mb), _od_rank_ratio(ta, ma)
        assert ra > 2.0 * rb, (c, rb, ra)
        assert rb < 0.15, (c, rb)


def test_acquisition_clean_drops_degradation_keeps_color():
    for c in range(syn.N_CENTERS):
        ta, ma = syn.center_tiles_with_masks(c, 4, 48, 48, seed=3,
                                             cohort="acquisition")
        tc, mc = syn.center_tiles_with_masks(c, 4, 48, 48, seed=3,
                                             cohort="acquisition-clean")
        np.testing.assert_array_equal(ma, mc)
        tb, _ = syn.center_tiles_with_masks(c, 4, 48, 48, seed=3,
                                            cohort="bl")
        assert np.abs(tb.astype(int) - tc.astype(int)).mean() > 5.0
        assert np.abs(ta.astype(int) - tc.astype(int)).mean() > 0.3


def test_unknown_cohort_rejected():
    with pytest.raises(ValueError, match="cohort"):
        syn.center_tiles_with_masks(0, 1, 16, 16, cohort="nope")


def test_multi_center_batches_cohort_plumbed():
    bat, _ = syn.multi_center_batches(range(2), 4, 4, 32, 32, seed=1,
                                      cohort="acquisition")
    assert bat[0].dtype == np.uint8 and bat[0].shape == (4, 32, 32, 3)
    bat_bl, _ = syn.multi_center_batches(range(2), 4, 4, 32, 32, seed=1)
    assert any(not np.array_equal(a, b) for a, b in zip(bat, bat_bl))
