"""The cluster plan of the staged kernels K2 (Vahadane normalize) and K4
(Macenko fit): for every estimation sample the routes admit, a cluster
size of at most 16 blocks, shared memory within one block's 227 KB, and
slices that together cover the sample; larger samples staged in device
memory. And the plan of K5 (Reinhard), which weighs the batch against the
card's block slots. Pure Python: no card needed.
"""

import pytest
import torch

from stainlib_tpu_torch.kernels import macenko_fused as mf
from stainlib_tpu_torch.kernels import reinhard_fused as rf

BLOCK_BYTES = 227 * 1024  # shared memory one block of an H100 can take
SM_BYTES = 228 * 1024  # shared memory of one SM


def _check(plan, n):
    assert plan.g in mf.CLUSTER_SIZES and plan.g <= 16
    assert plan.g * plan.slice >= n
    assert (plan.g - 1) * plan.slice < n  # no block left without pixels
    if plan.smem:
        assert plan.smem == 12 * plan.slice
        assert plan.smem + mf._SMEM_STATIC <= BLOCK_BYTES
    else:  # staged in device memory: the slice fits no block
        assert 12 * plan.slice + mf._SMEM_STATIC > BLOCK_BYTES


def _k2_samples(fit_stride):
    """Sample sizes of the batched K2 entry, squares 64^2..512^2."""
    out = []
    for side in range(64, 513, 16):
        nblk, blk, _ = mf._sample_args(side * side, fit_stride)
        out.append(nblk * blk)
    return out


def test_k4_plan_covers_the_tiled_route():
    """Every subsample the tiled route sends to K4 (8192..512^2 pixels in
    whole 1024-pixel groups) runs as a cluster of 16, staged in shared
    memory."""
    for n in range(8 * 1024, 512 * 512 + 1, 1024):
        plan = mf.cluster_plan(n, "K4")
        _check(plan, n)
        assert plan.g == 16 and plan.smem > 0
    assert mf.cluster_plan(256 * 256, "K4") == (16, 4096, 48 * 1024)
    assert mf.cluster_plan(512 * 512, "K4").smem == 192 * 1024


@pytest.mark.parametrize("fit_stride", [1, 2])
def test_k2_plan_covers_the_batched_entry(fit_stride):
    for n in _k2_samples(fit_stride):
        plan = mf.cluster_plan(n, "K2")
        _check(plan, n)
        assert plan.smem > 0
        if 16 * (SM_BYTES // 2 - mf._SMEM_STATIC) >= 12 * n:
            # Two blocks fit one SM wherever some G allows it.
            assert 2 * (plan.smem + mf._SMEM_STATIC) <= SM_BYTES


def test_k2_plan_at_the_api_shapes():
    """256^2 at fs=2 (32,768 sample pixels) and 512^2 at fs=1 (262,144)."""
    assert mf.cluster_plan(32768, "K2") == (4, 8192, 96 * 1024)
    assert mf.cluster_plan(262144, "K2") == (16, 16384, 192 * 1024)


@pytest.mark.parametrize("kernel", ["K2", "K4"])
def test_forced_cluster_sizes(kernel):
    """``g`` forces G; a slice that fits no block's shared memory is staged
    in device memory; sizes outside 1..16 and other kernels are refused."""
    for n in (8192, 32768, 65536, 262144):
        for g in mf.CLUSTER_SIZES:
            plan = mf.cluster_plan(n, kernel, g)
            _check(plan, n)
            assert plan.g == g
            fits = 12 * -(-n // g) + mf._SMEM_STATIC <= BLOCK_BYTES
            assert (plan.smem > 0) == fits
    for g in (0, 3, 32):
        with pytest.raises(ValueError, match="cluster size"):
            mf.cluster_plan(8192, kernel, g)
    with pytest.raises(ValueError, match="no cluster plan"):
        mf.cluster_plan(8192, "K1")


@pytest.mark.parametrize("kernel", ["K2", "K4"])
def test_plan_stages_large_samples_in_device_memory(kernel):
    """A sample over 16 blocks' shared memory (1024^2 at fs=1, 293,547
    pixels) runs as a cluster of 16 staged in a device-memory scratch
    buffer of 12 bytes per sample pixel; one pixel less fits."""
    limit = 16 * ((BLOCK_BYTES - mf._SMEM_STATIC) // 12)
    for n in (limit + 1, 1024 * 1024):
        plan = mf.cluster_plan(n, kernel)
        _check(plan, n)
        assert plan.g == 16 and plan.smem == 0
        buf = mf.stage_scratch(plan, 3, "cpu")
        assert buf.dtype == torch.float32
        assert buf.numel() * 4 == 3 * 16 * 12 * plan.slice
    plan = mf.cluster_plan(limit, kernel)
    assert plan.g == 16 and plan.smem == 12 * plan.slice
    assert mf.stage_scratch(plan, 3, "cpu") is None


@pytest.mark.parametrize("batch,side,g", [
    (1, 256, 16), (1, 512, 16), (16, 256, 16), (16, 512, 16),
    (256, 256, 1), (256, 512, 1), (1024, 256, 1), (1024, 512, 1)])
def test_k5_plan_weighs_batch_against_block_slots(batch, side, g):
    """One image spreads over 16 blocks, 16 tiles of 512^2 over 256, and a
    batch that fills the card's 264 block slots runs one block per tile."""
    n = side * side
    plan = rf.reinhard_plan(batch, n)
    assert plan.g == g
    assert plan.slice % 16 == 0 and plan.g * plan.slice >= n
    assert (plan.g - 1) * plan.slice < n  # no block left without pixels
    assert batch * plan.g <= 264 or plan.g == 1


def test_k5_plan_between_and_forced():
    """Between the extremes G halves as the batch doubles; a slice keeps
    4096 pixels (8 per thread of a block); ``g`` forces G."""
    n = 256 * 256
    assert [rf.reinhard_plan(b, n).g for b in (16, 17, 33, 66, 132, 133)] == [
        16, 8, 8, 4, 2, 1]
    assert rf.reinhard_plan(1, 128 * 128).g == 4
    assert rf.reinhard_plan(1, 32 * 32) == (1, 1024)
    assert rf.reinhard_plan(8, n, slots=64).g == 8  # a smaller card
    for g in rf.CLUSTER_SIZES:
        plan = rf.reinhard_plan(256, n, g=g)
        assert plan == (g, n // g)
    assert rf.reinhard_plan(1, 1024 + 128, g=16).slice == 80
    for g in (0, 3, 32):
        with pytest.raises(ValueError, match="cluster size"):
            rf.reinhard_plan(1, n, g=g)
