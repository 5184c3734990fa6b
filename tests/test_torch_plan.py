"""The cluster plan of the staged kernels K2 (Vahadane normalize), K4
(Macenko fit), K1 (Macenko normalize), K8 (the Vahadane dictionary), K6
(the fused Macenko augment) and K9 (the fixed-matrix normalize): for every
estimation sample the routes admit, a cluster size of at most 16 blocks,
shared memory within one block's 227 KB, and slices that together cover
the sample; larger samples staged in device memory. The plans of K1, K8,
K6 and K9 also weigh the batch against the card's block slots, as the plan
of K5 (Reinhard) does; that of K10 (the eigenplane, which stages nothing)
weighs it against the card's SMs. Pure Python: no card needed.
"""

import pytest
import torch

from stainlib_tpu_torch.kernels import macenko_fused as mf
from stainlib_tpu_torch.kernels import reinhard_fused as rf

BLOCK_BYTES = 227 * 1024  # shared memory one block of an H100 can take
SM_BYTES = 228 * 1024  # shared memory of one SM


def _check(plan, n, chunk=1, by_rule=False):
    """``chunk``: K1 and K8 deal the sample out in chunks of 512 pixels, so
    their slices are whole chunks. ``by_rule``: their batch rule may stage a
    slice in device memory that a block's shared memory would hold."""
    assert plan.g in mf.CLUSTER_SIZES and plan.g <= 16
    assert plan.g * plan.slice >= n
    chunks = -(-n // chunk)
    assert plan.slice == chunk * -(-chunks // plan.g)
    if chunk == 1:
        assert (plan.g - 1) * plan.slice < n  # no block without pixels
    elif by_rule:
        assert chunks >= plan.g  # dealt in turns: a chunk or more each
    if plan.smem:
        assert plan.smem == 12 * plan.slice
        assert plan.smem + mf._SMEM_STATIC <= BLOCK_BYTES
    elif not by_rule:  # staged in device memory: the slice fits no block
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


BATCHED = ("K1", "K8", "K6", "K9")  # chunks dealt in turns, the batch rule


@pytest.mark.parametrize("kernel", ["K2", "K4", "K1", "K8", "K6", "K9"])
def test_forced_cluster_sizes(kernel):
    """``g`` forces G, whatever the batch; a slice that fits no block's
    shared memory is staged in device memory; sizes outside 1..16 and
    other kernels are refused."""
    chunk = 512 if kernel in BATCHED else 1
    for n in (8192, 32768, 65536, 262144):
        for g in mf.CLUSTER_SIZES:
            plan = mf.cluster_plan(n, kernel, g)
            _check(plan, n, chunk)
            assert plan.g == g
            assert mf.cluster_plan(n, kernel, g, batch=256) == plan
            fits = 12 * -(-n // g) + mf._SMEM_STATIC <= BLOCK_BYTES
            assert (plan.smem > 0) == fits
    for g in (0, 3, 32):
        with pytest.raises(ValueError, match="cluster size"):
            mf.cluster_plan(8192, kernel, g)
    with pytest.raises(ValueError, match="no cluster plan"):
        mf.cluster_plan(8192, "K3")


@pytest.mark.parametrize("kernel", ["K2", "K4", "K1", "K8", "K6", "K9"])
def test_plan_stages_large_samples_in_device_memory(kernel):
    """A sample over 16 blocks' shared memory (1024^2 at fs=1, 293,547
    pixels) runs as a cluster of 16 staged in a device-memory scratch
    buffer of 12 bytes per sample pixel; one pixel less fits."""
    chunk = 512 if kernel in BATCHED else 1
    limit = 16 * ((BLOCK_BYTES - mf._SMEM_STATIC) // (12 * chunk) * chunk)
    for n in (limit + 1, 1024 * 1024):
        plan = mf.cluster_plan(n, kernel, batch=3)
        _check(plan, n, chunk)
        assert plan.g == 16 and plan.smem == 0
        buf = mf.stage_scratch(plan, 3, "cpu")
        assert buf.dtype == torch.float32
        assert buf.numel() * 4 == 3 * 16 * 12 * plan.slice
    plan = mf.cluster_plan(limit, kernel, batch=3)
    assert plan.g == 16 and plan.smem == 12 * plan.slice
    assert mf.stage_scratch(plan, 3, "cpu") is None
    if chunk == 1:  # K2's and K4's plans do not read the batch
        assert mf.cluster_plan(limit, kernel, batch=256) == plan


BATCHES = (1, 2, 3, 4, 8, 16, 17, 32, 64, 66, 67, 100, 128, 132, 133, 256)


def _check_batch_rule(kernel, n, batch):
    """The batch rule's plan for ``batch`` tiles of ``n`` sample pixels:
    slices of whole chunks that cover the sample, shared memory within one
    block's maximum or a scratch buffer of 12 bytes per staged pixel; the
    largest G that gives each block an SM of its own, in shared memory
    wherever some such G allows it; otherwise that G or two blocks per tile
    (one for a sample under 32,768 pixels), whichever is more, staged in
    device memory; and no shared-memory slice that keeps a second block off
    its SM unless the cluster has the card to itself. Wherever the rule
    stages in device memory, K6 stages 16 blocks per tile if those fit two
    to an SM, and K9 slices of at most 16,384 pixels."""
    plan = mf.cluster_plan(n, kernel, batch=batch)
    _check(plan, n, 512, by_rule=True)
    assert mf.cluster_plan(n, kernel, batch=batch, sms=132) == plan
    buf = mf.stage_scratch(plan, batch, "cpu")
    if plan.smem:
        assert buf is None
    else:
        assert buf.numel() * 4 == batch * plan.g * 12 * plan.slice
    own = [g for g in mf.CLUSTER_SIZES if batch * g <= 132
           and 512 * g < n + 512]
    alone = [g for g in own if mf.cluster_plan(n, kernel, g).smem]
    if kernel == "K9" and not plan.smem:
        g = min([g for g in mf.CLUSTER_SIZES
                 if mf.cluster_plan(n, kernel, g).slice <= 16384] + [16])
        assert plan == (g, mf.cluster_plan(n, kernel, g).slice, 0)
    elif (kernel == "K6" and not plan.smem and 16 * batch <= 264
            and n > 15 * 512):
        assert plan == (16, mf.cluster_plan(n, kernel, 16).slice, 0)
    elif alone:
        assert plan.g == alone[-1]
    else:
        g = max(own + [2 if n >= 32768 else 1])
        assert plan == (g, mf.cluster_plan(n, kernel, g).slice, 0)
    if plan.smem and plan.g > 4 and batch * plan.g > 66:
        assert 2 * (plan.smem + mf._SMEM_STATIC) <= SM_BYTES
    return plan


@pytest.mark.parametrize("fit_stride", [1, 2])
@pytest.mark.parametrize("kernel", ["K1", "K8"])
def test_batched_plan_covers_the_routes(kernel, fit_stride):
    """K1's and K8's plan for every square tile the routes admit (64^2 to
    512^2) in batches of 1 to 256, by the batch rule
    (:func:`_check_batch_rule`)."""
    for n in _k2_samples(fit_stride):
        for batch in BATCHES:
            _check_batch_rule(kernel, n, batch)


def _whole_tiles():
    """Pixels of the tiles ``stain_augment``'s fused route (K6) and
    ``vahadane_normalize_planar_2k`` (K9) take: H*W a multiple of 128, up
    to 512^2; squares 64^2..512^2 and some oblong shapes."""
    sides = [(s, s) for s in range(64, 513, 16)]
    sides += [(128, 192), (256, 384), (512, 256), (100, 128), (384, 512)]
    return sorted({h * w for h, w in sides if (h * w) % 128 == 0})


@pytest.mark.parametrize("kernel", ["K6", "K9"])
def test_k6_k9_plans_cover_their_routes(kernel):
    """K6 and K9 estimate over the whole tile: their plan for every tile
    their routes take, in batches of 1 to 256, follows the batch rule; one
    image of 256^2 or 512^2 spreads over 16 SMs, in shared memory."""
    for n in _whole_tiles():
        for batch in BATCHES:
            _check_batch_rule(kernel, n, batch)
    for side in (256, 512):
        assert mf.cluster_plan(side * side, kernel, batch=1) == (
            16, side * side // 16, 12 * side * side // 16)


def test_batched_plan_follows_the_card():
    """The batch rule counts the SMs it is given: on a card of 66 a batch
    of 64 tiles is planned as 128 tiles are on an H100's 132."""
    for kernel, n in (("K1", 32768), ("K8", 65536), ("K1", 131072)):
        for batch in (1, 4, 16, 64, 128):
            assert (mf.cluster_plan(n, kernel, batch=batch, sms=66)
                    == mf.cluster_plan(n, kernel, batch=2 * batch))


@pytest.mark.parametrize("kernel,n,want", [
    ("K1", 32768, {1: "16s", 4: "16s", 16: "8s", 64: "2s", 128: "2d",
                   256: "2d"}),
    ("K8", 65536, {1: "16s", 4: "16s", 16: "8s", 64: "2d", 128: "2d",
                   256: "2d"}),
    ("K1", 131072, {1: "16s", 4: "16s", 16: "8d", 128: "2d"}),
    ("K8", 262144, {1: "16s", 4: "16s", 16: "8d", 128: "2d"}),
    ("K1", 16384, {1: "16s", 128: "1s", 256: "1d"}),
    ("K6", 65536, {1: "16s", 4: "16s", 16: "8s", 64: "2d", 96: "2d",
                   128: "2d", 256: "2d"}),
    ("K9", 65536, {1: "16s", 4: "16s", 16: "8s", 64: "4d", 96: "4d",
                   128: "4d", 256: "4d"}),
    ("K6", 262144, {1: "16s", 4: "16s", 8: "16d", 12: "16d", 16: "16d",
                    17: "4d", 128: "2d"}),
    ("K9", 262144, {1: "16s", 4: "16s", 8: "16d", 12: "16d", 16: "16d",
                    17: "16d", 128: "16d"}),
], ids=["K1-256-fs2", "K8-256-fs1", "K1-512-fs2", "K8-512-fs1", "K1-128-fs1",
        "K6-256", "K9-256", "K6-512", "K9-512"])
def test_batched_plan_at_the_swept_shapes(kernel, n, want):
    """The plan at the shapes ``scripts/torch_cluster_sweep.py`` times: G,
    then ``s`` for shared memory or ``d`` for device memory."""
    got = {}
    for batch in want:
        plan = mf.cluster_plan(n, kernel, batch=batch)
        got[batch] = f"{plan.g}{'s' if plan.smem else 'd'}"
    assert got == want


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


@pytest.mark.parametrize("batch,side,g", [
    (1, 256, 16), (1, 512, 16), (4, 256, 16), (16, 256, 8), (16, 512, 8),
    (17, 256, 4), (33, 256, 4), (34, 256, 2), (66, 256, 2), (67, 256, 1),
    (128, 256, 1), (256, 256, 1), (1, 128, 4), (1, 64, 1)])
def test_k10_plan_weighs_batch_against_sms(batch, side, g):
    """One 256^2 tile spreads over 16 blocks, a batch gets one block per SM
    of the card's 132, and a part keeps 4096 pixels (16 per thread of a
    512-thread block, once)."""
    assert mf.eigenplane_plan(batch, side * side) == g
    assert batch * g <= 132 or g == 1


def test_k10_plan_forced_and_refused():
    """``g`` forces any cluster size; a size no cluster takes raises; a
    smaller card spreads a tile over fewer blocks."""
    n = 256 * 256
    for g in mf.CLUSTER_SIZES:
        assert mf.eigenplane_plan(256, n, g=g) == g
    for g in (0, 3, 32):
        with pytest.raises(ValueError, match="cluster size"):
            mf.eigenplane_plan(1, n, g=g)
    assert mf.eigenplane_plan(8, n, sms=32) == 4
