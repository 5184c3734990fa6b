"""The hand-written CUDA stain-augmentation kernels (K6 fused Macenko
augment, one thread-block cluster per tile; K7 augment apply) against their
plain PyTorch versions, and the augmentation routes on the card.

Needs a CUDA device (marker ``cuda``; every test skips without one). The
card has no jax, so this file imports only torch, numpy and the port. On
the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_augment_cuda.py

Tolerances: uint8 outputs at most 1 step apart on under 0.1% of the bytes
(kernel and plain version share the OD/luminance tables and sum the
moments in double / float64; on the card they have been byte-identical);
the fused routes within the JAX tests' functional budget (<=1 u8 on >99%
of bytes, max <=4).
"""

import numpy as np
import pytest
import torch

import stainlib_tpu_torch as st
from stainlib_tpu_torch.augmentation import functional as F
from stainlib_tpu_torch.kernels import _build
from stainlib_tpu_torch.kernels import fused_stain as fs
from stainlib_tpu_torch.kernels import macenko_fused as mf
from stainlib_tpu_torch.kernels import vahadane_fused as vf
from synth import he_batch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _draws(n, seed, device):
    return F._stain_draws(torch.Generator().manual_seed(seed), (n,), 0.2, 0.2,
                          device)


def _u8_close(got, want):
    d = (got.int() - want.int()).abs()
    assert d.max() <= 1 and (d > 0).float().mean() < 1e-3, (
        int(d.max()), float((d > 0).float().mean()))


@pytest.mark.cuda
@pytest.mark.parametrize("side,batch", [(256, 8), (512, 2)])
@pytest.mark.parametrize("background", [False, True])
def test_k6_k7_match_plain_versions(cuda, side, batch, background):
    rgb = torch.from_numpy(he_batch(batch, side, side, seed=97)).to(cuda)
    planar = fs.to_planar(rgb).contiguous()
    alpha, beta = _draws(batch, 1, cuda)
    kw = dict(augment_background=background)
    before = (mf.aug_launches, mf.augment_launches)
    k6 = mf.macenko_augment_planar(planar, alpha, beta, **kw)
    _u8_close(k6, mf.macenko_augment_planar_ref(planar, alpha, beta, **kw))
    assert torch.equal(mf.macenko_augment(rgb, alpha, beta, **kw),
                       fs.from_planar(k6, side, side))
    M = vf._prior_where_nan(vf.vahadane_stain_matrix_planar_ref(planar))
    k7 = mf.augment_with_matrix_planar(planar, M, alpha, beta, **kw)
    _u8_close(k7, mf.augment_with_matrix_planar_ref(planar, M, alpha, beta,
                                                    **kw))
    assert torch.equal(mf.augment_with_matrix(rgb, M, alpha, beta, **kw),
                       fs.from_planar(k7, side, side))
    assert (mf.aug_launches, mf.augment_launches) == (before[0] + 2,
                                                      before[1] + 2)


def _tiles_with_white(batch, side, seed, device):
    """``batch`` H&E tiles; of three, the second with its upper half white
    and the third all white (an empty tissue mask)."""
    tiles = he_batch(batch, side, side, seed=seed)
    if batch >= 3:
        tiles[1, : side // 2] = 255
        tiles[2] = 255
    return torch.from_numpy(tiles).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("background", [False, True])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("side", [256, 512])
def test_k6_cluster_equals_plain_at_every_cluster_size(cuda, side, batch,
                                                       background):
    """K6's bytes equal the plain version's at each cluster size G (forced
    through ``cluster_plan``'s ``g``), interleaved and planar, staged in
    shared memory or, where a block cannot hold its slice (the small G), in
    device memory, with a half-white and an all-white tile in a batch of
    three; the plan's own G gives the same bytes, twice."""
    rgb = _tiles_with_white(batch, side, 140, cuda)
    planar = fs.to_planar(rgb).contiguous()
    alpha, beta = _draws(batch, 141, cuda)
    kw = dict(augment_background=background)
    want = mf.macenko_augment_ref(rgb, alpha, beta, **kw)
    want_planar = fs.to_planar(want)
    for g in mf.CLUSTER_SIZES:
        got = mf._aug_launch(rgb, False, alpha, beta, g=g, **kw)
        assert torch.equal(got, want), (g, int(
            (got.int() - want.int()).abs().max()))
        assert torch.equal(mf._aug_launch(planar, True, alpha, beta, g=g,
                                          **kw), want_planar), g
    got = mf.macenko_augment(rgb, alpha, beta, **kw)
    assert torch.equal(got, want)
    assert torch.equal(mf.macenko_augment(rgb, alpha, beta, **kw), got)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,side,g,shared", [
    (1, 256, 16, True), (3, 256, 16, True), (70, 256, 2, False),
    (12, 512, 16, False)])
def test_k6_plan_follows_the_batch(cuda, batch, side, g, shared):
    """One image and three of 256^2 run at the plan's G for their batch (16
    blocks per tile, staged in shared memory), 70 tiles as two blocks per
    tile staged in device memory, 12 of 512^2 as 16 blocks per tile staged
    in device memory, and give the bytes of G = 1; a tile's output does not
    depend on the batch it came in."""
    rgb = torch.from_numpy(he_batch(batch, side, side, seed=142)).to(cuda)
    alpha, beta = _draws(batch, 143, cuda)
    plan = mf.cluster_plan(side * side, "K6", batch=batch)
    assert plan.g == g and (plan.smem > 0) == shared
    before = mf.aug_launches
    got = mf.macenko_augment(rgb, alpha, beta)
    assert mf.aug_launches == before + 1
    assert torch.equal(got, mf._aug_launch(rgb, False, alpha, beta, g=1))
    assert torch.equal(got, mf.macenko_augment_ref(rgb, alpha, beta))
    one = mf.macenko_augment(rgb[-1:].contiguous(), alpha[-1:], beta[-1:])
    assert torch.equal(one[0], got[-1])


@pytest.mark.cuda
def test_k6_argument_forms(cuda):
    """numpy, list and CPU-tensor draws, shared or per tile, give the bytes
    of the CUDA tensors the kernel reads by their own pointer."""
    rgb = torch.from_numpy(he_batch(3, 128, 128, seed=144)).to(cuda)
    alpha, beta = _draws(3, 145, cuda)
    want = mf.macenko_augment(rgb, alpha, beta)
    for conv in (lambda t: t.cpu().numpy(), lambda t: t.cpu().tolist(),
                 lambda t: t.cpu(), lambda t: t.double()):
        assert torch.equal(mf.macenko_augment(rgb, conv(alpha), conv(beta)),
                           want)
    shared = mf.macenko_augment(rgb, alpha[1], beta[1])
    assert torch.equal(shared, mf.macenko_augment(
        rgb, alpha[1].expand(3, 2), beta[1].expand(3, 2)))
    assert torch.equal(shared[1], want[1])


def _rows(n, seed, device):
    """n plausible H&E stain matrices, (n, 2, 3), rows of unit length."""
    rng = np.random.default_rng(seed)
    base = np.array([[0.56, 0.72, 0.41], [0.22, 0.80, 0.56]], np.float32)
    m = base + rng.uniform(-0.05, 0.05, (n, 2, 3)).astype(np.float32)
    m /= np.linalg.norm(m, axis=-1, keepdims=True)
    return torch.from_numpy(m).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("background", [False, True])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("batch", [1, 5])
def test_k7_equals_plain_version(cuda, batch, planar, shared, background):
    """K7 byte for byte, both layouts, shared and per-tile arguments, the
    background flag on and off."""
    rgb = torch.from_numpy(he_batch(batch, 128, 128, seed=120)).to(cuda)
    x = fs.to_planar(rgb).contiguous() if planar else rgb
    n = 1 if shared else batch
    M = _rows(n, 121, cuda)
    alpha, beta = _draws(n, 122, cuda)
    if shared:
        M, alpha, beta = M[0], alpha[0], beta[0]
    fn, ref = ((mf.augment_with_matrix_planar,
                mf.augment_with_matrix_planar_ref) if planar
               else (mf.augment_with_matrix, mf.augment_with_matrix_ref))
    kw = dict(augment_background=background)
    assert torch.equal(fn(x, M, alpha, beta, **kw),
                       ref(x, M, alpha, beta, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 5, 7), (2, 33, 31), (1, 1, 1),
                                   (4, 19, 64), (1, 300, 217)])
@pytest.mark.parametrize("background", [False, True])
def test_k7_interleaved_odd_sizes(cuda, shape, background):
    """Interleaved images whose H*W is no multiple of 16 and whose bases
    (b * 3 * H * W) are not 16-byte aligned: the scalar head and tail."""
    b, h, w = shape
    rng = np.random.default_rng(123)
    rgb = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3),
                                        dtype=np.uint8)).to(cuda)
    M = _rows(b, 124, cuda)
    alpha, beta = _draws(b, 125, cuda)
    kw = dict(augment_background=background)
    got = mf.augment_with_matrix(rgb, M, alpha, beta, **kw)
    assert torch.equal(got, mf.augment_with_matrix_ref(rgb, M, alpha, beta,
                                                       **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("offset", [1, 7, 16])
def test_k7_takes_unaligned_views(cuda, planar, offset):
    """A contiguous view that starts ``offset`` bytes into its buffer."""
    n = 2 * 3 * 128 * 128
    rng = np.random.default_rng(126)
    buf = torch.from_numpy(rng.integers(0, 256, n + 32,
                                        dtype=np.uint8)).to(cuda)
    shape = (2, 3, 128, 128) if planar else (2, 128, 128, 3)
    x = buf[offset:offset + n].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 == offset % 16
    M = _rows(2, 127, cuda)
    alpha, beta = _draws(2, 128, cuda)
    fn, ref = ((mf.augment_with_matrix_planar,
                mf.augment_with_matrix_planar_ref) if planar
               else (mf.augment_with_matrix, mf.augment_with_matrix_ref))
    assert torch.equal(fn(x, M, alpha, beta), ref(x, M, alpha, beta))


@pytest.mark.cuda
def test_k7_argument_forms_and_no_copy(cuda):
    """numpy, list and CPU-tensor arguments give the bytes of the CUDA
    tensors; ready float32 tensors reach the kernel by their own pointer."""
    rgb = torch.from_numpy(he_batch(3, 128, 128, seed=129)).to(cuda)
    M = _rows(3, 130, cuda)
    alpha, beta = _draws(3, 131, cuda)
    want = mf.augment_with_matrix(rgb, M, alpha, beta)
    for conv in (lambda t: t.cpu().numpy(), lambda t: t.cpu().tolist(),
                 lambda t: t.cpu(), lambda t: t.double()):
        assert torch.equal(mf.augment_with_matrix(
            rgb, conv(M), conv(alpha), conv(beta)), want)
    for t, (arg, stride) in zip((M, alpha, beta),
                                mf._augment_args(M, alpha, beta, 3, cuda)):
        assert arg.data_ptr() == t.data_ptr() and stride == t[0].numel()


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["macenko", "vahadane"])
def test_stain_augment_routes_and_budget(cuda, method):
    """<=512^2: K6 (Macenko) or K8 + K7 (Vahadane), one launch each, the
    same draws as the functional fit + pop and within its budget."""
    rgb = torch.from_numpy(he_batch(4, 256, 256, seed=98)).to(cuda)
    before = (mf.aug_launches, mf.augment_launches, vf.dict_launches)
    got = F.stain_augment(rgb, torch.Generator().manual_seed(3), method)
    want_counts = ((1, 0, 0) if method == "macenko" else (0, 1, 1))
    assert tuple(a - b for a, b in zip(
        (mf.aug_launches, mf.augment_launches, vf.dict_launches),
        before)) == want_counts
    alpha, beta = _draws(4, 3, "cpu")
    want = F._stain_augment_pop_apply(
        F.stain_augment_fit(rgb.cpu(), method), alpha, beta)
    d = (got.cpu().int() - want.int()).abs()
    assert d.max() <= 4 and (d <= 1).float().mean() > 0.99, (
        int(d.max()), float((d > 1).float().mean()))
    assert torch.equal(
        F.stain_augment(rgb, torch.Generator().manual_seed(3), method), got)


@pytest.mark.cuda
def test_large_field_route_is_one_k7_launch(cuda):
    field = torch.from_numpy(he_batch(1, 1024, 1024, seed=99)[0]).to(cuda)
    before = (mf.aug_launches, mf.augment_launches)
    got = F.stain_augment(field, torch.Generator().manual_seed(4))
    assert (mf.aug_launches - before[0],
            mf.augment_launches - before[1]) == (0, 1)
    alpha, beta = (x.reshape(1, 2) for x in F._stain_draws(
        torch.Generator().manual_seed(4), (), 0.2, 0.2, cuda))
    blocks = F._augment_field(field[None], alpha, beta, "macenko", block=512)
    assert torch.equal(blocks[0], got)
    M = vf._prior_where_nan(F._EXTRACTORS["macenko"](field[None]))
    _u8_close(got, mf.augment_with_matrix_ref(field[None], M, alpha,
                                              beta)[0])


@pytest.mark.cuda
def test_stain_augmentor_pops_through_k7(cuda):
    img = he_batch(1, 256, 256, seed=100)[0]
    aug = st.StainAugmentor("macenko", seed=7, device=cuda)
    aug.fit(img)
    before = mf.augment_launches
    pops = [aug.pop() for _ in range(3)]
    assert mf.augment_launches == before + 3
    assert all((a != b).any() for a, b in zip(pops, pops[1:]))
    gen = torch.Generator().manual_seed(7)
    params = F.stain_augment_fit(torch.from_numpy(img), "macenko")
    for got in pops:
        a, b = F._stain_draws(gen, (1,), 0.2, 0.2, "cpu")
        want = F._stain_augment_pop_apply(params, a[0], b[0]).numpy()
        assert np.quantile(np.abs(got.astype(int) - want.astype(int)),
                           0.99) <= 4


@pytest.mark.cuda
def test_failed_launch_raises_without_fallback(cuda, monkeypatch):
    """A refused launch raises; nothing falls back to the plain version or
    the functional path, and no launch is counted."""

    class RefusingLibrary:
        def __getattr__(self, name):
            if name == "stain_error_string":
                return lambda err: b"refused for the test"
            return lambda *args: 1  # cudaErrorInvalidValue

    rgb = torch.from_numpy(he_batch(2, 256, 256, seed=101)).to(cuda)
    alpha, beta = _draws(2, 5, cuda)
    _build.load_library()
    monkeypatch.setattr(_build, "_lib", RefusingLibrary())
    before = (mf.aug_launches, mf.augment_launches)
    with pytest.raises(RuntimeError, match="^augment_launch failed"):
        mf.macenko_augment(rgb, alpha, beta)
    with pytest.raises(RuntimeError, match="augment_apply_launch failed"):
        mf.augment_with_matrix(rgb, torch.eye(2, 3, device=cuda), alpha,
                               beta)
    with pytest.raises(RuntimeError, match="^augment_launch failed"):
        F.stain_augment(rgb, torch.Generator().manual_seed(0))
    assert (mf.aug_launches, mf.augment_launches) == before


@pytest.mark.cuda
def test_kernels_deterministic_and_per_tile(cuda):
    rgb = torch.from_numpy(he_batch(8, 256, 256, seed=102)).to(cuda)
    alpha, beta = _draws(8, 6, cuda)
    out = mf.macenko_augment(rgb, alpha, beta)
    assert torch.equal(mf.macenko_augment(rgb, alpha, beta), out)
    one = mf.macenko_augment(rgb[3:4].contiguous(), alpha[3:4], beta[3:4])
    assert torch.equal(one[0], out[3])
    vout = vf.vahadane_augment(rgb, alpha, beta)
    assert torch.equal(vf.vahadane_augment(rgb, alpha, beta), vout)
    with pytest.raises(ValueError, match="contiguous"):
        mf.macenko_augment_planar(fs.to_planar(rgb), alpha, beta)
