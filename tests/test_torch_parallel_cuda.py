"""The distributed layer on the card: an NCCL world of one process.

NCCL refuses two ranks on one GPU, so on one card the world is 1; the
cross-rank behaviour is held by gloo on the CPU (``tests/test_torch_parallel.py``,
``test_torch_wsi.py``, ``test_torch_data.py``, ``test_torch_slide.py``). Here:
``make_mesh()`` without a launcher, the sharded K1 and K2 path equal to a
direct kernel call byte for byte, the collectives through NCCL on CUDA
tensors, the prefetcher's mesh rows and batch structures on the card, and
``normalize_slide(mesh=...)`` equal to the call without a mesh.

Needs a CUDA device (marker ``cuda``; every test skips without one). The
card has no jax, so this file imports only torch, numpy and the port. On
the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_parallel_cuda.py
"""

import collections

import numpy as np
import pytest
import torch
import torch.distributed as dist

from stainlib_tpu_torch.data import native
from stainlib_tpu_torch.data.pipeline import DevicePrefetcher
from stainlib_tpu_torch.kernels import macenko_fused as mf
from stainlib_tpu_torch.kernels import vahadane_fused as vf
from stainlib_tpu_torch.kernels.fused_stain import from_planar, to_planar
from stainlib_tpu_torch.normalization import extractive
from stainlib_tpu_torch.normalization import slide as sl
from stainlib_tpu_torch.ops.lasso import nonneg_lasso_k2
from stainlib_tpu_torch.parallel import collectives as pc
from stainlib_tpu_torch.parallel.mesh import make_mesh
from stainlib_tpu_torch.parallel.stain_sharded import (
    normalize_batch_sharded, sharded_concentrations)
from synth import HE_TRUE, he_batch, he_patch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    m = make_mesh()
    try:
        yield m
    finally:
        dist.destroy_process_group()


def test_make_mesh_is_an_nccl_world_of_one(mesh):
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    assert mesh.device_type == "cuda" and mesh.mesh_dim_names == ("data",)
    assert mesh.mesh.tolist() == [0]


@pytest.mark.parametrize("method", ["macenko", "vahadane"])
def test_sharded_fused_equals_direct_kernel_call(mesh, method):
    """K1 / K2 through ``normalize_batch_sharded(fused=True)``, the same
    bytes as the kernel called on the whole batch, one launch."""
    target = he_patch(256, 256, seed=88)
    batch = he_batch(8, 256, 256, seed=89)
    mod = mf if method == "macenko" else vf
    mod.launches = 0
    got = normalize_batch_sharded(mesh, target, batch, method=method,
                                  fused=True)
    assert mod.launches == 1 and got.is_cuda
    params = extractive.fit(torch.from_numpy(target).cuda(), method=method)
    kern = (mf.macenko_normalize_planar if method == "macenko"
            else vf.vahadane_normalize_planar)
    planar = to_planar(torch.from_numpy(batch).cuda()).contiguous()
    want = from_planar(kern(planar, *params), 256, 256)
    assert torch.equal(got, want)
    plain = (mf.macenko_normalize_ref if method == "macenko"
             else vf.vahadane_normalize_ref)
    assert torch.equal(got, plain(torch.from_numpy(batch).cuda(), *params))


def test_collectives_through_nccl(mesh):
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(5, 3, device="cuda", generator=g)
    tree = {"x": x, "y": (x[0], None)}
    assert torch.equal(pc.psum_stats(tree, mesh)["x"], x)
    assert torch.equal(pc.all_gather_metrics(x, mesh), x)
    assert torch.equal(pc.broadcast_from_zero(tree, mesh)["y"][0], x[0])
    assert pc.pmean_grads(tree, mesh)["y"][1] is None
    assert torch.equal(pc.pmean_grads(tree, mesh)["x"], x)
    assert torch.equal(pc.pmean_grads(x, mesh, compress=True),
                       x.to(torch.bfloat16).float())
    step = pc.data_parallel_step(mesh, lambda w, b: (b @ w).square().mean())
    loss, grad = step(torch.ones(3, device="cuda"), x)
    assert torch.allclose(loss, (x @ torch.ones(3, device="cuda"))
                          .square().mean())
    assert grad.shape == (3,) and grad.is_cuda


def test_sharded_concentrations_equal_the_solve(mesh):
    od = torch.rand(4096, 3, generator=torch.Generator().manual_seed(1))
    M = torch.tensor(HE_TRUE, dtype=torch.float32)
    got = sharded_concentrations(mesh, od, M)
    assert torch.equal(got, nonneg_lasso_k2(od.cuda(), M.cuda()))


def test_prefetcher_mesh_and_structures_on_the_card(mesh):
    Pair = collections.namedtuple("Pair", "tiles flags")
    batches = [Pair(np.full((4, 2), i, np.float64), (np.arange(4), None))
               for i in range(6)]
    got = list(DevicePrefetcher(iter(batches), depth=2, workers=2,
                                mesh=mesh))
    for i, b in enumerate(got):
        assert isinstance(b, Pair) and b.flags[1] is None
        assert b.tiles.is_cuda and b.tiles.dtype == torch.float32
        assert b.flags[0].dtype == torch.int32
        assert float(b.tiles[0, 0]) == i and b.tiles.shape == (4, 2)


@pytest.mark.parametrize("method,estimation,counter", [
    ("macenko", "slide", "matrix_launches"), ("macenko", "tile", "launches")])
def test_normalize_slide_over_the_mesh_equals_single(mesh, tmp_path,
                                                     monkeypatch, method,
                                                     estimation, counter):
    """K3 (slide mode) and K1 (tile mode) over ``mesh``: the canvas of the
    call without a mesh, byte for byte, one launch per batch."""
    tl = he_batch(9, 256, 256, seed=70, background_frac=0.0)
    lv0 = np.concatenate([np.concatenate(list(tl[r * 3:r * 3 + 3]), axis=1)
                          for r in range(3)], axis=0)[:700, :600]
    path = str(tmp_path / "slide.wsiraw")
    native.write_wsiraw(path, [lv0])
    levels = []
    monkeypatch.setattr(sl, "write_tiff_pyramid",
                        lambda p, lv, **kw: levels.append(lv[0]))
    target = he_patch(256, 256, seed=40, background_frac=0.0)
    for m in (None, mesh):
        setattr(mf, counter, 0)
        info = sl.normalize_slide(path, "unused.tif", target, method=method,
                                  estimation=estimation, batch=4, mesh=m)
        assert info["fused"] is True and getattr(mf, counter) == 3
    assert len(levels) == 2 and np.array_equal(levels[0], levels[1])
