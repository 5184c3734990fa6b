"""The port's distributed layer (``stainlib_tpu_torch.parallel``) against
the JAX package's, on the CPU.

The cross-rank paths run on real gloo worlds of 2-4 CPU processes
(``tests/_torch_mp_worker.py``, jax-free, joined over a ``file://`` store in
the test's temporary directory); the JAX goldens are computed here, on the
8-device CPU mesh of ``tests/conftest.py``, from the same numpy inputs.
Tolerances:

* functional sharded normalize: at most 1 uint8 step apart on under 1% of
  the bytes (``tests/test_parallel.py:42-44``);
* fused (the plain K1 and K2 on the CPU) against JAX's interpret-mode
  kernels: at most 1 step, at least 99.9% identical
  (``tests/test_torch_macenko_kernel.py``, ``test_torch_vahadane_kernel.py``);
* concentrations atol 1e-6 against the single-device solve and float64,
  1e-5 against JAX's; data-parallel grads atol 1e-5, loss rtol 1e-6
  (``tests/test_parallel.py:57,80-83``);
* ``pmean_grads``: one float32 ulp, and one bfloat16 ulp with
  ``compress=True``; ``psum_stats`` the same bits as JAX's psum (both add
  in rank order), ``all_gather_metrics`` and ``broadcast_from_zero`` exact.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from stainlib_tpu.parallel import collectives as jax_pc  # noqa: E402
from stainlib_tpu.parallel import mesh as jax_mesh  # noqa: E402
from stainlib_tpu.parallel import stain_sharded as jax_ss  # noqa: E402
from stainlib_tpu_torch.parallel import mesh  # noqa: E402
from tests._torch_mp_worker import ROOT, run_world  # noqa: E402
from tests.synth import HE_TRUE, he_batch, he_patch  # noqa: E402

requires_8 = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 simulated devices")


def _diff(got, want):
    return np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))


@pytest.mark.parametrize("count", [0, 7, 100, 1001])
def test_local_data_shard_matches_jax(count):
    for world in (1, 2, 3, 8):
        for index in range(world):
            assert (mesh.local_data_shard(count, index, world)
                    == jax_mesh.local_data_shard(count, index, world))


def test_local_data_shard_and_mesh_without_group():
    """No process group: initialize_distributed() with no arguments is a
    no-op, as JAX's; rank 0 of 1; make_mesh() makes a world of one with a
    'data' axis (a file store, no port)."""
    mesh.initialize_distributed()
    assert not dist.is_initialized()
    assert mesh.local_data_shard(10) == (0, 10)
    with pytest.raises(RuntimeError, match="need 2 devices"):
        mesh.make_mesh(2, device="cpu")
    assert not dist.is_initialized()
    try:
        m = mesh.make_mesh(device="cpu")
        assert m.mesh_dim_names == ("data",) and m.mesh.tolist() == [0]
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert mesh.shard_rows(m, "data", (5, 2)) == slice(0, 5)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The 'parallel' task on 4 ranks, and its inputs."""
    rng = np.random.default_rng(11)
    inp = dict(
        target=he_patch(32, 32, seed=80), batch=he_batch(8, 32, 32, seed=81),
        target_f=he_patch(32, 128, seed=88),
        batch_f=he_batch(8, 32, 128, seed=89),
        od=np.abs(rng.standard_normal((8 * 64, 3))).astype(np.float32),
        M=np.asarray(HE_TRUE, np.float32),
        grad_w=rng.standard_normal((4, 5, 3)).astype(np.float32),
        grad_b=rng.standard_normal((4, 7)).astype(np.float32),
        x=rng.standard_normal((64, 5)).astype(np.float32),
        y=rng.standard_normal((64,)).astype(np.float32),
    )
    return inp, run_world("parallel", 4, tmp_path_factory.mktemp("w4"), inp)


def test_make_mesh_axes_and_errors_on_4_ranks(tmp_path):
    """(data=2, tiles=2) on 4 gloo ranks: JAX's layout (first axis
    slowest), each rank's coordinates, JAX's errors; a batch splits over
    'data' only, the 'tiles' axis holding copies."""
    target, batch = he_patch(32, 32, seed=1), he_batch(8, 32, 32, seed=2)
    outs = run_world("mesh", 4, tmp_path, dict(target=target, batch=batch,
                                               count=np.array(10)))
    want = jax_mesh.make_mesh(4, data=2, tiles=2)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    with pytest.raises(ValueError) as jax_err:
        jax_mesh.make_mesh(4, data=3)
    for r, o in enumerate(outs):
        assert tuple(o["names"]) == want.axis_names
        assert (o["layout"] == ids).all() and o["layout"].shape == (2, 2)
        assert tuple(o["coord"]) == (r // 2, r % 2)
        assert tuple(o["group_sizes"]) == (2, 2)
        assert tuple(o["flat_names"]) == ("data",)
        assert o["flat_layout"].tolist() == [0, 1, 2, 3]
        assert tuple(o["rows"]) == (4 * (r // 2), 4 * (r // 2) + 4)
        assert tuple(o["shard"]) == jax_mesh.local_data_shard(10, r, 4)
        assert str(o["err_value"]) == str(jax_err.value)
        assert str(o["err_runtime"]).startswith("need 8 devices but the gloo")
        assert "'pixel' not in mesh axes ('data', 'tiles')" in str(
            o["err_axis"])
    from stainlib_tpu_torch.normalization import extractive

    params = extractive.fit(torch.from_numpy(target))
    single = extractive.transform(params, torch.from_numpy(batch)).numpy()
    for o in outs:
        assert np.array_equal(o["normalized"], single)


@requires_8
def test_sharded_normalize_functional_matches_jax(world4):
    inp, outs = world4
    jm = jax_mesh.make_mesh(8, data=8)
    want = np.asarray(jax_ss.normalize_batch_sharded(
        jm, jnp.asarray(inp["target"]), jnp.asarray(inp["batch"])))
    for o in outs:
        assert o["functional"].shape == want.shape
        d = _diff(o["functional"], want)
        assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(),
                                                        (d > 0).mean())
    assert all(np.array_equal(o["functional"], outs[0]["functional"])
               for o in outs)


@requires_8
@pytest.mark.parametrize("method", ["macenko", "vahadane"])
def test_sharded_normalize_fused_matches_jax_kernel(world4, method):
    """Each rank's plain K1/K2 on its rows, gathered, against JAX's
    interpret-mode kernel under shard_map on its 8-device mesh."""
    inp, outs = world4
    jm = jax_mesh.make_mesh(8, data=8)
    want = np.asarray(jax_ss.normalize_batch_sharded(
        jm, jnp.asarray(inp["target_f"]), jnp.asarray(inp["batch_f"]),
        method=method, fused=True))
    for o in outs:
        d = _diff(o[f"fused_{method}"], want)
        assert d.max() <= 1 and (d == 0).mean() >= 0.999, (d.max(),
                                                           (d == 0).mean())


def test_sharded_normalize_needs_divisible_batch(world4):
    """JAX's device_put message: the axis size must divide the batch."""
    _, outs = world4
    for o in outs:
        assert ("should be divisible by 4, but it is equal to 6"
                in str(o["err_divisible"]))


@requires_8
def test_sharded_concentrations_match_jax(world4):
    """Gathered, equal to the single-device solve at atol 1e-6 (the JAX
    package's own sharded-vs-single check, ``tests/test_parallel.py:57``),
    and to JAX's sharded solve at the lasso's parity tolerance, atol 1e-5
    (``tests/test_torch_ops.py:142``): JAX's float32 solve is 2.1e-6 off
    the float64 one on these pixels, where the port's is within 1e-6."""
    from stainlib_tpu_torch.ops.lasso import nonneg_lasso_k2

    inp, outs = world4
    want = np.asarray(jax_ss.sharded_concentrations(
        jax_mesh.make_mesh(8, pixel=8), jnp.asarray(inp["od"]),
        jnp.asarray(inp["M"])))
    single = nonneg_lasso_k2(torch.from_numpy(inp["od"]),
                             torch.from_numpy(inp["M"])).numpy()
    f64 = nonneg_lasso_k2(torch.from_numpy(inp["od"]).double(),
                          torch.from_numpy(inp["M"]).double()).numpy()
    for o in outs:
        for key in ("conc", "conc_fallback"):
            np.testing.assert_allclose(o[key], single, rtol=0, atol=1e-6)
            np.testing.assert_allclose(o[key], f64, rtol=0, atol=1e-6)
            np.testing.assert_allclose(o[key], want, rtol=0, atol=1e-5)


@requires_8
def test_data_parallel_step_matches_global_grad(world4):
    inp, outs = world4
    x, y = jnp.asarray(inp["x"]), jnp.asarray(inp["y"])
    w = jnp.zeros((5,), jnp.float32)

    def loss_fn(w, batch):
        xb, yb = batch
        return jnp.mean((xb @ w - yb) ** 2)

    want = np.asarray(jax.grad(loss_fn)(w, (x, y)))
    loss = float(loss_fn(w, (x, y)))
    for o in outs:
        np.testing.assert_allclose(o["dp_grads"], want, atol=1e-5)
        np.testing.assert_allclose(float(o["dp_loss"]), loss, rtol=1e-6)


def _jax_over_4(fn, stacked):
    """``fn`` under shard_map on a 4-device 'data' mesh, each device holding
    one row of ``stacked``; returns each device's result, stacked."""
    from jax import shard_map

    jm = jax_mesh.make_mesh(4, data=4)
    run = jax.jit(shard_map(lambda s: jax.tree.map(
        lambda a: a[None], fn(jax.tree.map(lambda a: a[0], s))), mesh=jm,
        in_specs=P("data"), out_specs=P("data"), check_vma=False))
    return jax.tree.map(np.asarray, run(stacked))


def _ulps(got, want, dtype):
    """|got - want| in units of the last place of ``want`` in ``dtype``."""
    want = np.asarray(want, np.float32)
    spacing = np.spacing(np.abs(want).astype(np.float32))
    if dtype == "bfloat16":
        spacing = spacing * 2.0 ** 16  # 8 mantissa bits instead of 24
    return np.abs(np.asarray(got, np.float32) - want) / spacing


@requires_8
@pytest.mark.parametrize("compress", [False, True])
def test_pmean_grads_matches_jax(world4, compress):
    inp, outs = world4
    grads = {"w": jnp.asarray(inp["grad_w"]), "b": jnp.asarray(inp["grad_b"])}
    want = _jax_over_4(functools.partial(jax_pc.pmean_grads,
                                         compress=compress), grads)
    dtype = "bfloat16" if compress else "float32"
    for r, o in enumerate(outs):
        for k in ("w", "b"):
            got = o[f"pmean_{k}_{compress}"]
            assert got.dtype == np.float32
            assert _ulps(got, want[k][r], dtype).max() <= 1.0, (k, got,
                                                                want[k][r])


@requires_8
def test_psum_gather_broadcast_match_jax(world4):
    inp, outs = world4
    psum = _jax_over_4(jax_pc.psum_stats, jnp.asarray(inp["grad_w"]))
    gather = _jax_over_4(jax_pc.all_gather_metrics,
                         jnp.asarray(inp["grad_b"]))
    for r, o in enumerate(outs):
        assert np.array_equal(o["psum"], psum[r])
        assert np.array_equal(o["gather"], gather[r].reshape(-1))
        assert np.array_equal(o["gather"], inp["grad_b"].reshape(-1))
        assert np.array_equal(o["bcast_x"], inp["grad_w"][0])
        assert float(o["bcast_y"]) == 0.0


def test_dryrun_multichip_script_runs_on_two_cpu_ranks():
    """``scripts/torch_dryrun_multichip.py`` (the counterpart of
    ``__graft_entry__.dryrun_multichip``) on a gloo world of 2."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "torch_dryrun_multichip.py"),
         "2"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "DRYRUN_OK world=2" in res.stdout, res.stdout
