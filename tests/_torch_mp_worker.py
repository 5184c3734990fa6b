"""Multi-process CPU worlds for the port's distributed tests.

Each worker is one rank of a gloo process group of N CPU processes (the
analogue of one ``mpirun`` rank in the reference's launch, ``run.sh:20-63``),
joined through :func:`stainlib_tpu_torch.parallel.mesh.initialize_distributed`
over a ``file://`` store in the test's temporary directory, so parallel test
processes never race for a port. It reads its inputs from ``in.npz`` there,
runs one task through the port's public functions, and writes what it saw
to ``out_<rank>.npz``; the test compares that with the JAX package, which
the worker never imports.

Usage: python tests/_torch_mp_worker.py <task> <rank> <world> <workdir>

:func:`run_world` starts the N workers of a task and returns their outputs.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 120  # per worker process


def run_world(task: str, world: int, workdir, inputs: dict) -> list:
    """Run ``task`` on a gloo world of ``world`` CPU processes; returns each
    rank's outputs as a dict of arrays. Fails on a worker's error or after
    ``TIMEOUT_S`` seconds per worker, killing the others."""
    workdir = Path(workdir)
    np.savez(workdir / "in.npz", **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, __file__, task, str(r), str(world), str(workdir)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {task!r} failed:\n{log}"
    out = []
    for r in range(world):
        with np.load(workdir / f"out_{r}.npz") as f:
            out.append({k: f[k] for k in f.files})
    return out


def _raises(exc, fn, *args, **kw) -> str:
    """The message of the ``exc`` that ``fn`` raises."""
    try:
        fn(*args, **kw)
    except exc as e:
        return str(e)
    raise AssertionError(f"{fn.__name__} did not raise {exc.__name__}")


def task_mesh(inp, out):
    """make_mesh's layout and errors on a 4-rank world; shard_rows on a
    (data=2, tiles=2) mesh; local_data_shard's defaults."""
    import torch.distributed as dist

    from stainlib_tpu_torch.parallel.mesh import (
        local_data_shard, make_mesh, shard_rows)
    from stainlib_tpu_torch.parallel.stain_sharded import (
        normalize_batch_sharded)
    from stainlib_tpu_torch.parallel.collectives import all_gather_metrics

    mesh = make_mesh(4, device="cpu", data=2, tiles=2)
    flat = make_mesh(device="cpu")
    rows = shard_rows(mesh, "data", inp["batch"].shape)
    out.update(
        names=np.array(mesh.mesh_dim_names), layout=mesh.mesh.numpy(),
        coord=np.array([mesh.get_local_rank("data"),
                        mesh.get_local_rank("tiles")]),
        group_sizes=np.array([dist.get_world_size(mesh.get_group(n))
                              for n in mesh.mesh_dim_names]),
        flat_names=np.array(flat.mesh_dim_names),
        flat_layout=flat.mesh.numpy(),
        rows=np.array([rows.start, rows.stop]),
        shard=np.array(local_data_shard(int(inp["count"]))),
        err_value=np.array(_raises(ValueError, make_mesh, 4, device="cpu",
                                   data=3)),
        err_runtime=np.array(_raises(RuntimeError, make_mesh, 8,
                                     device="cpu")),
        err_axis=np.array(_raises(ValueError, shard_rows, mesh, "pixel",
                                  (8,))),
    )
    # The batch splits over 'data' only; the 'tiles' axis holds copies.
    shard = normalize_batch_sharded(mesh, inp["target"], inp["batch"],
                                    axis="data")
    out["normalized"] = all_gather_metrics(shard, mesh, "data").numpy()


def task_parallel(inp, out):
    """The sharded stain paths and the collectives on a 4-rank 'data' mesh
    (and a 4-rank 'pixel' mesh), gathered back."""
    import torch

    from stainlib_tpu_torch.parallel import collectives as pc
    from stainlib_tpu_torch.parallel.mesh import make_mesh, shard_rows
    from stainlib_tpu_torch.parallel.stain_sharded import (
        normalize_batch_sharded, sharded_concentrations)

    mesh = make_mesh(device="cpu")
    rank = mesh.get_local_rank("data")

    def gathered(x):
        return pc.all_gather_metrics(x, mesh).numpy()

    out["functional"] = gathered(normalize_batch_sharded(
        mesh, inp["target"], inp["batch"]))
    for method in ("macenko", "vahadane"):
        out[f"fused_{method}"] = gathered(normalize_batch_sharded(
            mesh, inp["target_f"], inp["batch_f"], method=method,
            fused=True))
    out["err_divisible"] = np.array(_raises(
        ValueError, normalize_batch_sharded, mesh, inp["target"],
        inp["batch"][:6]))

    pixel = make_mesh(device="cpu", pixel=4)
    conc = sharded_concentrations(pixel, inp["od"], inp["M"])
    out["conc"] = pc.all_gather_metrics(conc, pixel, "pixel").numpy()
    # No 'pixel' axis: the mesh's first axis shards the pixels.
    out["conc_fallback"] = gathered(sharded_concentrations(
        mesh, inp["od"], inp["M"]))

    grads = {"w": torch.from_numpy(inp["grad_w"][rank]),
             "b": (torch.from_numpy(inp["grad_b"][rank]), None)}
    for compress in (False, True):
        red = pc.pmean_grads(grads, mesh, compress=compress)
        assert red["b"][1] is None and red["w"].dtype == torch.float32
        out[f"pmean_w_{compress}"] = red["w"].numpy()
        out[f"pmean_b_{compress}"] = red["b"][0].numpy()
    out["psum"] = pc.psum_stats(torch.from_numpy(inp["grad_w"][rank]),
                                mesh).numpy()
    out["gather"] = gathered(torch.from_numpy(inp["grad_b"][rank]))
    tree = pc.broadcast_from_zero(
        {"x": inp["grad_w"][rank], "y": [torch.tensor(float(rank))]}, mesh)
    out["bcast_x"], out["bcast_y"] = tree["x"].numpy(), tree["y"][0].numpy()

    def loss_fn(w, batch):
        xb, yb = batch
        return torch.mean((xb @ w - yb) ** 2)

    x, y = (torch.from_numpy(inp[k]) for k in ("x", "y"))
    rows = shard_rows(mesh, "data", x.shape)
    step = pc.data_parallel_step(mesh, loss_fn)
    loss, grads = step(torch.zeros(x.shape[1]), (x[rows], y[rows]))
    out["dp_loss"], out["dp_grads"] = loss.numpy(), grads.numpy()


def task_prefetch(inp, out):
    """The prefetcher's mesh rows on a 2-rank world: each rank receives
    only its rows of every leaf, in order, with None leaves kept."""
    from stainlib_tpu_torch.data.pipeline import DevicePrefetcher
    from stainlib_tpu_torch.parallel.mesh import make_mesh, shard_rows

    mesh = make_mesh(device="cpu")
    batches = [(inp["tiles"][i], {"flag": inp["flags"][i], "none": None})
               for i in range(len(inp["tiles"]))]
    got = list(DevicePrefetcher(iter(batches), depth=2, workers=2,
                                device="cpu", mesh=mesh))
    assert all(d["none"] is None for _, d in got)
    out["tiles"] = np.stack([t.numpy() for t, _ in got])
    out["flags"] = np.stack([d["flag"].numpy() for _, d in got])
    out["flag_dtype"] = np.array(str(got[0][1]["flag"].dtype))
    out["err_scalar"] = np.array(_raises(
        ValueError, lambda: list(DevicePrefetcher(
            iter([np.float32(1)]), device="cpu", mesh=mesh))))
    out["rows"] = np.array([shard_rows(mesh, "data", (4,)).start])


def task_slide(inp, out):
    """normalize_slide with a 2-rank mesh against the same call without
    one, in the same process; each rank's canvas is kept."""
    from stainlib_tpu_torch.normalization import slide as sl
    from stainlib_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    rank = mesh.get_local_rank("data")
    work = Path(str(inp["workdir"]))
    real, real_write = sl._stream_canvas, sl.write_tiff_pyramid
    seen = {"writes": []}

    def keep(*a, **k):
        res = real(*a, **k)
        seen["canvas"] = res[0]
        return res

    def write(path, *a, **k):
        seen["writes"].append(path)
        return real_write(path, *a, **k)

    sl._stream_canvas, sl.write_tiff_pyramid = keep, write
    try:
        for name, method, est in (("macenko_slide", "macenko", "slide"),
                                  ("reinhard_tile", "reinhard", "tile")):
            kw = dict(method=method, estimation=est, tile=int(inp["tile"]),
                      batch=4, n_fit_tiles=8, seed=3, compression="none",
                      device="cpu")
            path = str(work / f"{name}_mesh.tif")
            sl.normalize_slide(str(inp["src"]), path, inp["target"],
                               mesh=mesh, **kw)
            out[f"{name}_canvas"] = seen["canvas"]
            out[f"{name}_written"] = np.array(path in seen["writes"])
            sl.normalize_slide(str(inp["src"]),
                               str(work / f"{name}_{rank}.tif"),
                               inp["target"], **kw)
            out[f"{name}_single"] = seen["canvas"]
    finally:
        sl._stream_canvas, sl.write_tiff_pyramid = real, real_write
    out["err_axis"] = np.array(_raises(
        ValueError, sl.normalize_slide, str(inp["src"]), "x.tif",
        inp["target"], mesh=mesh, mesh_axis="tiles", device="cpu"))
    out["err_batch"] = np.array(_raises(
        ValueError, sl.normalize_slide, str(inp["src"]), "x.tif",
        inp["target"], mesh=mesh, batch=3, device="cpu"))


def task_wsi(inp, out):
    """The sampler on a 2-rank world, worker and worker count left to the
    process group: this rank's slide, its train and eval batches."""
    from stainlib_tpu_torch.data.wsi import SamplerConfig, WsiSampler

    cfg = SamplerConfig(tile=32, batch_size=8, batch_tumor_ratio=0.5,
                        stddev_min=5.0)
    sampler = WsiSampler(str(inp["slides"]), str(inp["xmls"]), cfg, seed=1)
    assert len(sampler.paths) == 1
    batches = list(sampler.train_batches(num_batches=2))
    out.update(paths=np.array(sampler.paths[0]),
               tiles=np.stack([t for t, _ in batches]),
               flags=np.stack([f for _, f in batches]),
               eval=np.concatenate(list(sampler.eval_tiles(0))))


def task_flow(inp, out):
    """One data-parallel flow train step on a 2-rank 'data' mesh: this
    rank's rows of the batch, the given probes (every rank draws the same,
    as every shard of the JAX step splits the same key), the state from a
    checkpoint in the work directory. Saves the averaged loss and
    gradients, and the state after ``make_train_step(mesh=...)``."""
    import torch

    from stainlib_tpu_torch.models.train_flow import (
        FlowConfig, init_flow_state, loss_and_grads, make_train_step)
    from stainlib_tpu_torch.parallel.collectives import pmean_grads
    from stainlib_tpu_torch.parallel.mesh import make_mesh, shard_rows
    from stainlib_tpu_torch.utils.checkpoint import restore_checkpoint

    cfg = FlowConfig(**{k[4:]: inp[k].item() if inp[k].ndim == 0
                        else tuple(inp[k].tolist())
                        for k in inp if k.startswith("cfg_")})
    mesh = make_mesh(device="cpu")
    flow, gmm, template, tx = init_flow_state(cfg, 0, device="cpu")
    state = restore_checkpoint(str(inp["ckpt"]), template)
    hsd = torch.from_numpy(inp["hsd"][shard_rows(mesh, "data",
                                                 inp["hsd"].shape)])
    probes = [torch.from_numpy(inp[f"probe_{i}"])
              for i in range(int(inp["n_probes"]))]
    loss, grads = loss_and_grads(flow, gmm, cfg, state.params,
                                 state.spectral, hsd, probes)
    grads = pmean_grads(grads, mesh)
    out["loss"] = pmean_grads(loss, mesh).numpy()
    new, step_loss = make_train_step(flow, gmm, cfg, tx, mesh=mesh)(
        state, hsd, probes)
    out["step_loss"] = step_loss.numpy()
    for part, tree in (("grad", grads), ("param", new.params)):
        for model in tree:
            for name, t in tree[model].items():
                out[f"{part}:{model}:{name}"] = t.numpy()
    for name, t in new.spectral.items():
        out[f"spectral:{name}"] = t.numpy()
    out["step"] = np.array(new.step)


def task_validate(inp, out):
    """The flow's template pass sharded over a 2-rank 'data' mesh: the
    sums of ``template_sums_sharded`` (covariance and quantile curves
    included) and ``validate(mesh=...)``'s template statistics and NMI,
    from a checkpoint in the work directory."""
    import torch

    from stainlib_tpu_torch.models.train_flow import (
        FlowConfig, init_flow_state)
    from stainlib_tpu_torch.models.validate_flow import (
        template_sums_sharded, validate)
    from stainlib_tpu_torch.parallel.mesh import make_mesh
    from stainlib_tpu_torch.utils.checkpoint import restore_checkpoint

    cfg = FlowConfig(**{k[4:]: inp[k].item() if inp[k].ndim == 0
                        else tuple(inp[k].tolist())
                        for k in inp if k.startswith("cfg_")})
    mesh = make_mesh(device="cpu")
    flow, gmm, template, _ = init_flow_state(cfg, 0, device="cpu")
    state = restore_checkpoint(str(inp["ckpt"]), template)
    sums = template_sums_sharded(flow, gmm, cfg, state.params,
                                 state.spectral, torch.from_numpy(inp["tmpl"]),
                                 None, mesh, with_cov=True,
                                 with_quantiles=True)
    for name, t in zip(sums._fields, sums):
        out[f"sums:{name}"] = t.numpy()
    res = validate(flow, gmm, cfg, state.params, state.spectral,
                   [inp["tmpl"]], [inp["test"]], log=lambda *_: None,
                   transfer="full", mesh=mesh)
    out["mu_tmpl"], out["sigma_tmpl"] = res["mu_tmpl"], res["sigma_tmpl"]
    out["nmi"] = np.asarray(res["nmi"])


TASKS = dict(mesh=task_mesh, parallel=task_parallel, prefetch=task_prefetch,
             slide=task_slide, wsi=task_wsi, flow=task_flow,
             validate=task_validate)


def main(task: str, rank: int, world: int, workdir: str) -> None:
    sys.path.insert(0, str(ROOT))
    import torch.distributed as dist

    from stainlib_tpu_torch.parallel.mesh import initialize_distributed

    initialize_distributed(f"file://{workdir}/store", world, rank,
                           device="cpu")
    try:
        with np.load(Path(workdir) / "in.npz") as f:
            inp = {k: f[k] for k in f.files}
        out = {}
        TASKS[task](inp, out)
        assert "jax" not in sys.modules and "stainlib_tpu" not in sys.modules
        np.savez(Path(workdir) / f"out_{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
