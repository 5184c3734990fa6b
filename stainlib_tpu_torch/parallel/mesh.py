"""Process groups and device meshes: the Horovod/NCCL/MPI replacement.

Port of the JAX package's ``parallel/mesh.py:21-83``. The reference
launches N ranks with ``mpirun`` over SLURM and communicates via
Horovod/NCCL (``dlmodels/color-information/run.sh:20-63``,
``train_img_horo.py:148-173,406-454``). Here each rank is one process
holding one device: :func:`initialize_distributed` joins the processes in
a ``torch.distributed`` process group (NCCL on CUDA, gloo on the CPU), and
:func:`make_mesh` lays the group's ranks out as a named
``torch.distributed.device_mesh.DeviceMesh``, whose first axis is the
slowest (across hosts), as in the JAX package.

Unlike a JAX mesh, which one process drives, a rank here holds only its
own rows of a sharded batch: :func:`shard_rows` says which.
"""

from __future__ import annotations

import datetime
import os
import tempfile
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from stainlib_tpu_torch.api import _device

# Every collective of a group made here fails after this long instead of
# hanging: a rank that died leaves the others waiting forever otherwise.
TIMEOUT = datetime.timedelta(seconds=300)


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def _set_cuda_device(rank: int) -> None:
    local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
    torch.cuda.set_device(local)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           auto: bool = False, device="cuda") -> None:
    """Multi-process bootstrap (replaces ``hvd.init()``/mpirun env wiring).

    No-op when called with no arguments. Pass the coordinator's
    ``host:port`` (or a ``tcp://`` / ``file://`` URL) with the world size
    and this process's rank, or ``auto=True`` under a launcher that sets
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` (torchrun);
    arguments given with ``auto`` take the place of the environment's. On
    CUDA the process's device becomes ``LOCAL_RANK`` (or the rank modulo
    the devices on the host) and the group runs NCCL; on the CPU, gloo.
    """
    explicit = (coordinator_address is not None or process_id is not None
                or (num_processes is not None and num_processes > 1))
    if not (auto or explicit):
        return
    dev = _device(device)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    rank = process_id if process_id is not None else int(
        os.environ.get("RANK", 0))
    if dev.type == "cuda":
        _set_cuda_device(rank)
    dist.init_process_group(
        _backend(dev), init_method=init_method, timeout=TIMEOUT,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)


def _init_world_of_one(dev: torch.device) -> None:
    """A process group of this process alone, over a store in a temporary
    file (no port to pick, so no race between processes)."""
    fd, path = tempfile.mkstemp(prefix="stainlib_store_")
    os.close(fd)
    if dev.type == "cuda":
        _set_cuda_device(0)
    dist.init_process_group(_backend(dev), init_method=f"file://{path}",
                            world_size=1, rank=0, timeout=TIMEOUT)


def make_mesh(n_devices: Optional[int] = None, device="cuda",
              **axis_sizes: int) -> DeviceMesh:
    """A named mesh over the first ``n_devices`` ranks of the process group.

    ``axis_sizes`` are ordered: the FIRST axis should be the slowest
    (across hosts). Example: ``make_mesh(4, data=2, tiles=2)``. Default:
    one 'data' axis spanning the world, the reference's pure data-parallel
    Horovod layout. With no process group and ``n_devices`` None or 1 it
    makes a world of this process alone, so one card needs no launcher.
    Every rank of the group calls it with the same arguments.
    """
    dev = _device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is None:
        n_devices = world
    if not axis_sizes:
        axis_sizes = {"data": n_devices}
    sizes = list(axis_sizes.values())
    if int(np.prod(sizes)) != n_devices:
        raise ValueError(
            f"mesh axis sizes {axis_sizes} require "
            f"{int(np.prod(sizes))} devices but n_devices={n_devices}"
        )
    if world < n_devices:
        raise RuntimeError(
            f"need {n_devices} devices but the {_backend(dev)} process group "
            f"holds only {world} rank(s); start {n_devices} processes (for "
            "example with torchrun) and call initialize_distributed in each "
            "before make_mesh"
        )
    if not dist.is_initialized():
        _init_world_of_one(dev)
    return DeviceMesh(dev.type, torch.arange(n_devices).reshape(sizes),
                      mesh_dim_names=tuple(axis_sizes))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors of ``mesh`` live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_rows(mesh: DeviceMesh, axis: str, shape) -> slice:
    """This rank's rows of an array of ``shape`` whose leading axis is
    sharded over ``axis``: the block at the rank's coordinate on that axis.
    The other axes of the mesh hold copies (JAX's ``P(axis)``)."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"axis {axis!r} not in mesh axes {tuple(names)}")
    size = mesh.size(names.index(axis))
    n = shape[0] if len(shape) else None
    if n is None or n % size:
        raise ValueError(
            f"sharding over the mesh's {axis!r} axis implies that the global "
            f"size of dimension 0 should be divisible by {size}, but it is "
            f"equal to {n} (full shape: {tuple(shape)})")
    per = n // size
    start = mesh.get_local_rank(axis) * per
    return slice(start, start + per)


def local_data_shard(global_count: int, process_index: Optional[int] = None,
                     process_count: Optional[int] = None):
    """Per-rank shard bounds for dataset partitioning.

    Mirrors the reference sampler's per-rank split
    (``data_utils.py:1``: ``test_per_worker = testims // hvd.size()`` etc.):
    contiguous, equal shards, remainder dropped, deterministic across ranks.
    The defaults are the process group's rank and size, or 0 and 1 without
    a group.
    """
    on = dist.is_available() and dist.is_initialized()
    pi = (dist.get_rank() if on else 0) if process_index is None \
        else process_index
    pc = (dist.get_world_size() if on else 1) if process_count is None \
        else process_count
    per = global_count // pc
    return pi * per, (pi + 1) * per
