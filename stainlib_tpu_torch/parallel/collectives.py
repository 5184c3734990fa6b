"""Collective helpers mirroring the reference's Horovod primitive set.

Port of the JAX package's ``parallel/collectives.py:106-157``. The
reference uses exactly four Horovod primitives (SURVEY.md section 2.5):
grad allreduce w/ Adasum + fp16 compression (``train_img_horo.py:406-414``),
tensor allreduce + broadcast for template statistics (``:742-748``),
allgather for metric vectors (``:877``), and join barriers (``:454,748``).
Here they are ``torch.distributed`` collectives over the process group of
one axis of a :class:`~torch.distributed.device_mesh.DeviceMesh`
(``mesh.get_group(axis_name)``). torch has no ambient mesh axis, so each
function takes the mesh and the axis by name. ``compress=True`` reduces
bfloat16 values, the parity of Horovod's fp16 compression.

Every function takes a pytree (tuples, lists, dicts, namedtuples) of
tensors on the mesh's device and returns new tensors; the inputs are not
changed. ``None`` leaves pass through, as in a JAX pytree.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from stainlib_tpu_torch.ops.fdiv import fdiv
from stainlib_tpu_torch.parallel.mesh import mesh_device


def _map(fn, tree):
    return tree_map(lambda x: None if x is None else fn(x), tree)


def _gather(t, group) -> list:
    """Every rank's copy of ``t``, in the group's rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts


def _sum(t, group, dtype=None):
    """The sum of every rank's ``t``, added in rank order in ``dtype``
    (``t``'s by default). The same bits on every rank and backend, and
    XLA's CPU psum's (it adds in device order); an all-reduce adds in an
    order of the backend's choosing, one ulp or more apart. It moves n - 1
    copies of ``t`` to each rank where a ring all-reduce moves 2(n - 1)/n;
    the models of this package have under 4 MB of gradients."""
    parts = _gather(t, group)
    acc = parts[0].to(dtype or t.dtype, copy=True)
    for p in parts[1:]:
        acc += p
    return acc


def pmean_grads(grads, mesh, axis_name: str = "data", compress: bool = False):
    """Gradient allreduce (mean) across an axis: replaces
    ``hvd.DistributedOptimizer`` hooks (``train_img_horo.py:406-414``)."""
    group = mesh.get_group(axis_name)
    n = dist.get_world_size(group)

    def reduce_one(g):
        if compress:
            # bfloat16 values on the wire, added in float32 and rounded to
            # bfloat16 once, as XLA's bfloat16 psum does.
            s = _sum(g.to(torch.bfloat16), group, torch.float32)
            return fdiv(s.to(torch.bfloat16), n).to(g.dtype)
        return fdiv(_sum(g, group), n)

    return _map(reduce_one, grads)


def psum_stats(stats, mesh, axis_name: str = "data"):
    """Tensor allreduce (sum) for accumulated statistics: the template
    mean/std reduction of ``train_img_horo.py:742-744``."""
    group = mesh.get_group(axis_name)
    return _map(lambda s: _sum(s, group), stats)


def all_gather_metrics(metrics, mesh, axis_name: str = "data"):
    """Gather per-rank metric vectors onto every rank, concatenated along
    axis 0 in the axis's rank order (``hvd.allgather`` at
    ``train_img_horo.py:877``; JAX's ``all_gather(tiled=True)``)."""
    group = mesh.get_group(axis_name)
    return _map(lambda m: torch.cat(_gather(m, group)), metrics)


def broadcast_from_zero(tree, mesh):
    """Every rank of ``mesh`` gets the first rank's copy of ``tree``
    (``hvd.broadcast_parameters`` / ``broadcast_optimizer_state``,
    ``train_img_horo.py:452-453``). Leaves may be arrays; they come back
    as tensors on the mesh's device. The broadcast runs along each axis in
    turn, from the rank at coordinate 0."""
    dev = mesh_device(mesh)

    def bcast(x):
        x = torch.as_tensor(x).to(dev, copy=True).contiguous()
        for name in mesh.mesh_dim_names:
            group = mesh.get_group(name)
            dist.broadcast(x, src=dist.get_global_rank(group, 0),
                           group=group)
        return x

    return _map(bcast, tree)


def data_parallel_step(mesh, loss_fn, axis_name: str = "data",
                       compress_grads: bool = False):
    """Wrap ``loss_fn(params, batch) -> scalar`` into a data-parallel grad
    step: ``step(params, local_batch) -> (loss, grads)``, where
    ``local_batch`` is this rank's shard and the loss and gradients come
    back averaged over ``axis_name``: per-rank grads + pmean, the whole
    reference DP recipe in one wrapper. ``params`` and the batch are
    pytrees of tensors."""
    grad_and_value = torch.func.grad_and_value(loss_fn)

    def step(params, local_batch):
        grads, loss = grad_and_value(params, local_batch)
        grads = pmean_grads(grads, mesh, axis_name, compress=compress_grads)
        return pmean_grads(loss.detach(), mesh, axis_name), grads

    return step
