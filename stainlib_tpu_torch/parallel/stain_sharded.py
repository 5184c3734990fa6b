"""Sharded stain-processing paths: data-parallel tiles + pixel sharding.

Port of the JAX package's ``parallel/stain_sharded.py:185-260``. The
reference streams 100k+ tiles per WSI through per-image CPU calls
(``data_utils.py:1``); the scaling axes here are (SURVEY.md section 2.5):

  * ``data``: tile batches sharded across ranks: each rank runs the
    identical normalization on its rows, no communication at all (stain
    normalization is embarrassingly parallel over tiles);
  * ``pixel``: the sequence-parallel analogue: the flattened pixel axis of
    a huge solve sharded across ranks, again collective-free since the
    closed-form lasso is per-pixel.

Each function returns this rank's shard; ``collectives.all_gather_metrics``
puts the whole back together where a caller needs it.
"""

from __future__ import annotations

import torch

from stainlib_tpu_torch.kernels.fused_stain import from_planar, to_planar
from stainlib_tpu_torch.kernels.macenko_fused import macenko_normalize_planar
from stainlib_tpu_torch.kernels.vahadane_fused import vahadane_normalize_planar
from stainlib_tpu_torch.normalization import extractive
from stainlib_tpu_torch.ops.lasso import nonneg_lasso_k2
from stainlib_tpu_torch.parallel.mesh import mesh_device, shard_rows


def normalize_batch_sharded(mesh, target_rgb, batch_rgb,
                            method: str = "macenko", axis: str = "data",
                            fused: bool = False):
    """Fit on the target (every rank), transform this rank's rows of the
    (B, H, W, 3) tile batch; returns them as uint8 on the mesh's device.

    The mesh's ``axis`` size must divide B. ``fused=True`` runs the
    per-tile kernels on the rank's rows at the kernels' defaults, as the
    JAX package's ``run_shard`` does (the per-rank model execution of the
    reference, ``train_img_horo.py:541-594``): K1
    (``macenko_normalize_planar``) or K2 (``vahadane_normalize_planar``) on
    CUDA, their plain versions on the CPU. Otherwise the functional
    ``extractive.transform`` runs.
    """
    dev = mesh_device(mesh)
    params = extractive.fit(torch.as_tensor(target_rgb).to(dev),
                            method=method)
    batch = torch.as_tensor(batch_rgb)
    shard = batch[shard_rows(mesh, axis, batch.shape)].to(dev)
    if fused:
        H, W = shard.shape[-3], shard.shape[-2]
        kern = (macenko_normalize_planar if method.lower() == "macenko"
                else vahadane_normalize_planar)
        out = kern(to_planar(shard).contiguous(),
                   params.stain_matrix_target, params.max_c_target)
        return from_planar(out, H, W)
    return extractive.transform(params, shard, method=method)


def sharded_concentrations(mesh, od_pixels, stain_matrix,
                           regularizer: float = 0.01, axis: str = "pixel"):
    """Pixel-sharded exact lasso over (N, 3) OD pixels: this rank's rows
    of the (N, 2) concentrations. Where the mesh has no ``axis``, its first
    axis shards the pixels (as in the JAX package); its size must divide
    N. Collective-free: concentrations are per-pixel."""
    if axis not in mesh.mesh_dim_names:
        axis = mesh.mesh_dim_names[0]
    dev = mesh_device(mesh)
    od = torch.as_tensor(od_pixels)
    od = od[shard_rows(mesh, axis, od.shape)].to(dev, torch.float32)
    M = torch.as_tensor(stain_matrix).to(dev, torch.float32)
    return nonneg_lasso_k2(od, M, regularizer)
