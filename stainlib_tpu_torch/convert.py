"""Carry fitted state from the JAX package into the port.

The counterparts of the JAX package's fitted state: ``ExtractiveParams``
(``normalization/extractive.py:35-39``, ``normalizer.py:27-37``),
``ReinhardParams`` (``normalization/reinhard.py:24-28``,
``normalizer.py:64-68``), and the stain augmenter's ``StainAugmentParams``
and ``FusedStainAugmentState`` (``augmentation/functional.py:149-196``),
the slide-level estimates ``SlideStainParams`` and
``SlideReinhardParams`` (``normalization/slide.py:62-74``), the flow
trainer's ``FlowState`` (``models/train_flow.py:85-91``), the toy
flow's variables (``models/toy.py``), the U-Net's parameters
(``models/segmentation.py``) and the DANN nets' variables and SGD or Adam
state (``models/dann.py``, ``models/backbones.py``). Given the JAX
state as numpy arrays, build the port's, so both packages can transform,
pop or train from the same state.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from stainlib_tpu_torch.api import _device
from stainlib_tpu_torch.augmentation.functional import (
    FusedStainAugmentState,
    StainAugmentParams,
)
from stainlib_tpu_torch.models.dann import DannState, SgdState
from stainlib_tpu_torch.models.train_flow import (
    AdamState, FlowState, MultiStepsState, rng_state)
from stainlib_tpu_torch.normalization.extractive import ExtractiveParams
from stainlib_tpu_torch.normalization.reinhard import ReinhardParams
from stainlib_tpu_torch.normalization.slide import (
    SlideReinhardParams,
    SlideStainParams,
)
from stainlib_tpu_torch.utils.ema import EmaState


def _to(x, device):
    return torch.tensor(np.array(x, np.float32), device=device)


def params_from_jax(stain_matrix_target, max_c_target, device) -> ExtractiveParams:
    """``np.asarray`` of a JAX ``ExtractiveParams``' fields -> the port's
    ``ExtractiveParams`` on ``device``, float32."""
    return ExtractiveParams(stain_matrix_target=_to(stain_matrix_target, device),
                            max_c_target=_to(max_c_target, device))


def reinhard_params_from_jax(means, stds, device) -> ReinhardParams:
    """``np.asarray`` of a JAX ``ReinhardParams``' ``means`` and ``stds`` ->
    the port's ``ReinhardParams`` on ``device``, float32."""
    return ReinhardParams(means=_to(means, device), stds=_to(stds, device))


def stain_augment_params_from_jax(stain_matrix, concentrations, mask,
                                  device) -> StainAugmentParams:
    """``np.asarray`` of a JAX ``StainAugmentParams``' fields -> the port's
    ``StainAugmentParams`` on ``device``: float32 matrix and
    concentrations, boolean mask."""
    return StainAugmentParams(
        stain_matrix=_to(stain_matrix, device),
        concentrations=_to(concentrations, device),
        mask=torch.tensor(np.array(mask, bool), device=device))


def fused_augment_state_from_jax(planar, stain_matrix, h: int, w: int,
                                 device) -> FusedStainAugmentState:
    """``np.asarray`` of a JAX ``FusedStainAugmentState``' planar uint8
    tiles and stain matrices, with its ``h`` and ``w`` -> the port's
    ``FusedStainAugmentState`` on ``device``."""
    return FusedStainAugmentState(
        planar=torch.tensor(np.array(planar, np.uint8), device=device),
        stain_matrix=_to(stain_matrix, device), h=int(h), w=int(w))


def slide_params_from_jax(p, device) -> SlideStainParams:
    """A JAX ``SlideStainParams`` (numpy fields) -> the port's, float32 on
    ``device``."""
    return SlideStainParams(stain_matrix=_to(p.stain_matrix, device),
                            max_c=_to(p.max_c, device))


def slide_reinhard_params_from_jax(p, device) -> SlideReinhardParams:
    """A JAX ``SlideReinhardParams`` (numpy LAB stats, a float divisor) ->
    the port's, its stats float32 on ``device``."""
    return SlideReinhardParams(
        stats=reinhard_params_from_jax(np.asarray(p.stats.means),
                                       np.asarray(p.stats.stds), device),
        brightness_divisor=float(p.brightness_divisor))


# flax's names -> the port's module paths: ``scales_1_0/g/conv2/kernel`` ->
# ``scales.1.0.g.convs.2.weight``, ``Conv_1/kernel`` -> ``convs.1.weight``.
_NAMES = ((re.compile(r"(scales|norms)_(\d+)_(\d+)"), r"\1.\2.\3"),
          (re.compile(r"Conv_(\d+)"), r"convs.\1"),
          (re.compile(r"\bconv(\d+)"), r"convs.\1"),
          (re.compile(r"\bkernel$"), "weight"))


def _flat_from_jax(tree, device, prefix="") -> dict:
    """A nested dict of JAX arrays -> {port name: float32 tensor}: kernels
    HWIO -> OIHW, spectral vectors NHWC -> NCHW, keys in sorted order (the
    order ``init_flow_state`` gives)."""
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            out.update(_flat_from_jax(val, device, path))
            continue
        a = np.array(val, np.float32)
        if key == "kernel":
            a = a.transpose(3, 2, 0, 1)
        elif key == "u":
            a = a.transpose(0, 3, 1, 2)
        for pattern, repl in _NAMES:
            path = pattern.sub(repl, path)
        out[path.replace("/", ".")] = torch.tensor(a, device=device)
    return dict(sorted(out.items()))


def _params_from_jax(tree, device) -> dict:
    return {part: _flat_from_jax(tree[part], device)
            for part in ("flow", "gmm")}


def _find(tree, attr: str):
    """The first node of a JAX optimizer state (tuples of NamedTuples) that
    has ``attr``."""
    if hasattr(tree, attr):
        return tree
    if isinstance(tree, (tuple, list)):
        for t in tree:
            found = _find(t, attr)
            if found is not None:
                return found
    return None


def _opt_state_from_jax(opt_state, device):
    multi = _find(opt_state, "mini_step")
    adam = _find(opt_state, "nu")
    inner = AdamState(count=int(adam.count),
                      mu=_params_from_jax(adam.mu, device),
                      nu=_params_from_jax(adam.nu, device))
    if multi is None:
        return inner
    return MultiStepsState(mini_step=int(multi.mini_step),
                           gradient_step=int(multi.gradient_step),
                           inner_opt_state=inner,
                           acc_grads=_params_from_jax(multi.acc_grads, device))


def toy_state_from_jax(variables, device="cuda") -> dict:
    """A JAX ``ToyResFlow``'s variables (``{"params": ..., "spectral":
    ...}``, numpy leaves) -> a state dict for the port's ``ToyResFlow``:
    ``blocks_0/d0/kernel`` -> ``blocks.0.d0.kernel``, the (in, out) kernel
    layout kept."""
    dev = _device(device)
    out = {}

    def walk(tree, prefix):
        for key, val in tree.items():
            path = f"{prefix}.{key}" if prefix else key
            if isinstance(val, dict):
                walk(val, path)
            else:
                name = re.sub(r"blocks_(\d+)", r"blocks.\1", path)
                out[name] = _to(val, dev)

    for part in ("params", "spectral"):
        walk(variables.get(part, {}), "")
    return out


def flow_state_from_jax(params, spectral, opt_state=None, ema=None,
                        step: int = 0, device="cuda") -> FlowState:
    """A JAX ``FlowState``'s ``params``, ``spectral``, ``opt_state`` (optax's
    chain, or its ``MultiSteps``) and ``ema``, as numpy pytrees -> the
    port's ``FlowState`` on ``device``. Fields not given (and the
    generator's state, which has no JAX counterpart) are None."""
    dev = _device(device)
    return FlowState(
        params=_params_from_jax(params, dev),
        spectral=_flat_from_jax(spectral, dev),
        opt_state=None if opt_state is None else _opt_state_from_jax(
            opt_state, dev),
        ema=None if ema is None else EmaState(
            decay=float(ema.decay), params=_params_from_jax(ema.params, dev)),
        step=int(step),
        rng=None,
    )


def _net_flat(tree, device, prefix="") -> dict:
    """A flax variable tree (numpy leaves) -> {port name: float32 tensor}:
    ``Conv_0/kernel`` (HWIO) -> ``Conv_0.weight`` (OIHW, a depthwise
    (3, 3, 1, C) -> (C, 1, 3, 3)); a Dense ``kernel`` (in, out) is kept;
    other leaves keep their names. Sub-module names are flax's."""
    out = {}
    for key, val in tree.items():
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(val, dict):
            out.update(_net_flat(val, device, path))
            continue
        if type(val).__name__ == "MaskedNode":
            continue
        a = np.array(val, np.float32)
        if key == "kernel" and a.ndim == 4:
            a, path = a.transpose(3, 2, 0, 1), f"{prefix}.weight"
        out[path] = torch.tensor(np.ascontiguousarray(a), device=device)
    return out


def unet_params_from_jax(params, device="cuda") -> dict:
    """A JAX ``UNet``'s ``params`` (numpy leaves) -> the port's ``UNet``
    parameters: ``Conv_i`` -> ``convs.i`` (OIHW); ``ConvTranspose_i`` ->
    ``ups.i``, its (2, 2, in, out) kernel flipped in both spatial axes and
    laid out (in, out, 2, 2) for ``conv_transpose2d`` (flax's
    ``transpose_kernel=False`` convolves the dilated input with the kernel
    as it is)."""
    dev = _device(device)
    out = {}
    for name, leaves in params.items():
        kind, i = name.rsplit("_", 1)
        w = np.array(leaves["kernel"], np.float32)
        if kind == "ConvTranspose":
            mod, w = f"ups.{i}", w[::-1, ::-1].transpose(2, 3, 0, 1)
        else:
            mod, w = f"convs.{i}", w.transpose(3, 2, 0, 1)
        out[f"{mod}.weight"] = torch.tensor(np.ascontiguousarray(w),
                                            device=dev)
        out[f"{mod}.bias"] = _to(leaves["bias"], dev)
    return out


def _merge_masked(trees, device) -> dict:
    out = {}
    for t in trees:
        out.update(_net_flat(t, device))
    return out


def _dann_opt_from_jax(opt_state, device):
    """optax's ``multi_transform`` of two nesterov ``sgd`` (the traces of
    both groups, merged), or ``adam``'s (count, mu, nu)."""
    adam = _find(opt_state, "nu")
    if adam is not None:
        return AdamState(count=int(adam.count),
                         mu=_net_flat(adam.mu, device),
                         nu=_net_flat(adam.nu, device))
    groups = opt_state.inner_states.values()
    return SgdState(trace=_merge_masked(
        [_find(g, "trace").trace for g in groups], device))


def dann_state_from_jax(params, batch_stats, opt_state=None, seed: int = 0,
                        device="cuda") -> DannState:
    """A JAX ``DannState``'s ``params``, ``batch_stats`` and ``opt_state``
    (numpy pytrees) -> the port's ``DannState`` for the net of the same
    flax names (``DannCNN``, ``BaselineCNN``, ``DannCNNGap``,
    ``MobileNetDann``) on ``device``. The dropout key has no counterpart:
    ``rng`` is ``rng_state(seed, 1)``; ``opt_state`` None stays None."""
    dev = _device(device)
    return DannState(
        params=_net_flat(params, dev),
        batch_stats=_net_flat(batch_stats, dev),
        opt_state=None if opt_state is None else _dann_opt_from_jax(
            opt_state, dev),
        rng=rng_state(seed, 1))


def mobilenet_dann_from_jax(variables, opt_state=None, seed: int = 0,
                            device="cuda") -> DannState:
    """A JAX ``MobileNetDann``'s variables (``{"params", "batch_stats"}``,
    numpy leaves) and optional optimizer state -> the port's state for
    ``backbones.MobileNetDann``."""
    return dann_state_from_jax(variables["params"], variables["batch_stats"],
                               opt_state, seed, device)
