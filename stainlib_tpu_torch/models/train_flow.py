"""Distributed residual-flow + GMM trainer.

Port of the JAX package's ``models/train_flow.py``, the counterpart of
``dlmodels/color-information/train_img_horo.py``: the Horovod gradient
allreduce becomes ``parallel.collectives.pmean_grads`` over a mesh axis,
and the training niceties carry over one to one:

* linear LR warmup (``update_lr``, ``:255-259``), optionally joined to
  SGDR cosine restarts (``:389``),
* gradient accumulation every ``update_freq`` steps + grad-norm clip 1.0
  (``:577-594``), as optax's ``MultiSteps`` and ``clip_by_global_norm``,
* EMA after each applied update (``:366,594``),
* ``update_lipschitz`` after each optimizer step (``:1089-1095``),
* keep-last-5 + most-recent checkpoints and resume (``:421-448,
  1149-1165``) through :mod:`stainlib_tpu_torch.utils.checkpoint`.

The state is explicit, as in the JAX package: :class:`FlowState` holds the
parameters, the spectral buffers, the optimizer state, the EMA, the step
and the generator's state, and a step returns a new state. The modules
that :func:`build_models` makes are templates run through
``torch.func.functional_call`` with the state's tensors.

The optimizer is optax's chain ``clip_by_global_norm -> adam(schedule)``
(b1 0.9, b2 0.999, eps 1e-8 outside the square root, eps_root 0), written
as plain functions on tensors, its constants rounded in float32 as optax
rounds them. The schedule is read at the count before the update, so the
first update under linear warmup uses lr 0.

The model consumes HSD images (B, H, W, 3), channels last as
``ops.colorspace.rgb_to_hsd`` gives them: the flow sees the density
channel D, the GMM conditions on the chroma (cx, cy), the ``compute_loss``
wiring of ``train_img_horo.py:466-501``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
from torch.func import functional_call
from torch.utils._pytree import (
    tree_flatten, tree_leaves, tree_map, tree_unflatten)
from torch.utils.checkpoint import checkpoint

from stainlib_tpu_torch.api import _device
from stainlib_tpu_torch.models.gmm import ConvGMM, bits_per_dim, upsample_gamma
from stainlib_tpu_torch.models.resflow import ResidualFlow, update_lipschitz
from stainlib_tpu_torch.parallel.collectives import pmean_grads
from stainlib_tpu_torch.utils.ema import EmaState, ema_init, ema_update


@dataclasses.dataclass
class FlowConfig:
    """The argparse surface of ``train_img_horo.py:43-141``, reduced to the
    knobs that affect the math."""

    image_size: int = 32
    n_scales: int = 2
    blocks_per_scale: int = 4
    hidden: int = 64
    coeff: float = 0.98
    n_power_series: int = 6
    n_clusters: int = 4
    lr: float = 1e-3
    warmup_iters: int = 1000
    cosine_restart_period: int = 0  # >0: CosineAnnealingWarmRestarts parity
    update_freq: int = 1  # gradient accumulation factor
    grad_clip: float = 1.0
    ema_decay: float = 0.999
    nvals: int = 256
    remat: bool = False  # recompute the flow forward in the backward pass
    kernel_sizes: tuple = (3, 3, 3)  # the reference's --kernels (3-1-3 pub.)
    remat_logdet: bool = False  # checkpoint each power-series term


def reference_capacity() -> "FlowConfig":
    """The published-model configuration: ~500k parameters on 256x256
    patches (``color-information/README.md``'s segmentation table reports
    500,388 parameters; constructor ``train_img_horo.py:324-358`` with the
    default ``--idim 128 --kernels 3-1-3``). This configuration has 502,855
    parameters (flow 491,835 + ConvGMM 11,020): 3 scales x 5 iResBlocks,
    hidden 128, 3-1-3 bottleneck kernels, and a checkpoint per logdet
    series term so that the 256^2 activations fit in device memory."""
    return FlowConfig(
        image_size=256, n_scales=3, blocks_per_scale=5, hidden=128,
        kernel_sizes=(3, 1, 3), n_power_series=6, n_clusters=4,
        warmup_iters=200, remat_logdet=True,
    )


class FlowState(NamedTuple):
    params: Any  # {"flow": {name: tensor}, "gmm": {name: tensor}}
    spectral: Any  # {name: tensor}: the flow's u and sigma buffers
    opt_state: Any  # AdamState, or MultiStepsState with update_freq > 1
    ema: EmaState
    step: int
    rng: Any  # the probes' (seed, counter): rng_state(), int64 on the CPU


def build_models(cfg: FlowConfig, device="cuda", generator=None):
    """The flow and the GMM, their weights drawn from ``generator`` (on
    ``device``; ``device="meta"`` allocates nothing)."""
    dev = _device(device)
    flow = ResidualFlow(
        n_scales=cfg.n_scales, blocks_per_scale=cfg.blocks_per_scale,
        hidden=cfg.hidden, coeff=cfg.coeff,
        n_power_series=cfg.n_power_series,
        input_shape=(1, cfg.image_size, cfg.image_size),
        kernel_sizes=tuple(cfg.kernel_sizes),
        remat_logdet=cfg.remat_logdet, device=dev, generator=generator,
    )
    gmm = ConvGMM(n_clusters=cfg.n_clusters, latent_channels=1, device=dev,
                  generator=generator)
    return flow, gmm


# ---- the optimizer: optax's clip -> adam(schedule) [-> MultiSteps] -------


class AdamState(NamedTuple):
    count: int  # updates applied; the schedule reads it before each one
    mu: Any
    nu: Any


class MultiStepsState(NamedTuple):
    mini_step: int
    gradient_step: int
    inner_opt_state: AdamState
    acc_grads: Any


class Optimizer(NamedTuple):
    """optax's ``GradientTransformation``: ``init(params) -> state``,
    ``update(grads, state, params) -> (updates, state)``; ``updates`` is
    None where MultiSteps applies nothing."""

    init: Callable
    update: Callable


def make_schedule(cfg: FlowConfig) -> Callable[[int], float]:
    """The learning rate at an update count: optax's ``join_schedules`` of
    ``linear_schedule(0, lr, warmup_iters)`` and a constant tail, or 64
    cycles of ``sgdr_schedule`` with period ``cosine_restart_period``;
    each value rounded in float32 as optax computes it."""
    lr32 = np.float32(cfg.lr)
    warm, period = cfg.warmup_iters, cfg.cosine_restart_period

    def tail(t: int) -> np.float32:
        if period <= 0:
            return lr32
        t = t - min(t // period, 63) * period
        c = np.float32(min(t, period))
        cos = np.cos(np.float32(np.pi) * c / np.float32(period))
        return lr32 * (np.float32(0.5) * (np.float32(1.0) + cos))

    def schedule(count: int) -> float:
        if count >= warm:
            return float(tail(count - warm))
        frac = np.float32(1.0) - np.float32(max(count, 0)) / np.float32(warm)
        return float(np.float32(-cfg.lr) * frac + lr32)

    return schedule


def _global_norm(grads):
    leaves = tree_leaves(grads)
    total = torch.sum(leaves[0] * leaves[0])
    for g in leaves[1:]:
        total = total + torch.sum(g * g)
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """optax's clip: ``t / norm * max_norm`` where the global norm exceeds
    ``max_norm``, else ``t`` (no epsilon, unlike ``clip_grad_norm_``)."""
    norm = _global_norm(grads)
    keep = norm < max_norm
    return tree_map(lambda t: torch.where(keep, t, (t / norm) * max_norm),
                    grads)


def adam(schedule: Callable[[int], float]) -> Optimizer:
    """``optax.adam(schedule)`` with its defaults (b1 0.9, b2 0.999, eps
    1e-8 outside the square root, bias-corrected), on pytrees of tensors:
    ``update(grads, state) -> (updates, state)``, the learning rate read at
    the count before the update."""
    b1, b2, eps = 0.9, 0.999, 1e-8

    def init(params):
        return AdamState(0, tree_map(torch.zeros_like, params),
                         tree_map(torch.zeros_like, params))

    def update(grads, state: AdamState, params=None):
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads,
                      state.nu)
        count = state.count + 1
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
        step_size = -schedule(state.count)
        updates = tree_map(
            lambda m, v: step_size * ((m / bc1) / (torch.sqrt(v / bc2) + eps)),
            mu, nu)
        return updates, AdamState(count, mu, nu)

    return Optimizer(init, update)


def make_optimizer(cfg: FlowConfig) -> Optimizer:
    """Adam + warmup + clip + accumulation (``train_img_horo.py:255-259,
    387-414,577-594``), equal to the JAX package's optax chain."""
    inner = adam(make_schedule(cfg))
    adam_init = inner.init

    def adam_update(grads, state: AdamState):
        return inner.update(clip_by_global_norm(grads, cfg.grad_clip), state)

    if cfg.update_freq <= 1:
        def update(grads, state, params=None):
            with torch.no_grad():
                return adam_update(grads, state)

        return Optimizer(adam_init, update)

    k = cfg.update_freq

    def init(params):
        return MultiStepsState(0, 0, adam_init(params),
                               tree_map(torch.zeros_like, params))

    def update_multi(grads, state: MultiStepsState, params=None):
        with torch.no_grad():
            # optax's running mean of the mini-batch gradients.
            n = float(state.mini_step + 1)
            acc = tree_map(lambda g, a: a + (g - a) / n, grads,
                           state.acc_grads)
            if state.mini_step != k - 1:
                return None, MultiStepsState(state.mini_step + 1,
                                             state.gradient_step,
                                             state.inner_opt_state, acc)
            updates, inner = adam_update(acc, state.inner_opt_state)
            return updates, MultiStepsState(
                0, state.gradient_step + 1, inner,
                tree_map(torch.zeros_like, acc))

    return Optimizer(init, update_multi)


def apply_updates(params, updates):
    if updates is None:
        return params
    with torch.no_grad():
        return tree_map(lambda p, u: p + u, params, updates)


def _update_applied(opt_state) -> bool:
    """Whether the update just made changed the parameters (MultiSteps
    applies on the last mini-step of each cycle only)."""
    return not isinstance(opt_state, MultiStepsState) or \
        opt_state.mini_step == 0


# ---- state, loss, step ----------------------------------------------------


def rng_state(seed: int, counter: int = 0) -> torch.Tensor:
    """The probes' generator state: ``(seed, counter)``, an int64 tensor on
    the CPU of one shape on every device, as the JAX package's key is. A
    step seeds a ``torch.Generator`` on its own device from both and
    advances the counter by one, so a checkpoint saved on one device
    restores into a template made on another, and a resume on one device
    draws the uninterrupted run's probes."""
    return torch.tensor([int(seed) & (2**63 - 1), int(counter)],
                        dtype=torch.int64)


def _mix(seed: int, counter: int) -> int:
    """splitmix64 of the pair: the seed of one step's generator."""
    z = (seed * 0x9E3779B97F4A7C15 + counter + 1) & (2**64 - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & (2**64 - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & (2**64 - 1)
    return z ^ (z >> 31)


def _generator(rng, device) -> torch.Generator:
    seed, counter = (int(v) for v in rng)
    return torch.Generator(device=device).manual_seed(_mix(seed, counter))


def _advance(rng) -> torch.Tensor:
    seed, counter = (int(v) for v in rng)
    return rng_state(seed, counter + 1)


def _detached(named) -> dict:
    return {k: v.detach().clone() for k, v in sorted(named)}


def init_flow_state(cfg: FlowConfig, generator, sample_hsd=None,
                    device="cuda"):
    """Build models + state on ``device``. ``generator``: a
    ``torch.Generator`` on that device, or an int seed for one; it draws
    the weights, the spectral vectors and later the probes.

    ``sample_hsd``: a real HSD batch (B, H, W, 3) for ActNorm's
    data-dependent init (the reference materializes lazy ActNorm with a
    real forward, ``train_img_horo.py:437-441``); without one, uniform
    noise on [0.05, 0.95] is used (a constant dummy would put ActNorm's
    scale at 1/eps). Returns ``(flow, gmm, state, tx)``."""
    dev = _device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, models on {dev}")
    flow, gmm = build_models(cfg, dev, generator)
    if sample_hsd is not None:
        hsd = torch.as_tensor(sample_hsd, dtype=torch.float32, device=dev)
        x0 = _density01(hsd)
    else:
        x0 = torch.rand((2, 1, cfg.image_size, cfg.image_size),
                        generator=generator, device=dev) * 0.9 + 0.05
    with torch.no_grad():
        flow(x0, skip_logdet=True, data_init=True)
    params = {"flow": _detached(flow.named_parameters()),
              "gmm": _detached(gmm.named_parameters())}
    tx = make_optimizer(cfg)
    state = FlowState(
        params=params,
        spectral=_detached(flow.named_buffers()),
        opt_state=tx.init(params),
        ema=ema_init(params, cfg.ema_decay),
        step=0,
        rng=rng_state(generator.initial_seed()),
    )
    return flow, gmm, state, tx


def _density01(hsd):
    """The flow's input: D / 4 clipped to (0, 1), NCHW (B, 1, H, W)."""
    d = torch.clamp(hsd[..., 2:3] / 4.0, 1e-4, 1.0 - 1e-4)
    return d.permute(0, 3, 1, 2)


def hsd_loss_fn(flow, gmm, cfg: FlowConfig, params, spectral, hsd,
                probes=None, generator=None):
    """bits/dim of the density channel under flow+GMM (``compute_loss``,
    ``train_img_horo.py:466-501``): D -> flow -> z; GMM conditioned on
    chroma; logpx = logpz - delta_logp - log(nvals)*dims. ``probes``: one
    tensor per block (``flow.draw_probes``), else drawn from ``generator``
    here, before any checkpoint, so a recompute sees the same draws.
    Returns (mean bpd, (mu, sigma, gamma))."""
    d01 = _density01(hsd)
    cond = hsd[..., :2].permute(0, 3, 1, 2)
    if probes is None:
        probes = flow.draw_probes(d01.shape, generator, d01.device)

    def flow_fwd(p, x):
        return functional_call(flow, {**p, **spectral}, (x,),
                               {"probes": probes})

    if cfg.remat:
        # Trade FLOPs for memory: recompute the flow's activations in the
        # backward pass (the reference's --mem-eff flags, train_img_horo.py:
        # 91-98). The parameters are arguments, so the recompute binds the
        # same tensors.
        z, delta_logp = checkpoint(flow_fwd, params["flow"], d01,
                                   use_reentrant=False)
    else:
        z, delta_logp = flow_fwd(params["flow"], d01)
    logpz, aux = functional_call(gmm, params["gmm"], (z, cond))
    bpd = bits_per_dim(logpz, delta_logp, (cfg.image_size, cfg.image_size, 1),
                       cfg.nvals)
    return bpd.mean(), aux


def loss_and_grads(flow, gmm, cfg: FlowConfig, params, spectral, hsd,
                   probes=None, generator=None):
    """(loss, grads): the loss of :func:`hsd_loss_fn` and its gradients
    with respect to ``params``, by autograd (``torch.func.grad`` does not
    compose with the logdet's checkpoints)."""
    leaves, spec = tree_flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss, _ = hsd_loss_fn(flow, gmm, cfg, tree_unflatten(live, spec),
                              spectral, hsd, probes, generator)
        grads = torch.autograd.grad(loss, live)
    return loss.detach(), tree_unflatten(list(grads), spec)


def make_train_step(flow, gmm, cfg: FlowConfig, tx: Optimizer, mesh=None,
                    axis: str = "data"):
    """One update: ``step(state, hsd, probes=None) -> (state, loss)``.

    In order: the loss and its gradients on the state's (old) spectral
    buffers; with a mesh, both averaged over ``axis`` in rank order
    (``pmean_grads``, the DistributedOptimizer equivalent; ``hsd`` is then
    this rank's rows); the optimizer update; the EMA, where the update was
    applied; the Lipschitz refresh with the new parameters from the old
    spectral state. The probes are drawn from a generator seeded by the
    state's ``rng`` (:func:`rng_state`), which every rank holds alike, at
    this rank's shape, as every shard of the JAX package's step splits the
    same key."""

    def step(state: FlowState, hsd, probes=None):
        rng = state.rng
        if probes is None:
            gen = _generator(rng, hsd.device)
            probes = flow.draw_probes(_density01(hsd).shape, gen, hsd.device)
            rng = _advance(rng)
        loss, grads = loss_and_grads(flow, gmm, cfg, state.params,
                                     state.spectral, hsd, probes)
        if mesh is not None:
            grads = pmean_grads(grads, mesh, axis)
            loss = pmean_grads(loss, mesh, axis)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = apply_updates(state.params, updates)
        # EMA advances once per REAL optimizer update (the reference applies
        # it after each optimizer.step(), train_img_horo.py:594): decaying
        # the shadow toward parameters that an accumulation step left
        # unchanged would shrink its horizon by update_freq.
        ema = ema_update(state.ema, params) if _update_applied(opt_state) \
            else state.ema
        # Post-step Lipschitz refresh (train_img_horo.py:1089-1095).
        spectral = update_lipschitz(flow, params["flow"], state.spectral)
        return FlowState(params, spectral, opt_state, ema, state.step + 1,
                         rng), loss

    return step


@torch.no_grad()
def encode(flow, gmm, params, spectral, cfg: FlowConfig, hsd, probes=None,
           generator=None):
    """Eval-mode pass returning (bpd, z, gamma) for deployment/validation;
    gamma (B, K, H, W) is upsampled back to the image grid.

    The flow is fully convolutional (the spectral vectors, its only
    size-bound state, are not used in a forward pass), so ``hsd`` may be
    any spatial size divisible by the squeeze factor; bpd and gamma follow
    the input's size, not ``cfg.image_size``."""
    h, w = hsd.shape[-3], hsd.shape[-2]
    d01 = _density01(hsd)
    z, delta_logp = functional_call(
        flow, {**params["flow"], **spectral}, (d01,),
        {"probes": probes, "generator": generator})
    logpz, (_, _, gamma) = functional_call(
        gmm, params["gmm"], (z, hsd[..., :2].permute(0, 3, 1, 2)))
    bpd = bits_per_dim(logpz, delta_logp, (h, w, 1), cfg.nvals)
    return bpd, z, upsample_gamma(gamma, h, w)
