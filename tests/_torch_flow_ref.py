"""Shared helpers for the flow port's parity tests: the JAX package's
state and probe draws, carried into the port's layout.

The JAX side runs on the CPU; arrays cross as numpy. The probes are the
JAX package's own ``jax.random.rademacher`` draws, recomputed from the
same key splits as ``ResidualFlow.__call__`` makes them (one split per
block, in block order), transposed to NCHW and given to the port
explicitly.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from stainlib_tpu.models import train_flow as jtf
from stainlib_tpu.ops.colorspace import rgb_to_hsd
from stainlib_tpu.utils.ema import ema_init
from stainlib_tpu_torch.convert import flow_state_from_jax
from stainlib_tpu_torch.models import train_flow as ttf
from synth import he_batch


# The JAX side's programs are small and run once: compile them with XLA's
# cheap CPU pipeline (about 2.5x less compile time, the same loss bits on
# the trainer's step).
_CHEAP_XLA = {"xla_backend_optimization_level": 0,
              "xla_llvm_disable_expensive_passes": True}


def jit(fn):
    """``jax.jit`` with XLA's cheap CPU compile options."""
    return jax.jit(fn, compiler_options=_CHEAP_XLA)


def hsd_batch(n: int, side: int, seed: int) -> np.ndarray:
    rgb = he_batch(n, side, side, seed=seed, background_frac=0.0)
    return np.asarray(rgb_to_hsd(jnp.asarray(rgb)), np.float32)


def port_cfg(cfg) -> ttf.FlowConfig:
    return ttf.FlowConfig(**dataclasses.asdict(cfg))


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def block_shapes(cfg, batch: int, side: int) -> list:
    """Each block's input shape (NHWC) for a (batch, side, side, 1) input."""
    shapes, c, h = [], 1, side
    for _ in range(cfg.n_scales):
        shapes += [(batch, h, h, c)] * cfg.blocks_per_scale
        c, h = c * 4, h // 2
    return shapes


def rademacher(key, shape) -> torch.Tensor:
    """One JAX Rademacher draw, as the port's (1, B, C, H, W) probe."""
    return nchw(jax.random.rademacher(key, shape, jnp.float32))[None]


def flow_probes(key, shapes) -> list:
    """The probes ``ResidualFlow.__call__`` draws from ``key``."""
    out = []
    for shape in shapes:
        key, sub = jax.random.split(key)
        out.append(rademacher(sub, shape))
    return out


def step_probes(state, shapes) -> list:
    """The probes of the JAX train step from ``state`` (its loss key)."""
    return flow_probes(jax.random.split(state.key, 3)[0], shapes)


def random_variables(module, seed, *args):
    """flax variables of ``module``'s shapes, drawn with numpy: kernels
    N(0, 1/fan_in), other parameters N(0, 0.1), spectral ``u`` N(0, 1) and
    ``sigma`` 1 as at init (``jax.eval_shape`` traces; nothing compiles)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, *args)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "sigma" in name:
            return jnp.ones(leaf.shape, jnp.float32)
        std = (1.0 / np.prod(leaf.shape[:-1]) ** 0.5 if "kernel" in name
               else 1.0 if "'u'" in name else 0.1)
        return jnp.asarray(rng.normal(0, std, leaf.shape), jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_init(cfg, key, seed: int = 0):
    """A JAX ``FlowState`` as ``init_flow_state`` lays it out, with its
    variables drawn by :func:`random_variables` (the eager init compiles
    each block's scan anew): (flow, gmm, state, tx)."""
    flow, gmm = jtf.build_models(cfg)
    x0 = jnp.full((1, cfg.image_size, cfg.image_size, 1), 0.5)
    fvars = random_variables(flow, seed, key, x0, key)
    z0 = jax.eval_shape(lambda v: flow.apply(v, x0, key)[0], fvars)
    gvars = random_variables(gmm, seed + 1, key, jnp.zeros(z0.shape),
                             jnp.zeros(x0.shape[:3] + (2,)))
    params = {"flow": fvars["params"], "gmm": gvars["params"]}
    tx = jtf.make_optimizer(cfg)
    state = jtf.FlowState(params=params, spectral=fvars["spectral"],
                          opt_state=tx.init(params),
                          ema=ema_init(params, cfg.ema_decay),
                          step=jnp.int32(0), key=key)
    return flow, gmm, state, tx


def to_port(state, with_opt: bool = True) -> ttf.FlowState:
    """A JAX ``FlowState`` -> the port's on the CPU."""
    host = jax.tree.map(np.asarray, state)
    return flow_state_from_jax(
        host.params, host.spectral,
        host.opt_state if with_opt else None,
        host.ema if with_opt else None, step=int(host.step), device="cpu")


def port_tree(tree) -> dict:
    """A JAX params-shaped pytree (gradients, updates) in the port's
    names and layout."""
    return flow_state_from_jax(jax.tree.map(np.asarray, tree), {},
                               device="cpu").params


def assert_tree_close(got: dict, want: dict, rtol=0.0, atol=0.0):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            assert_tree_close(got[k], want[k], rtol, atol)
        else:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=rtol, atol=atol, err_msg=k)
