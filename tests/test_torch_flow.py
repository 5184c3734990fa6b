"""The flow + GMM colour model: the port against the JAX package.

Each layer, ``ResidualFlow``, ``update_lipschitz``, ``ConvGMM`` and
``bits_per_dim`` of ``stainlib_tpu_torch.models`` on the same inputs,
parameters and Rademacher probes as the JAX package's, on the CPU. The
JAX weights reach the port through ``convert.flow_state_from_jax``
(HWIO -> OIHW, NHWC -> NCHW).

Tolerances: float32 layer outputs and latents atol 1e-5; logdets and bpd
rtol 1e-5 (sums of a few hundred float32 terms, added in another order);
gradients rtol 1e-4 with atol 1e-6 (a backward pass through a
jvp chain, the rounding of each term compounding); the squeeze, which
only moves values, exactly.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from _torch_flow_ref import (
    block_shapes, flow_probes, jit, nchw, rademacher, random_variables)
from stainlib_tpu.models import flow_layers as jfl
from stainlib_tpu.models import gmm as jgmm
from stainlib_tpu.models import resflow as jrf
from stainlib_tpu.models import train_flow as jtf
from stainlib_tpu_torch.convert import _flat_from_jax
from stainlib_tpu_torch.models import flow_layers as tfl
from stainlib_tpu_torch.models import gmm as tgmm
from stainlib_tpu_torch.models import resflow as trf
from stainlib_tpu_torch.models import train_flow as ttf

KEY = jax.random.PRNGKey(0)
ATOL = 1e-5  # float32 layer outputs and latents
RTOL_LOGDET = 1e-5  # logdets, bpd, logpz
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small ops: one intra-op thread, so that a test
    worker does not oversubscribe the cores beside the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().numpy()


def _x(shape, seed, lo=0.05, hi=0.95):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _bind(module, variables):
    """The module's tensors from flax ``variables`` (params and spectral)."""
    named = _flat_from_jax(variables.get("params", {}), "cpu")
    named.update(_flat_from_jax(variables.get("spectral", {}), "cpu"))
    return named


def test_squeeze_matches_jax_channel_order():
    x = np.arange(2 * 4 * 6 * 3, dtype=np.float32).reshape(2, 4, 6, 3)
    want = np.asarray(jfl.squeeze(jnp.asarray(x)))
    got = tfl.squeeze(nchw(x))
    assert got.shape == (2, 12, 2, 3)
    np.testing.assert_array_equal(_np(got), want.transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(_np(tfl.unsqueeze(got)),
                                  x.transpose(0, 3, 1, 2))


def test_logit_transform_forward_and_inverse():
    x = _x((2, 4, 4, 1), 0)
    jl = jfl.LogitTransform()
    y, ld = jl(jnp.asarray(x))
    back, ld_inv = jl(y, reverse=True)
    tl = tfl.LogitTransform()
    ty, tld = tl(nchw(x))
    tback, tld_inv = tl.inverse(ty)
    np.testing.assert_allclose(_np(ty), nchw(y).numpy(), atol=ATOL)
    np.testing.assert_allclose(_np(tld), ld, rtol=RTOL_LOGDET)
    np.testing.assert_allclose(_np(tback), nchw(back).numpy(), atol=ATOL)
    np.testing.assert_allclose(_np(tld_inv), ld_inv, rtol=RTOL_LOGDET)


def test_actnorm_data_init_forward_and_inverse():
    x = np.random.default_rng(1).normal(3.0, 2.0, (8, 4, 4, 2)).astype(
        np.float32)
    layer = jfl.ActNorm()
    variables = layer.init(KEY, jnp.asarray(x))
    y, ld = layer.apply(variables, jnp.asarray(x))
    back, ld_inv = layer.apply(variables, y, reverse=True)
    t = tfl.ActNorm(2)
    ty, tld = t(nchw(x), data_init=True)
    for name in ("bias", "logs"):
        np.testing.assert_allclose(_np(getattr(t, name)),
                                   variables["params"][name], atol=1e-6)
    tback, tld_inv = t.inverse(ty)
    np.testing.assert_allclose(_np(ty), nchw(y).numpy(), atol=ATOL)
    np.testing.assert_allclose(_np(tld), ld, rtol=RTOL_LOGDET)
    np.testing.assert_allclose(_np(tback), nchw(back).numpy(), atol=ATOL)
    np.testing.assert_allclose(_np(tld_inv), ld_inv, rtol=RTOL_LOGDET)


@pytest.mark.parametrize("k", [3, 1])
def test_spectral_norm_conv_and_power_iteration(k):
    """The conv before and after a refresh, the power iteration (conv and
    its adjoint, ``conv_transpose2d``) and sigma, on a kernel inflated so
    that the norm exceeds the budget."""
    x = np.random.default_rng(2).normal(0, 1, (2, 8, 8, 3)).astype(np.float32)
    conv = jfl.SpectralNormConv(features=4, kernel_size=k, coeff=0.9,
                                input_shape=(8, 8, 3), n_iters=5)
    variables = conv.init(KEY, jnp.asarray(x))
    params = {"kernel": variables["params"]["kernel"] * 20.0,
              "bias": variables["params"]["bias"] + 0.1}
    before = conv.apply({"params": params, "spectral": variables["spectral"]},
                        jnp.asarray(x))
    after, sp = conv.apply({"params": params,
                            "spectral": variables["spectral"]},
                           jnp.asarray(x), update=True, mutable=["spectral"])

    t = tfl.SpectralNormConv(3, 4, kernel_size=k, coeff=0.9, n_iters=5,
                             input_hw=(8, 8))
    assert float(t.sigma) == 1.0  # before the first refresh: min(1, coeff)
    named = _bind(t, {"params": params, "spectral": variables["spectral"]})
    np.testing.assert_allclose(
        _np(functional_call(t, named, (nchw(x),))), nchw(before).numpy(),
        atol=ATOL)
    u, sigma = tfl.power_iteration(named["weight"], named["u"], 5)
    np.testing.assert_allclose(_np(u), nchw(sp["spectral"]["u"]).numpy(),
                               atol=ATOL)
    np.testing.assert_allclose(float(sigma), float(sp["spectral"]["sigma"]),
                               rtol=RTOL_LOGDET)
    named.update(u=u, sigma=sigma)
    np.testing.assert_allclose(
        _np(functional_call(t, named, (nchw(x),))), nchw(after).numpy(),
        atol=ATOL)


def _jax_block(n_probes=1, remat=False, shape=(8, 8, 2)):
    return jrf.IResBlock(hidden=8, coeff=0.9, n_power_series=3,
                         n_probes=n_probes, input_shape=shape,
                         kernel_sizes=(3, 1, 3), remat_logdet=remat)


def _port_block(n_probes=1, remat=False, shape=(8, 8, 2)):
    h, w, c = shape
    return trf.IResBlock(c, hidden=8, coeff=0.9, n_power_series=3,
                         n_probes=n_probes, input_hw=(h, w),
                         kernel_sizes=(3, 1, 3), remat_logdet=remat)


def _block_probes(key, n_probes, shape):
    if n_probes == 1:
        return rademacher(key, shape)
    return torch.cat([rademacher(k, shape)
                      for k in jax.random.split(key, n_probes)])


@pytest.mark.parametrize("n_probes", [1, 3])
def test_iresblock_forward_logdet_and_inverse_with_jax_probes(n_probes):
    x = np.random.default_rng(4).normal(0, 1, (2, 8, 8, 2)).astype(np.float32)
    block = _jax_block(n_probes)
    variables = random_variables(block, 1, KEY, jnp.asarray(x), KEY)
    key = jax.random.PRNGKey(7)
    y, ld = jit(block.apply)(variables, jnp.asarray(x), key)

    t = _port_block(n_probes)
    named = _bind(t, variables)
    ty, tld = functional_call(t, named, (nchw(x),),
                              {"probe": _block_probes(key, n_probes, x.shape)})
    np.testing.assert_allclose(_np(ty), nchw(y).numpy(), atol=ATOL)
    np.testing.assert_allclose(_np(tld), ld, rtol=RTOL_LOGDET)
    if n_probes == 1:  # the inverse does not depend on the probes
        back = jit(lambda v, y: block.apply(v, y, method="inverse"))(
            variables, y)
        t.load_state_dict(named)
        tback = t.inverse(nchw(np.asarray(y)))
        np.testing.assert_allclose(_np(tback), nchw(back).numpy(), atol=ATOL)
        np.testing.assert_allclose(_np(tback), nchw(x).numpy(), atol=1e-4)


@pytest.mark.parametrize("remat", [False, True])
def test_logdet_gradient_matches_jax_through_checkpoints(remat):
    """The jvp-chained series backpropagates to the parameters, also with a
    checkpoint per term (``torch.utils.checkpoint(use_reentrant=False)``):
    the gradient of the logdet equals JAX's."""
    x = np.random.default_rng(5).normal(0, 1, (2, 8, 8, 2)).astype(np.float32)
    block = _jax_block(remat=remat)
    variables = random_variables(block, 2, KEY, jnp.asarray(x), KEY)
    key = jax.random.PRNGKey(9)

    def jloss(p):
        return jnp.sum(block.apply({"params": p,
                                    "spectral": variables["spectral"]},
                                   jnp.asarray(x), key)[1])

    jgrad = jit(jax.grad(jloss))(variables["params"])

    t = _port_block(remat=remat)
    named = _bind(t, variables)
    params = {k: v.requires_grad_() for k, v in named.items()
              if k.endswith(("weight", "bias"))}
    _, tld = functional_call(t, {**named, **params}, (nchw(x),),
                             {"probe": rademacher(key, x.shape)})
    # The last conv's bias does not reach the Jacobian: JAX's gradient
    # there is zero, autograd's None.
    grads = torch.autograd.grad(tld.sum(), list(params.values()),
                                allow_unused=True)
    want = _flat_from_jax(jgrad, "cpu")
    assert not want["g.convs.2.bias"].any()
    for name, g in zip(params, grads):
        g = torch.zeros_like(want[name]) if g is None else g
        np.testing.assert_allclose(_np(g), _np(want[name]), err_msg=name,
                                   **GRAD_TOL)


def test_exact_logdet_4x4x1():
    x = np.random.default_rng(6).normal(0, 1, (2, 4, 4, 1)).astype(np.float32)
    block = jrf.IResBlock(hidden=8, coeff=0.7, input_shape=(4, 4, 1))
    variables = random_variables(block, 3, KEY, jnp.asarray(x), KEY)
    y, ld = jit(lambda v, x: block.apply(v, x, KEY, exact_logdet=True))(
        variables, jnp.asarray(x))
    t = trf.IResBlock(1, hidden=8, coeff=0.7, input_hw=(4, 4))
    ty, tld = functional_call(t, _bind(t, variables), (nchw(x),),
                              {"exact_logdet": True})
    np.testing.assert_allclose(_np(ty), nchw(y).numpy(), atol=ATOL)
    np.testing.assert_allclose(_np(tld), ld, rtol=RTOL_LOGDET)


@pytest.fixture(scope="module")
def flow16():
    """A 16^2, 2-scale JAX flow with drawn variables, its input and its
    probes, and the port's flow with the same tensors."""
    cfg = jtf.FlowConfig(image_size=16, n_scales=2, blocks_per_scale=2,
                         hidden=8, n_power_series=4, kernel_sizes=(3, 1, 3))
    flow, _ = jtf.build_models(cfg)
    x = _x((3, 16, 16, 1), 8)
    variables = random_variables(flow, 4, KEY, jnp.asarray(x), KEY)
    key = jax.random.PRNGKey(11)
    probes = flow_probes(key, block_shapes(cfg, 3, 16))
    tflow, _ = ttf.build_models(ttf.FlowConfig(
        image_size=16, n_scales=2, blocks_per_scale=2, hidden=8,
        n_power_series=4, kernel_sizes=(3, 1, 3)), "cpu")
    return dict(cfg=cfg, flow=flow, variables=variables, x=x, key=key,
                probes=probes, tflow=tflow, named=_bind(tflow, variables))


def test_residual_flow_forward_and_inverse_16_two_scales(flow16):
    f = flow16
    z, dl = jit(f["flow"].apply)(f["variables"], jnp.asarray(f["x"]),
                                     f["key"])
    back = jit(lambda v, z: f["flow"].apply(v, z, method="inverse"))(
        f["variables"], z)
    tz, tdl = functional_call(f["tflow"], f["named"], (nchw(f["x"]),),
                              {"probes": f["probes"]})
    assert tz.shape == (3, 4, 8, 8)
    np.testing.assert_allclose(_np(tz), nchw(z).numpy(), atol=ATOL)
    np.testing.assert_allclose(_np(tdl), dl, rtol=RTOL_LOGDET)
    f["tflow"].load_state_dict(f["named"])
    tback = f["tflow"].inverse(nchw(np.asarray(z)))
    np.testing.assert_allclose(_np(tback), nchw(back).numpy(), atol=ATOL)
    np.testing.assert_allclose(_np(tback), nchw(f["x"]).numpy(), atol=1e-4)


def test_update_lipschitz_matches_jax(flow16):
    f = flow16
    params = jax.tree.map(lambda k: k * 3.0, f["variables"]["params"])
    variables = {"params": params, "spectral": f["variables"]["spectral"]}
    new = jit(lambda v, x, k: jrf.update_lipschitz(f["flow"], v, x, k))(
        variables, jnp.asarray(f["x"]), f["key"])
    tparams = _flat_from_jax(params, "cpu")
    tspec = _flat_from_jax(f["variables"]["spectral"], "cpu")
    got = trf.update_lipschitz(f["tflow"], tparams, tspec)
    want = _flat_from_jax(new["spectral"], "cpu")
    assert set(got) == set(want) and len(got) == 24  # 12 convs' u, sigma
    for k in want:
        if k.endswith(".u"):
            np.testing.assert_allclose(_np(got[k]), _np(want[k]), atol=ATOL,
                                       err_msg=k)
        else:
            assert float(want[k]) > 1.0  # the refresh moved sigma
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=RTOL_LOGDET, err_msg=k)
    assert all(torch.equal(tspec[k], _flat_from_jax(
        f["variables"]["spectral"], "cpu")[k]) for k in tspec)  # unchanged


def test_conv_gmm_and_upsample_gamma():
    rng = np.random.default_rng(12)
    z = rng.normal(0, 1, (2, 8, 8, 4)).astype(np.float32)
    cond = rng.normal(0, 0.3, (2, 16, 16, 2)).astype(np.float32)
    gmm = jgmm.ConvGMM(n_clusters=3, latent_channels=1)
    variables = jit(gmm.init)(KEY, jnp.asarray(z), jnp.asarray(cond))
    variables = jax.tree.map(lambda a: a + 0.05, variables)  # mu, sigma move
    logpz, (mu, sigma, gamma) = jit(gmm.apply)(
        variables, jnp.asarray(z), jnp.asarray(cond))
    t = tgmm.ConvGMM(n_clusters=3, latent_channels=1)
    tlogpz, (tmu, tsigma, tgamma) = functional_call(
        t, _flat_from_jax(variables["params"], "cpu"), (nchw(z), nchw(cond)))
    np.testing.assert_allclose(_np(tlogpz), logpz, rtol=RTOL_LOGDET)
    np.testing.assert_allclose(_np(tmu), mu, atol=ATOL)
    np.testing.assert_allclose(_np(tsigma), sigma, atol=ATOL)
    assert tgamma.shape == (2, 3, 8, 8)
    np.testing.assert_allclose(_np(tgamma), nchw(gamma).numpy(), atol=ATOL)
    up = jgmm.upsample_gamma(gamma, 16, 16)
    np.testing.assert_allclose(_np(tgmm.upsample_gamma(tgamma, 16, 16)),
                               nchw(up).numpy(), atol=ATOL)


def test_bits_per_dim_matches_jax():
    rng = np.random.default_rng(13)
    logpz = rng.normal(-300, 50, 5).astype(np.float32)
    dlp = rng.normal(-600, 80, 5).astype(np.float32)
    for shape, nvals in (((16, 16, 1), 256), ((256, 256, 1), 256),
                         ((32, 32, 3), 255)):
        want = jgmm.bits_per_dim(jnp.asarray(logpz), jnp.asarray(dlp), shape,
                                 nvals)
        got = tgmm.bits_per_dim(torch.from_numpy(logpz),
                                torch.from_numpy(dlp), shape, nvals)
        np.testing.assert_allclose(_np(got), want, rtol=RTOL_LOGDET)


def test_reference_capacity_param_count_on_meta():
    """502,855 parameters in both packages: the port's counted on the
    ``meta`` device (nothing allocated), JAX's through ``eval_shape``."""
    cfg = ttf.reference_capacity()
    flow, gmm = ttf.build_models(cfg, "meta")
    n_flow = sum(p.numel() for p in flow.parameters())
    n_gmm = sum(p.numel() for p in gmm.parameters())
    assert (n_flow, n_gmm) == (491_835, 11_020)
    assert all(p.is_meta for p in flow.parameters())

    jcfg = jtf.reference_capacity()
    jflow, jg = jtf.build_models(jcfg)
    x0 = jnp.full((1, 256, 256, 1), 0.5)
    fvars = jax.eval_shape(lambda: jflow.init(KEY, x0, KEY))
    z = jax.eval_shape(lambda v: jflow.apply(v, x0, KEY)[0], fvars)
    gvars = jax.eval_shape(lambda: jg.init(KEY, jnp.zeros(z.shape),
                                           jnp.zeros((1, 256, 256, 2))))
    n = sum(math.prod(p.shape) for p in jax.tree.leaves(fvars["params"]))
    n += sum(math.prod(p.shape) for p in jax.tree.leaves(gvars["params"]))
    assert n == n_flow + n_gmm == 502_855


def test_initializers_draw_the_jax_distributions():
    """Kernels N(0, 1/(k k C_in)), zero biases, u standard normal, sigma 1;
    the GMM's convs flax's lecun_normal (truncated at 2 sd, variance
    1/fan_in), mu linspace(-1, 1), log_sigma 0; all from the generator."""
    g = torch.Generator().manual_seed(0)
    conv = tfl.SpectralNormConv(64, 128, 3, input_hw=(32, 32), generator=g)
    w = _np(conv.weight)
    assert abs(w.std() - math.sqrt(1 / (9 * 64))) < 0.01 * w.std()
    assert abs(w.mean()) < 0.01 * w.std() and not _np(conv.bias).any()
    assert abs(_np(conv.u).std() - 1.0) < 0.01 and float(conv.sigma) == 1.0
    gmm = tgmm.ConvGMM(n_clusters=4, hidden=32, cond_channels=64, generator=g)
    w = _np(gmm.convs[0].weight)
    std = math.sqrt(1 / (9 * 64))
    assert abs(w.std() - std) < 0.02 * std
    assert np.abs(w).max() <= 2 * std / 0.87962566103423978
    # jnp.linspace rounds its interior points through XLA's fused
    # arithmetic: within one float32 ulp of torch.linspace's.
    np.testing.assert_allclose(_np(gmm.mu)[:, 0], jnp.linspace(-1.0, 1.0, 4),
                               rtol=0, atol=1.2e-7)
    assert not _np(gmm.log_sigma).any()
    again = tfl.SpectralNormConv(64, 128, 3, input_hw=(32, 32),
                                 generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.weight, conv.weight)
