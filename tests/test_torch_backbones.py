"""The port's DANN backbones against the JAX package's, on the CPU.

``MobileNetBackbone`` / ``MobileNetDann`` at alpha 0.5 on 32x32 inputs
(the parameter count does not depend on the size), batch 4, and
``DannCNNGap`` at 63x63, batch 8; float32 inputs in [0, 1]. JAX's
variables are numpy draws of the flax shapes, carried over by
``convert.mobilenet_dann_from_jax`` / ``dann_state_from_jax``.

Tolerances: inference logits atol 1e-5 times their largest magnitude; the
TF-SAME stride-2 and depthwise convolutions atol 1e-5; training mode
(dropout off on both sides) through the float64 triangulation of
``tests/test_torch_dann.py``: the port's float32 within TIGHT, JAX's
within LOOSE, of the port's float64 (MobileNet's training-mode logits
1e-4 / 1e-3 of their largest magnitude: its last BatchNorms normalize 8
values per channel); the trunk's 829,536 exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_flow_ref import jit
from stainlib_tpu.models import backbones as jb
from stainlib_tpu.models import dann as jd
from stainlib_tpu_torch import convert
from stainlib_tpu_torch.models import _nets
from stainlib_tpu_torch.models import backbones as tb
from test_torch_dann import (
    LOGIT_RTOL, LOOSE, TIGHT, _host, _jax_loss_and_grads, _rel_close,
    _triangulate, flax_variables, no_dropout)  # noqa: F401  (a fixture)

TRUNK = 829_536


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(seed, n=4, side=32):
    rng = np.random.default_rng(seed)
    return (rng.random((n, side, side, 3)).astype(np.float32),
            rng.integers(0, 2, n), rng.integers(0, 2, n))


@pytest.fixture(scope="module")
def mobilenet():
    model = jb.MobileNetDann(n_domains=2, bn_momentum=0.9)
    v = flax_variables(model, 1, jax.random.PRNGKey(0),
                       jnp.zeros((1, 32, 32, 3)), train=False)
    return model, v


def test_trunk_counts_829536_like_keras_and_jax():
    shapes = jax.eval_shape(
        lambda k: jb.MobileNetBackbone(alpha=0.5).init(
            k, jnp.zeros((1, 32, 32, 3)), train=False), jax.random.PRNGKey(0))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    trunk = tb.MobileNetBackbone(alpha=0.5, device="cpu")
    assert tb.trunk_size(trunk) == n_jax == TRUNK
    dann_shapes = jax.eval_shape(
        lambda k: jb.MobileNetDann(n_domains=2).init(
            k, jnp.zeros((1, 32, 32, 3)), train=False),
        jax.random.PRNGKey(0))
    n_params = sum(int(np.prod(a.shape))
                   for a in jax.tree.leaves(dann_shapes["params"]))
    model = tb.MobileNetDann(n_domains=2, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == n_params


@pytest.mark.parametrize("side", [32, 33])
def test_same_padding_at_stride_2_is_tensorflows(side):
    """flax's ``padding="SAME"`` at stride 2 pads 0 before and 1 after on an
    even side (1 and 1 on an odd one); ``Conv2d(padding=1)`` would shift the
    output on the even side."""
    rng = np.random.default_rng(side)
    x = rng.normal(size=(2, side, side, 6)).astype(np.float32)
    k = rng.normal(size=(3, 3, 6, 5)).astype(np.float32)
    conv = jax.numpy.asarray
    want = np.asarray(jax.lax.conv_general_dilated(
        conv(x), conv(k), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    mod = _nets.Conv(6, 5, 3, 2, bias=False, device="cpu")
    w = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    got = torch.func.functional_call(mod, {"weight": w}, (
        torch.from_numpy(x).permute(0, 3, 1, 2),)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    sym = torch.nn.functional.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                                     w, stride=2, padding=1)
    shifted = np.abs(sym.permute(0, 2, 3, 1).numpy() - want).max() > 1e-3
    assert shifted == (side % 2 == 0)


def test_depthwise_conv_layout():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    k = rng.normal(size=(3, 3, 1, 4)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=4))
    flat = convert._net_flat({"Conv_0": {"kernel": k}}, "cpu")
    assert flat["Conv_0.weight"].shape == (4, 1, 3, 3)
    mod = _nets.Conv(4, 4, 3, groups=4, bias=False, device="cpu")
    got = torch.func.functional_call(mod, {"weight": flat["Conv_0.weight"]}, (
        torch.from_numpy(x).permute(0, 3, 1, 2),)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_mobilenet_dann_eval_mode_matches_jax(mobilenet):
    model, v = mobilenet
    x, _, _ = _x(2)
    ml, dl = jit(lambda v, x: model.apply(v, x, train=False))(
        v, jnp.asarray(x))
    tm = tb.MobileNetDann(n_domains=2, bn_momentum=0.9, device="cpu")
    st = convert.mobilenet_dann_from_jax(v, device="cpu")
    names = {k for k, _ in tm.named_parameters()} | {
        k for k, _ in tm.named_buffers()}
    assert set(st.params) | set(st.batch_stats) == names
    gm, gd = torch.func.functional_call(tm, {**st.params, **st.batch_stats},
                                        (x,), {"train": False})
    for got, want in ((gm, ml), (gd, dl)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want,
                                   atol=LOGIT_RTOL * np.abs(want).max())


def test_mobilenet_dann_train_mode_matches_jax(mobilenet):
    """A training-mode forward at batch 8: the logits and the moved
    BatchNorm statistics through the float64 triangulation (the trunk's
    last BatchNorms see 8 values per channel at 32^2)."""
    model, v = mobilenet
    x, _, _ = _x(3, n=8)
    (ml, _), upd = jit(lambda v, x: model.apply(
        v, x, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
    st = convert.mobilenet_dann_from_jax(v, device="cpu")
    want = convert.mobilenet_dann_from_jax(
        {"params": v["params"], "batch_stats": _host(upd["batch_stats"])},
        device="cpu").batch_stats
    out = {}
    for dt in (torch.float32, torch.float64):
        tm = tb.MobileNetDann(n_domains=2, bn_momentum=0.9,
                              device="cpu").to(dt)
        stats = {}
        logits, _ = torch.func.functional_call(
            tm, {k: t.to(dt) for k, t in {**st.params,
                                          **st.batch_stats}.items()},
            (x,), {"train": True, "stats": stats})
        out[dt] = ({"logits": logits.detach()}, stats)
    (l32, s32), (l64, s64) = out[torch.float32], out[torch.float64]
    _rel_close(l32, l64, 1e-4)
    _rel_close({"logits": torch.from_numpy(np.asarray(ml))}, l64, 1e-3)
    _rel_close(s32, s64, TIGHT["stats"])
    _rel_close(want, s64, LOOSE["stats"])


@pytest.mark.parametrize("rate", [0.25, 0.0])
def test_dann_cnn_gap_matches_jax(rate, no_dropout):
    model = jb.DannCNNGap(n_domains=3, dropout=rate)
    v = flax_variables(model, 5, jax.random.PRNGKey(0),
                       jnp.zeros((1, 63, 63, 3)), train=False)
    rng = np.random.default_rng(6)
    x = rng.random((8, 63, 63, 3)).astype(np.float32)
    my, dy = rng.integers(0, 2, 8), rng.integers(0, 3, 8)
    ml, dl = model.apply(v, jnp.asarray(x), train=False)
    st = convert.dann_state_from_jax(v["params"], v["batch_stats"],
                                     device="cpu")
    tm = tb.DannCNNGap(n_domains=3, dropout=rate, device="cpu")
    gm, gd = torch.func.functional_call(tm, {**st.params, **st.batch_stats},
                                        (x,), {"train": False})
    for got, want in ((gm, ml), (gd, dl)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want,
                                   atol=LOGIT_RTOL * np.abs(want).max())
    (loss, upd), grads = _jax_loss_and_grads(model, v, x, my, dy,
                                             jd.PHASE_ADVERSARIAL)
    want = convert.dann_state_from_jax(_host(grads),
                                       _host(upd["batch_stats"]),
                                       device="cpu")
    _triangulate(lambda: tb.DannCNNGap(n_domains=3, dropout=rate,
                                       device="cpu"),
                 st, x, my, dy, jd.PHASE_ADVERSARIAL, loss, want.params,
                 want.batch_stats)


def test_gap_dropout_follows_the_generator():
    tm = tb.DannCNNGap(n_domains=2, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    x = torch.rand((4, 63, 63, 3), generator=torch.Generator().manual_seed(1))

    def run(seed):
        return tm(x, train=True, stats={},
                  generator=torch.Generator().manual_seed(seed))[0]

    assert torch.equal(run(3), run(3)) and not torch.equal(run(3), run(4))
    assert torch.equal(tm(x, train=False)[0], tm(x, train=False)[0])
