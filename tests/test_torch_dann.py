"""The port's DANN models, optimizer and step against the JAX package's, on
the CPU.

JAX on the CPU is the reference; its variables are numpy draws of the flax
shapes (``jax.eval_shape``: nothing compiles eagerly) and cross through
``convert.dann_state_from_jax``. ``DannCNN`` and ``BaselineCNN`` at 63x63,
batch 8, on uint8 patches (promoted to float32 unscaled, as flax does) and
on float32 ones in [0, 1]. Training-mode comparisons run with dropout off
on both sides: the JAX side through a test-local patch of
``flax.linen.Dropout`` (the JAX package is untouched), the port's through
its ``dropout``.

Tolerances. Inference: logits atol 1e-5 times their largest magnitude
(uint8 inputs reach the convs as 0..255). ``_nets.BatchNorm`` against
``flax.linen.BatchNorm`` on well-conditioned inputs: outputs atol 1e-5,
running statistics rtol 1e-6, atol 1e-7. The optimizer on given
gradients: atol 1e-7. Training-mode forwards and steps are held against
the port's own float64 evaluation of the same step (``_port_eval``),
because flax's BatchNorm variance E[x^2] - E[x]^2 over a batch of 8
cancels in float32, and XLA's CPU reductions round it more than torch's:
on these inputs JAX's float32 sits up to 7e-5 (loss, relative), 4.2e-2
(gradients) and 6.1e-5 (running statistics) from the float64 evaluation,
the port's float32 up to 1e-5, 4.5e-4 and 1.1e-5, the last two relative
to each leaf's largest |value|. So the port's float32 must be within
``TIGHT`` of its float64 and JAX's float32 within ``LOOSE`` of it: loss
2e-5 / 2e-4, gradients 1e-3 / 0.1, running statistics 1e-4 / 5e-4.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_flow_ref import jit
from stainlib_tpu.models import dann as jd
from stainlib_tpu_torch import convert
from stainlib_tpu_torch.models import _nets
from stainlib_tpu_torch.models import backbones as tb
from stainlib_tpu_torch.models import dann as td

LOGIT_RTOL = 1e-5
OPT_ATOL = 1e-7
LR = 0.05
TIGHT = dict(loss=2e-5, grads=1e-3, stats=1e-4)
LOOSE = dict(loss=2e-4, grads=0.1, stats=5e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _NoDropout(fnn.Module):
    """flax ``Dropout``'s signature, the identity."""

    rate: float = 0.0
    broadcast_dims: tuple = ()
    deterministic: bool = None
    rng_collection: str = "dropout"

    @fnn.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    for mod in (td, tb):
        monkeypatch.setattr(mod, "dropout", lambda x, *a, **k: x)


def flax_variables(module, seed, *args, **kwargs):
    """Numpy draws of a flax module's variables: kernels N(0, 1/fan_in),
    biases N(0, 0.1), BatchNorm scales 1 + N(0, 0.1), running means
    N(0, 0.1) and variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(functools.partial(module.init, **kwargs), *args)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            a = rng.normal(0, np.prod(leaf.shape[:-1]) ** -0.5, leaf.shape)
        elif name.endswith("['var']"):
            a = rng.uniform(0.5, 1.5, leaf.shape)
        elif name.endswith("['scale']"):
            a = 1.0 + rng.normal(0, 0.1, leaf.shape)
        else:
            a = rng.normal(0, 0.1, leaf.shape)
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(kind, seed, n=8, side=63, n_domains=3):
    rng = np.random.default_rng(seed)
    x = rng.random((n, side, side, 3))
    x = (x * 255).astype(np.uint8) if kind == "u8" else x.astype(np.float32)
    return x, rng.integers(0, 2, n), rng.integers(0, n_domains, n)


@pytest.fixture(scope="module")
def dann_vars():
    model = jd.DannCNN(n_domains=3)
    v = flax_variables(model, 0, jax.random.PRNGKey(0),
                       jnp.zeros((1, 63, 63, 3)), train=False)
    return model, v


def _port_state(v, opt_state=None):
    return convert.dann_state_from_jax(v["params"], v["batch_stats"],
                                       opt_state, device="cpu")


def _close_tree(got, want, rtol=0.0, atol=0.0):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


def _rel_close(got, want, rel):
    """Each leaf within ``rel`` of the leaf's largest |value|."""
    for k in want:
        scale = float(want[k].double().abs().max())
        err = float((got[k].double() - want[k].double()).abs().max())
        assert err <= rel * scale + 1e-12, (k, err, scale)


def _port_eval(model_fn, st, x, my, dy, phase, dtype):
    """The port's training-mode loss, gradients and moved statistics of
    one step from ``st``, evaluated in ``dtype``."""
    cast = {k: t.to(dtype) for k, t in st.params.items()}
    stats = {k: t.to(dtype) for k, t in st.batch_stats.items()}
    return td.loss_and_grads(model_fn().to(dtype), st._replace(
        params=cast, batch_stats=stats), x, my, dy, *phase)


def _triangulate(model_fn, st, x, my, dy, phase, jloss, jgrads, jstats):
    """The port's float32 within TIGHT, JAX's within LOOSE, of the port's
    float64 evaluation; returns the port's float32 (loss, grads, stats)."""
    l32, _, _, g32, s32 = _port_eval(model_fn, st, x, my, dy, phase,
                                     torch.float32)
    l64, _, _, g64, s64 = _port_eval(model_fn, st, x, my, dy, phase,
                                     torch.float64)
    for loss, tol in ((l32, TIGHT), (jloss, LOOSE)):
        assert abs(float(loss) / float(l64) - 1) <= tol["loss"], (
            float(loss), float(l64))
    _rel_close(g32, g64, TIGHT["grads"])
    _rel_close(jgrads, g64, LOOSE["grads"])
    _rel_close(s32, s64, TIGHT["stats"])
    _rel_close(jstats, s64, LOOSE["stats"])
    return l32, g32, s32


@pytest.mark.parametrize("lam", [1.0, -1.0, 2.0])
def test_gradient_reversal_matches_jax(lam):
    x = np.random.default_rng(0).normal(size=(4, 5)).astype(np.float32)
    g = np.random.default_rng(1).normal(size=(4, 5)).astype(np.float32)
    y, vjp = jax.vjp(jd.gradient_reversal, jnp.asarray(x), jnp.float32(lam))
    gx, glam = vjp(jnp.asarray(g))
    t = torch.from_numpy(x).requires_grad_()
    out = td.gradient_reversal(t, lam)
    assert torch.equal(out, torch.from_numpy(np.asarray(y)))
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(gx))
    assert float(glam) == 0.0
    # hp_lambda gets no gradient: backward returns None for it.
    assert td._GradientReversal.backward(type("C", (), {"hp_lambda": lam}),
                                         torch.ones(1))[1] is None


@pytest.mark.parametrize("kind", ["u8", "f32"])
def test_dann_cnn_eval_mode_matches_jax(dann_vars, kind):
    model, v = dann_vars
    x, _, _ = _batch(kind, 1)
    ml, dl = jit(lambda v, x: model.apply(v, x, train=False))(
        v, jnp.asarray(x))
    tm = td.DannCNN(n_domains=3, device="cpu")
    st = _port_state(v)
    names = {k for k, _ in tm.named_parameters()} | {
        k for k, _ in tm.named_buffers()}
    assert set(st.params) | set(st.batch_stats) == names
    pm = td.predict_mitosis(tm, st, x)
    pd = td.predict_domain(tm, st, x)
    for got, want in ((pm, jax.nn.softmax(ml)), (pd, jax.nn.softmax(dl))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    gm, gd = td._eval_logits(tm, st, x)
    for got, want in ((gm, ml), (gd, dl)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=LOGIT_RTOL * np.abs(want).max())


@pytest.mark.parametrize("momentum", [0.99, 0.9])
@pytest.mark.parametrize("shape", [(6, 5, 4, 7), (16, 9)])
def test_batch_norm_is_flax(shape, momentum):
    """``_nets.BatchNorm`` against ``flax.linen.BatchNorm`` (epsilon 1e-5,
    flax's decay, the biased E[x^2] - E[x]^2 variance), NCHW or (B, C), in
    training and in inference, on well-conditioned inputs."""
    rng = np.random.default_rng(len(shape))
    c = shape[1]
    x = rng.normal(0.5, 2.0, shape).astype(np.float32)
    nhwc = x if x.ndim == 2 else x.transpose(0, 2, 3, 1)
    v = {"params": {"scale": rng.uniform(0.5, 2, c).astype(np.float32),
                    "bias": rng.normal(0, 1, c).astype(np.float32)},
         "batch_stats": {"mean": rng.normal(0, 1, c).astype(np.float32),
                         "var": rng.uniform(0.5, 2, c).astype(np.float32)}}
    outs = {}
    for train in (True, False):
        bn = fnn.BatchNorm(use_running_average=not train, momentum=momentum)
        outs[train] = bn.apply(v, jnp.asarray(nhwc),
                               mutable=["batch_stats"] if train else False)
    mod = _nets.BatchNorm(c, momentum, device="cpu")
    mod.path = "bn"
    variables = {"scale": torch.from_numpy(v["params"]["scale"]),
                 "bias": torch.from_numpy(v["params"]["bias"]),
                 "mean": torch.from_numpy(v["batch_stats"]["mean"]),
                 "var": torch.from_numpy(v["batch_stats"]["var"])}
    stats = {}
    y_train = torch.func.functional_call(mod, variables, (
        torch.from_numpy(x), True, stats))
    y_eval = torch.func.functional_call(mod, variables, (
        torch.from_numpy(x), False))
    for got, want in ((y_train, outs[True][0]), (y_eval, outs[False])):
        got = got.numpy() if x.ndim == 2 else got.numpy().transpose(
            0, 2, 3, 1)
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    upd = outs[True][1]["batch_stats"]
    for name in ("mean", "var"):
        np.testing.assert_allclose(stats[f"bn.{name}"].numpy(),
                                   np.asarray(upd[name]), rtol=1e-6,
                                   atol=1e-7)
    assert not any("num_batches" in k for k, _ in mod.named_buffers())


@pytest.mark.parametrize("kind", ["u8", "f32"])
def test_dann_cnn_train_mode_and_batch_stats_match_jax(kind, no_dropout):
    """A training-mode forward at BatchNorm momentum 0.9 (the demos'): the
    logits and the moved statistics, through the float64 triangulation."""
    model = jd.DannCNN(n_domains=3, bn_momentum=0.9)
    v = flax_variables(model, 0, jax.random.PRNGKey(0),
                       jnp.zeros((1, 63, 63, 3)), train=False)
    x, my, dy = _batch(kind, 2)
    (ml, dl), upd = jit(lambda v, x: model.apply(
        v, x, hp_lambda=1.0, train=True, mutable=["batch_stats"]))(
            v, jnp.asarray(x))
    tm = td.DannCNN(n_domains=3, bn_momentum=0.9, device="cpu")
    st = _port_state(v)
    stats = {}
    gm, gd = torch.func.functional_call(
        tm, {**st.params, **st.batch_stats}, (torch.from_numpy(x),),
        {"train": True, "stats": stats})
    for got, want in ((gm, ml), (gd, dl)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want,
                                   atol=1e-4 * np.abs(want).max())
    want = _port_state({"params": v["params"],
                        "batch_stats": _host(upd["batch_stats"])})
    (jloss, _), jgrads = _jax_loss_and_grads(model, v, x, my, dy,
                                             jd.PHASE_ADVERSARIAL)
    jgrads = _port_state({"params": _host(jgrads),
                          "batch_stats": v["batch_stats"]}).params
    _, _, s32 = _triangulate(
        lambda: td.DannCNN(n_domains=3, bn_momentum=0.9, device="cpu"), st,
        x, my, dy, jd.PHASE_ADVERSARIAL, jloss, jgrads, want.batch_stats)
    assert all(torch.equal(stats[k], s32[k]) for k in stats)
    # The momentum is flax's decay: 0.9 of the old value stays.
    assert not torch.allclose(stats["BatchNorm_0.mean"],
                              st.batch_stats["BatchNorm_0.mean"])


def _jax_loss_and_grads(model, v, x, my, dy, phase):
    w_mit, w_dom, lam = phase

    def loss_fn(params):
        (ml, dl), upd = model.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            jnp.asarray(x), hp_lambda=lam, train=True,
            mutable=["batch_stats"])
        l_mit = optax.softmax_cross_entropy_with_integer_labels(
            ml, jnp.asarray(my)).mean()
        l_dom = optax.softmax_cross_entropy_with_integer_labels(
            dl, jnp.asarray(dy)).mean()
        return w_mit * l_mit + w_dom * l_dom, upd

    return jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])


PHASES = {"mitosis": jd.PHASE_MITOSIS, "domain": jd.PHASE_DOMAIN,
          "adversarial": jd.PHASE_ADVERSARIAL}


@pytest.mark.parametrize("kind", ["u8", "f32"])
@pytest.mark.parametrize("phase", list(PHASES))
def test_one_step_of_each_phase_matches_jax(dann_vars, kind, phase,
                                            no_dropout):
    """The loss, the gradients, the SGD update on JAX's gradients, and the
    port's whole step (its own gradients) against JAX's ``dann_train_step``
    from the same state."""
    model, v = dann_vars
    ph = PHASES[phase]
    x, my, dy = _batch(kind, 3)
    tx = jd.make_dann_optimizer(LR)
    jstate = jd.DannState(v["params"], v["batch_stats"], tx.init(v["params"]),
                          jax.random.PRNGKey(0))
    # One step first, so that the traces are not zero.
    jstep = jit(jd.make_train_step(model, tx))
    jstate, _ = jstep(jstate, jnp.asarray(x[::-1].copy()), jnp.asarray(my),
                      jnp.asarray(dy), *jd.PHASE_ADVERSARIAL)
    jv = {"params": _host(jstate.params),
          "batch_stats": _host(jstate.batch_stats)}
    (loss, upd), grads = _jax_loss_and_grads(model, jv, x, my, dy, ph)
    after, metrics = jstep(jstate, jnp.asarray(x), jnp.asarray(my),
                           jnp.asarray(dy), *ph)

    tm = td.DannCNN(n_domains=3, device="cpu")
    ttx = td.make_dann_optimizer(LR)
    st = _port_state(jv, _host(jstate.opt_state))
    wgrads = _port_state({"params": _host(grads),
                          "batch_stats": _host(upd["batch_stats"])})
    _, tgrads, _ = _triangulate(
        lambda: td.DannCNN(n_domains=3, device="cpu"), st, x, my, dy, ph,
        loss, wgrads.params, wgrads.batch_stats)

    # The optimizer on JAX's gradients: JAX's updated parameters and traces.
    want = _port_state({"params": _host(after.params),
                        "batch_stats": _host(after.batch_stats)},
                       _host(after.opt_state))
    upd_t, opt = ttx.update(wgrads.params, st.opt_state)
    _close_tree({k: st.params[k] + upd_t[k] for k in upd_t}, want.params,
                atol=OPT_ATOL)
    _close_tree(opt.trace, want.opt_state.trace, atol=OPT_ATOL)

    # The port's whole step: its own gradients through the same optimizer;
    # JAX's step within the gradients' LOOSE bound times the step's rate.
    new, m = td.dann_train_step(tm, ttx, st, x, my, dy, *ph)
    mine, _ = ttx.update(tgrads, st.opt_state)
    _close_tree(new.params, {k: st.params[k] + mine[k] for k in mine},
                atol=OPT_ATOL)
    for k in want.params:
        bound = LOOSE["grads"] * 1.9 * LR * float(
            wgrads.params[k].abs().max())
        err = float((new.params[k] - want.params[k]).abs().max())
        assert err <= bound + OPT_ATOL, (k, err, bound)
    assert abs(float(m["loss"]) / float(metrics["loss"]) - 1) <= \
        LOOSE["loss"]
    _rel_close(new.batch_stats, want.batch_stats, LOOSE["stats"])
    assert new.rng.tolist() == [st.rng[0].item(), st.rng[1].item() + 1]


def test_domain_head_takes_a_quarter_of_the_rate():
    """``make_dann_optimizer``: from zero traces a unit gradient moves
    ``dom_regressor`` by -0.25 x lr x (1 + momentum) (nesterov), every other
    parameter by -lr x (1 + momentum); optax agrees."""
    tm = td.DannCNN(n_domains=3, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    params = {k: p.detach() for k, p in tm.named_parameters()}
    tx = td.make_dann_optimizer(0.01)
    grads = {k: torch.ones_like(p) for k, p in params.items()}
    upd, state = tx.update(grads, tx.init(params))
    for k, u in upd.items():
        rate = 0.0025 if k.startswith("dom_regressor.") else 0.01
        torch.testing.assert_close(u, torch.full_like(u, -rate * 1.9))
    assert torch.equal(state.trace["Conv_0.weight"], grads["Conv_0.weight"])
    jtx = jd.make_dann_optimizer(0.01)
    jp = {"dom_regressor": {"kernel": jnp.ones((2, 2))},
          "mit_pred": {"kernel": jnp.ones((2, 2))}}
    jupd, _ = jtx.update(jp, jtx.init(jp), jp)
    np.testing.assert_allclose(np.asarray(jupd["dom_regressor"]["kernel"]),
                               -0.0025 * 1.9, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(jupd["mit_pred"]["kernel"]),
                               -0.01 * 1.9, rtol=1e-6)
    plain = td.make_dann_optimizer(0.01, nesterov=False)
    upd, _ = plain.update(grads, plain.init(params))
    torch.testing.assert_close(upd["mit_pred.kernel"],
                               torch.full_like(upd["mit_pred.kernel"], -0.01))


@pytest.mark.parametrize("kind", ["u8", "f32"])
def test_baseline_cnn_matches_jax(kind, no_dropout):
    model = jd.BaselineCNN()
    v = flax_variables(model, 4, jax.random.PRNGKey(0),
                       jnp.zeros((1, 63, 63, 3)), train=False)
    x, _, _ = _batch(kind, 5)
    want_eval = model.apply(v, jnp.asarray(x), train=False)
    want_train, upd = model.apply(v, jnp.asarray(x), train=True,
                                  mutable=["batch_stats"])
    tm = td.BaselineCNN(device="cpu")
    st = _port_state(v)
    variables = {**st.params, **st.batch_stats}
    assert set(variables) == {k for k, _ in tm.named_parameters()} | {
        k for k, _ in tm.named_buffers()}
    stats = {}
    got_eval = torch.func.functional_call(tm, variables, (x,),
                                          {"train": False})
    got_train = torch.func.functional_call(tm, variables, (x,),
                                           {"train": True, "stats": stats})
    for got, want, tol in ((got_eval, want_eval, LOGIT_RTOL),
                           (got_train, want_train, 1e-4)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want,
                                   atol=tol * np.abs(want).max())
    _rel_close(stats, _port_state({"params": v["params"], "batch_stats":
                                     _host(upd["batch_stats"])}).batch_stats,
                 LOOSE["stats"])


def test_init_dann_draws_flax_initializers():
    """Glorot-uniform convolutions, lecun-normal Dense kernels (a normal
    truncated at 2 sigma, variance 1/fan_in), zero biases, BatchNorm at
    (1, 0) and (0, 1); the same seed gives the same state."""
    model, st, _ = td.init_dann(3, n_domains=4, device="cpu")
    _, again, _ = td.init_dann(3, n_domains=4, device="cpu")
    assert all(torch.equal(st.params[k], again.params[k]) for k in st.params)
    w = st.params["Conv_1.weight"]
    limit = (6.0 / (16 * 16 + 16 * 16)) ** 0.5
    assert float(w.abs().max()) <= limit and float(w.std()) > limit / 3
    k = st.params["mit_pred_feats1.kernel"]
    assert k.shape == (256, 128)
    assert abs(float(k.std()) * 256 ** 0.5 - 1.0) < 0.05
    assert float(k.abs().max()) <= 2.0 / 0.87962566103423978 / 16 + 1e-6
    assert all(float(st.params[n].abs().max()) == 0.0
               for n in st.params if n.endswith(".bias"))
    assert torch.equal(st.batch_stats["mit_bn.var"], torch.ones(128))
    assert st.rng.tolist() == [3, 1]
    assert "num_batches_tracked" not in " ".join(st.batch_stats)


def test_reinit_layers():
    _, st, _ = td.init_dann(0, n_domains=2, device="cpu")
    out = td.reinit_layers(st.params, ["dom_regressor", "mit_pred", "nope"],
                           seed=7, scale=0.05)
    again = td.reinit_layers(st.params, ["dom_regressor", "mit_pred"], 7)
    for k in st.params:
        layer = k.split(".")[0]
        if layer not in ("dom_regressor", "mit_pred"):
            assert out[k] is st.params[k]
        elif k.endswith(".bias"):
            assert float(out[k].abs().max()) == 0.0
        else:
            assert float(out[k].abs().max()) <= 0.1 + 1e-7
            assert not torch.equal(out[k], st.params[k])
            assert torch.equal(out[k], again[k])


def test_train_mode_dropout_draws_follow_the_state():
    """With dropout on, a step's draws come from the state's (seed,
    counter): the same state steps to the same bits, a later counter to
    others."""
    model, st, tx = td.init_dann(1, n_domains=2, input_shape=(39, 39, 3),
                                 device="cpu")
    x, my, dy = _batch("f32", 6, side=39, n_domains=2)
    a, la = td.dann_train_step(model, tx, st, x, my, dy, *td.PHASE_MITOSIS)
    b, lb = td.dann_train_step(model, tx, st, x, my, dy, *td.PHASE_MITOSIS)
    assert torch.equal(la["loss"], lb["loss"])
    later = a._replace(params=st.params, opt_state=st.opt_state,
                       batch_stats=st.batch_stats)
    c, lc = td.dann_train_step(model, tx, later, x, my, dy,
                               *td.PHASE_MITOSIS)
    assert not torch.equal(la["loss"], lc["loss"])
