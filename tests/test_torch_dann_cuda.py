"""The DANN nets, their step and the evaluation on the card against the
CPU, the same weights.

Needs a CUDA device (marker ``cuda``; every test skips without one). The
card has no jax, so this file imports only torch, numpy and the port. On
the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_dann_cuda.py

Dropout is off on both sides where a training-mode pass is compared (the
card's generator draws other masks than the CPU's). Tolerances (cuDNN's
float32 convolutions round otherwise than the CPU's): inference logits,
card against CPU, atol 1e-4 of their largest magnitude. A step's loss,
gradients and running statistics: flax's BatchNorm variance E[x^2] -
E[x]^2 cancels in float32, so the card is held to the CPU's float64
evaluation of the same step (as ``tests/test_torch_dann.py`` holds JAX and
the port): loss rtol 1e-4, gradients within 2e-3 and statistics within
1e-4 of each leaf's largest |value| (the port's float32 on the CPU sits up
to 4.5e-4 from float64 there). The sliding-window scores atol 1e-5.
"""

import numpy as np
import pytest
import torch

from stainlib_tpu_torch.data import generators
from stainlib_tpu_torch.models import backbones as tb
from stainlib_tpu_torch.models import dann as td
from stainlib_tpu_torch.models import evaluation as ev

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's card path")
    return torch.device("cuda", 0)


@pytest.fixture
def no_dropout(monkeypatch):
    for mod in (td, tb):
        monkeypatch.setattr(mod, "dropout", lambda x, *a, **k: x)


def _on(state, d):
    return state._replace(
        params={k: v.to(d) for k, v in state.params.items()},
        batch_stats={k: v.to(d) for k, v in state.batch_stats.items()},
        opt_state=None if state.opt_state is None else type(
            state.opt_state)({k: v.to(d) for k, v in
                              state.opt_state.trace.items()}))


def _batch(kind, seed, n=8, side=63):
    rng = np.random.default_rng(seed)
    x = rng.random((n, side, side, 3))
    x = (x * 255).astype(np.uint8) if kind == "u8" else x.astype(np.float32)
    return x, rng.integers(0, 2, n), rng.integers(0, 3, n)


def _rel(got, want, rel):
    for k in want:
        err = float((got[k].cpu().double() - want[k].double()).abs().max())
        assert err <= rel * float(want[k].abs().max()) + 1e-12, (k, err)


@pytest.mark.parametrize("kind", ["u8", "f32"])
def test_dann_cnn_eval_and_each_phase_card_vs_cpu(dev, kind, no_dropout):
    model, st, tx = td.init_dann(0, n_domains=3, device="cpu")
    gmodel = td.DannCNN(n_domains=3, device=dev)
    gst = _on(st, dev)
    x, my, dy = _batch(kind, 1)
    for want, got in zip(td._eval_logits(model, st, x),
                         td._eval_logits(gmodel, gst, x)):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   atol=1e-4 * float(want.abs().max()))
    st64 = st._replace(
        params={k: v.double() for k, v in st.params.items()},
        batch_stats={k: v.double() for k, v in st.batch_stats.items()})
    model64 = td.DannCNN(n_domains=3, device="cpu").double()
    for ph in (td.PHASE_MITOSIS, td.PHASE_DOMAIN, td.PHASE_ADVERSARIAL):
        lw, _, _, gw, sw = td.loss_and_grads(model64, st64, x, my, dy, *ph)
        lg, _, _, gg, sg = td.loss_and_grads(gmodel, gst, x, my, dy, *ph)
        np.testing.assert_allclose(float(lg), float(lw), rtol=1e-4)
        _rel(gg, gw, 2e-3)
        _rel(sg, sw, 1e-4)
    new, _ = td.dann_train_step(gmodel, tx, gst, x, my, dy,
                                *td.PHASE_ADVERSARIAL)
    assert new.params["Conv_0.weight"].device.type == "cuda"
    assert new.rng.device.type == "cpu" and int(new.rng[1]) == 2


def test_mobilenet_dann_card_vs_cpu(dev, no_dropout):
    gen = torch.Generator().manual_seed(0)
    model = tb.MobileNetDann(n_domains=2, bn_momentum=0.9, device="cpu",
                             generator=gen)
    st = td.model_state(model, 0, td.make_dann_optimizer())
    gmodel = tb.MobileNetDann(n_domains=2, bn_momentum=0.9, device=dev)
    assert tb.trunk_size(gmodel.MobileNetBackbone_0) == 829_536
    x, my, dy = _batch("f32", 2, n=16, side=64)
    x[..., 1] *= 0.5
    for want, got in zip(td._eval_logits(model, st, x),
                         td._eval_logits(gmodel, _on(st, dev), x)):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   atol=1e-4 * float(want.abs().max()))
    st64 = st._replace(
        params={k: v.double() for k, v in st.params.items()},
        batch_stats={k: v.double() for k, v in st.batch_stats.items()})
    lc, _, _, _, sc = td.loss_and_grads(model.double(), st64, x, my, dy % 2,
                                        *td.PHASE_ADVERSARIAL)
    lg, _, _, _, sg = td.loss_and_grads(gmodel, _on(st, dev), x, my, dy % 2,
                                        *td.PHASE_ADVERSARIAL)
    np.testing.assert_allclose(float(lg), float(lc), rtol=1e-4)
    _rel(sg, sc, 1e-4)


def test_sliding_window_scores_and_evaluation_with_a_card_model(dev):
    model, st, _ = td.init_dann(1, n_domains=2, device="cpu")
    gmodel = td.DannCNN(n_domains=2, device=dev)
    gst = _on(st, dev)
    rng = np.random.default_rng(3)
    image = rng.integers(0, 256, (95, 127, 3), dtype=np.uint8)
    want = generators.sliding_window_scores(
        lambda b: td.predict_mitosis(model, st, b), image, 63, 16, 4)
    got = generators.sliding_window_scores(
        lambda b: td.predict_mitosis(gmodel, gst, b), image, 63, 16, 4)
    assert got.shape == want.shape == (3, 5)
    np.testing.assert_allclose(got, want, atol=1e-5)
    imgs, labels = rng.integers(0, 256, (20, 63, 63, 3), dtype=np.uint8), \
        np.arange(20) % 2
    t, f1, auc = ev.evaluate_validation(
        lambda b: td.predict_mitosis(gmodel, gst, b), imgs, labels, 8)
    assert 0.0 <= auc <= 1.0 and 0.0 <= f1 <= 1.0 and 0.0 < t < 1.0
