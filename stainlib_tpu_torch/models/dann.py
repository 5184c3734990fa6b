"""Stain-adversarial DANN models with gradient reversal.

Port of the JAX package's ``models/dann.py``, the re-design of
``dlmodels/stain_adversarial_learning`` (Keras/TF1):

* gradient reversal (``models_code/models_keras.py:138-180``) is a
  ``torch.autograd.Function``: the identity forward, ``-hp_lambda * g``
  backward and no gradient for ``hp_lambda``;
* ``DannCNN`` (``dann_mitosis_model``, ``models_keras.py:42-86``): 63x63x3
  input, three conv blocks of 16 4x4 filters with batch-norm, max-pool and
  dropout, a 2-way mitosis head and an N-domain head behind the reversal;
  ``BaselineCNN`` (``mitosis_model``, ``models_keras.py:90-134``);
* the 3-phase schedule of ``tupac_dann_4reps.py:117-146``: one step
  function takes ``(w_mit, w_dom, hp_lambda)`` as plain scalars;
* per-layer learning rates (``LR_SGD``, ``utils/keras_utils.py:261-328``):
  nesterov SGD with 0.25x on the domain head, optax's ``multi_transform``
  of two ``optax.sgd`` written as plain functions.

The nets take NHWC input of any dtype and promote it to their parameters'
dtype (float32) without rescaling, as flax's ``nn.Conv`` does (uint8
patches reach the convs as 0..255). They run NCHW inside and flatten in (H, W, C) order, so the first
Dense kernel's rows are flax's. Module names are flax's (``Conv_0``,
``BatchNorm_0``, ``dom_regressor``, ...); BatchNorm is flax's
(``models/_nets.py``). The state is explicit, as in the JAX package:
:class:`DannState` holds the parameters, the batch statistics, the
optimizer's traces and the dropout generator's ``(seed, counter)``
(``train_flow.rng_state``: one layout on every device); each step seeds a
generator on its device from it and advances the counter by one. The
dropout draws therefore differ from flax's per-module keys; the tests
compare the two with dropout off.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from stainlib_tpu_torch.api import _device
from stainlib_tpu_torch.models._nets import (
    BatchNorm, Conv, Dense, dropout, name_batch_norms)
from stainlib_tpu_torch.models.train_flow import (
    Optimizer, _advance, _generator, _mix, apply_updates, rng_state)


# --------------------------------------------------------------------------
# Gradient reversal
# --------------------------------------------------------------------------


class _GradientReversal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, hp_lambda):
        ctx.hp_lambda = float(hp_lambda)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.hp_lambda * g, None


def gradient_reversal(x, hp_lambda):
    """Identity forward; backward multiplies the gradient by ``-hp_lambda``
    (``reverse_gradient``, ``models_keras.py:138-155``). ``hp_lambda`` is a
    plain scalar and gets no gradient."""
    return _GradientReversal.apply(x, hp_lambda)


# --------------------------------------------------------------------------
# Models
# --------------------------------------------------------------------------


def _nchw(x, dtype=torch.float32):
    """NHWC of any dtype -> NCHW in ``dtype`` (the parameters'), unscaled."""
    return torch.as_tensor(x).to(dtype).permute(0, 3, 1, 2)


def _flat_hwc(x):
    """NCHW -> (B, H*W*C): flax's ``x.reshape(B, -1)`` on NHWC."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def _out_side(side: int, n_convs_before: list) -> int:
    for n in n_convs_before:
        side = (side - 3 * n) // 2
    return side


class DannCNN(nn.Module):
    """Two-headed mitosis/domain CNN (``dann_mitosis_model``,
    ``models_keras.py:42-86``). ``forward(x, hp_lambda, train, generator,
    stats)`` returns (mitosis_logits, domain_logits); softmax lives in the
    loss. ``generator`` draws the dropout masks in training; ``stats``, a
    dict, receives the moved BatchNorm statistics."""

    def __init__(self, n_domains: int = 8, n_filters: int = 16,
                 bn_momentum: float = 0.99, input_shape=(63, 63, 3),
                 device=None, generator=None):
        super().__init__()
        self.n_domains, self.n_filters = n_domains, n_filters
        self.bn_momentum = bn_momentum
        f, c = n_filters, input_shape[-1]
        for i, c_in in enumerate((c, f, f, f)):
            setattr(self, f"Conv_{i}", Conv(c_in, f, 4, padding="VALID",
                                            init="glorot", device=device,
                                            generator=generator))
        for i in range(3):
            setattr(self, f"BatchNorm_{i}",
                    BatchNorm(f, bn_momentum, device=device))
        side = _out_side(input_shape[0], [2, 1, 1])
        n_feats = side * side * f
        self.dom_pred_feats1 = Dense(n_feats, 128, device, generator)
        self.dom_pred_feats2 = Dense(128, 128, device, generator)
        self.dom_regressor = Dense(128, n_domains, device, generator)
        self.mit_pred_feats1 = Dense(n_feats, 128, device, generator)
        self.mit_pred_feats2 = Dense(128, 128, device, generator)
        self.mit_bn = BatchNorm(128, bn_momentum, device=device)
        self.mit_pred = Dense(128, 2, device, generator)
        name_batch_norms(self)

    def forward(self, x, hp_lambda=1.0, train: bool = True, generator=None,
                stats=None):
        x = _nchw(x, self.Conv_0.weight.dtype)
        # Block 1: conv, conv, BN, pool.
        x = F.relu(self.Conv_0(x))
        x = F.relu(self.Conv_1(x))
        x = F.max_pool2d(self.BatchNorm_0(x, train, stats), 2, 2)
        # Block 2: conv, BN, pool, dropout.
        x = F.relu(self.Conv_2(x))
        x = F.max_pool2d(self.BatchNorm_1(x, train, stats), 2, 2)
        x = dropout(x, 0.25, train, generator)
        # Block 3.
        x = F.relu(self.Conv_3(x))
        x = F.max_pool2d(self.BatchNorm_2(x, train, stats), 2, 2)
        x = dropout(x, 0.25, train, generator)
        feats = _flat_hwc(x)

        # Domain head behind gradient reversal.
        xd = gradient_reversal(feats, hp_lambda)
        xd = F.relu(self.dom_pred_feats1(xd))
        xd = F.relu(self.dom_pred_feats2(xd))
        domain_logits = self.dom_regressor(xd)

        # Mitosis head.
        xm = F.relu(self.mit_pred_feats1(feats))
        xm = F.relu(self.mit_pred_feats2(xm))
        xm = F.relu(self.mit_bn(xm, train, stats))
        xm = dropout(xm, 0.25, train, generator)
        return self.mit_pred(xm), domain_logits


class BaselineCNN(nn.Module):
    """Sequential mitosis classifier (``mitosis_model``,
    ``models_keras.py:90-134``). ``forward(x, train, generator, stats)``
    returns the logits."""

    def __init__(self, n_filters: int = 16, input_shape=(63, 63, 3),
                 device=None, generator=None):
        super().__init__()
        f = n_filters
        for i, c_in in enumerate((input_shape[-1], f, f, f)):
            setattr(self, f"Conv_{i}", Conv(c_in, f, 4, padding="VALID",
                                            device=device,
                                            generator=generator))
        for i in range(4):
            setattr(self, f"BatchNorm_{i}",
                    BatchNorm(128 if i == 3 else f, 0.99, device=device))
        side = _out_side(input_shape[0] - 3, [1, 1, 1])
        self.Dense_0 = Dense(side * side * f, 128, device, generator)
        self.Dense_1 = Dense(128, 2, device, generator)
        name_batch_norms(self)

    def forward(self, x, train: bool = True, generator=None, stats=None):
        x = F.relu(self.Conv_0(_nchw(x, self.Conv_0.weight.dtype)))
        for i in range(3):
            x = F.relu(getattr(self, f"Conv_{i + 1}")(x))
            x = getattr(self, f"BatchNorm_{i}")(x, train, stats)
            x = F.max_pool2d(x, 2, 2)
            x = dropout(x, 0.25, train, generator)
        x = self.BatchNorm_3(self.Dense_0(_flat_hwc(x)), train, stats)
        x = dropout(F.relu(x), 0.25, train, generator)
        return self.Dense_1(x)


# --------------------------------------------------------------------------
# Optimizer: per-layer learning rates
# --------------------------------------------------------------------------


class SgdState(NamedTuple):
    trace: Any  # {name: tensor}: optax's momentum trace, both groups merged


def _is_dom(name: str) -> bool:
    return "dom_regressor" in name.split(".")


def make_dann_optimizer(lr: float = 0.01, momentum: float = 0.9,
                        dom_lr_multiplier: float = 0.25,
                        nesterov: bool = True) -> Optimizer:
    """SGD with a reduced LR on the domain head.

    Parity with ``LR_SGD`` (``keras_utils.py:261-328``), which multiplies the
    LR by 0.25 for layers named 'dom_regressor'. optax's ``sgd``: the trace
    ``t = g + momentum * t``, then ``-lr * (g + momentum * t)`` (nesterov)
    or ``-lr * t``; a parameter whose name has a ``dom_regressor``
    component takes ``lr * dom_lr_multiplier``."""

    def init(params):
        return SgdState({k: torch.zeros_like(v) for k, v in params.items()})

    def update(grads, state: SgdState, params=None):
        with torch.no_grad():
            trace, updates = {}, {}
            for k, g in grads.items():
                t = g + momentum * state.trace[k]
                trace[k] = t
                rate = lr * dom_lr_multiplier if _is_dom(k) else lr
                updates[k] = (g + momentum * t if nesterov else t) * -rate
        return updates, SgdState(trace)

    return Optimizer(init, update)


# --------------------------------------------------------------------------
# Training step + 3-phase schedule
# --------------------------------------------------------------------------


class DannState(NamedTuple):
    params: Any  # {name: tensor}
    batch_stats: Any  # {name: tensor}: the BatchNorm buffers
    opt_state: Any
    rng: Any  # the dropout draws' (seed, counter): train_flow.rng_state


def model_state(model: nn.Module, seed: int, tx: Optimizer) -> DannState:
    """A :class:`DannState` from ``model``'s current weights and buffers."""
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    stats = {k: v.detach().clone() for k, v in model.named_buffers()}
    return DannState(params, stats, tx.init(params), rng_state(seed, 1))


def init_dann(seed: int = 0, n_domains: int = 8, lr: float = 0.01,
              input_shape=(63, 63, 3), bn_momentum: float = 0.99,
              device="cuda") -> tuple:
    """``(model, state, tx)``: a :class:`DannCNN` on ``device``, its weights
    drawn from a generator seeded with ``seed``, its state and the
    per-layer-rate SGD."""
    dev = _device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = DannCNN(n_domains=n_domains, bn_momentum=bn_momentum,
                    input_shape=input_shape, device=dev, generator=gen)
    tx = make_dann_optimizer(lr)
    return model, model_state(model, seed, tx), tx


def _cross_entropy(logits, labels):
    """optax's ``softmax_cross_entropy_with_integer_labels``, averaged."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[:, None]).mean()


def _device_of(state: DannState) -> torch.device:
    return next(iter(state.params.values())).device


def loss_and_grads(model: nn.Module, state: DannState, images, mit_labels,
                   dom_labels, w_mit, w_dom, hp_lambda, generator=None):
    """The weighted loss of one training-mode forward and its gradients
    with respect to ``state.params``: ``(loss, l_mit, l_dom, grads,
    stats)``, ``stats`` the moved BatchNorm statistics."""
    dev = _device_of(state)
    images = torch.as_tensor(images).to(dev)
    mit_labels = torch.as_tensor(mit_labels).to(dev)
    dom_labels = torch.as_tensor(dom_labels).to(dev)
    live = {k: v.detach().requires_grad_() for k, v in state.params.items()}
    stats = {}
    with torch.enable_grad():
        mit_logits, dom_logits = functional_call(
            model, {**live, **state.batch_stats}, (images,),
            {"hp_lambda": hp_lambda, "train": True, "generator": generator,
             "stats": stats})
        l_mit = _cross_entropy(mit_logits, mit_labels)
        l_dom = _cross_entropy(dom_logits, dom_labels)
        loss = float(w_mit) * l_mit + float(w_dom) * l_dom
        grads = torch.autograd.grad(loss, list(live.values()))
    return (loss.detach(), l_mit.detach(), l_dom.detach(),
            dict(zip(live, grads)), stats)


def dann_train_step(model: nn.Module, tx: Optimizer, state: DannState,
                    images, mit_labels, dom_labels, w_mit, w_dom, hp_lambda):
    """One weighted step; the three phases of ``tupac_dann_4reps.py:117-146``
    are (w_mit, w_dom, hp_lambda) = (1,0,0), (0,1,-1), (1,1,1) on the SAME
    function. Labels are int class ids. Returns (state, metrics)."""
    gen = _generator(state.rng, _device_of(state))
    loss, l_mit, l_dom, grads, stats = loss_and_grads(
        model, state, images, mit_labels, dom_labels, w_mit, w_dom,
        hp_lambda, gen)
    updates, opt_state = tx.update(grads, state.opt_state, state.params)
    new_state = DannState(
        params=apply_updates(state.params, updates),
        batch_stats={**state.batch_stats, **stats},
        opt_state=opt_state,
        rng=_advance(state.rng),
    )
    return new_state, {"loss": loss, "loss_mit": l_mit, "loss_dom": l_dom}


def make_train_step(model: nn.Module, tx: Optimizer) -> Callable:
    """One function for every phase, the weights given as scalars."""
    return functools.partial(dann_train_step, model, tx)


def reinit_layers(params, layer_names, seed: int, scale: float = 0.05):
    """Re-initialize the parameters of named top-level layers.

    Parity with ``reset_weights`` (``utils/keras_utils.py:254-258``), which
    re-runs initializers on chosen Keras layers: kernels redraw from a
    normal truncated at two standard deviations, times ``scale``, biases
    zero; layer ``i``'s ``j``-th parameter (by name) from a generator
    seeded with ``(seed, i * 131 + j)``."""
    out = dict(params)
    for i, name in enumerate(layer_names):
        keys = sorted(k for k in params if k.split(".")[0] == name)
        for j, k in enumerate(keys):
            v = params[k]
            if k.split(".")[-1].startswith("bias"):
                out[k] = torch.zeros_like(v)
                continue
            gen = torch.Generator(device=v.device).manual_seed(
                _mix(seed, i * 131 + j))
            w = torch.empty_like(v)
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
            out[k] = scale * w
    return out


PHASE_MITOSIS = (1.0, 0.0, 0.0)
PHASE_DOMAIN = (0.0, 1.0, -1.0)
PHASE_ADVERSARIAL = (1.0, 1.0, 1.0)


def phase_adversarial(hp_lambda: float = 1.0):
    """Adversarial phase weights with an explicit reversal strength.

    The reference fixes hp_lambda=1 in the adversarial update but carries a
    ``lambda_m`` config knob and a commented-out adaptive schedule
    ``(2/(1+exp(-20 iter/change_iter)))-1`` (``base_experiment_dann.py:
    104-106``). The domain phase pushes +1x the domain gradient INTO the
    shared features and the adversarial phase pushes -hp_lambda x, so at
    hp_lambda=1 the net first-order pressure on the features cancels;
    hp_lambda ~ 2 makes it strictly adversarial (used by the invariance
    demonstration, ``scripts/torch_dann_invariance_demo.py``)."""
    return (1.0, 1.0, float(hp_lambda))


@torch.no_grad()
def _eval_logits(model, state: DannState, images):
    x = torch.as_tensor(images).to(_device_of(state))
    return functional_call(model, {**state.params, **state.batch_stats},
                           (x,), {"train": False})


def predict_mitosis(model: nn.Module, state: DannState, images):
    """Inference-mode mitosis class probabilities (softmax over 2)."""
    return torch.softmax(_eval_logits(model, state, images)[0], dim=-1)


def predict_domain(model: nn.Module, state: DannState, images):
    """Inference-mode domain class probabilities from the adversarial head.

    Under successful adversarial training this head's accuracy on held-out
    data degrades toward chance — the stain-invariance criterion of
    ``base_experiment_dann.py:78-134``."""
    return torch.softmax(_eval_logits(model, state, images)[1], dim=-1)
