"""DANN experiment loop: 3-phase alternating schedule over repetitions.

Port of the JAX package's ``models/train_dann.py``, parity with
``base_experiment_dann.py:78-134`` / ``tupac_dann_4reps.py:92-168``: per
repetition, (1) a mitosis-branch warmup, (2) epochs of 1000 iterations
alternating mitosis / domain / adversarial updates, (3) per-epoch
validation with macro-F1 threshold sweep keeping the best parameters, (4)
internal + external test at the best threshold; aggregated mean/std over
repetitions and CSV metric dumps (``tupac_dann_4reps.py:163-168``). The
three phases run on one step function (scalar phase weights), and batches
stream from caller-provided iterators. Everything runs on ``device``
(default ``"cuda"``).
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Callable, Iterator, Optional

import numpy as np
import torch
from torch.func import functional_call

from stainlib_tpu_torch.api import _device
from stainlib_tpu_torch.models import dann
from stainlib_tpu_torch.models.evaluation import (
    evaluate_test, evaluate_validation)
from stainlib_tpu_torch.models.train_flow import _mix


@dataclasses.dataclass
class DannConfig:
    """Union of the reference knobs (``utils/config.py:1-16`` and the
    scripts' arguments)."""

    n_domains: int = 8
    lr: float = 0.01
    num_reps: int = 4
    num_epochs: int = 5
    iters_per_epoch: int = 1000
    warmup_iters: int = 20
    batch_size: int = 64
    out_dir: Optional[str] = None


def train_dann_experiment(
    cfg: DannConfig,
    mitosis_batches: Iterator,
    domain_batches: Iterator,
    val_data,
    test_internal,
    test_external,
    seed: int = 0,
    log: Callable[[str], None] = print,
    device="cuda",
):
    """Run the full repetition experiment.

    ``mitosis_batches`` / ``domain_batches`` yield (images, mit_labels,
    dom_labels) numpy batches (the balanced generators of
    ``utils_patches.py:54-305`` live in
    :mod:`stainlib_tpu_torch.data.generators`). ``val_data`` / ``test_*``
    are (images, labels) tuples.

    Returns (aggregated, per_rep) where aggregated = mean/std over reps of
    [auc_int, f1_int, auc_ext, f1_ext].
    """
    dev = _device(device)
    measures = []
    for rep in range(cfg.num_reps):
        log(f"================= TRAINING REPETITION {rep} =================")
        model, state, tx = dann.init_dann(
            seed + rep, n_domains=cfg.n_domains, lr=cfg.lr, device=dev)
        step = dann.make_train_step(model, tx)

        def predict(st, x):
            return dann.predict_mitosis(model, st, x)

        best = {"f1": -1.0, "thres": 0.5, "auc": 0.0, "state": state}

        # Mitosis warmup (tupac_dann_4reps.py:106-113).
        for _ in range(cfg.warmup_iters):
            imgs, mit_y, dom_y = next(mitosis_batches)
            state, _ = step(state, imgs, mit_y, dom_y, *dann.PHASE_MITOSIS)

        for epoch in range(cfg.num_epochs):
            for _ in range(cfg.iters_per_epoch):
                imgs, mit_y, dom_y = next(mitosis_batches)
                state, m = step(state, imgs, mit_y, dom_y, *dann.PHASE_MITOSIS)
                imgs, mit_y, dom_y = next(domain_batches)
                state, m = step(state, imgs, mit_y, dom_y, *dann.PHASE_DOMAIN)
                imgs, mit_y, dom_y = next(mitosis_batches)
                state, m = step(
                    state, imgs, mit_y, dom_y, *dann.PHASE_ADVERSARIAL
                )

            thres, f1, auc = evaluate_validation(
                lambda x: predict(state, x), *val_data,
                batch_size=cfg.batch_size,
            )
            log(f"rep {rep} epoch {epoch}: val f1={f1:.4f} auc={auc:.4f}")
            # Keep the best-F1 parameters (checkpoint-best channel,
            # base_experiment_dann.py:120-125).
            if f1 > best["f1"]:
                best = {"f1": f1, "thres": thres, "auc": auc, "state": state}

        state = best["state"]
        auc_i, f1_i = evaluate_test(
            lambda x: predict(state, x), *test_internal, best["thres"],
            batch_size=cfg.batch_size,
        )
        auc_e, f1_e = evaluate_test(
            lambda x: predict(state, x), *test_external, best["thres"],
            batch_size=cfg.batch_size,
        )
        measures.append([auc_i, f1_i, auc_e, f1_e])
        log(f"rep {rep}: int auc/f1 {auc_i:.4f}/{f1_i:.4f} "
            f"ext auc/f1 {auc_e:.4f}/{f1_e:.4f}")

    measures = np.asarray(measures)
    aggregated = np.stack([measures.mean(0), measures.std(0)])

    if cfg.out_dir:
        os.makedirs(cfg.out_dir, exist_ok=True)
        for name, arr in [("measures_dann.csv", measures),
                          ("AGG_measures_dann.csv", aggregated)]:
            with open(os.path.join(cfg.out_dir, name), "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["auc_int", "f1_int", "auc_ext", "f1_ext"])
                w.writerows(arr.tolist())
    return aggregated, measures


# ---------------------------------------------------------------------------
# Invariance demonstration helpers
# ---------------------------------------------------------------------------


def train_dann_phases(images, task_labels, domain_labels, phases, iters,
                      batch_size=48, seed=0, lr=0.01, bn_momentum=0.9,
                      n_domains=2, device="cuda"):
    """Train a :class:`~stainlib_tpu_torch.models.dann.DannCNN` with an
    explicit per-iteration phase list (each a ``(w_mit, w_dom, hp_lambda)``
    triple).

    The building block of the invariance demonstration: ``phases =
    [PHASE_MITOSIS]`` is the plain baseline, ``[PHASE_MITOSIS, PHASE_DOMAIN]``
    the non-adversarial two-head model (the domain head acts as a live probe
    of how much domain information the shared features carry), and
    ``[PHASE_MITOSIS, PHASE_DOMAIN, phase_adversarial(lam)]`` the full DANN
    loop of ``base_experiment_dann.py:87-110``. ``bn_momentum`` defaults to
    0.9 (not the reference's Keras 0.99) because demonstration runs are a few
    hundred steps, too short for 0.99 running statistics to track. The
    data go to the device once; each iteration's batch is
    ``default_rng(seed + 100)``'s draw, gathered there.

    Returns ``(model, state)``.
    """
    dev = _device(device)
    model, state, tx = dann.init_dann(
        seed, n_domains=n_domains, lr=lr, input_shape=images.shape[1:],
        bn_momentum=bn_momentum, device=dev,
    )
    step = dann.make_train_step(model, tx)
    X = torch.as_tensor(np.asarray(images)).to(dev)
    y = torch.as_tensor(np.asarray(task_labels)).to(dev)
    d = torch.as_tensor(np.asarray(domain_labels)).to(dev)
    rng = np.random.default_rng(seed + 100)
    for _ in range(iters):
        idx = torch.as_tensor(rng.integers(0, len(images), batch_size)).to(dev)
        im, ty, dy = X[idx], y[idx], d[idx]
        for ph in phases:
            state, _ = step(state, im, ty, dy, *ph)
    return model, state


@torch.no_grad()
def eval_task_domain(model, state, images, task_labels, domain_labels,
                     batch_size=128):
    """Inference-mode task accuracy/F1 and domain-head accuracy.

    The domain-head number is the invariance criterion: it is TRAINED every
    iteration (phase 2), so if it still cannot beat chance the shared
    features carry no usable domain signal (``base_experiment_dann.py``'s
    stated goal)."""
    variables = {**state.params, **state.batch_stats}
    dev = dann._device_of(state)
    preds, dpreds = [], []
    for i in range(0, len(images), batch_size):
        im = torch.as_tensor(np.asarray(images[i : i + batch_size])).to(dev)
        ml, dl = functional_call(model, variables, (im,), {"train": False})
        preds.append(ml.argmax(-1).cpu().numpy())
        dpreds.append(dl.argmax(-1).cpu().numpy())
    pred = np.concatenate(preds)
    dpred = np.concatenate(dpreds)
    task_labels = np.asarray(task_labels)
    tp = int(((pred == 1) & (task_labels == 1)).sum())
    fp = int(((pred == 1) & (task_labels == 0)).sum())
    fn = int(((pred == 0) & (task_labels == 1)).sum())
    return {
        "task_acc": float((pred == task_labels).mean()),
        "task_f1": 2.0 * tp / max(2 * tp + fp + fn, 1),
        "domain_acc": float((dpred == np.asarray(domain_labels)).mean()),
    }


@torch.no_grad()
def recalibrate_batch_stats(model, state, images, batch_size=64, passes=2,
                            seed: int = 0):
    """Recompute BatchNorm running statistics with frozen parameters.

    Short demonstration runs leave the running averages lagging the final
    parameters (inference-mode predictions then disagree wildly with
    train-mode ones); a couple of frozen-parameter passes over the training
    set converge them. Each pass is a training-mode forward, dropout
    included (its masks from a generator seeded with ``(seed, pass)``).
    Returns the state with refreshed ``batch_stats``.
    """
    dev = dann._device_of(state)
    X = torch.as_tensor(np.asarray(images)).to(dev)
    bs = state.batch_stats
    n_full = len(images) // batch_size * batch_size
    for p in range(passes):
        gen = torch.Generator(device=dev).manual_seed(_mix(seed, p))
        for i in range(0, n_full, batch_size):
            stats = {}
            functional_call(model, {**state.params, **bs},
                            (X[i : i + batch_size],),
                            {"train": True, "generator": gen,
                             "stats": stats})
            bs = {**bs, **stats}
    return state._replace(batch_stats=bs)
