#!/usr/bin/env python
"""Train the TCGA-capacity DANN (MobileNet alpha=0.5 trunk) on the PyTorch
port.

The port's counterpart of ``scripts/train_dann_capacity.py``. The
reference's TCGA experiment (``tcga_dann_4reps.py:66-168``) trains a keras
``MobileNet(input_shape=(224,224,3), alpha=0.5, include_top=False,
pooling='avg')`` trunk with two Dense(256)->Dense(128)->softmax heads
(task = Gleason GP3/GP4, domain behind gradient reversal), Adam lr=1e-3,
batch 64, alternating the three phase weight settings per iteration:
(w_task, w_dom, hp_lambda) = (1,0,0), (0,1,-1), (1,1,1).

This script runs that configuration (the trunk's parameters plus
BatchNorm statistics asserted equal to keras's published 829,536) on the
synthetic two-domain task at 224x224, and reports the parameter count,
the loss descent and the dependent-chain throughput. ``--invariance`` runs
the probe-toward-chance comparison at this capacity instead, and
``--shortcut`` the shortcut-robustness experiment (train on 95%%
tint-correlated data, test anti-correlated); ``--domain-cue`` picks the
tint or the stain recipes as the domain. Runs on the card unless
``--device cpu`` is given.

Usage: python scripts/torch_train_dann_capacity.py [--iters 40] [--batch 64]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

TRUNK_PARAMS_PLUS_STATS = 829_536  # keras MobileNet(alpha=0.5), no top


def parse_args(argv):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--iters", type=int, default=40,
                   help="3-phase iterations (3 optimizer steps each)")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--n-train", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu runs on the host)")
    p.add_argument("--invariance", action="store_true",
                   help="run the probe-toward-chance comparison at this "
                        "capacity instead of the throughput measurement")
    p.add_argument("--shortcut", action="store_true",
                   help="run the shortcut-robustness experiment (train on "
                        "95%%-tint-correlated data, test anti-correlated)")
    p.add_argument("--hp-lambda", type=float, default=2.0)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--stripe-contrast", type=float, default=None,
                   help="stripe contrast (tint cue only; default 0.03)")
    p.add_argument("--noise", type=float, default=None,
                   help="pixel noise sigma (default: 0.18 tint, 0.02 stain)")
    p.add_argument("--domain-cue", choices=("tint", "stain"), default="tint",
                   help="'tint': two_domain_task's global channel multiplier"
                        " (trivially readable); 'stain': stain_domain_task's"
                        " hue-rotated H&E recipes at matched brightness")
    p.add_argument("--stripe-amp", type=float, default=None,
                   help="H-concentration stripe modulation (stain cue only;"
                        " default 0.35)")
    p.add_argument("--lr", type=float, default=0.01)
    args = p.parse_args(argv)
    # Per-cue defaults, and a hard error instead of silently ignoring a
    # knob that belongs to the other cue's generator.
    if args.domain_cue == "stain":
        if args.stripe_contrast is not None:
            p.error("--stripe-contrast is a tint-cue knob; with "
                    "--domain-cue stain use --stripe-amp")
        args.noise = 0.02 if args.noise is None else args.noise
        args.stripe_amp = 0.35 if args.stripe_amp is None else args.stripe_amp
    else:
        if args.stripe_amp is not None:
            p.error("--stripe-amp is a stain-cue knob; with "
                    "--domain-cue tint use --stripe-contrast")
        args.noise = 0.18 if args.noise is None else args.noise
        args.stripe_contrast = (0.03 if args.stripe_contrast is None
                                else args.stripe_contrast)
    return args


def _dev(args):
    from stainlib_tpu_torch.api import _device

    return _device(args.device)


def _model(args, seed, bn_momentum=0.9):
    from stainlib_tpu_torch.models.backbones import MobileNetDann

    dev = _dev(args)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return MobileNetDann(n_domains=2, alpha=0.5, bn_momentum=bn_momentum,
                         device=dev, generator=gen)


def _train_phases(model, phases, X, y, d, iters, batch, seed, tx=None):
    """Phase-list training loop for an arbitrary two-headed model (the
    MobileNet capacity variant of ``train_dann.train_dann_phases``, which
    builds the 63x63 DannCNN). The dataset is staged on the device once and
    each iteration's batch is gathered there."""
    from stainlib_tpu_torch.models import dann
    from stainlib_tpu_torch.models.train_flow import adam

    if tx is None:
        tx = adam(lambda count: 1e-3)  # tcga_dann_4reps.py:112
    state = dann.model_state(model, seed, tx)
    dev = dann._device_of(state)
    Xd, yd, dd = (torch.as_tensor(np.asarray(a)).to(dev) for a in (X, y, d))
    step = dann.make_train_step(model, tx)
    rng = np.random.default_rng(seed + 100)
    for _ in range(iters):
        idx = torch.as_tensor(rng.integers(0, len(X), batch)).to(dev)
        for ph in phases:
            state, _ = step(state, Xd[idx], yd[idx], dd[idx], *ph)
    return state


def _best_of_reps(args, name, phases, iters, reps, train, val, ext):
    """The demo's selection protocol at capacity: ``reps`` repetitions,
    each train -> BN recalibration -> held-out val, keep the best by TASK
    F1 (``base_experiment_dann.py:117-125`` semantics; never by domain
    accuracy), then evaluate the winner once on the external set."""
    from stainlib_tpu_torch.models import dann
    from stainlib_tpu_torch.models.train_dann import (
        eval_task_domain,
        recalibrate_batch_stats,
    )

    X, y, d = train
    best, best_f1 = None, -1.0
    for rep in range(reps):
        model = _model(args, args.seed + 31 * rep)
        tx = dann.make_dann_optimizer(args.lr)
        state = _train_phases(model, phases, X, y, d, iters,
                              args.batch, args.seed + 31 * rep, tx=tx)
        state = recalibrate_batch_stats(model, state, X[:512],
                                        batch_size=args.batch)
        v = eval_task_domain(model, state, *val, batch_size=args.batch)
        print(f"{name} rep {rep}: val {json.dumps(v)}", flush=True)
        if v["task_f1"] > best_f1:
            best, best_f1 = (model, state), v["task_f1"]
    res = eval_task_domain(*best, *ext, batch_size=args.batch)
    print(name, "external", json.dumps(res), flush=True)
    return res


def _task(args, n, seed, corr):
    from stainlib_tpu_torch.data.synthetic import (
        stain_domain_task, two_domain_task)

    if args.domain_cue == "stain":
        return stain_domain_task(n, seed=seed, size=args.size,
                                 correlation=corr,
                                 stripe_amp=args.stripe_amp,
                                 noise=args.noise)
    return two_domain_task(n, seed=seed, size=args.size,
                           correlation=corr,
                           stripe_contrast=args.stripe_contrast,
                           noise=args.noise)


def run_invariance(args):
    """Probe-toward-chance at the TCGA capacity (224x224 MobileNet trunk):
    the non-adversarial two-head model's live-trained domain head reads the
    domain cue; the 3-phase DANN loop (``tcga_dann_4reps.py:140-168``) must
    push it toward chance while task accuracy holds. The per-layer-rate SGD
    of ``keras_utils.py:261-328``, BN momentum 0.9 for short runs, and
    best-of-``--reps`` selection by held-out TASK F1."""
    from stainlib_tpu_torch.models import dann

    train = _task(args, args.n_train, args.seed, 0.5)
    val = _task(args, 192, args.seed + 2, 0.5)
    ext = _task(args, 256, args.seed + 1, 0.5)

    results = {}
    for name, phases, reps in [
        ("probe", [dann.PHASE_MITOSIS, dann.PHASE_DOMAIN], 1),
        ("dann", [dann.PHASE_MITOSIS, dann.PHASE_DOMAIN,
                  dann.phase_adversarial(args.hp_lambda)], args.reps),
    ]:
        results[name] = _best_of_reps(args, name, phases, args.iters, reps,
                                      train, val, ext)

    out = {
        "size": args.size,
        "iters": args.iters,
        "probe_domain_acc": round(results["probe"]["domain_acc"], 3),
        "dann_domain_acc": round(results["dann"]["domain_acc"], 3),
        "probe_task_f1": round(results["probe"]["task_f1"], 3),
        "dann_task_f1": round(results["dann"]["task_f1"], 3),
    }
    print(json.dumps(out), flush=True)
    return out


def run_shortcut(args):
    """Shortcut robustness at the TCGA capacity: the domain cue
    95%-correlated with the task at train time, anti-correlated at test. A
    plain task-only model latches onto the cue and collapses on the
    external set; the 3-phase DANN loop must hold task F1 there. Baseline
    is compute-matched (3x iterations of the single phase)."""
    from stainlib_tpu_torch.models import dann

    train = _task(args, args.n_train, args.seed, 0.95)
    val = _task(args, 192, args.seed + 2, 0.95)
    ext = _task(args, 256, args.seed + 1, 0.0)

    results = {}
    for name, phases, iters in [
        ("baseline", [dann.PHASE_MITOSIS], args.iters * 3),
        ("dann", [dann.PHASE_MITOSIS, dann.PHASE_DOMAIN,
                  dann.phase_adversarial(args.hp_lambda)], args.iters),
    ]:
        results[name] = _best_of_reps(args, name, phases, iters, args.reps,
                                      train, val, ext)

    out = {
        "size": args.size,
        "iters": args.iters,
        "baseline_external_f1": round(results["baseline"]["task_f1"], 3),
        "dann_external_f1": round(results["dann"]["task_f1"], 3),
        "baseline_external_acc": round(results["baseline"]["task_acc"], 3),
        "dann_external_acc": round(results["dann"]["task_acc"], 3),
    }
    print(json.dumps(out), flush=True)
    return out


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args):
    if args.invariance:
        return run_invariance(args)
    if args.shortcut:
        return run_shortcut(args)
    from stainlib_tpu_torch.data.synthetic import two_domain_task
    from stainlib_tpu_torch.models import dann
    from stainlib_tpu_torch.models.backbones import trunk_size
    from stainlib_tpu_torch.models.train_flow import adam

    dev = _dev(args)
    model = _model(args, args.seed, bn_momentum=0.99)
    n_trunk = trunk_size(model.MobileNetBackbone_0)
    n_total = sum(p.numel() for p in model.parameters())
    assert n_trunk == TRUNK_PARAMS_PLUS_STATS, n_trunk

    tx = adam(lambda count: 1e-3)  # tcga_dann_4reps.py:112 (Adam lr=0.001)
    state = dann.model_state(model, args.seed, tx)
    step = dann.make_train_step(model, tx)

    X, y, d = two_domain_task(args.n_train, seed=args.seed, size=args.size,
                              correlation=0.5)
    X, y, d = (torch.as_tensor(a).to(dev) for a in (X, y, d))
    nb = args.n_train // args.batch

    def batch(i):
        s = (i % nb) * args.batch
        return (X[s:s + args.batch], y[s:s + args.batch], d[s:s + args.batch])

    # The reference's per-iteration phase triple (tcga_dann_4reps.py:140-168).
    phases = [dann.PHASE_MITOSIS, dann.PHASE_DOMAIN, dann.PHASE_ADVERSARIAL]

    # The first iteration (cuDNN's algorithm choice, the allocator's pools).
    t0 = time.perf_counter()
    for ph in phases:
        state, _ = step(state, *batch(0), *ph)
    _sync(dev)
    compile_s = time.perf_counter() - t0

    # Dependent-chain timing: the losses stay on the device in the loop.
    losses = []
    t0 = time.perf_counter()
    for i in range(args.iters):
        for ph in phases:
            state, loss = step(state, *batch(i), *ph)
            losses.append(loss["loss_mit"])
    _sync(dev)
    dt = time.perf_counter() - t0
    steps = args.iters * 3
    imgs = steps * args.batch

    losses = [[float(v) for v in losses[i : i + 3]]
              for i in range(0, len(losses), 3)]
    for i in range(0, args.iters, 10):
        print(f"iter {i}: task {losses[i][0]:.4f} dom {losses[i][1]:.4f} "
              f"adv {losses[i][2]:.4f}", flush=True)
    head = np.mean([l[0] for l in losses[:5]])
    tail = np.mean([l[0] for l in losses[-5:]])
    out = {
        "trunk_params_plus_stats": n_trunk,
        "model_params": n_total,
        "batch": args.batch,
        "size": args.size,
        "compile_s": round(compile_s, 1),
        "opt_steps_per_s": round(steps / dt, 2),
        "imgs_per_s": round(imgs / dt, 1),
        "task_loss_first5": round(float(head), 4),
        "task_loss_last5": round(float(tail), 4),
    }
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    return run(parse_args(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
