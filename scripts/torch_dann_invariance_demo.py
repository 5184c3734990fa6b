#!/usr/bin/env python
"""Demonstrate that DANN training produces stain/domain invariance, on the
PyTorch port.

The port's counterpart of ``scripts/dann_invariance_demo.py``: the
reference's adversarial experiments (``base_experiment_dann.py:78-134``)
train a two-headed CNN whose domain head sits behind gradient reversal;
the claim is that the shared features become domain-invariant while the
task head keeps working. On the synthetic two-domain task
(``data/synthetic.two_domain_task``: stripe orientation = task, global
color tint = domain):

1. **Probe-toward-chance** (domain independent of task): the
   non-adversarial two-head model's domain head reads the tint; under the
   3-phase DANN loop the same continuously-trained head falls toward chance
   while task F1 holds.
2. **Shortcut robustness** (domain 95%-correlated with task at train time,
   anti-correlated at external-test time): the plain baseline inherits the
   color shortcut and degrades externally; DANN stays at its internal
   accuracy.

Adversarial runs are repeated ``--reps`` times and the best validation
TASK-F1 repetition is kept (``base_experiment_dann.py:117-125``);
hp_lambda defaults to 2 (see ``dann.phase_adversarial``); BatchNorm
statistics are recalibrated before every evaluation. Runs on the card
unless ``--device cpu`` is given.

    python scripts/torch_dann_invariance_demo.py --out dann_effect
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--size", type=int, default=39)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--n-train", type=int, default=768)
    p.add_argument("--n-test", type=int, default=384)
    p.add_argument("--iters", type=int, default=180)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--adversarial-lambda", type=float, default=2.0)
    p.add_argument("--out", default="dann_effect")
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu runs on the host)")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def run(args):
    from stainlib_tpu_torch.api import _device
    from stainlib_tpu_torch.data.synthetic import two_domain_task
    from stainlib_tpu_torch.models import dann
    from stainlib_tpu_torch.models.train_dann import (
        eval_task_domain,
        recalibrate_batch_stats,
        train_dann_phases,
    )

    dev = _device(args.device)
    lam = args.adversarial_lambda
    dann_phases = [dann.PHASE_MITOSIS, dann.PHASE_DOMAIN,
                   dann.phase_adversarial(lam)]
    summary = {}

    def trained(Xtr, ytr, dtr, phases, iters, seed):
        model, state = train_dann_phases(
            Xtr, ytr, dtr, phases, iters, batch_size=args.batch, seed=seed,
            device=dev)
        state = recalibrate_batch_stats(model, state, Xtr,
                                        batch_size=args.batch)
        return model, state

    def best_of_reps(Xtr, ytr, dtr, val, iters, seed0):
        """Reference's repetition + best-val-F1-checkpoint workflow."""
        best = None
        for rep in range(args.reps):
            model, state = trained(Xtr, ytr, dtr, dann_phases, iters,
                                   seed0 + rep)
            f1 = eval_task_domain(model, state, *val)["task_f1"]
            print(f"  rep {rep}: val task_f1 {f1:.3f}", flush=True)
            if best is None or f1 > best[0]:
                best = (f1, model, state)
        return best[1], best[2]

    # ---- Experiment 1: probe-toward-chance (domain independent of task) --
    Xtr, ytr, dtr = two_domain_task(args.n_train, seed=args.seed,
                                    correlation=0.5, size=args.size)
    val = two_domain_task(args.n_test // 2, seed=args.seed + 5,
                          correlation=0.5, size=args.size)
    Xte, yte, dte = two_domain_task(args.n_test, seed=args.seed + 1,
                                    correlation=0.5, size=args.size)

    model, state = trained(Xtr, ytr, dtr,
                           [dann.PHASE_MITOSIS, dann.PHASE_DOMAIN],
                           args.iters, args.seed + 1)
    m = eval_task_domain(model, state, Xte, yte, dte)
    summary["probe_nonadv"] = {k: round(v, 4) for k, v in m.items()}
    print(f"[probe] nonadv: task_f1 {m['task_f1']:.3f} "
          f"domain_acc {m['domain_acc']:.3f}", flush=True)

    model, state = best_of_reps(Xtr, ytr, dtr, val, args.iters,
                                args.seed + 50)
    m = eval_task_domain(model, state, Xte, yte, dte)
    summary["probe_dann"] = {k: round(v, 4) for k, v in m.items()}
    print(f"[probe] dann: task_f1 {m['task_f1']:.3f} "
          f"domain_acc {m['domain_acc']:.3f}", flush=True)

    # ---- Experiment 2: shortcut robustness (internal vs external) --------
    Xtr, ytr, dtr = two_domain_task(args.n_train, seed=args.seed + 10,
                                    correlation=0.95, size=args.size)
    val = two_domain_task(args.n_test // 2, seed=args.seed + 15,
                          correlation=0.95, size=args.size)
    Xin, yin, din = two_domain_task(args.n_test, seed=args.seed + 11,
                                    correlation=0.95, size=args.size)
    Xex, yex, dex = two_domain_task(args.n_test, seed=args.seed + 12,
                                    correlation=0.0, size=args.size)

    def shortcut_eval(name, model, state):
        mi = eval_task_domain(model, state, Xin, yin, din)
        me = eval_task_domain(model, state, Xex, yex, dex)
        summary[f"shortcut_{name}"] = {
            "internal_acc": round(mi["task_acc"], 4),
            "internal_f1": round(mi["task_f1"], 4),
            "external_acc": round(me["task_acc"], 4),
            "external_f1": round(me["task_f1"], 4),
        }
        print(f"[shortcut] {name}: int acc/f1 "
              f"{mi['task_acc']:.3f}/{mi['task_f1']:.3f} ext acc/f1 "
              f"{me['task_acc']:.3f}/{me['task_f1']:.3f}", flush=True)

    model, state = trained(Xtr, ytr, dtr, [dann.PHASE_MITOSIS],
                           args.iters * 8 // 5, args.seed + 20)
    shortcut_eval("baseline", model, state)
    model, state = best_of_reps(Xtr, ytr, dtr, val, args.iters,
                                args.seed + 70)
    shortcut_eval("dann", model, state)

    print(json.dumps(summary))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "invariance_summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
    return summary


def main(argv=None):
    return run(parse_args(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
