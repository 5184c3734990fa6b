"""The port's DANN CLIs against their JAX twins' outputs, run small on the
CPU.

Each port CLI runs in process with ``--device cpu``; its JAX twin with the
same flags, its jitted programs compiled with XLA's cheap CPU options and
its flax inits jitted (``cheap_jit``, ``jitted_inits`` of
``tests/test_torch_seg_scripts.py``). Each side draws its own DANN weights
from the seed, so the outputs' keys and shapes are compared:

* ``torch_train_dann.py`` (each ``--augment``): the two CSVs' header and
  rows, the printed summary lines;
* ``torch_dann_invariance_demo.py``: the summary's keys, values in [0, 1];
* ``torch_train_dann_capacity.py``: the three modes' JSON keys equal to
  the JAX script's (read from its source: importing it configures JAX's
  compilation cache), the 829,536 trunk and the model's parameter count
  equal to JAX's, the domain-cue flag checks.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mp_worker import ROOT
from stainlib_tpu.models import backbones as jb
from test_torch_seg_scripts import (  # noqa: F401  (fixtures)
    _last_json, _script, cheap_jit, jitted_inits)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_dann_cli_matches_jax_layout(tmp_path, capsys, jitted_inits):
    """The port with each augmenter; the JAX twin without one (its
    augmenters run eagerly, op by op)."""
    flags = ["--reps", "1", "--epochs", "1", "--iters", "2", "--warmup",
             "1", "--batch", "16", "--augment"]
    _script("train_dann.py")["main"](flags + ["none", "--out",
                                              str(tmp_path / "j")])
    want_out = capsys.readouterr().out
    for aug in ("hed", "rgb", "hsv", "none"):
        agg = _script("torch_train_dann.py")["main"](
            flags + [aug, "--device", "cpu", "--out", str(tmp_path / aug)])
        got_out = capsys.readouterr().out
        assert agg.shape == (2, 4) and np.isfinite(agg).all()
        for name in ("measures_dann.csv", "AGG_measures_dann.csv"):
            a = (tmp_path / aug / name).read_text().splitlines()
            b = (tmp_path / "j" / name).read_text().splitlines()
            assert a[0] == b[0] and len(a) == len(b)
        assert [ln.split(":")[0] for ln in got_out.splitlines()[-2:]] == \
            [ln.split(":")[0] for ln in want_out.splitlines()[-2:]]


def test_dann_invariance_demo_matches_jax_layout(tmp_path, capsys,
                                                 jitted_inits):
    flags = ["--size", "39", "--batch", "8", "--n-train", "32",
             "--n-test", "16", "--iters", "2", "--reps", "1"]
    want = _script("dann_invariance_demo.py")["run"](
        _script("dann_invariance_demo.py")["parse_args"](
            flags + ["--cpu", "--out", str(tmp_path / "j")]))
    got = _script("torch_dann_invariance_demo.py")["main"](
        flags + ["--device", "cpu", "--out", str(tmp_path / "t")])
    assert _last_json(capsys.readouterr().out) == got
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].keys() == v.keys()
        assert all(0.0 <= x <= 1.0 for x in got[k].values())
    assert json.load(open(tmp_path / "t" / "invariance_summary.json")) == got


def _jax_capacity_keys() -> list:
    """The keys of each ``out = {...}`` of the JAX capacity script, in
    order: throughput, invariance, shortcut."""
    src = (ROOT / "scripts" / "train_dann_capacity.py").read_text()
    blocks = re.findall(r"out = \{(.*?)\n    \}", src, re.S)
    return [re.findall(r'"(\w+)":', b) for b in blocks]


def test_train_dann_capacity_modes_match_jax_keys(capsys):
    inv_keys, short_keys, thr_keys = _jax_capacity_keys()
    main = _script("torch_train_dann_capacity.py")["main"]
    small = ["--size", "32", "--n-train", "16", "--batch", "4", "--iters",
             "2", "--device", "cpu"]
    got = main(small)
    assert list(got) == thr_keys
    assert got["trunk_params_plus_stats"] == 829_536
    shapes = jax.eval_shape(lambda k: jb.MobileNetDann(n_domains=2).init(
        k, jnp.zeros((1, 32, 32, 3)), train=False), jax.random.PRNGKey(0))
    assert got["model_params"] == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(shapes["params"]))
    assert np.isfinite(got["task_loss_last5"])
    assert list(main(small + ["--invariance", "--reps", "1"])) == inv_keys
    assert list(main(small + ["--shortcut", "--reps", "1", "--domain-cue",
                              "stain"])) == short_keys
    printed = capsys.readouterr().out
    assert "probe external" in printed and "baseline external" in printed
    parse = _script("torch_train_dann_capacity.py")["parse_args"]
    with pytest.raises(SystemExit):
        parse(["--domain-cue", "stain", "--stripe-contrast", "0.1"])
    with pytest.raises(SystemExit):
        parse(["--stripe-amp", "0.2"])
    a = parse(["--domain-cue", "stain"])
    assert (a.noise, a.stripe_amp) == (0.02, 0.35)
    a = parse([])
    assert (a.noise, a.stripe_contrast) == (0.18, 0.03)
