"""The port's segmentation and flow-demo CLIs against their JAX twins'
JSON, run small on the CPU.

Each port CLI runs in process with ``--device cpu``; its JAX twin with the
same flags and ``--cpu``, its jitted programs compiled with XLA's cheap
CPU options and its flax inits jitted (``cheap_jit``, ``jitted_inits``).

* ``torch_seg_transfer_demo.py``: the U-Net's initial weights are JAX's
  (the port's ``init_unet`` patched): the raw, Macenko and Reinhard
  conditions' per-center mIoU within 0.02 (the normalizers' uint8 outputs
  differ by a few values on some pixels, and an argmax may flip); the flow
  condition (trained, or from a checkpoint) with every transfer and option
  on the port, the summary's layout checked;
* ``torch_flow_effect_demo.py``: the raw NMI spread equal (rounded to 4
  decimals as printed), the keys equal;
* ``torch_flow_transfer_probe.py``: JAX's checkpoint and the port's of the
  same weights (``reference_capacity`` swapped for a small flow on both
  sides): the gamma-derived values within 2e-4 (the JSON's rounding), the
  Q-Q residuals within 2e-3, bits/dim within 2e-2 relative (each side
  draws its own Hutchinson probes).
"""

import json
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_flow_ref import _CHEAP_XLA, jax_init, jit, port_cfg, to_port
from _torch_mp_worker import ROOT
from stainlib_tpu.models import dann as jd
from stainlib_tpu.models import segmentation as js
from stainlib_tpu.models import train_flow as jtf
from stainlib_tpu.utils import checkpoint as jckpt
from stainlib_tpu_torch import convert
from stainlib_tpu_torch.models import segmentation as ts
from stainlib_tpu_torch.models import train_flow as ttf
from stainlib_tpu_torch.utils import checkpoint as tckpt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(name):
    return runpy.run_path(str(ROOT / "scripts" / name))


@pytest.fixture
def cheap_jit(monkeypatch):
    """The JAX twins' ``jax.jit`` with XLA's cheap CPU compile options
    (``_torch_flow_ref.jit``): their programs are small and run a few
    times; the JAX package is untouched."""
    real = jax.jit

    def cheap(fn=None, **kw):
        kw.setdefault("compiler_options", _CHEAP_XLA)
        if fn is None:
            return lambda f: real(f, **kw)
        return real(fn, **kw)

    monkeypatch.setattr(jax, "jit", cheap)


@pytest.fixture
def jitted_inits(monkeypatch, cheap_jit):
    """flax's ``init`` of the JAX twins' nets, jitted (eagerly it compiles
    op by op), and ``init_flow_state`` as ``_torch_flow_ref.jax_init``
    (numpy draws of its shapes): neither changes what the twins compare."""
    for cls in (js.UNet, jd.DannCNN):
        init_fn = cls.init
        monkeypatch.setattr(cls, "init", lambda self, key, *a, _f=init_fn,
                            **kw: jit(lambda k, *b: _f(self, k, *b, **kw))(
                                key, *a))
    monkeypatch.setattr(jtf, "init_flow_state",
                        lambda c, key, **kw: jax_init(c, key))


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


SEG = ["--size", "16", "--train-tiles", "8", "--eval-tiles", "4",
       "--seg-steps", "3", "--seg-base", "4", "--seg-depth", "1",
       "--batch", "4", "--seed", "1"]


def test_seg_transfer_demo_matches_jax(tmp_path, monkeypatch, capsys,
                                     jitted_inits):
    flags = SEG + ["--methods", "raw,macenko,reinhard"]
    want = _script("seg_transfer_demo.py")["run"](
        _script("seg_transfer_demo.py")["parse_args"](
            flags + ["--cpu", "--out", str(tmp_path / "j")]))
    capsys.readouterr()

    def jax_weights(n_classes=3, base=16, depth=3, seed=0, device="cuda"):
        model = ts.UNet(n_classes, base, depth, device=device)
        init = js.UNet(n_classes=n_classes, base=base, depth=depth).init(
            jax.random.PRNGKey(seed), jnp.zeros((1, 16, 16, 3)))["params"]
        return model, convert.unet_params_from_jax(
            jax.tree.map(np.asarray, init), device)

    monkeypatch.setattr(ts, "init_unet", jax_weights)
    got = _script("torch_seg_transfer_demo.py")["main"](
        flags + ["--device", "cpu", "--out", str(tmp_path / "t")])
    assert _last_json(capsys.readouterr().out) == got
    assert json.load(open(tmp_path / "t" / "seg_transfer.json")) == got
    assert got.keys() == want.keys() and got["conditions"].keys() == \
        want["conditions"].keys() == {"raw", "macenko", "reinhard"}
    for name, res in want["conditions"].items():
        assert res.keys() == got["conditions"][name].keys()
        np.testing.assert_allclose(got["conditions"][name]["per_center"],
                                   res["per_center"], atol=0.02,
                                   err_msg=name)


@pytest.mark.parametrize("extra", [
    ["--transfer", "quantile", "--class-match", "--class-match-scope",
     "center", "--seg-augment"],
    ["--transfer", "rgb-full-quantile", "--src-stats", "image",
     "--cohort", "acquisition", "--class-match"],
    ["--transfer", "full", "--methods", "flow,vahadane"],
])
def test_seg_transfer_demo_flow_condition_options(tmp_path, capsys, extra):
    """The flow condition (trained here) with the transfers, class-match
    scopes, per-image statistics, the cohorts and ``--seg-augment``: the
    summary's layout is the JAX script's."""
    if "--seg-augment" in extra:
        pytest.importorskip("PIL")
    flags = SEG + ["--methods", "raw,flow", "--flow-steps", "2",
                   "--flow-hidden", "8", "--flow-scales", "1",
                   "--flow-blocks", "1", "--device", "cpu",
                   "--out", str(tmp_path)] + extra
    got = _script("torch_seg_transfer_demo.py")["main"](flags)
    methods = flags[len(flags) - 1 - flags[::-1].index("--methods") + 1]
    assert set(got["conditions"]) == set(methods.split(","))
    for res in got["conditions"].values():
        assert len(res["per_center"]) == 5
        assert all(0.0 <= v <= 1.0 for v in res["per_center"])
    assert got["seg_augment"] == ("--seg-augment" in extra)


def test_seg_transfer_demo_from_a_capacity_checkpoint(tmp_path, monkeypatch,
                                                      capsys):
    """``--capacity-ckpt``: a checkpoint saved from a CPU state restores
    (``reference_capacity`` swapped for a small flow), EMA or raw weights,
    a given step."""
    cfg = ttf.FlowConfig(image_size=16, n_scales=2, blocks_per_scale=1,
                         hidden=8, n_power_series=2, n_clusters=3)
    monkeypatch.setattr(ttf, "reference_capacity", lambda: cfg)
    state = ttf.init_flow_state(cfg, 4, device="cpu")[2]
    tckpt.save_checkpoint(str(tmp_path / "ck"), state._replace(step=9), 9)
    main = _script("torch_seg_transfer_demo.py")["main"]
    for extra in ([], ["--flow-raw-weights", "--capacity-step", "9"]):
        got = main(SEG + ["--methods", "flow", "--capacity-ckpt",
                          str(tmp_path / "ck"), "--device", "cpu",
                          "--out", ""] + extra)
        assert "capacity flow checkpoint: step 9" in capsys.readouterr().out
        assert len(got["conditions"]["flow"]["per_center"]) == 5
    with pytest.raises(SystemExit):
        main(SEG[:1] + ["15"] + SEG[2:] + ["--device", "cpu"])
    with pytest.raises(SystemExit):
        main(SEG + ["--methods", "raw,nope", "--device", "cpu"])


def test_flow_effect_demo_matches_jax(tmp_path, capsys, jitted_inits):
    flags = ["--steps", "1", "--image-size", "16", "--batch", "4",
             "--tiles-per-center", "4", "--n-scales", "1", "--blocks", "1",
             "--hidden", "8"]
    want = _script("flow_effect_demo.py")["run"](
        _script("flow_effect_demo.py")["parse_args"](
            flags + ["--cpu", "--out", str(tmp_path / "j")]))
    got = _script("torch_flow_effect_demo.py")["main"](
        flags + ["--device", "cpu", "--out", str(tmp_path / "t")])
    assert _last_json(capsys.readouterr().out) == got
    assert got.keys() == want.keys()
    for k in ("raw_nmi_sd", "raw_nmi_cv", "n_images", "steps"):
        assert got[k] == want[k], k
    assert all(np.isfinite(v) for v in got.values())
    assert (tmp_path / "t" / "nmi_metrics.csv").exists()


def test_flow_transfer_probe_matches_jax(tmp_path, monkeypatch, capsys,
                                        jitted_inits):
    cfg = jtf.FlowConfig(image_size=16, n_scales=2, blocks_per_scale=1,
                         hidden=8, n_power_series=2, n_clusters=3,
                         kernel_sizes=(3, 1, 3))
    pcfg = port_cfg(cfg)
    _, _, state, _ = jax_init(cfg, jax.random.PRNGKey(0))
    ema = state.ema._replace(params=jax.tree.map(lambda p: p * 0.98,
                                                 state.params))
    state = state._replace(ema=ema, step=jnp.int32(5))
    jckpt.save_checkpoint(str(tmp_path / "jck"),
                          jax.tree.map(np.asarray, state), 5)
    tckpt.save_checkpoint(str(tmp_path / "tck"), to_port(state)._replace(
        rng=ttf.rng_state(0)), 5)
    monkeypatch.setattr(jtf, "reference_capacity", lambda: cfg)
    monkeypatch.setattr(ttf, "reference_capacity", lambda: pcfg)
    flags = ["--size", "16", "--tiles", "4", "--batch", "4",
             "--template-tiles", "8"]
    want = _script("flow_transfer_probe.py")["run"](
        _script("flow_transfer_probe.py")["parse_args"](
            flags + ["--cpu", "--ckpt", str(tmp_path / "jck"), "--out",
                     str(tmp_path / "j")]))
    capsys.readouterr()
    got = _script("torch_flow_transfer_probe.py")["main"](
        flags + ["--device", "cpu", "--ckpt", str(tmp_path / "tck"),
                 "--out", str(tmp_path / "t")])
    printed = capsys.readouterr().out
    assert "checkpoint step 5, EMA weights" in printed
    assert "mean |du8|" in printed and _last_json(printed) == got
    assert got.keys() == want.keys()
    for center, res in want.items():
        mine = got[center]
        assert mine.keys() == res.keys()
        np.testing.assert_allclose(mine["bpd"], res["bpd"], rtol=2e-2)
        for k in ("gamma_max_mean", "class_usage", "src_vs_tmpl_mu_dist"):
            np.testing.assert_allclose(mine[k], res[k], atol=2e-4,
                                       err_msg=(center, k))
        for a, b in zip(mine["qq_affine_resid"], res["qq_affine_resid"]):
            assert (a is None) == (b is None)
            if a is not None:
                assert abs(a - b) <= 2e-3, (center, a, b)
