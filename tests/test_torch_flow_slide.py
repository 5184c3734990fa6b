"""Whole-slide flow deployment: the port's ``flow_normalize_slide`` against
the JAX package's, on the CPU.

Both read the same small WSIRAW slide (16^2 tiles of a small flow, partial
tiles on two edges) from checkpoints of the same weights (the JAX state
through ``convert.flow_state_from_jax``, each package's own checkpoint
format), write lossless TIFFs, and the written level 0 is compared: within
1 uint8 on all but 1e-3 of the bytes, at most 2 (the transfers' budget,
``tests/test_torch_color_eval.py``). The port's written level 0 is the
canvas its stream filled.
"""

import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_flow_ref import jax_init, port_cfg, to_port
from _torch_mp_worker import ROOT
from stainlib_tpu.models import train_flow as jtf
from stainlib_tpu.normalization import slide as jslide
from stainlib_tpu.utils import checkpoint as jckpt
from stainlib_tpu_torch.data import native
from stainlib_tpu_torch.models import train_flow as ttf
from stainlib_tpu_torch.normalization import slide as tslide
from stainlib_tpu_torch.utils import checkpoint as tckpt
from synth import he_batch

CFG = jtf.FlowConfig(image_size=16, n_scales=2, blocks_per_scale=1, hidden=8,
                     n_power_series=2, n_clusters=3, kernel_sizes=(3, 1, 3))
PCFG = port_cfg(CFG)
W, H = 90, 80  # 6 x 5 tiles of 16^2, the last column and row partial

requires_tiff = pytest.mark.skipif(
    not native.tiff_native_available(), reason="libtiff toolchain missing")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_template_state(monkeypatch):
    """The JAX package's ``flow_normalize_slide`` builds a template state
    with ``init_flow_state`` and restores the checkpoint into it; its eager
    init compiles for 30 s here. The template is built as
    ``_torch_flow_ref.jax_init`` builds it (the same pytree, values drawn
    with numpy), and the restore replaces every value."""
    monkeypatch.setattr(jtf, "init_flow_state",
                        lambda cfg, key, sample_hsd=None: jax_init(cfg, key))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    work = tmp_path_factory.mktemp("flow_slide")
    tiles = he_batch(4, 48, 48, seed=0, background_frac=0.0)
    lv0 = np.concatenate([np.concatenate(list(tiles[:2]), axis=1),
                          np.concatenate(list(tiles[2:]), axis=1)],
                         axis=0)[:H, :W].copy()
    lv0[:6] = 255  # a white band: tiles the sampler rejects
    src = str(work / "slide.wsiraw")
    native.write_wsiraw(src, [lv0])
    _, _, state, _ = jax_init(CFG, jax.random.PRNGKey(0))
    # The EMA weights deploy: make them differ from the raw ones.
    ema = state.ema._replace(params=jax.tree.map(lambda p: p * 0.98,
                                                 state.params))
    state = state._replace(ema=ema, step=jnp.int32(7))
    jdir = str(work / "jax_ckpt")
    jckpt.save_checkpoint(jdir, jax.tree.map(np.asarray, state), 7)
    tdir = str(work / "torch_ckpt")
    tckpt.save_checkpoint(tdir, to_port(state)._replace(
        rng=ttf.rng_state(0)), 7)
    template = he_batch(8, 16, 16, seed=5, background_frac=0.0)
    return dict(work=work, src=src, lv0=lv0, jdir=jdir, tdir=tdir,
                template=template)


def _read(path):
    s = native.open_slide(path)
    out = s.read_region(0, 0, 0, *s.level_size(0))
    s.close()
    return out


def _u8_budget(got, want, what):
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    first = np.argwhere(d > 0)[:1].tolist()
    assert d.max() <= 2 and (d > 1).mean() <= 1e-3, (
        f"{what}: max {d.max()}, share > 1 {(d > 1).mean():.2e}, first "
        f"differing byte {first}")


@requires_tiff
@pytest.mark.parametrize("transfer,class_match", [
    ("diag", False), ("full", True), ("quantile", False),
    ("rgb-quantile", True)])
def test_flow_normalize_slide_matches_jax(setup, transfer, class_match,
                                          monkeypatch):
    s = setup
    kw = dict(template=s["template"], batch=4, n_src_tiles=6, cfg=CFG,
              compression="none", transfer=transfer,
              class_match=class_match, seed=2)
    jout = str(s["work"] / f"jax_{transfer}.tif")
    jinfo = jslide.flow_normalize_slide(s["src"], jout, s["jdir"], **kw)
    seen = {}
    real = tslide._stream_canvas

    def keep(*a, **k):
        seen["canvas"], n = real(*a, **k)
        return seen["canvas"], n

    monkeypatch.setattr(tslide, "_stream_canvas", keep)
    tout = str(s["work"] / f"torch_{transfer}.tif")
    info = tslide.flow_normalize_slide(s["src"], tout, s["tdir"],
                                       device="cpu", **{**kw, "cfg": PCFG})
    assert info == jinfo
    assert info["tiles"] == 30 and info["step"] == 7 and info["ema"]
    got, want = _read(tout), _read(jout)
    assert got.shape == (H, W, 3) and np.array_equal(got, seen["canvas"])
    _u8_budget(got, want, transfer)
    tissue = np.abs(got[8:].astype(int) - s["lv0"][8:]).mean()
    assert tissue > 0.5, "the recolouring did not move the tissue"


@requires_tiff
def test_flow_wsi_cli_end_to_end(setup, monkeypatch, capsys):
    """``scripts/torch_flow_normalize_wsi.py`` on the CPU with
    ``reference_capacity`` swapped for the small flow: the JAX CLI's flags,
    ``--device cpu``, a pyramidal TIFF written."""
    s = setup
    monkeypatch.setattr(ttf, "reference_capacity", lambda: PCFG)
    main = runpy.run_path(str(ROOT / "scripts"
                              / "torch_flow_normalize_wsi.py"))["main"]
    out = str(s["work"] / "cli.tif")
    assert main([s["src"], out, "--ckpt", s["tdir"], "--batch", "4",
                 "--src-tiles", "6", "--transfer", "quantile",
                 "--class-match", "--compression", "deflate",
                 "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "90x80 (30 tiles" in printed and "step 7" in printed
    got = _read(out)
    assert got.shape == (H, W, 3) and got.dtype == np.uint8


@requires_tiff
def test_flow_normalize_slide_raw_weights_and_default_template(setup):
    """The raw weights instead of the EMA ones, and the default template
    (the synthetic center 0); errors before anything is read."""
    s = setup
    kw = dict(batch=4, n_src_tiles=6, cfg=CFG, compression="none",
              use_ema=False)
    jout, tout = (str(s["work"] / f"{p}_raw.tif") for p in ("jax", "torch"))
    jinfo = jslide.flow_normalize_slide(s["src"], jout, s["jdir"], **kw)
    info = tslide.flow_normalize_slide(s["src"], tout, s["tdir"],
                                       device="cpu", **{**kw, "cfg": PCFG})
    assert info == jinfo and info["ema"] is False
    _u8_budget(_read(tout), _read(jout), "raw weights")
    with pytest.raises(ValueError):
        tslide.flow_normalize_slide(s["src"], tout, s["tdir"], cfg=PCFG,
                                    transfer="full-quantile", device="cpu")
