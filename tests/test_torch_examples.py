"""The port's examples and launcher on the CPU: the augmentation demo
(``examples/torch_augmentation_demo.py``) against the JAX demo and the JAX
drop-in classes, the walkthrough notebook
(``examples/stainlib_tpu_torch_walkthrough.ipynb``) cell by cell, and
``scripts/torch_launch_multihost.sh`` as a two-process gloo world.

Tolerances. The normalizer panels are held as ``tests/test_torch_slide.py``
holds slide mode: the estimates against the JAX drop-in classes' (Macenko
rows atol 1e-4, the documented gap of JAX's float32 sums at 256^2;
Vahadane atol 2e-5, ``tests/test_torch_vahadane.py``; maxC rtol 1e-4;
Reinhard's LAB statistics atol 2e-4, ``tests/test_torch_reinhard.py``),
then the bytes from one estimate (the port's, through JAX's
``transform_with_matrix`` and Reinhard ``transform``): at most 1 uint8
step on under 0.1% of them (PERF.md section 2). JAX's own estimates at
224^2 move its panels further: its Reinhard source stds cancel in float32
(7e-6 relative from float64, 2 u8 on 2% of the bytes), its Vahadane
dictionary sits 1.5e-5 off (1 u8 on 0.3%). The grayscale panel,
recomputed by JAX's arithmetic from the port's draws, at the same budget.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import stainlib_tpu as jsl  # noqa: E402
import stainlib_tpu_torch as tsl  # noqa: E402
from stainlib_tpu.normalization import extractive as jax_ex  # noqa: E402
from stainlib_tpu.normalization import reinhard as jax_rh  # noqa: E402
from stainlib_tpu.ops.colorspace import rgb_to_gray, to_uint8  # noqa: E402
from stainlib_tpu_torch.augmentation import functional as F  # noqa: E402
from stainlib_tpu_torch.models import train_flow as ttf  # noqa: E402
from stainlib_tpu_torch.normalization import extractive, reinhard  # noqa: E402
from stainlib_tpu_torch.normalization import slide  # noqa: E402
from stainlib_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
NOTEBOOK = ROOT / "examples" / "stainlib_tpu_torch_walkthrough.ipynb"


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


demo = _load("examples/torch_augmentation_demo.py", "_torch_demo")
jax_demo = _load("examples/augmentation_demo.py", "_jax_demo")


def _u8_close(got, want, share=1e-3):
    d = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    assert d.max() <= 1 and (d > 0).mean() < share, (d.max(), (d > 0).mean())


@pytest.fixture(scope="module")
def panels():
    return demo.build_panels("cpu", 0)


@pytest.mark.parametrize("h,w,seed", [(224, 224, 1), (224, 224, 2),
                                      (96, 160, 7)])
def test_he_patch_equals_jax(h, w, seed):
    got = demo.he_patch(h, w, seed)
    assert np.array_equal(got, jax_demo.he_patch(h, w, seed))


def test_panels_shapes_titles_and_determinism(panels):
    images, titles = panels
    assert titles == [
        "original", "HED lighter (randomize+transform)",
        "Grayscale (fit+pop)", "Stain augment (macenko)",
        "Normalized to target (macenko)", "Stain augment (vahadane)",
        "Normalized to target (vahadane)", "Reinhard",
        "HED strong (batched)", "HSV light (batched)",
        "RGB jitter (batched)"]
    for im in images:
        assert isinstance(im, np.ndarray)
        assert im.dtype == np.uint8 and im.shape == (224, 224, 3)
    again, _ = demo.build_panels("cpu", 0)
    assert all(np.array_equal(a, b) for a, b in zip(images, again))
    other, _ = demo.build_panels("cpu", 1)
    random = [1, 2, 3, 5, 8, 9, 10]  # the augmenter panels
    assert all(not np.array_equal(images[i], other[i]) for i in random)
    fixed = [0, 4, 6, 7]  # the original and the normalizers
    assert all(np.array_equal(images[i], other[i]) for i in fixed)


@pytest.mark.parametrize("index,method,atol", [(4, "macenko", 1e-4),
                                              (6, "vahadane", 2e-5)])
def test_normalizer_panels_match_jax_classes(panels, index, method, atol):
    patch, target = demo.he_patch(seed=1), demo.he_patch(seed=2)
    n = jsl.ExtractiveStainNormalizer(method)
    n.fit(target)
    t = tsl.ExtractiveStainNormalizer(method, device="cpu")
    t.fit(target)
    np.testing.assert_allclose(t.stain_matrix_target, n.stain_matrix_target,
                               rtol=0, atol=atol)
    np.testing.assert_allclose(t.maxC_target, n.maxC_target, rtol=1e-4)
    M, mc = extractive.estimate_source(torch.from_numpy(patch), method)
    jM, jmc = jax_ex.estimate_source(jnp.asarray(patch), method)
    np.testing.assert_allclose(M.numpy(), np.asarray(jM), rtol=0, atol=atol)
    np.testing.assert_allclose(mc.numpy(), np.asarray(jmc), rtol=1e-4)
    want = jax_ex.transform_with_matrix(
        jnp.asarray(patch), jnp.asarray(M.numpy()), jnp.asarray(mc.numpy()),
        jax_ex.ExtractiveParams(jnp.asarray(t.stain_matrix_target),
                                jnp.asarray(t.maxC_target[0])))
    _u8_close(panels[0][index], want)


def test_reinhard_and_grayscale_panels_match_jax(panels):
    images, _ = panels
    patch, target = demo.he_patch(seed=1), demo.he_patch(seed=2)
    assert np.array_equal(images[0], patch)
    r = jsl.ReinhardStainNormalizer()
    r.fit(target)
    t = tsl.ReinhardStainNormalizer(device="cpu")
    t.fit(target)
    np.testing.assert_allclose(t.target_means, r.target_means, atol=2e-4)
    np.testing.assert_allclose(t.target_stds, r.target_stds, atol=2e-4)
    src = reinhard.fit(torch.from_numpy(patch))  # the transform's statistics
    jsrc = jax_rh.fit(jnp.asarray(patch))
    np.testing.assert_allclose(src.stds.numpy(), np.asarray(jsrc.stds),
                               atol=2e-4)
    want = jax_rh.transform(
        jax_rh.ReinhardParams(jnp.asarray(t.target_means),
                              jnp.asarray(t.target_stds)),
        jnp.asarray(patch), source_stats=jax_rh.ReinhardParams(
            jnp.asarray(src.means.numpy()), jnp.asarray(src.stds.numpy())))
    _u8_close(images[7], want)
    # The grayscale pop's draws, as the port's GrayscaleAugmentor(seed=0)
    # takes them, through JAX's grayscale arithmetic
    # (stainlib_tpu/augmentation/functional.py:127-139).
    gen = torch.Generator().manual_seed(0)
    alpha = float(F._uniform(gen, (), 0.8, 1.2, "cpu"))
    beta = float(F._uniform(gen, (), -0.2, 0.2, "cpu"))
    g = jnp.clip(rgb_to_gray(jnp.asarray(patch)) * alpha + beta, 0.0, 1.0)
    want = np.asarray(to_uint8(jnp.stack([g, g, g], axis=-1) * 255.0))
    _u8_close(images[2], want)


def test_main_saves_the_grid(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    out = tmp_path / "demo.png"
    demo.main(["--device", "cpu", "--out", str(out)])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert "with 11 panels" in capsys.readouterr().out


def _code_cells():
    nb = json.loads(NOTEBOOK.read_text())
    assert nb["nbformat"] == 4
    return ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code"]


def test_notebook_imports_no_jax_and_sets_the_device():
    cells = _code_cells()
    assert cells[0].startswith('DEVICE = "cuda"')
    text = NOTEBOOK.read_text()
    assert not re.search(r"\b(import|from) (jax|flax|optax|stainlib_tpu)\b",
                         text.replace("stainlib_tpu_torch", ""))
    assert "tiles/s" not in text  # no throughput claim is copied
    for src in cells[1:]:  # every device-taking call gets DEVICE
        for call in re.findall(r"sl\.\w+\([^)]*\)", src):
            assert "DEVICE" in call, call


@pytest.mark.parametrize("tiff", [True, False])
def test_notebook_cells_run_on_the_cpu(tmp_path, monkeypatch, capsys, tiff):
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from stainlib_tpu_torch.data import native

    if tiff and not native.tiff_native_available():
        pytest.skip("libtiff toolchain missing")
    if not tiff:  # the card's host: no TIFF writer
        monkeypatch.setattr(native, "tiff_native_available", lambda: False)
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    ns = {}
    for src in _code_cells():
        src = src.replace('DEVICE = "cuda"', 'DEVICE = "cpu"')
        exec(compile(src, str(NOTEBOOK), "exec"), ns)
    plt.close("all")
    assert ns["DEVICE"] == "cpu" and ns["out_lv0"].shape == (512, 512, 3)
    printed = capsys.readouterr().out
    assert ("no libtiff on this host" in printed) is (not tiff)
    if tiff:
        assert ns["normalized_batch"].shape == (8, 256, 256, 3)
        assert ns["info"]["tiles"] == 4 and ns["info"]["fused"] is False
        return
    # Without the writer, the cell's K3 route gives normalize_slide's level
    # 0 (the functional slide mode on the CPU) within the slide-mode budget
    # (PERF.md section 2: max 3, over 1 on under 0.5% of the bytes).
    levels = []
    monkeypatch.setattr(slide, "write_tiff_pyramid",
                        lambda path, lv, **kw: levels.append(lv))
    slide.normalize_slide(ns["slide_in"], ns["slide_out"], ns["target"],
                          batch=4, n_fit_tiles=4, device="cpu")
    d = np.abs(levels[0][0].astype(int) - ns["out_lv0"])
    assert d.max() <= 3 and (d > 1).mean() < 5e-3, (d.max(), (d > 1).mean())


def test_launcher_two_rank_gloo_world(tmp_path):
    save = tmp_path / "ck"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(GPUS_PER_HOST="2", STEPS="1", PYTHON=sys.executable,
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        ["bash", str(ROOT / "scripts" / "torch_launch_multihost.sh"),
         "--image-size", "16", "--batch", "4", "--n-scales", "1",
         "--blocks", "1", "--hidden", "8", "--device", "cpu",
         "--save", str(save)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "world 2" in out.stderr + out.stdout
    cfg = ttf.FlowConfig(image_size=16, n_scales=1, blocks_per_scale=1,
                         hidden=8)
    _, _, template, _ = ttf.init_flow_state(cfg, 1, device="cpu")
    restored = ckpt.restore_checkpoint(str(save), template)
    assert restored.step == 1


def test_launcher_needs_a_coordinator_for_several_hosts(tmp_path):
    env = dict(os.environ, NUM_HOSTS="2", PYTHON=sys.executable)
    out = subprocess.run(
        ["bash", str(ROOT / "scripts" / "torch_launch_multihost.sh")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode == 2 and "COORDINATOR" in out.stderr
