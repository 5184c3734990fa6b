"""The fused Macenko kernel's plain PyTorch version and its wrappers.

On the CPU the wrappers run the plain version, which is held to the JAX
Pallas kernel in interpret mode (at most 1 uint8 step apart, at least
99.9% identical) and to the functional path within the budget that
``tests/test_macenko_fused.py`` sets for the TPU kernel. The CUDA kernel
itself is tested in ``test_torch_macenko_cuda.py``.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stainlib_tpu.kernels import macenko_fused as jax_k  # noqa: E402
from stainlib_tpu.normalization import extractive as jax_ex  # noqa: E402
from stainlib_tpu_torch.kernels import macenko_fused as mf  # noqa: E402
from stainlib_tpu_torch.normalization import extractive  # noqa: E402
from tests.synth import he_batch, he_patch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _diff(got, want):
    return np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))


def _target(side, seed=90):
    p = jax_ex.fit(jnp.asarray(he_patch(side, side, seed=seed)))
    return np.array(p.stain_matrix_target), np.array(p.max_c_target)


@pytest.mark.parametrize("fit_stride", [1, 2, 4])
@pytest.mark.parametrize("rows", [16, 128, 512, 2048])
def test_stride_sample_matches_jax(rows, fit_stride):
    """The estimation sample is the JAX kernel's ``_stride_rows``, pixel for
    pixel, in flat pixel units."""
    iota = jnp.arange(rows * 128, dtype=jnp.int32).reshape(rows, 128)
    want = np.asarray(jax_k._stride_rows(iota, fit_stride)).reshape(-1)
    idx = mf._sample_index(rows, fit_stride, "cpu")
    got = np.arange(rows * 128) if idx is None else idx.numpy()
    assert (got == want).all()
    if rows == 512 and fit_stride == 2:  # 256^2 at fs=2: rows 16i..16i+7
        assert ((got // 128) % 16 < 8).all() and got.size == 256 * 128


@pytest.mark.parametrize("shape,kw", [
    ((32, 64), {}),
    ((128, 128), dict(fit_stride=2, n_bisect=10)),
])
def test_plain_version_matches_jax_kernel(shape, kw):
    h, w = shape
    M, mc = _target(h)
    batch = he_batch(2, h, w, seed=95)
    want = np.asarray(jax_k.macenko_normalize(jnp.asarray(batch), M, mc,
                                              interpret=True, **kw))
    got = mf.macenko_normalize(torch.from_numpy(batch), M, mc, **kw).numpy()
    d = _diff(got, want)
    assert d.max() <= 1 and (d == 0).mean() >= 0.999, (d.max(),
                                                      (d == 0).mean())


def test_plain_version_against_functional_path():
    """The TPU kernel's budget (``tests/test_macenko_fused.py``): <=1 u8 on
    >99.5% and max <=3 at fs=1; <=2 on >99.5% and max <=3 at fs=2, 128^2."""
    for (h, w), kw, step in (((32, 64), {}, 1),
                             ((128, 128), dict(fit_stride=2), 2)):
        params = extractive.fit(torch.from_numpy(he_patch(h, w, seed=90)))
        batch = torch.from_numpy(he_batch(2, h, w, seed=91))
        want = extractive.transform(params, batch)
        got = mf.macenko_normalize(batch, params.stain_matrix_target,
                                   params.max_c_target, **kw)
        d = _diff(got, want)
        assert (d <= step).mean() > 0.995 and d.max() <= 3, (d.max(), kw)


def test_wrappers_on_cpu_tensors():
    """A CPU tensor takes the plain version (no launch); both entry points
    agree; malformed input raises."""
    M, mc = _target(64)
    rgb = torch.from_numpy(he_batch(2, 32, 64, seed=96))
    before = mf.launches
    out = mf.macenko_normalize(rgb, M, mc)
    planar = mf.macenko_normalize_planar(mf.to_planar(rgb).contiguous(), M, mc)
    assert mf.launches == before
    assert out.dtype == torch.uint8 and out.shape == rgb.shape
    assert torch.equal(mf.from_planar(planar, 32, 64), out)
    per_tile = np.broadcast_to(M, (2, 2, 3))
    assert torch.equal(mf.macenko_normalize(rgb, per_tile, mc), out)
    with pytest.raises(TypeError):
        mf.macenko_normalize(rgb.float(), M, mc)
    with pytest.raises(ValueError):
        mf.macenko_normalize(rgb[:, :, :3], M, mc)  # 32*3 pixels: not lanes
    with pytest.raises(ValueError):
        mf.macenko_normalize_planar(rgb, M, mc)
    with pytest.raises(ValueError):
        mf.macenko_normalize_planar(mf.to_planar(rgb), M, mc, fit_stride=3)


def test_import_needs_no_jax_and_builds_nothing():
    code = ("import sys, torch, stainlib_tpu_torch\n"
            "from stainlib_tpu_torch.kernels import _build\n"
            "assert 'jax' not in sys.modules\n"
            "assert 'stainlib_tpu' not in sys.modules\n"
            "assert _build._lib is None and not _build.build_info\n"
            "assert not torch.backends.cuda.matmul.allow_tf32\n"
            "assert not torch.backends.cudnn.allow_tf32\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)
    pattern = re.compile(r"^\s*(import|from) (jax|stainlib_tpu)\b", re.M)
    for src in (ROOT / "stainlib_tpu_torch").rglob("*.py"):
        assert not pattern.search(src.read_text()), src
