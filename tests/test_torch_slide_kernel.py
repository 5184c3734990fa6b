"""The port's whole-slide kernel route on the CPU against the JAX
package's Pallas kernels in interpret mode.

``_use_fused`` is forced, so ``normalize_slide`` takes the kernels' route
and the wrappers of K3 (slide mode), K1, K2 and K5 (tile mode) run their
plain versions on the CPU tensors; the JAX side runs
``normalize_slide(..., interpret=True)``, as ``tests/test_torch_tiled.py``
does for the tiled route. The slide and the budget are those of
``tests/test_torch_slide.py``: written bytes at most 1 uint8 step apart on
under 0.1% of the bytes, each side from one estimate.
"""

import pytest

jax = pytest.importorskip("jax")

from stainlib_tpu_torch.kernels import macenko_fused as mf  # noqa: E402
from stainlib_tpu_torch.kernels import reinhard_fused as rf  # noqa: E402
from stainlib_tpu_torch.kernels import vahadane_fused as vf  # noqa: E402
from stainlib_tpu_torch.normalization import slide  # noqa: E402
from tests.test_torch_slide import (  # noqa: E402, F401
    _run_both,
    _share_slide_estimate,
    _u8_close,
    slide_tif,
)


def _launches():
    return mf.matrix_launches, mf.launches, vf.launches, rf.launches


@pytest.mark.parametrize("method,estimation", [
    ("macenko", "slide"), ("macenko", "tile"), ("vahadane", "tile"),
    ("reinhard", "tile")], ids=["K3", "K1", "K2", "K5"])
def test_normalize_slide_kernel_route_matches_jax_interpret(
        tmp_path, monkeypatch, slide_tif, method, estimation):
    """The kernel route on the CPU: ``_use_fused`` forced, so the wrappers
    run their plain versions, against the JAX package's Pallas kernels in
    interpret mode. Nothing launches."""
    if estimation == "slide":
        _share_slide_estimate(monkeypatch, slide_tif, method)
    monkeypatch.setattr(slide, "_use_fused", lambda tile, device: True)
    before = _launches()
    info, want_info, got, want = _run_both(tmp_path, slide_tif, method,
                                           estimation, interpret=True)
    assert info == want_info and info["fused"] is True
    assert _launches() == before  # the CPU launches nothing
    _u8_close(got, want)


