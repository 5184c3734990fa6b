"""The port's augmentation demo on the card against the CPU
(``chip_smoke.py`` phase 67's check): ``build_panels("cuda", seed)`` against
``build_panels("cpu", seed)``, and the kernels its 224^2 panels launch
through the drop-in API (K1, K2, K5, and K7 per stain-augment pop).

Needs a CUDA device (marker ``cuda``; every test skips without one). The
card has no jax, so this file imports only torch, numpy and the port. On
the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_examples_cuda.py

Tolerances (PERF.md section 2, card against CPU): the normalizer panels
(the kernels against the CPU's functional path) within 1 uint8 step on
over 99% of the bytes, at most K1's 2, K2's 4 and K5's 3; the torch-only
augmenter panels (HED, grayscale, HSV, RGB jitter; the same draws from a
CPU generator) within 1 step on over 99%; the stain-augment pops (K7
against the functional pop) at a 99th percentile of at most 4.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from stainlib_tpu_torch.kernels import macenko_fused as mf
from stainlib_tpu_torch.kernels import reinhard_fused as rf
from stainlib_tpu_torch.kernels import vahadane_fused as vf

ROOT = Path(__file__).resolve().parent.parent

# panel index: (kind, max u8)
PANELS = {0: ("equal", 0), 1: ("augmenter", 255), 2: ("augmenter", 255),
          3: ("pop", 255), 4: ("normalizer", 2), 5: ("pop", 255),
          6: ("normalizer", 4), 7: ("normalizer", 3), 8: ("augmenter", 255),
          9: ("augmenter", 255), 10: ("augmenter", 255)}


def _demo():
    spec = importlib.util.spec_from_file_location(
        "_torch_demo_cuda", ROOT / "examples" / "torch_augmentation_demo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_panels_card_against_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    demo = _demo()
    mf.launches = mf.augment_launches = vf.launches = rf.launches = 0
    card, titles = demo.build_panels("cuda", 1)
    torch.cuda.synchronize()
    counts = dict(K1=mf.launches, K2=vf.launches, K5=rf.launches,
                  K7=mf.augment_launches)
    assert counts == dict(K1=1, K2=1, K5=1, K7=2), counts
    cpu, cpu_titles = demo.build_panels("cpu", 1)
    assert titles == cpu_titles and len(card) == len(PANELS)
    for i, (kind, mx) in PANELS.items():
        assert card[i].dtype == np.uint8 and card[i].shape == (224, 224, 3)
        d = np.abs(card[i].astype(int) - cpu[i].astype(int))
        if kind == "equal":
            assert d.max() == 0, titles[i]
        elif kind == "pop":
            assert np.percentile(d, 99) <= 4, titles[i]
        else:
            assert d.max() <= mx and (d > 1).mean() < 1e-2, (
                titles[i], int(d.max()), float((d > 1).mean()))
    again, _ = demo.build_panels("cuda", 1)
    assert all(np.array_equal(a, b) for a, b in zip(card, again))
