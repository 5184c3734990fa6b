"""The U-Net segmenter on the card against the CPU, the same weights.

Needs a CUDA device (marker ``cuda``; every test skips without one). The
card has no jax, so this file imports only torch, numpy and the port. On
the card:

    python -m pytest --noconftest -q -m cuda \
        tests/test_torch_segmentation_cuda.py

Tolerances, card against CPU (cuDNN's float32 convolutions round otherwise
than the CPU's): logits atol 1e-4; the loss rtol 1e-5; gradients within
1e-4 of each leaf's largest |value|; five ``train_segmenter`` steps from
the same weights atol 1e-4 and the class maps equal on all but 1e-3 of
the pixels.
"""

import numpy as np
import pytest
import torch

from stainlib_tpu_torch.data import synthetic
from stainlib_tpu_torch.models import segmentation as ts

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's card path")
    return torch.device("cuda", 0)


def _data(seed, n=8, side=64):
    """Tiles and masks of the synthetic cohort's template center, as the
    seg demo trains on (uniform noise with random labels leaves the deep
    layers' gradients near zero, where any rounding is a large share)."""
    return synthetic.center_tiles_with_masks(0, n, side, side, seed=seed)


def _on(tree, d):
    return {k: v.to(d) for k, v in tree.items()}


@pytest.mark.parametrize("base,depth", [(8, 2), (16, 3)])
def test_unet_logits_and_gradients_card_vs_cpu(dev, base, depth):
    model, params = ts.init_unet(3, base, depth, seed=1, device="cpu")
    gmodel = ts.UNet(3, base, depth, device=dev)
    imgs, masks = _data(base)
    x = torch.from_numpy(imgs)
    want = torch.func.functional_call(model, params, (ts._unit(x),))
    got = torch.func.functional_call(gmodel, _on(params, dev),
                                     (ts._unit(x.to(dev)),))
    np.testing.assert_allclose(got.detach().cpu().numpy(),
                               want.detach().numpy(), atol=1e-4)
    loss, grads = ts.loss_and_grads(model, params, x, torch.from_numpy(masks))
    gloss, ggrads = ts.loss_and_grads(gmodel, _on(params, dev), x.to(dev),
                                      torch.from_numpy(masks).to(dev))
    np.testing.assert_allclose(float(gloss), float(loss), rtol=1e-5)
    for k in grads:
        err = float((ggrads[k].cpu() - grads[k]).abs().max())
        assert err <= 1e-4 * float(grads[k].abs().max()) + 1e-9, k


def test_train_segmenter_card_vs_cpu(dev, monkeypatch):
    """Both from the CPU's initial weights (``init_unet`` draws its own on
    each device's generator)."""
    imgs, masks = _data(4, n=16, side=32)
    _, init = ts.init_unet(3, 8, 2, seed=2, device="cpu")
    monkeypatch.setattr(ts, "init_unet", lambda n, b, d, seed, device: (
        ts.UNet(n, b, d, device=device), _on(init, device)))
    kw = dict(steps=5, batch=8, base=8, depth=2, seed=2)
    cpu_predict, cpu_params = ts.train_segmenter(imgs, masks, device="cpu",
                                                 **kw)
    card_predict, card_params = ts.train_segmenter(imgs, masks, device=dev,
                                                   **kw)
    for k in cpu_params:
        np.testing.assert_allclose(card_params[k].cpu().numpy(),
                                   cpu_params[k].numpy(), atol=1e-4,
                                   err_msg=k)
    got = card_predict(imgs)
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert (got.cpu().numpy() != cpu_predict(imgs).numpy()).mean() <= 1e-3
