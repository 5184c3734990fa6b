"""Small U-Net segmenter for the cross-center transfer demonstration.

Port of the JAX package's ``models/segmentation.py``: the framework's own
minimal segmenter, which ``scripts/torch_seg_transfer_demo.py`` trains on
the template center of the synthetic cohort and deploys on its
color-shifted centers (the shape of the reference's "Semantic Segmentation
Comparison with DCGMM" table, ``dlmodels/color-information/README.md``).

Layout: the net takes NHWC images and returns NHWC logits, as the flax
``UNet`` does, and runs NCHW inside (cuDNN's convolutions in float32, TF32
off). Its modules follow flax's creation order: ``convs.i`` is flax's
``Conv_i`` (3x3 "SAME", then the 1x1 head last), ``ups.i`` its
``ConvTranspose_i``. flax's ``ConvTranspose((2, 2), strides=(2, 2))`` has
``transpose_kernel=False``, so it equals ``conv_transpose2d(stride=2)``
with its kernel flipped in both spatial axes; ``ups.i.weight`` holds the
flipped kernel, (in, out, 2, 2) (``convert.unet_params_from_jax`` flips
it). The skip concatenation puts the upsampled channels first, as JAX's
``concatenate(axis=-1)`` does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from stainlib_tpu_torch.api import _device
from stainlib_tpu_torch.models._nets import Conv, lecun_normal_
from stainlib_tpu_torch.models.train_flow import adam, apply_updates
from stainlib_tpu_torch.ops.fdiv import fdiv


class UpConv(nn.Module):
    """flax ``ConvTranspose(features, (2, 2), strides=(2, 2))`` on NCHW;
    ``weight`` (in, out, 2, 2) is flax's kernel flipped in both spatial
    axes."""

    def __init__(self, c_in: int, c_out: int, device=None, generator=None):
        super().__init__()
        w = torch.empty(c_in, c_out, 2, 2, device=device)
        self.weight = nn.Parameter(lecun_normal_(w, 4 * c_in, generator))
        self.bias = nn.Parameter(torch.zeros(c_out, device=device))

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight, self.bias, stride=2)


class UNet(nn.Module):
    """Encoder/decoder with skip connections. ``depth`` pool stages, channel
    widths ``base * 2**level``; input H/W must be divisible by
    ``2**depth``. ``forward(x)``: float NHWC -> logits (B, H, W, K)."""

    def __init__(self, n_classes: int = 3, base: int = 16, depth: int = 3,
                 in_channels: int = 3, device=None, generator=None):
        super().__init__()
        self.n_classes, self.base, self.depth = n_classes, base, depth
        pairs, c = [], in_channels
        for lvl in range(depth):
            pairs += [(c, base << lvl), (base << lvl, base << lvl)]
            c = base << lvl
        pairs += [(c, base << depth), (base << depth, base << depth)]
        ups = []
        for lvl in reversed(range(depth)):
            ups.append((base << (lvl + 1), base << lvl))
            pairs += [(2 * (base << lvl), base << lvl),
                      (base << lvl, base << lvl)]
        self.convs = nn.ModuleList(
            Conv(i, o, 3, device=device, generator=generator)
            for i, o in pairs)
        # flax creates the transposed convs between the blocks' convs; each
        # kind draws its own weights in its own creation order here.
        self.ups = nn.ModuleList(UpConv(i, o, device, generator)
                                 for i, o in ups)
        self.convs.append(Conv(base, n_classes, 1, device=device,
                               generator=generator))

    def _block(self, x, i):
        x = F.relu(self.convs[i](x))
        return F.relu(self.convs[i + 1](x))

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        skips, i = [], 0
        for _ in range(self.depth):
            x = self._block(x, i)
            i += 2
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        x = self._block(x, i)
        i += 2
        for j, lvl in enumerate(reversed(range(self.depth))):
            x = torch.cat([self.ups[j](x), skips[lvl]], dim=1)
            x = self._block(x, i)
            i += 2
        return self.convs[i](x).permute(0, 2, 3, 1)


def mean_iou(pred: np.ndarray, labels: np.ndarray, n_classes: int) -> float:
    """Mean intersection-over-union over classes present in ``labels``
    (the standard mIoU of the reference's segmentation table)."""
    pred = np.asarray(pred).reshape(-1)
    labels = np.asarray(labels).reshape(-1)
    ious = []
    for k in range(n_classes):
        gt = labels == k
        if not gt.any():
            continue
        pk = pred == k
        inter = float(np.logical_and(gt, pk).sum())
        union = float(np.logical_or(gt, pk).sum())
        ious.append(inter / max(union, 1.0))
    return float(np.mean(ious)) if ious else float("nan")


def _unit(imgs_u8) -> torch.Tensor:
    """uint8 NHWC -> float32 in [0, 1] (``/ 255``, exact on every device)."""
    return fdiv(imgs_u8.to(torch.float32), 255.0)


def segmentation_loss(model: UNet, params: dict, imgs_u8, labels):
    """Mean softmax cross-entropy of the logits against integer labels
    (optax's ``softmax_cross_entropy_with_integer_labels``, averaged)."""
    logits = functional_call(model, params, (_unit(imgs_u8),))
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None]).mean()


def loss_and_grads(model: UNet, params: dict, imgs_u8, labels):
    live = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.enable_grad():
        loss = segmentation_loss(model, live, imgs_u8, labels)
        grads = torch.autograd.grad(loss, list(live.values()))
    return loss.detach(), dict(zip(live, grads))


def init_unet(n_classes: int = 3, base: int = 16, depth: int = 3,
              seed: int = 0, device="cuda"):
    """``(model, params)``: a :class:`UNet` on ``device``, its weights drawn
    from a generator seeded with ``seed``, and its parameters as a dict."""
    dev = _device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = UNet(n_classes=n_classes, base=base, depth=depth, device=dev,
                 generator=gen)
    return model, {k: v.detach().clone()
                   for k, v in model.named_parameters()}


def train_segmenter(images_u8: np.ndarray, masks: np.ndarray, *,
                    steps: int = 300, batch: int = 32, lr: float = 1e-3,
                    base: int = 16, depth: int = 3, n_classes: int = 3,
                    seed: int = 0, log=None, device="cuda"):
    """Train a :class:`UNet` on uint8 tiles + int masks with Adam (optax's
    defaults, a constant rate) from :func:`init_unet`'s weights; the
    batches are ``default_rng(seed)``'s draws, as the JAX package's are.
    Returns ``(predict_fn, params)``, where ``predict_fn(uint8 batch) ->
    (B, H, W) int32 class map`` on ``device``."""
    dev = _device(device)
    model, params = init_unet(n_classes, base, depth, seed, dev)
    tx = adam(lambda count: lr)
    opt_state = tx.init(params)
    imgs = torch.as_tensor(np.asarray(images_u8)).to(dev)
    labels = torch.as_tensor(np.asarray(masks)).to(dev)
    rng = np.random.default_rng(seed)
    for i in range(steps):
        sel = torch.as_tensor(rng.integers(0, len(images_u8), batch)).to(dev)
        loss, grads = loss_and_grads(model, params, imgs[sel], labels[sel])
        with torch.no_grad():
            updates, opt_state = tx.update(grads, opt_state)
        params = apply_updates(params, updates)
        if log is not None and (i % 100 == 0 or i == steps - 1):
            log(f"seg step {i}: loss {float(loss):.4f}")

    @torch.no_grad()
    def predict(imgs_u8):
        x = torch.as_tensor(np.asarray(imgs_u8) if not isinstance(
            imgs_u8, torch.Tensor) else imgs_u8).to(dev)
        logits = functional_call(model, params, (_unit(x),))
        return torch.argmax(logits, dim=-1).to(torch.int32)

    return predict, params
