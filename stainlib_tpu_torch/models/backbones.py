"""DANN model variants and backbones.

Port of the JAX package's ``models/backbones.py``, the reference's variant
zoo:

* ``dann_mitosis_model_gap`` / no-dropout variants
  (``models_code/models_keras.py:182-278``): global-average-pooling feature
  head and a dropout-free stack (:class:`DannCNNGap`);
* the MobileNet alpha=0.5 backbone used for TCGA 224x224 patches
  (``tcga_dann_4reps.py:74-80``): a width-scaled depthwise-separable
  MobileNetV1 (:class:`MobileNetBackbone`), wired to the same two-headed
  gradient-reversal top (:class:`MobileNetDann`).

flax's ``padding="SAME"`` at stride 2 pads as TensorFlow does, 0 before
and 1 after on an even side (``_nets.Conv``); a depthwise kernel is
(C, 1, 3, 3) with ``groups=C``. The trunk at alpha 0.5 counts 829,536
parameters plus BatchNorm means and variances, keras's published figure.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from stainlib_tpu_torch.models._nets import (
    BatchNorm, Conv, Dense, dropout, name_batch_norms)
from stainlib_tpu_torch.models.dann import _nchw, gradient_reversal


class DannCNNGap(nn.Module):
    """GAP variant: conv trunk -> global average pool -> two heads."""

    def __init__(self, n_domains: int = 8, n_filters: int = 16,
                 dropout: float = 0.25, in_channels: int = 3, device=None,
                 generator=None):
        super().__init__()
        self.n_domains, self.dropout = n_domains, dropout
        f = n_filters
        for i, c_in in enumerate((in_channels, f, f)):
            setattr(self, f"Conv_{i}", Conv(c_in, f, 4, padding="VALID",
                                            device=device,
                                            generator=generator))
            setattr(self, f"BatchNorm_{i}", BatchNorm(f, 0.99, device=device))
        self.dom_pred_feats1 = Dense(f, 128, device, generator)
        self.dom_regressor = Dense(128, n_domains, device, generator)
        self.mit_pred_feats1 = Dense(f, 128, device, generator)
        self.mit_pred = Dense(128, 2, device, generator)
        name_batch_norms(self)

    def forward(self, x, hp_lambda=1.0, train: bool = True, generator=None,
                stats=None):
        x = _nchw(x, self.Conv_0.weight.dtype)
        for i in range(3):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
            x = getattr(self, f"BatchNorm_{i}")(x, train, stats)
            x = F.max_pool2d(x, 2, 2)
            x = dropout(x, self.dropout, train, generator)
        feats = x.mean(dim=(2, 3))  # global average pooling

        xd = gradient_reversal(feats, hp_lambda)
        xd = F.relu(self.dom_pred_feats1(xd))
        domain_logits = self.dom_regressor(xd)

        xm = F.relu(self.mit_pred_feats1(feats))
        xm = dropout(xm, self.dropout, train, generator)
        return self.mit_pred(xm), domain_logits


# The full MobileNetV1 stack after the stem: 64s1, 128s2/s1, 256s2/s1,
# 512s2 then five 512s1 blocks, 1024s2/s1, matching keras
# MobileNet(alpha) (``tcga_dann_4reps.py:74-80``).
MOBILENET_BLOCKS = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
                    (512, 2), (512, 1), (512, 1), (512, 1), (512, 1),
                    (512, 1), (1024, 2), (1024, 1))


class MobileNetBackbone(nn.Module):
    """Width-scaled MobileNetV1 trunk (depthwise-separable convs).

    ``alpha=0.5`` reproduces the capacity of the reference's
    ``MobileNet(alpha=0.5)`` TCGA backbone (``tcga_dann_4reps.py:74-80``).
    ``forward(x, train, stats)`` takes NCHW float32 and returns GAP
    features (B, C). ``Conv_{2i+1}`` / ``Conv_{2i+2}`` are block ``i``'s
    depthwise and pointwise convs, as flax names them."""

    def __init__(self, alpha: float = 0.5, bn_momentum: float = 0.99,
                 in_channels: int = 3, device=None, generator=None):
        super().__init__()
        self.alpha = alpha

        def c(ch):
            return max(8, int(ch * alpha))

        self.layers = []
        chans = c(32)
        self._add(Conv(in_channels, chans, 3, 2, bias=False, device=device,
                       generator=generator), bn_momentum, device)
        for ch, stride in MOBILENET_BLOCKS:
            self._add(Conv(chans, chans, 3, stride, groups=chans, bias=False,
                           device=device, generator=generator),
                      bn_momentum, device)
            self._add(Conv(chans, c(ch), 1, bias=False, device=device,
                           generator=generator), bn_momentum, device)
            chans = c(ch)
        self.features = chans

    def _add(self, conv, momentum, device):
        i = len(self.layers)
        setattr(self, f"Conv_{i}", conv)
        setattr(self, f"BatchNorm_{i}",
                BatchNorm(conv.weight.shape[0], momentum, device=device))
        self.layers.append(i)

    def forward(self, x, train: bool = True, stats=None):
        for i in self.layers:
            x = getattr(self, f"Conv_{i}")(x)
            x = F.relu(getattr(self, f"BatchNorm_{i}")(x, train, stats))
        return x.mean(dim=(2, 3))


class MobileNetDann(nn.Module):
    """MobileNet trunk + the two-headed gradient-reversal top — the TCGA
    configuration of ``tcga_dann_4reps.py:66-99``: each head is the
    reference's Dense(256) -> Dense(128) -> softmax stack (``feats1_gp``/
    ``feats2_gp``/``output`` and the domain mirror behind the reversal)."""

    def __init__(self, n_domains: int = 8, alpha: float = 0.5,
                 bn_momentum: float = 0.99, device=None, generator=None):
        super().__init__()
        self.MobileNetBackbone_0 = MobileNetBackbone(
            alpha=alpha, bn_momentum=bn_momentum, device=device,
            generator=generator)
        f = self.MobileNetBackbone_0.features
        self.feats1_dom = Dense(f, 256, device, generator)
        self.feats2_dom = Dense(256, 128, device, generator)
        self.dom_regressor = Dense(128, n_domains, device, generator)
        self.feats1_gp = Dense(f, 256, device, generator)
        self.feats2_gp = Dense(256, 128, device, generator)
        self.mit_pred = Dense(128, 2, device, generator)
        name_batch_norms(self)

    def forward(self, x, hp_lambda=1.0, train: bool = True, generator=None,
                stats=None):
        trunk = self.MobileNetBackbone_0
        feats = trunk(_nchw(x, trunk.Conv_0.weight.dtype), train, stats)
        xd = gradient_reversal(feats, hp_lambda)
        xd = F.relu(self.feats1_dom(xd))
        xd = F.relu(self.feats2_dom(xd))
        domain_logits = self.dom_regressor(xd)
        xm = F.relu(self.feats1_gp(feats))
        xm = F.relu(self.feats2_gp(xm))
        return self.mit_pred(xm), domain_logits


def trunk_size(backbone: MobileNetBackbone) -> int:
    """Parameters plus BatchNorm means and variances (keras's count)."""
    return (sum(p.numel() for p in backbone.parameters())
            + sum(b.numel() for b in backbone.buffers()))
