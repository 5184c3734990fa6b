"""The work of the flow + GMM colour model's encode, counted from shapes:
its float32 operations and its least bytes, and the least time one H100
could take for them (the peaks of ``roofline.py``).

The encode is what ``FlowNormalizer.transform`` runs before the transfer:
the flow's forward without its log-determinant, which gives the batch's
latent (the entry's ``latent``, one of its results, held to the reference
by the cell's ``mosaic_z``), and the GMM head, which gives gamma. Its
operations are those of every convolution, ``2 Cin Cout k^2`` per output
pixel (the flow's scale ``s`` on the image grid halved ``s`` times, the
GMM head's three 3x3 convolutions on the latent grid), and of the
activations: :data:`SWISH_OPS` per element of each swish / 1.1 pass over a
hidden tensor, one per element of each ReLU of the GMM head. The rest
(ActNorm, the residual adds, the logit, the pooling, the softmax) is left
out: a few operations per pixel of a 1- to 16-channel tensor. Its least
bytes are the uint8 tiles read once and written once, the float32 latent
written once (as many values as pixels: the squeezes keep the count) and
the weights read once. Whatever implements the encode, the bound stays: it
is the work, not the code. An encode that gave gamma alone, without the
latent, would be other work with another bound.
"""

from __future__ import annotations

from benchmark import roofline

SWISH_OPS = 5  # exp, add, reciprocal, multiply, the scale by 1 / 1.1
GMM_LAYERS = (2, 32, 32)  # the GMM head's input channels, layer by layer


def _scales(cfg: dict, side: int):
    """(channels, side) of each scale of the flow."""
    return [(4 ** s, side >> s) for s in range(cfg["n_scales"])]


def _flow_convs(cfg: dict, c: int):
    """(Cin, Cout, k) of one residual branch on ``c`` channels."""
    h, ks = cfg["hidden"], cfg["kernel_sizes"]
    return [(ci, co, ks[i % len(ks)])
            for i, (ci, co) in enumerate(zip([c, h, h], [h, h, c]))]


def _gmm_convs(cfg: dict):
    outs = list(GMM_LAYERS[1:]) + [cfg["n_clusters"]]
    return [(ci, co, 3) for ci, co in zip(GMM_LAYERS, outs)]


def conv_flops(cfg: dict, side: int) -> int:
    """The float32 operations of every convolution of one tile's encode."""
    total = 0
    for c, s in _scales(cfg, side):
        per_px = sum(2 * ci * co * k * k for ci, co, k in _flow_convs(cfg, c))
        total += cfg["blocks_per_scale"] * per_px * s * s
    z = side >> (cfg["n_scales"] - 1)
    total += sum(2 * ci * co * k * k for ci, co, k in _gmm_convs(cfg)) * z * z
    return total


def encode_ops(cfg: dict, side: int) -> int:
    """Every counted float32 operation of one tile's encode."""
    act = sum(cfg["blocks_per_scale"] * 2 * cfg["hidden"] * s * s * SWISH_OPS
              for _, s in _scales(cfg, side))
    z = side >> (cfg["n_scales"] - 1)
    relu = sum(co for _, co, _ in _gmm_convs(cfg)[:-1]) * z * z
    return conv_flops(cfg, side) + act + relu


def weight_count(cfg: dict) -> int:
    n = 0
    for c, _ in _scales(cfg, cfg["image_size"]):
        branch = sum(ci * co * k * k + co for ci, co, k in _flow_convs(cfg, c))
        n += cfg["blocks_per_scale"] * (branch + 2 * c)
    n += sum(ci * co * k * k + co for ci, co, k in _gmm_convs(cfg))
    return n + 2 * cfg["n_clusters"]  # the class means and log-scales


def encode_bound_ms(cfg: dict, batch: int, side: int):
    """(the least time in ms of one batch's encode, "bytes" or
    "operations": which bound rules)."""
    n_bytes = batch * side * side * (2 * 3 + 4) + 4 * weight_count(cfg)
    t_bytes = n_bytes / roofline.HBM_BYTES_PER_S * 1e3
    t_ops = batch * encode_ops(cfg, side) / roofline.F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
