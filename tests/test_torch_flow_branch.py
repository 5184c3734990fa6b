"""The flow's residual branch as the kernels compute it, on the CPU.

``kernels.flow_branch.flow_branch_plain`` (the kernels' steps in plain
torch: the 3x3 out-convolution as a projection onto its nine taps and
their gather by shifted adds) against ``x + lipschitz_apply`` (the
branch as the model computes it), for 1, 4 and 16 channels, the
published hidden width and a small one, square and uneven sizes; and the
dispatch rule of ``IResBlock.forward``: the CPU, autograd and shapes the
kernels are not written for run ``lipschitz_apply``, and
``FlowNormalizer.fused_branches_per_call`` reads 0 on the CPU. The
kernels themselves run on the card (``test_torch_flow_branch_cuda.py``).

Tolerances, largest gap over the largest value: 1e-12 in float64, 1e-5
in float32 (the taps are summed after the projection, the convolution
sums them inside it: the same terms in another order).
"""

import pytest
import torch

from benchmark import flow_weights
from stainlib_tpu_torch.kernels import flow_branch as fb
from stainlib_tpu_torch.models import resflow as trf
from stainlib_tpu_torch.models import train_flow as tf
from stainlib_tpu_torch.models.flow_layers import lipschitz_apply
from stainlib_tpu_torch.normalization.flow import FlowNormalizer
from synth import he_batch

RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(c, hidden, dtype, seed, kernels=(3, 1, 3)):
    """Branch weights at the scale of a spectral-norm layer (std
    sqrt(1 / fan_in)), with nonzero biases."""
    g = torch.Generator().manual_seed(seed)
    shapes = [(hidden, c), (hidden, hidden), (c, hidden)]
    out = []
    for (o, i), k in zip(shapes, kernels):
        w = torch.randn((o, i, k, k), generator=g, dtype=torch.float64)
        b = torch.randn((o,), generator=g, dtype=torch.float64) * 0.1
        out.append(((w / (i * k * k) ** 0.5).to(dtype), b.to(dtype)))
    return out


def _gap(p, r):
    return float((p - r).abs().max() / r.abs().max())


@pytest.mark.parametrize("size", [(16, 16), (24, 40), (3, 5)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("hidden", [128, 8])
@pytest.mark.parametrize("c", [1, 4, 16])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_the_plain_version_is_the_branch(dtype, c, hidden, size):
    weights = _weights(c, hidden, dtype, seed=c * 1000 + hidden)
    x = torch.randn((2, c, *size), generator=torch.Generator().manual_seed(3),
                    dtype=torch.float64).to(dtype)
    got = fb.flow_branch_plain(x, weights)
    want = x + lipschitz_apply(x, weights)
    assert got.dtype == dtype and got.shape == x.shape
    assert _gap(got, want) <= RTOL[dtype]
    if dtype == torch.float32 and fb.supported(weights):
        # On a CPU tensor the entry is the plain version.
        assert torch.equal(fb.flow_branch(x, weights), got)


@pytest.mark.parametrize("c,hidden,kernels,want", [
    (1, 128, (3, 1, 3), True),
    (4, 128, (3, 1, 3), True),
    (16, 128, (3, 1, 3), True),
    (3, 32, (3, 1, 3), True),
    (16, 96, (3, 1, 3), True),
    (1, 128, (3, 3, 3), False),
    (4, 48, (3, 1, 3), False),
    (4, 8, (3, 1, 3), False),
    (17, 128, (3, 1, 3), False),
    (4, 160, (3, 1, 3), False),
    (4, 32, (3, 1), False),
], ids=lambda v: "-".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_the_kernels_take_the_shapes_they_are_written_for(c, hidden, kernels,
                                                          want):
    weights = _weights(c, hidden, torch.float32, seed=1, kernels=kernels)
    assert fb.supported(weights) is want
    # Never on the CPU, whatever the shapes.
    x = torch.zeros((1, c, 8, 8))
    with torch.inference_mode():
        assert not fb.eligible(x, weights)
    if not want:
        with pytest.raises(ValueError):
            fb.flow_branch(x, weights)


def test_the_deploy_forward_on_the_cpu_runs_lipschitz_apply():
    blk = trf.IResBlock(4, hidden=32, kernel_sizes=(3, 1, 3),
                        input_hw=(8, 8),
                        generator=torch.Generator().manual_seed(0))
    x = torch.rand((2, 4, 8, 8), generator=torch.Generator().manual_seed(1))
    before = fb.launches
    with torch.inference_mode():
        y, ld = blk(x, skip_logdet=True)
    assert torch.equal(y, x + lipschitz_apply(x, blk.g.weights()))
    assert torch.equal(ld, torch.zeros(2))
    assert fb.launches == before and not blk.fused


def test_fused_branches_per_call_reads_0_on_the_cpu():
    c = dict(image_size=16, n_scales=2, blocks_per_scale=2, hidden=32,
             kernel_sizes=[3, 1, 3], coeff=0.98, n_clusters=3,
             weights_seed=7)
    tiles = torch.from_numpy(he_batch(3, 16, 16, seed=5,
                                      background_frac=0.2))
    weights = flow_weights.draw(c, flow_weights.seed_of(c, tiles[:1]),
                                "cpu")
    cfg = tf.FlowConfig(image_size=16, n_scales=2, blocks_per_scale=2,
                        hidden=32, kernel_sizes=(3, 1, 3), n_clusters=3)
    norm = FlowNormalizer(cfg, *weights)
    assert norm.fused_branches_per_call == 0
    norm.fit(tiles[:1])
    norm.transform(tiles)
    assert norm.fused_branches_per_call == 0
