"""The flow's residual branch kernels (``kernels/flow_branch.py``) on the
card: against their plain version for 1, 4 and 16 channels at the
capacity model's three grids and at sizes that are not multiples of the
kernel's 128-pixel tile, for batches of 1, 3 and 64; the same bytes on two
runs; the deploy encode at ``reference_capacity()`` with the kernels
against the same encode on ``lipschitz_apply``; autograd and a training
step, which never take the kernels; a refused launch. Needs a CUDA device
(marker ``cuda``; every test skips without one). The card has no jax, so
this file imports only torch, the port and the benchmark's files. On the
card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_flow_branch_cuda.py

Tolerances, largest gap over the largest value: 1e-5 against the plain
version and on the latent (float32 products summed in another order:
FFMA chains in the kernel, cuDNN's in the plain version); the colours read
gamma, which reads the chroma alone, so gamma and the recoloured tiles
are the same bytes.
"""

import dataclasses
import json
from pathlib import Path

import pytest
import torch
from torch.func import functional_call

from benchmark import flow_weights, tiles
from stainlib_tpu_torch.kernels import _build
from stainlib_tpu_torch.kernels import flow_branch as fb
from stainlib_tpu_torch.models import train_flow as tf
from stainlib_tpu_torch.models import validate_flow as vf
from stainlib_tpu_torch.normalization.flow import FlowNormalizer
from stainlib_tpu_torch.ops.colorspace import rgb_to_hsd

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parent.parent
CFG = json.loads((ROOT / "benchmark/configs/resflow-capacity.json")
                 .read_text())
MIX = dict(json.loads((ROOT / "benchmark/traffic/perslide-256-b64.json")
                      .read_text()), pool_batches=1)
RTOL = 1e-5
HIDDEN = 128


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the branch kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _weights(c, dev, seed, hidden=HIDDEN):
    """Branch weights at the scale of a spectral-norm layer, nonzero
    biases."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for (o, i), k in zip([(hidden, c), (hidden, hidden), (c, hidden)],
                         (3, 1, 3)):
        w = torch.randn((o, i, k, k), generator=g) / (i * k * k) ** 0.5
        b = torch.randn((o,), generator=g) * 0.1
        out.append((w.to(dev), b.to(dev)))
    return out


def _x(batch, c, h, w, dev, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((batch, c, h, w), generator=g).to(dev)


def _gap(p, r):
    return float((p - r).abs().max() / r.abs().max())


@pytest.mark.parametrize("batch", [1, 3, 64])
@pytest.mark.parametrize("size", [(256, 256), (128, 128), (64, 64),
                                  (45, 37), (20, 20)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("c", [1, 4, 16])
def test_the_kernels_match_their_plain_version(dev, c, size, batch):
    weights = _weights(c, dev, seed=c)
    x = _x(batch, c, *size, dev, seed=batch)
    before = fb.launches
    with torch.inference_mode():
        got = fb.flow_branch(x, weights)
        want = fb.flow_branch_plain(x, weights)
    assert fb.launches == before + 1
    assert got.shape == x.shape and got.dtype == torch.float32
    assert _gap(got, want) <= RTOL


@pytest.mark.parametrize("c,side", [(1, 256), (4, 128), (16, 64)])
def test_two_runs_give_the_same_bytes(dev, c, side):
    weights = _weights(c, dev, seed=10 + c)
    x = _x(64, c, side, side, dev, seed=5)
    with torch.inference_mode():
        assert torch.equal(fb.flow_branch(x, weights),
                           fb.flow_branch(x, weights))


def test_the_deploy_encode_takes_the_kernels(dev, monkeypatch):
    seed = 2 ** 31 + 17
    batch = tiles.make_pool(MIX, seed, dev).batches[0]
    target = tiles.make_target(CFG["target"], seed, dev)
    params, spectral = flow_weights.draw(
        CFG, flow_weights.seed_of(CFG, target), dev)
    fc = tf.FlowConfig(image_size=256, n_scales=3, blocks_per_scale=5,
                       hidden=128, kernel_sizes=(3, 1, 3), n_clusters=4)
    flow, gmm = tf.build_models(fc, "meta")
    hsd = rgb_to_hsd(batch)
    before = fb.launches
    z, gamma = vf.encode_latent(flow, gmm, params, spectral, hsd)
    assert fb.launches - before == 15
    norm = FlowNormalizer(fc, params, spectral)
    norm.fit(target[None])
    norm.fit_source(batch[:32])
    out = norm.transform(batch)
    assert norm.fused_branches_per_call == 15

    monkeypatch.setattr(fb, "eligible", lambda x, weights: False)
    z0, gamma0 = vf.encode_latent(flow, gmm, params, spectral, hsd)
    assert _gap(z, z0) <= RTOL
    assert torch.equal(gamma, gamma0)
    assert torch.equal(norm.transform(batch), out)
    assert norm.fused_branches_per_call == 0


def test_autograd_and_training_never_take_the_kernels(dev, monkeypatch):
    cfg = dataclasses.replace(tf.reference_capacity(), image_size=32)
    flow, gmm, state, tx = tf.init_flow_state(cfg, 7, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    hsd = torch.rand((2, 32, 32, 3), generator=g, device=dev) * 2.0
    x = tf._density01(hsd)
    variables = {**state.params["flow"], **state.spectral}
    step = tf.make_train_step(flow, gmm, cfg, tx)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        def run():
            with torch.enable_grad():
                z = functional_call(flow, variables, (x,),
                                    {"skip_logdet": True})[0]
            new, loss = step(state, hsd)
            return z, new, loss

        before = fb.launches
        z, new, loss = run()
        assert fb.launches == before
        monkeypatch.setattr(fb, "eligible", lambda x, weights: False)
        z0, new0, loss0 = run()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert torch.equal(z, z0) and torch.equal(loss, loss0)
    for name, p in new.params["flow"].items():
        assert torch.equal(p, new0.params["flow"][name]), name


def test_a_refused_launch_raises(dev, monkeypatch):
    """A refused launch raises; nothing falls back to the plain version,
    and no branch is counted."""

    class RefusingLibrary:
        def __getattr__(self, name):
            if name == "stain_error_string":
                return lambda err: b"refused for the test"
            return lambda *args: 1  # cudaErrorInvalidValue

    weights = _weights(4, dev, seed=1)
    x = _x(2, 4, 32, 32, dev, seed=2)
    _build.load_library()
    monkeypatch.setattr(_build, "_lib", RefusingLibrary())
    before = fb.launches
    with torch.inference_mode():
        with pytest.raises(RuntimeError, match="^flow_branch_launch failed"):
            fb.flow_branch(x, weights)
    assert fb.launches == before
