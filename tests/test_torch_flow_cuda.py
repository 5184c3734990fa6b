"""The flow + GMM model and its trainer on the card.

The same small flow on the card and on the CPU with the same weights and
probes; a train step, ``encode``, a checkpoint round trip and the
training CLI on CUDA tensors. Needs a CUDA device (marker ``cuda``; every
test skips without one). The card has no jax, so this file imports only
torch, numpy and the port. On the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_flow_cuda.py

Tolerances, card against CPU: z atol 1e-4, delta_logp rtol 1e-4, the loss
rtol 1e-5, each gradient leaf within 1e-3 of its largest value (cuDNN's
convolutions round otherwise than the CPU's).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.func import functional_call

from stainlib_tpu_torch.models import train_flow as tf
from stainlib_tpu_torch.ops.colorspace import rgb_to_hsd
from stainlib_tpu_torch.utils import checkpoint as ck
from synth import he_batch

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parent.parent
CFG = tf.FlowConfig(image_size=16, n_scales=2, blocks_per_scale=2, hidden=8,
                    n_power_series=3, warmup_iters=0)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's card path")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def cpu_state():
    hsd = rgb_to_hsd(torch.from_numpy(he_batch(4, 16, 16, seed=1,
                                               background_frac=0.0)))
    flow, gmm, state, tx = tf.init_flow_state(CFG, 0, hsd, "cpu")
    probes = flow.draw_probes((4, 1, 16, 16), torch.Generator().manual_seed(1))
    return hsd, flow, gmm, state, tx, probes


def _on(state, dev):
    moved = torch.utils._pytree.tree_map(
        lambda t: t.to(dev) if isinstance(t, torch.Tensor) else t,
        state._replace(rng=None))
    return moved._replace(rng=tf.rng_state(0))


def _rel(a, b):
    return float((a.cpu() - b).abs().max() / b.abs().max())


def test_flow_forward_and_loss_card_against_cpu(dev, cpu_state):
    hsd, flow, gmm, state, tx, probes = cpu_state
    gflow, ggmm = tf.build_models(CFG, dev)
    gstate = _on(state, dev)
    x = torch.clamp(hsd[..., 2:3] / 4, 1e-4, 1 - 1e-4).permute(0, 3, 1, 2)
    with torch.no_grad():
        z, dl = functional_call(flow, {**state.params["flow"],
                                       **state.spectral}, (x,),
                                {"probes": probes})
        gz, gdl = functional_call(
            gflow, {**gstate.params["flow"], **gstate.spectral},
            (x.to(dev),), {"probes": [p.to(dev) for p in probes]})
    assert gz.is_cuda
    assert float((gz.cpu() - z).abs().max()) <= 1e-4
    assert _rel(gdl, dl) <= 1e-4
    loss, grads = tf.loss_and_grads(flow, gmm, CFG, state.params,
                                    state.spectral, hsd, probes)
    gloss, ggrads = tf.loss_and_grads(
        gflow, ggmm, CFG, gstate.params, gstate.spectral, hsd.to(dev),
        [p.to(dev) for p in probes])
    assert abs(float(gloss) - float(loss)) <= 1e-5 * abs(float(loss))
    for part in grads:
        for k in grads[part]:
            assert _rel(ggrads[part][k], grads[part][k]) <= 1e-3, k


def test_train_step_encode_and_checkpoint_on_card(dev, tmp_path):
    hsd = rgb_to_hsd(torch.from_numpy(
        he_batch(4, 16, 16, seed=2, background_frac=0.0)).to(dev))
    flow, gmm, state, tx = tf.init_flow_state(CFG, 0, hsd, dev)
    assert state.params["flow"]["scales.0.0.g.convs.0.weight"].is_cuda
    step = tf.make_train_step(flow, gmm, CFG, tx)
    for _ in range(2):
        state, loss = step(state, hsd)
    assert state.step == 2 and torch.isfinite(loss)
    ck.save_checkpoint(str(tmp_path), state, state.step)
    _, _, fresh, _ = tf.init_flow_state(CFG, 5, device=dev)
    back = ck.restore_checkpoint(str(tmp_path), fresh)
    assert back.params["gmm"]["mu"].is_cuda
    a, la = step(state, hsd)
    b, lb = step(back, hsd)
    assert torch.equal(la, lb)
    bpd, z, gamma = tf.encode(flow, gmm, a.params, a.spectral, CFG, hsd[:2],
                              generator=torch.Generator(dev).manual_seed(0))
    assert gamma.shape == (2, CFG.n_clusters, 16, 16) and bpd.is_cuda
    np.testing.assert_allclose(gamma.sum(1).cpu().numpy(), 1.0, atol=1e-5)


def test_cli_on_card(dev, tmp_path):
    cmd = [sys.executable, str(ROOT / "scripts" / "torch_train_flow.py"),
           "--steps", "2", "--image-size", "16", "--batch", "4",
           "--n-scales", "1", "--blocks", "1", "--hidden", "8",
           "--save", str(tmp_path), "--save-every", "1"]
    env = {k: v for k, v in os.environ.items() if k != "WORLD_SIZE"}
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                       env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "device cuda:0" in r.stdout
    assert ck.latest_step(str(tmp_path)) == 2
