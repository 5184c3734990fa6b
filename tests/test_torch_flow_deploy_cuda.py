"""The flow + GMM colour model's batch entry on the card, at the published
widths: 64 tiles of 256^2 (the cell's batch), the capacity model
(3 scales x 5 iResBlocks, 128 hidden channels, 3-1-3 kernels, 4 classes)
on the benchmark's seeded random weights, against the plain reference
(``benchmark/reference/flow.py``) on the same card; and the entry's spans
in a ``utils.profiling.trace`` of the card. Needs a CUDA device (marker
``cuda``; every test skips without one). The card has no jax, so this
file imports only torch, numpy, the port and the benchmark's reference.
On the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_flow_deploy_cuda.py

Tolerances: the benchmark's limits (``benchmark/limits/flow-deploy.json``,
set from ``benchmark/calibrate.py`` readings on the card; their reasons in
PERF.md section 2).
"""

import json
from pathlib import Path

import pytest
import torch

from benchmark import flow_weights, model_spans, tiles, trace
from benchmark.reference import flow as ref
from stainlib_tpu_torch.models import train_flow as tf
from stainlib_tpu_torch.normalization.flow import FlowNormalizer
from stainlib_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parent.parent
CFG = json.loads((ROOT / "benchmark/configs/resflow-capacity.json")
                 .read_text())
LIMITS = json.loads((ROOT / "benchmark/limits/flow-deploy.json").read_text())
# The cell's mix, one batch of its pool.
MIX = dict(json.loads((ROOT / "benchmark/traffic/perslide-256-b64.json")
                      .read_text()), pool_batches=1)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's card path")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def fitted(dev):
    seed = 2 ** 31 + 5
    pool = tiles.make_pool(MIX, seed, dev)
    target = tiles.make_target(CFG["target"], seed, dev)
    weights = flow_weights.draw(CFG, flow_weights.seed_of(CFG, target), dev)
    fc = tf.FlowConfig(image_size=256, n_scales=3, blocks_per_scale=5,
                       hidden=128, kernel_sizes=(3, 1, 3), n_clusters=4)
    norm = FlowNormalizer(fc, *weights)
    batch = pool.batches[0]
    src = batch[:32]
    return dict(norm=norm, weights=weights, target=target, batch=batch,
                src=src, t=norm.fit(target[None]),
                s=norm.fit_source(src))


def _gap(p, r):
    return float((p - r).abs().max() / r.abs().max())


def test_the_entry_matches_the_reference_at_the_published_widths(fitted):
    f = fitted
    out = f["norm"].transform(f["batch"])
    assert out.shape == (64, 256, 256, 3) and out.dtype == torch.uint8
    rt = ref.stats(f["target"][None], f["weights"], CFG)
    rs = ref.stats(f["src"], f["weights"], CFG)
    for got, want, key in [(f["t"].mu, rt[0], "template_mu"),
                           (f["t"].sigma, rt[1], "template_sigma"),
                           (f["s"].mu, rs[0], "slide_mu"),
                           (f["s"].sigma, rs[1], "slide_sigma")]:
        assert _gap(got, want) <= LIMITS[key], key
    assert _gap(f["norm"].latent, ref.latent(f["batch"], f["weights"],
                                             CFG)) <= LIMITS["mosaic_z"]
    want = ref.recolor(f["batch"], f["weights"], CFG, rs, rt)
    d = (out.to(torch.int16) - want.to(torch.int16)).abs()
    assert int(d.max()) <= LIMITS["out_max_u8"]
    assert float((d > 0).float().mean()) <= LIMITS["out_share_ne"]
    assert f["norm"].conv_flops_per_call == 64 * 18_712_363_008


def test_the_spans_hold_the_encode_and_the_transfer(fitted, tmp_path):
    f = fitted
    f["norm"].transform(f["batch"])  # warm
    with profiling.trace(str(tmp_path)):
        with torch.profiler.record_function("bench.window"):
            f["norm"].transform(f["batch"])
    (path,) = tmp_path.glob("trace_*.json")
    rec = dict(trace=trace.read(str(path), "bench.window", "bench.entry"))
    names = {h["name"] for h in rec["trace"]["host"]}
    assert {"stain.flow", "stain.flow.encode", "stain.flow.transfer"} <= names
    enc = model_spans.span_device_ms(rec, "stain.flow.encode")
    tra = model_spans.span_device_ms(rec, "stain.flow.transfer")
    # The encode's convolutions dominate: 1.2 TFLOP against the
    # transfer's elementwise passes over 4.2M pixels.
    assert enc > 5.0 * tra > 0.0
