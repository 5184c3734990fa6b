"""The flow + GMM colour model's batch entry (``normalization.flow.
FlowNormalizer``) on the CPU: against the benchmark's plain reference
(``benchmark/reference/flow.py``) on the benchmark's seeded random weights
(``benchmark/flow_weights.py``), at the published widths on 32^2 tiles and
at a toy size; the control (the reference with every layer's output
through bfloat16) fails the same tolerances; ``flow_normalize_slide``
gives the bytes of the composition it had before the entry; the per-batch
route gives ``validate_flow.deploy``'s bytes; the spans and the operation
counter.

Tolerances, port against reference, both float32 on the CPU:

* fits (the template's and the slide's per-class mu and sigma) and the
  flow's latent z of the recoloured batch (the entry's ``latent``):
  largest gap at most 1e-5 of the largest value. The two
  round otherwise (the port's float64 logarithms and its sums rounded to
  float32 per batch, the reference's float32 logarithms and float64 sums;
  ``silu / 1.1`` against ``x sigmoid(x) / 1.1``); measured at most 3.3e-7
  here, while the control's gaps are 6e-5 to 7e-4 on the fits and 1.2e-2
  to 2.8e-2 on z.
* uint8 out: at most 1 apart (a last-bit difference moves a truncation by
  one step at most), on at most 1e-3 of the bytes (measured 0); the
  control differs on 0.29 to 0.34 of them.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import flow_weights, flow_work
from benchmark.reference import flow as ref
from stainlib_tpu_torch.data import native
from stainlib_tpu_torch.models import color_eval
from stainlib_tpu_torch.models import train_flow as tf
from stainlib_tpu_torch.models import validate_flow as vf
from stainlib_tpu_torch.normalization import slide as sl
from stainlib_tpu_torch.normalization.flow import FlowNormalizer
from stainlib_tpu_torch.ops.colorspace import hsd_to_rgb, rgb_to_hsd
from stainlib_tpu_torch.utils import checkpoint as ck
from stainlib_tpu_torch.utils import profiling
from synth import he_batch

ROOT = Path(__file__).resolve().parent.parent
PUBLISHED = dict(image_size=256, n_scales=3, blocks_per_scale=5, hidden=128,
                 kernel_sizes=[3, 1, 3], coeff=0.98, n_clusters=4,
                 weights_seed=20191906)
TOY = dict(image_size=16, n_scales=2, blocks_per_scale=2, hidden=8,
           kernel_sizes=[3, 1, 3], coeff=0.98, n_clusters=3,
           weights_seed=7)
FIT_RTOL = 1e-5
U8_MAX, U8_SHARE = 1, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flow_cfg(c: dict) -> tf.FlowConfig:
    return tf.FlowConfig(image_size=c["image_size"], n_scales=c["n_scales"],
                         blocks_per_scale=c["blocks_per_scale"],
                         hidden=c["hidden"], coeff=c["coeff"],
                         n_clusters=c["n_clusters"],
                         kernel_sizes=tuple(c["kernel_sizes"]))


def _tiles(n, side, seed):
    return torch.from_numpy(he_batch(n, side, side, seed=seed,
                                     background_frac=0.2))


def _gap(p, r):
    return float((p - r).abs().max() / r.abs().max())


def _port_and_reference(c, side, low=None):
    """The entry and the reference on one target tile, a 4-tile source and
    a 3-tile batch: (port, reference), each (fits and the batch's latent,
    output)."""
    target, src, batch = (_tiles(1, side, 1), _tiles(4, side, 2),
                          _tiles(3, side, 3))
    weights = flow_weights.draw(c, flow_weights.seed_of(c, target), "cpu")
    norm = FlowNormalizer(_flow_cfg(c), *weights)
    t, s = norm.fit(target), norm.fit_source(src)
    out = norm.transform(batch)
    port = ({"template_mu": t.mu, "template_sigma": t.sigma,
             "slide_mu": s.mu, "slide_sigma": s.sigma, "z": norm.latent},
            out)
    rt, rs = ref.stats(target, weights, c, low), ref.stats(src, weights, c,
                                                           low)
    want = ({"template_mu": rt[0], "template_sigma": rt[1],
             "slide_mu": rs[0], "slide_sigma": rs[1],
             "z": ref.latent(batch, weights, c, low)},
            ref.recolor(batch, weights, c, rs, rt, low))
    return port, want


def _u8(a, b):
    d = (a.to(torch.int16) - b.to(torch.int16)).abs()
    return int(d.max()), float((d > 0).float().mean())


@pytest.mark.parametrize("c,side", [(PUBLISHED, 32), (TOY, 16)],
                         ids=["published-32", "toy-16"])
def test_the_entry_matches_the_reference(c, side):
    (fits, out), (rfits, rout) = _port_and_reference(c, side)
    assert out.dtype == torch.uint8 and out.shape == (3, side, side, 3)
    for k, r in rfits.items():
        assert fits[k].shape == r.shape
        assert _gap(fits[k], r) <= FIT_RTOL, k
    worst, share = _u8(out, rout)
    assert worst <= U8_MAX and share <= U8_SHARE, (worst, share)


@pytest.mark.parametrize("c,side", [(PUBLISHED, 32), (TOY, 16)],
                         ids=["published-32", "toy-16"])
def test_the_control_fails_the_tolerances(c, side):
    (fits, out), (rfits, rout) = _port_and_reference(c, side, torch.bfloat16)
    assert _gap(fits["z"], rfits["z"]) > FIT_RTOL
    assert max(_gap(fits[k], rfits[k]) for k in fits if k != "z") > FIT_RTOL
    assert _u8(out, rout)[1] > U8_SHARE


def test_the_weights_carry_the_models_names_and_shapes():
    c = PUBLISHED
    params, spectral = flow_weights.draw(c, 5, "cpu")
    flow, gmm = tf.build_models(_flow_cfg(c), "meta")
    want = {n: p.shape for n, p in flow.named_parameters()}
    assert {n: p.shape for n, p in params["flow"].items()} == want
    assert {n: p.shape for n, p in params["gmm"].items()} == {
        n: p.shape for n, p in gmm.named_parameters()}
    assert set(spectral) == {n for n, _ in flow.named_buffers()}
    n_params = sum(p.numel() for part in params.values()
                   for p in part.values())
    assert n_params == flow_work.weight_count(c) == 502_855


@pytest.mark.parametrize("c,side", [(PUBLISHED, 32), (TOY, 16)],
                         ids=["published-32", "toy-16"])
def test_conv_flops_per_call_is_the_benchmarks_count(c, side):
    target = _tiles(1, side, 1)
    norm = FlowNormalizer(_flow_cfg(c), *flow_weights.draw(c, 3, "cpu"))
    norm.fit(target)
    assert norm.conv_flops_per_call == 0
    norm.transform(_tiles(2, side, 4))
    assert norm.conv_flops_per_call == 2 * flow_work.conv_flops(c, side)


def test_the_published_encode_counts_18_7_gflop_per_256_tile():
    assert flow_work.conv_flops(PUBLISHED, 256) == 18_712_363_008
    bound, by = flow_work.encode_bound_ms(PUBLISHED, 64, 256)
    assert by == "operations" and 18.0 < bound < 19.0


def _small_state(tmp_path):
    cfg = tf.FlowConfig(image_size=16, n_scales=2, blocks_per_scale=1,
                        hidden=8, n_power_series=2, n_clusters=3,
                        kernel_sizes=(3, 1, 3))
    _, _, state, _ = tf.init_flow_state(cfg, 3, device="cpu")
    ema = state.ema._replace(params=torch.utils._pytree.tree_map(
        lambda p: p * 0.98, state.params))
    ck.save_checkpoint(str(tmp_path / "ck"), state._replace(ema=ema), 7)
    return cfg, str(tmp_path / "ck")


def _old_recolor(cfg, ckpt, template, src_tiles, batch, transfer,
                 class_match):
    """``flow_normalize_slide``'s recolour as it was composed before the
    entry: template and source statistics, then per batch gamma and the
    transfer."""
    tmpl_hsd = rgb_to_hsd(torch.from_numpy(template))
    flow, gmm, state, _ = tf.init_flow_state(
        cfg, 0, sample_hsd=tmpl_hsd[:batch], device="cpu")
    state = ck.restore_checkpoint(ckpt, state)
    params, spectral = state.ema.params, state.spectral
    full = transfer == "full"
    quant = transfer in ("quantile", "rgb-quantile")
    q_space = "rgb" if transfer == "rgb-quantile" else "hsd"

    def stats(hsd):
        return vf.accumulate_template_stats(
            flow, gmm, cfg, params, spectral,
            [hsd[i:i + batch] for i in range(0, len(hsd), batch)],
            return_cov=full, return_quantiles=quant, quantile_space=q_space)

    t_stats = stats(tmpl_hsd)
    s_stats = stats(rgb_to_hsd(torch.from_numpy(src_tiles)))
    perm = (color_eval.match_classes_by_usage(s_stats.usage, t_stats.usage)
            if class_match else None)

    def recolor(batch_u8, _bi):
        hsd = rgb_to_hsd(batch_u8)
        gamma = vf.encode_gamma(flow, gmm, params, spectral, hsd)
        if quant:
            xq = hsd if q_space == "hsd" else hsd_to_rgb(hsd)
            return color_eval.image_dist_transform_quantile(
                xq, gamma, s_stats.quantiles, t_stats.quantiles, perm=perm,
                space=q_space)
        if full:
            return color_eval.image_dist_transform_full(
                hsd, gamma, s_stats.mu, s_stats.cov, t_stats.mu,
                t_stats.cov, perm=perm)
        return color_eval.image_dist_transform(
            hsd, gamma, s_stats.mu, s_stats.sigma, t_stats.mu,
            t_stats.sigma, perm=perm)

    return recolor


@pytest.mark.parametrize("transfer,class_match", [
    ("diag", False), ("full", True), ("quantile", False),
    ("rgb-quantile", True)])
def test_flow_normalize_slide_keeps_its_bytes(tmp_path, monkeypatch,
                                              transfer, class_match):
    cfg, ckpt = _small_state(tmp_path)
    tiles = he_batch(4, 48, 48, seed=0, background_frac=0.0)
    lv0 = np.concatenate([np.concatenate(list(tiles[:2]), axis=1),
                          np.concatenate(list(tiles[2:]), axis=1)],
                         axis=0)[:80, :90].copy()
    lv0[:6] = 255
    src = str(tmp_path / "s.wsiraw")
    native.write_wsiraw(src, [lv0])
    template = he_batch(8, 16, 16, seed=5, background_frac=0.0)
    got = {}

    def keep(canvas, min_dim=512):
        got["canvas"] = np.array(canvas)
        return [canvas]

    monkeypatch.setattr(sl, "build_pyramid", keep)
    monkeypatch.setattr(sl, "write_tiff_pyramid", lambda *a, **k: None)
    sl.flow_normalize_slide(src, str(tmp_path / "o.tif"), ckpt,
                            template=template, batch=4, n_src_tiles=6,
                            cfg=cfg, class_match=class_match,
                            transfer=transfer, device="cpu")
    slide = native.open_slide(src)
    try:
        src_tiles, xy = slide.sample_tiles(0, 16, 6, seed=0)
        if (xy[:, 0] >= 0).any():
            src_tiles = src_tiles[xy[:, 0] >= 0]
        recolor = _old_recolor(cfg, ckpt, template,
                               np.ascontiguousarray(src_tiles), 4, transfer,
                               class_match)
        want, _ = sl._stream_canvas(slide, 0, 16, 4, 90, 80, recolor, None,
                                    2, 2, device="cpu")
    finally:
        slide.close()
    assert np.array_equal(got["canvas"], np.asarray(want))


@pytest.mark.parametrize("class_match", [False, True])
def test_the_per_batch_route_is_deploys(class_match):
    c = TOY
    params, spectral = flow_weights.draw(c, 11, "cpu")
    cfg = _flow_cfg(c)
    norm = FlowNormalizer(cfg, params, spectral, class_match=class_match)
    t = norm.fit(_tiles(4, 16, 1))
    batches = [_tiles(3, 16, 6), _tiles(3, 16, 9)]
    flow, gmm = tf.build_models(cfg, "meta")
    _, outs, _ = vf.deploy(flow, gmm, cfg, params, spectral,
                           [rgb_to_hsd(b) for b in batches], t.mu, t.sigma,
                           log=lambda _m: None,
                           usage_tmpl=t.usage if class_match else None)
    for b, want in zip(batches, outs):
        assert np.array_equal(norm.transform(b).numpy(), want)


def test_transform_before_fit_and_unknown_transfers_raise():
    c = TOY
    weights = flow_weights.draw(c, 1, "cpu")
    with pytest.raises(ValueError, match="transfer"):
        FlowNormalizer(_flow_cfg(c), *weights, transfer="full-quantile")
    with pytest.raises(RuntimeError, match="fit"):
        FlowNormalizer(_flow_cfg(c), *weights).transform(_tiles(1, 16, 0))


def _refuse(*args, **kw):
    raise AssertionError("a span was made with no profiler recording")


def test_no_span_is_made_when_no_profiler_records(monkeypatch):
    monkeypatch.setattr(profiling, "record_function", _refuse)
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        _refuse)
    c = TOY
    norm = FlowNormalizer(_flow_cfg(c), *flow_weights.draw(c, 2, "cpu"))
    norm.fit(_tiles(1, 16, 0))
    norm.fit_source(_tiles(2, 16, 1))
    assert norm.transform(_tiles(2, 16, 2)).shape == (2, 16, 16, 3)


def _inside(child, parent):
    return (parent["ts"] <= child["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"])


def test_the_spans_nest_in_a_trace(tmp_path):
    c = TOY
    norm = FlowNormalizer(_flow_cfg(c), *flow_weights.draw(c, 2, "cpu"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        norm.fit(_tiles(1, 16, 0))
        norm.fit_source(_tiles(2, 16, 1))
        norm.transform(_tiles(2, 16, 2))
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    spans = [e for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"]
    by = {}
    for e in spans:
        by.setdefault(e["name"], []).append(e)
    assert len(by["stain.flow.fit"]) == 2
    (top,), (enc,), (tra,) = (by[n] for n in (
        "stain.flow", "stain.flow.encode", "stain.flow.transfer"))
    assert _inside(enc, top) and _inside(tra, top)
    assert enc["ts"] + enc["dur"] <= tra["ts"]
    convs = [e for e in json.loads(path.read_text())["traceEvents"]
             if e.get("name") == "aten::conv2d" and _inside(e, top)]
    assert convs and all(_inside(e, enc) for e in convs)


def test_the_reference_imports_neither_package():
    probe = ("import json, sys; import benchmark.reference.flow, "
             "benchmark.flow_weights, benchmark.flow_work; "
             "print(json.dumps(sorted({m.split('.')[0] "
             "for m in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "stainlib_tpu",
                      "stainlib_tpu_torch"}
