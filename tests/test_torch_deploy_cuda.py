"""Flow deployment and evaluation on the card: the card against the CPU.

``encode_gamma``, the quantiles' scan and interpolation, every transfer,
``validate``, ``flow_normalize_slide``'s stream, ``sample_flow`` and the toy
flow, with the same weights on both devices. Needs a CUDA device (marker
``cuda``; every test skips without one). The card has no jax, so this file
imports only torch, numpy and the port. On the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_deploy_cuda.py

Tolerances, card against CPU: gamma atol 1e-5 (cuDNN's convolutions round
otherwise than the CPU's); ``_cumsum`` and ``_interp`` the same bits; the
uint8 outputs within 1 on all but 1e-3 of the bytes, at most 2; the
template statistics rtol 1e-5, atol 1e-6; NMI within 1e-5 where the bytes
are equal; samples and the toy flow atol 1e-4.
"""

import numpy as np
import pytest
import torch

from stainlib_tpu_torch.data import native
from stainlib_tpu_torch.data.synthetic import multi_center_batches
from stainlib_tpu_torch.models import color_eval as ce
from stainlib_tpu_torch.models import train_flow as tf
from stainlib_tpu_torch.models import validate_flow as vf
from stainlib_tpu_torch.models.sampling import _sample_flow_apply
from stainlib_tpu_torch.models.toy import ToyResFlow
from stainlib_tpu_torch.normalization import slide as sl
from stainlib_tpu_torch.ops.colorspace import rgb_to_hsd
from stainlib_tpu_torch.utils import checkpoint as ck

pytestmark = pytest.mark.cuda

CFG = tf.FlowConfig(image_size=16, n_scales=2, blocks_per_scale=1, hidden=8,
                    n_power_series=2, n_clusters=3)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's card path")
    return torch.device("cuda", 0)


def _on(tree, d):
    return {k: _on(v, d) if isinstance(v, dict) else v.to(d)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def model(dev):
    rgb, _ = multi_center_batches(range(4), 3, 4, 16, 16, seed=11)
    hsd = [rgb_to_hsd(torch.from_numpy(b)) for b in rgb]
    flow, gmm, state, _ = tf.init_flow_state(CFG, 0, hsd[0], "cpu")
    gflow, ggmm = tf.build_models(CFG, dev)
    return dict(cpu=(flow, gmm, state.params, state.spectral),
                card=(gflow, ggmm, _on(state.params, dev),
                      _on(state.spectral, dev)),
                hsd=hsd, state=state)


def _u8_budget(got, want):
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 2 and (d > 1).mean() <= 1e-3, (d.max(),
                                                      (d > 1).mean())
    return d.reshape(len(d), -1).max(1)


def test_gamma_only_route_card_vs_cpu(model, dev):
    f, g, p, s = model["cpu"]
    gf, gg, gp, gs = model["card"]
    want = vf.encode_gamma(f, g, p, s, model["hsd"][0])
    got = vf.encode_gamma(gf, gg, gp, gs, model["hsd"][0].to(dev))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5)
    _, _, enc = tf.encode(gf, gg, gp, gs, CFG, model["hsd"][0].to(dev),
                          generator=torch.Generator(dev).manual_seed(0))
    assert torch.equal(got, enc.permute(0, 2, 3, 1))


def test_scan_and_interp_same_bits_on_the_card(dev):
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.random((3, 70_001, 2)).astype(np.float32) ** 4)
    assert torch.equal(ce._cumsum(w.to(dev), 1).cpu(), ce._cumsum(w, 1))
    xp = torch.from_numpy(np.sort(rng.random((3, 33)), -1).astype(np.float32))
    fp = torch.from_numpy(rng.random((3, 33)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(-0.1, 1.1, (3, 5000)).astype(np.float32))
    got = ce._interp(x.to(dev), xp.to(dev), fp.to(dev)).cpu()
    assert torch.equal(got, ce._interp(x, xp, fp))


@pytest.mark.parametrize("transfer", vf.TRANSFERS)
def test_validate_card_vs_cpu(model, dev, transfer):
    outs = {}
    for where in ("cpu", "card"):
        f, g, p, s = model[where]
        outs[where] = vf.validate(f, g, CFG, p, s, model["hsd"][:1],
                                  model["hsd"][1:], log=lambda *_: None,
                                  transfer=transfer, class_match=True)
    a, b = outs["card"], outs["cpu"]
    for name in ("mu", "sigma", "usage", "cov", "quantiles"):
        x, y = getattr(a["stats"], name), getattr(b["stats"], name)
        if y is not None:
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
    d_max = np.concatenate([_u8_budget(x, y) for x, y in
                            zip(a["outputs"], b["outputs"])])
    same = d_max == 0
    np.testing.assert_allclose(np.asarray(a["nmi"])[same],
                               np.asarray(b["nmi"])[same], atol=1e-5)


def test_flow_normalize_slide_stream_on_the_card(model, dev, tmp_path,
                                                 monkeypatch):
    """The stream on the card against the CPU's; the writer is not run
    where the host has no libtiff. One checkpoint, saved from the CPU
    state, serves both deploys: its ``rng`` leaf has one layout on every
    device."""
    lv0 = np.concatenate([np.concatenate(list(b), axis=1) for b in
                          multi_center_batches(range(4), 2, 4, 16, 16,
                                               seed=3)[0]], axis=0)
    src = str(tmp_path / "s.wsiraw")
    native.write_wsiraw(src, [lv0])
    seen = []
    real = sl._stream_canvas

    def keep(*a, **k):
        res = real(*a, **k)
        seen.append(res[0])
        return res

    monkeypatch.setattr(sl, "_stream_canvas", keep)
    if not native.tiff_native_available():
        monkeypatch.setattr(sl, "write_tiff_pyramid", lambda *a, **k: None)
    tmpl = multi_center_batches([0], 8, 8, 16, 16, seed=5)[0][0]
    ck.save_checkpoint(str(tmp_path / "ck"), model["state"], 0)
    for d in (dev, torch.device("cpu")):
        sl.flow_normalize_slide(src, str(tmp_path / "o.tif"),
                                str(tmp_path / "ck"), template=tmpl,
                                batch=4, n_src_tiles=4, cfg=CFG,
                                compression="none", device=d)
    _u8_budget(seen[0][None], seen[1][None])


def test_checkpoints_restore_across_devices(model, dev, tmp_path,
                                            monkeypatch):
    """A state saved on the CPU restores into a template made on the card,
    and the reverse; both deploy ``flow_normalize_slide`` on the card to
    the same bytes, and a restored state steps on as it would have."""
    lv0 = np.concatenate([np.concatenate(list(b), axis=1) for b in
                          multi_center_batches(range(4), 2, 4, 16, 16,
                                               seed=3)[0]], axis=0)
    src = str(tmp_path / "s.wsiraw")
    native.write_wsiraw(src, [lv0])
    seen = []
    real = sl._stream_canvas

    def keep(*a, **k):
        res = real(*a, **k)
        seen.append(res[0])
        return res

    monkeypatch.setattr(sl, "_stream_canvas", keep)
    if not native.tiff_native_available():
        monkeypatch.setattr(sl, "write_tiff_pyramid", lambda *a, **k: None)
    tmpl = multi_center_batches([0], 8, 8, 16, 16, seed=5)[0][0]
    cpu_state = model["state"]
    card_state = tf.init_flow_state(CFG, 0, model["hsd"][0].to(dev), dev)[2]
    card_state = card_state._replace(
        params=_on(cpu_state.params, dev),
        spectral=_on(cpu_state.spectral, dev),
        ema=card_state.ema._replace(params=_on(cpu_state.params, dev)))
    ck.save_checkpoint(str(tmp_path / "from_cpu"), cpu_state, 3)
    ck.save_checkpoint(str(tmp_path / "from_card"), card_state, 3)
    on_card = ck.restore_checkpoint(str(tmp_path / "from_cpu"), card_state)
    on_cpu = ck.restore_checkpoint(str(tmp_path / "from_card"), cpu_state)
    assert on_card.params["gmm"]["mu"].device.type == "cuda"
    assert on_cpu.params["gmm"]["mu"].device.type == "cpu"
    assert torch.equal(on_card.rng, cpu_state.rng)
    for name in ("from_cpu", "from_card"):
        sl.flow_normalize_slide(src, str(tmp_path / "o.tif"),
                                str(tmp_path / name), template=tmpl,
                                batch=4, n_src_tiles=4, cfg=CFG,
                                compression="none", device=dev)
    assert np.array_equal(seen[0], seen[1])
    flow, gmm = tf.build_models(CFG, dev)
    step = tf.make_train_step(flow, gmm, CFG, tf.make_optimizer(CFG))
    hsd = model["hsd"][1].to(dev)
    after, loss = step(on_card, hsd)
    assert torch.isfinite(loss) and after.step == on_card.step + 1
    assert int(after.rng[1]) == int(on_card.rng[1]) + 1


def test_sample_flow_and_toy_card_vs_cpu(model, dev):
    f, _, p, s = model["cpu"]
    gf, _, gp, gs = model["card"]
    gen = torch.Generator().manual_seed(0)
    z = torch.randn((2, 4, 4, 4), generator=gen)
    comp = torch.randint(0, 3, (2, 4, 4), generator=gen)
    gmm = {"mu": p["gmm"]["mu"], "sigma": torch.exp(p["gmm"]["log_sigma"])}
    want = _sample_flow_apply(f, {**p["flow"], **s}, z, comp, gmm)
    got = _sample_flow_apply(gf, {**gp["flow"], **gs}, z.to(dev),
                             comp.to(dev), _on(gmm, dev))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4)
    toy = ToyResFlow(n_blocks=2, hidden=16, device="cpu",
                     generator=torch.Generator().manual_seed(1))
    toy.update_spectral()
    gtoy = ToyResFlow(n_blocks=2, hidden=16, device=dev)
    gtoy.load_state_dict(toy.state_dict())
    x = torch.randn(64, 2, generator=gen)
    (zc, lc), (zg, lg) = toy(x), gtoy(x.to(dev))
    np.testing.assert_allclose(zg.detach().cpu().numpy(),
                               zc.detach().numpy(), atol=1e-4)
    np.testing.assert_allclose(lg.detach().cpu().numpy(),
                               lc.detach().numpy(), atol=1e-4)
