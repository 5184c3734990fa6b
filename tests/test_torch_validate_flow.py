"""Flow deployment and evaluation: the port's ``validate_flow`` against the
JAX package's, on the same weights and tiles.

JAX's weights cross through ``convert.flow_state_from_jax``; the tiles are
the synthetic multi-center cohort (``data.synthetic``). The gamma-only
route (the flow's forward with the logdet skipped) must give ``encode``'s
gamma; the template statistics, every transfer, per-batch and pooled class
matching, and the template pass sharded over a 2-rank gloo world against
JAX's ``template_sums_sharded`` on 2 CPU devices. Then the CLIs:
``scripts/torch_train_flow.py --evaluate`` and
``scripts/torch_train_flow_capacity.py``, at toy sizes.

Budgets: the statistics rtol 1e-5, atol 1e-6; each uint8 output within 1
on all but 1e-3 of the bytes, at most 2; NMI within 1e-5 on the images
whose bytes are equal (elsewhere within what the byte budget lets it
move), and the per-class NMI equal there; gamma against JAX's atol 1e-5
and the gamma-only route equal to ``encode``'s. The JAX package's sharded
template pass is compiled with XLA's cheap options (``_torch_flow_ref.
jit``): at the default level its shard_map takes 30 s to compile here.
"""

import dataclasses
import os
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_flow_ref import jax_init, jit, port_cfg, to_port
from _torch_mp_worker import ROOT, run_world
from stainlib_tpu.data.synthetic import multi_center_batches
from stainlib_tpu.models import color_eval as jce
from stainlib_tpu.models import train_flow as jtf
from stainlib_tpu.models import validate_flow as jvf
from stainlib_tpu.ops.colorspace import hsd_to_rgb as j_hsd_to_rgb
from stainlib_tpu.ops.colorspace import rgb_to_hsd, to_uint8
from stainlib_tpu.parallel.mesh import make_mesh as jax_mesh
from stainlib_tpu_torch.models import train_flow as ttf
from stainlib_tpu_torch.models import validate_flow as tvf
from stainlib_tpu_torch.ops.colorspace import hsd_to_rgb as thsd_to_rgb
from stainlib_tpu_torch.ops.colorspace import to_uint8 as tto_uint8
from stainlib_tpu_torch.utils import checkpoint as ckpt

KEY = jax.random.PRNGKey(0)
STAT_TOL = dict(rtol=1e-5, atol=1e-6)
CFG = jtf.FlowConfig(image_size=16, n_scales=2, blocks_per_scale=1, hidden=8,
                     n_power_series=2, n_clusters=3, kernel_sizes=(3, 1, 3))
PCFG = port_cfg(CFG)


def quiet(*_):
    pass


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """JAX's small flow and its port: weights, tiles (a template batch and
    two test batches of 4 tiles of 16^2 from four centers)."""
    flow, gmm, state, _ = jax_init(CFG, KEY)
    rgb, _ = multi_center_batches(range(4), 3, 4, 16, 16, seed=11)
    hsd = [np.asarray(rgb_to_hsd(jnp.asarray(b)), np.float32) for b in rgb]
    tflow, tgmm = ttf.build_models(PCFG, "cpu")
    p = to_port(state, with_opt=False)
    return dict(flow=flow, gmm=gmm, state=state, tflow=tflow, tgmm=tgmm,
                params=p.params, spectral=p.spectral, tmpl=hsd[:1],
                test=hsd[1:])


def _u8_budget(got, want, what):
    """Within 1 u8 on all but 1e-3 of the bytes, at most 2; returns which
    images are equal byte for byte."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == np.uint8 and got.shape == want.shape, what
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    first = np.argwhere(d > 0)[:1].tolist()
    assert d.max() <= 2 and (d > 1).mean() <= 1e-3, (
        f"{what}: max {d.max()}, share > 1 {(d > 1).mean():.2e}, first "
        f"differing byte {first}")
    return (d.reshape(len(d), -1) == 0).all(1)


def _nmi_close(got, want, d_max):
    """Per image: within 1e-5 where the uint8 images are equal; elsewhere
    within what their byte differences allow (the median and the 95th
    percentile of the channel mean move by at most d/3 each, the 95th
    percentile of tissue is above 50)."""
    got, want = np.asarray(got), np.asarray(want)
    bound = np.where(d_max == 0, 1e-5, d_max / 3.0 * 2.0 / 50.0)
    assert (np.abs(got - want) <= bound).all(), (got - want, d_max)


def _batches_close(got_rgb, want_rgb, got_nmi, want_nmi, got_cls, want_cls,
                   what):
    """The u8 budget per batch, then the NMI and, on the images whose
    bytes are equal, the per-class NMI equal."""
    d_max = []
    for i, (a, b) in enumerate(zip(got_rgb, want_rgb)):
        _u8_budget(a, b, f"{what} batch {i}")
        d = np.abs(a.astype(np.int16) - np.asarray(b).astype(np.int16))
        d_max += d.reshape(len(d), -1).max(1).tolist()
    d_max = np.asarray(d_max)
    _nmi_close(got_nmi, want_nmi, d_max)
    same = d_max == 0
    np.testing.assert_array_equal(got_cls[same], want_cls[same])
    return same


def _stats_close(got, want, names=("mu", "sigma", "usage", "cov",
                                   "quantiles")):
    for name in names:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            a = a.numpy() if isinstance(a, torch.Tensor) else a
            np.testing.assert_allclose(a, np.asarray(b), err_msg=name,
                                       **STAT_TOL)


def test_gamma_only_route_is_encodes_gamma(model):
    """``encode_gamma`` (logdet skipped) equals the port's ``encode``'s
    gamma bit for bit, and JAX's ``encode``'s within 1e-5."""
    m = model
    hsd = torch.from_numpy(m["test"][0].copy())
    g = tvf.encode_gamma(m["tflow"], m["tgmm"], m["params"],
                         m["spectral"], hsd)
    _, _, g_enc = ttf.encode(m["tflow"], m["tgmm"], m["params"],
                             m["spectral"], PCFG, hsd,
                             generator=torch.Generator().manual_seed(0))
    assert g.shape == (4, 16, 16, CFG.n_clusters)
    assert torch.equal(g, g_enc.permute(0, 2, 3, 1))
    _, _, want = jit(lambda p, s, h: jtf.encode(
        m["flow"], m["gmm"], p, s, CFG, h, KEY))(
            m["state"].params, m["state"].spectral, jnp.asarray(m["test"][0]))
    np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=1e-5)


def _sums_kw(space):
    return dict(with_cov=True, with_quantiles=True, quantile_space=space,
                moment_space=space)


@pytest.mark.parametrize("space", ["hsd", "rgb"])
def test_template_sums_and_finalize_match_jax(model, space):
    """The accumulated sums (mass, moments, outer products, mass-weighted
    quantile curves) against JAX's; ``finalize_stats`` on JAX's sums
    against JAX's.

    Two places where JAX's own evaluations disagree beyond the budget, so
    the port is held to the one that is defined without XLA's fusion. In
    RGB space the covariance and sigma are differences of sums near 4e4
    per pixel that leave about 3e3, so the float32 rounding of JAX's sums
    moves them by about 1e-5: the finalized statistics are held through the
    sums and ``finalize_stats`` separately, each at the budget. And JAX's
    jitted ``_batch_sums`` fuses ``hsd_to_rgb`` into the quantiles' sort,
    which moves its RGB curves by up to 1e-4 relative (up to 0.2 of a
    level) from JAX's own ``class_channel_quantiles`` of the same pixels;
    the RGB renderings of the uint8-derived HSD cluster within a few ulps
    of each level, where the last bit of each package's ``exp`` reorders
    them. So the RGB curves are held to JAX's ``class_channel_quantiles``
    on the port's own pixels and gamma (``color_eval``'s test holds that
    function on shared inputs)."""
    m = model
    batches = m["tmpl"] + m["test"]
    want = jvf.accumulate_template_sums(
        m["flow"], m["gmm"], CFG, m["state"].params, m["state"].spectral,
        batches, KEY, **_sums_kw(space))
    got = tvf.accumulate_template_sums(
        m["tflow"], m["tgmm"], PCFG, m["params"], m["spectral"], batches,
        **_sums_kw(space))
    if space == "rgb":
        wq = 0.0
        for b in batches:
            h = torch.from_numpy(b.copy())
            g = tvf.encode_gamma(m["tflow"], m["tgmm"], m["params"],
                                 m["spectral"], h).numpy()
            q, mass = jce.class_channel_quantiles(thsd_to_rgb(h).numpy(), g)
            wq = wq + np.asarray(mass)[:, None, None] * np.asarray(q)
        want_sums = want._replace(wq=wq)
    else:
        want_sums = want
    for name, a, b in zip(want._fields, got, want_sums):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **STAT_TOL)
    host = tvf.TemplateSums(*(torch.from_numpy(np.array(b)) for b in want))
    _stats_close(tvf.finalize_stats(host), jvf.finalize_stats(want))


def test_template_stats_match_jax(model):
    """``accumulate_template_stats`` end to end in HSD, every statistic;
    only the statistics asked for are computed."""
    m = model
    kw = dict(return_cov=True, return_quantiles=True)
    want = jvf.accumulate_template_stats(
        m["flow"], m["gmm"], CFG, m["state"].params, m["state"].spectral,
        m["tmpl"] + m["test"], KEY, **kw)
    got = tvf.accumulate_template_stats(
        m["tflow"], m["tgmm"], PCFG, m["params"], m["spectral"],
        m["tmpl"] + m["test"], **kw)
    _stats_close(got, want)
    plain = tvf.accumulate_template_stats(
        m["tflow"], m["tgmm"], PCFG, m["params"], m["spectral"], m["tmpl"])
    assert plain.cov is None and plain.quantiles is None
    assert float(plain.usage.sum()) == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("pooled", [False, True], ids=["per_batch", "pooled"])
def test_deploy_with_class_matching_matches_jax(model, pooled):
    """``deploy`` with usage-rank matching, one permutation per batch or
    one for the whole test set, on JAX's template statistics."""
    m = model
    stats = jvf.accumulate_template_stats(
        m["flow"], m["gmm"], CFG, m["state"].params, m["state"].spectral,
        m["tmpl"], KEY)
    usage = np.asarray(stats.usage)[::-1].copy()  # a permuted template
    want = jvf.deploy(m["flow"], m["gmm"], CFG, m["state"].params,
                      m["state"].spectral, m["test"], stats.mu, stats.sigma,
                      KEY, log=quiet, usage_tmpl=usage, pooled_usage=pooled)
    lines = []
    got = tvf.deploy(m["tflow"], m["tgmm"], PCFG, m["params"], m["spectral"],
                     m["test"], np.asarray(stats.mu), np.asarray(stats.sigma),
                     log=lines.append, usage_tmpl=usage, pooled_usage=pooled)
    assert len(lines) == len(m["test"]) and "imgs/sec" in lines[0]
    _batches_close(got[1], want[1], got[0], want[0], got[2][0], want[2][0],
                   "deploy")
    # The input rendered to uint8: each package's within the u8 budget
    # (JAX's float32 exp against the port's correctly rounded one); the
    # per-class NMI of the port's rendering is JAX's function of it.
    want_raw = []
    for i, b in enumerate(m["test"]):
        h = torch.from_numpy(b.copy())
        mine = tto_uint8(thsd_to_rgb(h)).numpy()
        _u8_budget(mine, to_uint8(j_hsd_to_rgb(b)), f"raw batch {i}")
        g = tvf.encode_gamma(m["tflow"], m["tgmm"], m["params"],
                             m["spectral"], h).numpy()
        want_raw.append(jce.nmi_per_class(mine, g))
    np.testing.assert_array_equal(got[2][1], np.concatenate(want_raw))


@pytest.mark.parametrize("transfer", tvf.TRANSFERS)
def test_validate_matches_jax(model, transfer, tmp_path):
    m = model
    want = jvf.validate(m["flow"], m["gmm"], CFG, m["state"].params,
                        m["state"].spectral, m["tmpl"], m["test"], KEY,
                        log=quiet, transfer=transfer, class_match=True)
    got = tvf.validate(m["tflow"], m["tgmm"], PCFG, m["params"],
                       m["spectral"], m["tmpl"], m["test"], log=quiet,
                       transfer=transfer, class_match=True,
                       out_dir=str(tmp_path))
    np.testing.assert_allclose(got["mu_tmpl"], want["mu_tmpl"], **STAT_TOL)
    if transfer != "rgb-full-quantile":  # RGB moments: see the sums' test
        np.testing.assert_allclose(got["sigma_tmpl"], want["sigma_tmpl"],
                                   **STAT_TOL)
    same = _batches_close(got["outputs"], want["outputs"], got["nmi"],
                          want["nmi"], got["class_nmi"], want["class_nmi"],
                          transfer)
    if same.all():
        assert got["nmi_sd"] == pytest.approx(want["nmi_sd"], abs=1e-5)
    assert set(want) <= set(got)
    rows = open(tmp_path / "nmi_metrics.csv").read().splitlines()
    assert rows[0] == "nmi" and rows[-2].startswith("sd,")
    with pytest.raises(ValueError):
        tvf.validate(m["tflow"], m["tgmm"], PCFG, m["params"],
                     m["spectral"], m["tmpl"], m["test"], transfer="typo")


def test_validate_mesh_two_ranks_matches_jax_sharded(model, tmp_path):
    """The template pass sharded over a 2-rank gloo world (each rank's
    rows, their own quantile curves, the sums added in rank order) against
    JAX's ``template_sums_sharded`` on ``make_mesh(2, data=2)``; and
    ``validate(mesh=...)``'s statistics against those sums finalized and
    its NMI against the same call without a mesh."""
    m = model
    if jax.device_count() < 2:
        pytest.skip("needs 2 simulated devices")
    mesh = jax_mesh(2, data=2)
    tmpl, test = m["tmpl"][0], m["test"][0]
    want = jit(lambda p, s, h: jvf.template_sums_sharded(
        m["flow"], m["gmm"], CFG, p, s, h, KEY, mesh, with_cov=True,
        with_quantiles=True))(m["state"].params, m["state"].spectral, tmpl)
    want_stats = jvf.finalize_stats(want)
    flow, gmm, state, _ = ttf.init_flow_state(PCFG, 0, device="cpu")
    ckpt.save_checkpoint(str(tmp_path / "ckpt"), state._replace(
        params=m["params"], spectral=m["spectral"]), 1)
    inp = {f"cfg_{k}": np.array(v) for k, v in
           dataclasses.asdict(PCFG).items()}
    inp.update(ckpt=str(tmp_path / "ckpt"), tmpl=tmpl, test=test)
    outs = run_world("validate", 2, tmp_path, inp)
    single = tvf.validate(m["tflow"], m["tgmm"], PCFG, m["params"],
                          m["spectral"], [tmpl], [test], log=quiet,
                          transfer="full")
    for out in outs:
        for name, b in zip(want._fields, want):
            np.testing.assert_allclose(out[f"sums:{name}"], np.asarray(b),
                                       err_msg=name, **STAT_TOL)
        np.testing.assert_allclose(out["mu_tmpl"], want_stats.mu,
                                   **STAT_TOL)
        np.testing.assert_allclose(out["sigma_tmpl"], want_stats.sigma,
                                   **STAT_TOL)
        np.testing.assert_allclose(out["nmi"], single["nmi"], atol=1e-5)
    assert all(np.array_equal(outs[0][k], outs[1][k]) for k in outs[0])


def test_save_visuals_writes_the_four_pngs(model, tmp_path):
    m = model
    g = tvf.encode_gamma(m["tflow"], m["tgmm"], m["params"], m["spectral"],
                         torch.from_numpy(m["test"][0].copy()))
    rgb = np.zeros((4, 16, 16, 3), np.uint8)
    tvf.save_visuals(str(tmp_path), 7, m["tmpl"][0], m["test"][0], rgb, g)
    assert sorted(os.listdir(tmp_path)) == [
        f"im_{n}_000007.png" for n in ("conv", "gamma", "test", "tmpl")]


def test_cli_evaluate_runs_validate_on_the_checkpoint(tmp_path, capsys):
    """``scripts/torch_train_flow.py``: 2 steps, then ``--evaluate`` on the
    checkpoint it wrote (and ``--evaluate`` without one fails)."""
    main = runpy.run_path(str(ROOT / "scripts"
                              / "torch_train_flow.py"))["main"]
    args = ["--device", "cpu", "--image-size", "16", "--batch", "4",
            "--n-scales", "1", "--blocks", "1", "--hidden", "8",
            "--save", str(tmp_path)]
    main(args + ["--steps", "2"])
    res = main(args + ["--evaluate"])
    out = capsys.readouterr().out
    assert "resumed at step 2" in out and "NMI sd=" in out
    assert len(res["nmi"]) == 4 and np.isfinite(res["nmi_sd"])
    assert os.path.exists(tmp_path / "nmi_metrics.csv")
    with pytest.raises(FileNotFoundError):
        main(args[:-1] + [str(tmp_path / "none"), "--evaluate"])


@pytest.mark.parametrize("skip_eval", [True, False], ids=["skip_eval", "eval"])
def test_capacity_script_at_a_toy_size(tmp_path, monkeypatch, skip_eval):
    """``scripts/torch_train_flow_capacity.py`` with ``reference_capacity``
    swapped for a 16^2 flow: 2 steps, the checkpoint round trip, and the
    evaluation (raw NMI, then ``validate`` with the EMA weights, class
    matching and the quantile transfer); the summary's keys are the JAX
    script's."""
    monkeypatch.setattr(ttf, "reference_capacity", lambda: dataclasses.replace(
        PCFG, warmup_iters=1))
    ns = runpy.run_path(str(ROOT / "scripts"
                            / "torch_train_flow_capacity.py"))
    args = ["--device", "cpu", "--steps", "2", "--batch", "4",
            "--template-tiles", "4", "--train-pool", "2",
            "--tiles-per-center", "1", "--resume-steps", "1",
            "--out", str(tmp_path), "--ema-val", "--class-match",
            "--transfer", "quantile"]
    summary = ns["run"](ns["parse_args"](args + (["--skip-eval"]
                                                 if skip_eval else [])))
    keys = {"cohort", "params", "image_size", "batch", "steps",
            "imgs_per_s", "ms_per_step", "bpd_first", "bpd_final",
            "bpd_resumed", "bpd_curve"}
    if not skip_eval:
        keys |= {"raw_nmi_sd", "raw_nmi_cv", "normalized_nmi_sd",
                 "normalized_nmi_cv", "sd_reduction", "class_nmi_sd_raw",
                 "class_nmi_cv_raw", "class_nmi_sd", "class_nmi_cv"}
    assert set(summary) == keys
    assert np.isfinite(summary["bpd_final"])
    assert ckpt.latest_step(str(tmp_path / "ckpt")) == 2
    assert os.path.exists(tmp_path / "capacity_summary.json")
