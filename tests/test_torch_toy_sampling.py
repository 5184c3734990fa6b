"""Sampling from the flow and the toy 2-D flow: the port against the JAX
package.

``sample_flow`` from JAX's own ``jax.random.normal`` and
``jax.random.categorical`` draws (fed to the port's ``_sample_flow_apply``
as NCHW latents); ``sample_toy`` byte for byte; ``ToyResFlow``'s forward,
exact logdet, spectral update and inverse on JAX's weights
(``convert.toy_state_from_jax``); ``train_toy``'s first three losses
against the JAX trainer's optax Adam; ``ResidualFlow.input_shape``; the
sampling CLI at a toy size.

Tolerances: samples and the inverse atol 1e-5 (40 or 60 fixed-point
iterations of float32 convolutions or matrix products); the toy forward
atol 1e-5, its logdet atol 1e-4 (a slogdet of I + J per point); the
spectral state atol 1e-6; the losses rtol 1e-5.
"""

import dataclasses
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_flow_ref import jit, port_cfg, random_variables
from _torch_mp_worker import ROOT
from stainlib_tpu.models import toy as jtoy
from stainlib_tpu.models.resflow import ResidualFlow as JFlow
from stainlib_tpu.models.sampling import sample_flow as j_sample_flow
from stainlib_tpu.models.train_flow import FlowConfig as JConfig
from stainlib_tpu_torch.convert import flow_state_from_jax, toy_state_from_jax
from stainlib_tpu_torch.models import sampling as tsamp
from stainlib_tpu_torch.models import toy as ttoy
from stainlib_tpu_torch.models import train_flow as ttf
from stainlib_tpu_torch.models.resflow import ResidualFlow
from stainlib_tpu_torch.utils import checkpoint as ckpt

TOY = dict(n_blocks=2, hidden=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["8gaussians", "rings", "moons"])
def test_sample_toy_is_byte_equal(name):
    want = jtoy.sample_toy(name, 512, seed=4)
    got = ttoy.sample_toy(name, 512, seed=4)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_sample_toy_rejects_an_unknown_density():
    with pytest.raises(ValueError):
        ttoy.sample_toy("spirals", 4)


@pytest.fixture(scope="module")
def toy():
    """JAX's toy flow after one spectral update (a real norm estimate, so
    the blocks contract) and the port's on the same variables."""
    model = jtoy.ToyResFlow(**TOY)
    x = jnp.asarray(jtoy.sample_toy("8gaussians", 64, seed=1))
    v = jit(model.init)(jax.random.PRNGKey(0), x[:32])
    _, upd = jit(lambda v, x: model.apply(v, x, update=True,
                                          mutable=["spectral"]))(v, x)
    v = {"params": v["params"], "spectral": upd["spectral"]}
    tm = ttoy.ToyResFlow(**TOY, device="cpu")
    tm.load_state_dict(toy_state_from_jax(jax.tree.map(np.asarray, v), "cpu"))
    return dict(model=model, v=v, tm=tm, x=np.asarray(x))


def test_toy_flow_forward_logdet_and_inverse_match_jax(toy):
    z, ld = jit(toy["model"].apply)(toy["v"], jnp.asarray(toy["x"]))
    tz, tld = toy["tm"](torch.from_numpy(toy["x"]))
    np.testing.assert_allclose(tz.detach().numpy(), np.asarray(z), atol=1e-5)
    np.testing.assert_allclose(tld.detach().numpy(), np.asarray(ld),
                               atol=1e-4)
    back = jit(lambda v, z: toy["model"].apply(
        v, z, method=toy["model"].inverse))(toy["v"], z)
    tback = toy["tm"].inverse(tz.detach())
    np.testing.assert_allclose(tback.numpy(), np.asarray(back), atol=1e-5)
    np.testing.assert_allclose(tback.numpy(), toy["x"], atol=1e-4)


def test_toy_spectral_update_matches_jax(toy):
    """``forward(update=True)``: two power iterations per layer, then the
    pass with the new sigma; the logdet with the updated layers."""
    (z, ld), upd = jit(lambda v, x: toy["model"].apply(
        v, x, update=True, mutable=["spectral"]))(toy["v"],
                                                  jnp.asarray(toy["x"]))
    tm = ttoy.ToyResFlow(**TOY, device="cpu")
    tm.load_state_dict(toy["tm"].state_dict())
    tz, tld = tm(torch.from_numpy(toy["x"]), update=True)
    np.testing.assert_allclose(tz.detach().numpy(), np.asarray(z), atol=1e-5)
    np.testing.assert_allclose(tld.detach().numpy(), np.asarray(ld),
                               atol=1e-4)
    want = toy_state_from_jax({"spectral": jax.tree.map(np.asarray,
                                                        upd["spectral"])},
                              "cpu")
    state = tm.state_dict()
    for name, t in want.items():
        np.testing.assert_allclose(state[name].numpy(), t.numpy(),
                                   atol=1e-6, err_msg=name)


def test_train_toy_first_three_losses_match_optax():
    """The JAX trainer for 1, 2 and 3 iterations (its last loss is the
    i-th step's) against the port's from the same initial variables: the
    same batches (numpy's), plain Adam as optax computes it, the spectral
    refresh after each update."""
    cfg = jtoy.ToyConfig(**TOY, batch_size=32)
    data = jtoy.sample_toy(cfg.dataset, cfg.batch_size * 4, 0)
    v = jtoy.ToyResFlow(**TOY).init(jax.random.PRNGKey(0),
                                    jnp.asarray(data[:cfg.batch_size]))
    state = toy_state_from_jax(jax.tree.map(np.asarray, v), "cpu")
    for n in (1, 2, 3):
        jcfg = dataclasses.replace(cfg, n_iters=n)
        want = jtoy.train_toy(jcfg, seed=0, log=lambda _: None)[2]
        tm = ttoy.ToyResFlow(**TOY, device="cpu")
        tm.load_state_dict(state)
        got = ttoy.train_toy(ttoy.ToyConfig(**dataclasses.asdict(jcfg)),
                             seed=0, log=lambda _: None, device="cpu",
                             model=tm)[2]
        assert got == pytest.approx(want, rel=1e-5), n


def test_train_toy_lowers_the_nll_from_its_own_init():
    cfg = ttoy.ToyConfig(**TOY, batch_size=64, n_iters=30, lr=5e-3)
    lines = []
    model, state, first = ttoy.train_toy(
        dataclasses.replace(cfg, n_iters=1), seed=2, log=lines.append,
        device="cpu")
    _, _, last = ttoy.train_toy(cfg, seed=2, log=lines.append, device="cpu")
    assert np.isfinite(last) and last < first
    assert lines[0].startswith("toy iter 0: nll")
    assert set(state) == set(model.state_dict())


def test_residual_flow_keeps_its_input_shape():
    flow = ResidualFlow(n_scales=2, blocks_per_scale=1, hidden=8,
                        input_shape=(1, 16, 8), device="cpu")
    assert flow.input_shape == (1, 16, 8)
    assert flow.latent_shape(3) == (3, 4, 8, 4)
    first = ResidualFlow(n_scales=2, blocks_per_scale=1, hidden=8,
                         input_shape=(1, 16, 16), squeeze_first=True,
                         device="cpu")
    assert first.latent_shape(1) == (1, 16, 4, 4)
    z, _ = flow(torch.rand(3, 1, 16, 8) * 0.8 + 0.1, skip_logdet=True)
    assert tuple(z.shape) == flow.latent_shape(3)


@pytest.fixture(scope="module")
def small_flow():
    """JAX's 2-scale flow on 8x8 inputs with random variables, and the
    port's on the same ones."""
    jflow = JFlow(n_scales=2, blocks_per_scale=1, hidden=8,
                  n_power_series=2, input_shape=(8, 8, 1))
    x0 = jnp.full((1, 8, 8, 1), 0.5)
    key = jax.random.PRNGKey(0)
    v = random_variables(jflow, 3, key, x0, key)
    host = jax.tree.map(np.asarray, v)
    p = flow_state_from_jax({"flow": host["params"], "gmm": {}},
                            host["spectral"], device="cpu")
    tflow = ResidualFlow(n_scales=2, blocks_per_scale=1, hidden=8,
                         n_power_series=2, input_shape=(1, 8, 8),
                         device="cpu")
    return dict(jflow=jflow, v=v, tflow=tflow,
                variables={**p.params["flow"], **p.spectral})


@pytest.mark.parametrize("mixture", [False, True], ids=["normal", "gmm"])
def test_sample_flow_matches_jax_on_its_draws(small_flow, mixture):
    f = small_flow
    gmm = None
    if mixture:
        gmm = {"mu": np.float32([[-0.5], [0.2], [0.9]]),
               "sigma": np.float32([[0.5], [1.0], [0.7]]),
               "pi": np.float32([0.2, 0.5, 0.3])}
    key = jax.random.PRNGKey(5)
    want = j_sample_flow(f["jflow"], f["v"], 3, key, gmm_params=gmm,
                         temperature=0.8)
    k1, k2 = jax.random.split(key)
    z = np.asarray(jax.random.normal(k1, (3, 4, 4, 4)))
    comp = None
    tgmm = None
    if mixture:
        pi = jnp.asarray(gmm["pi"]) / jnp.sum(jnp.asarray(gmm["pi"]))
        comp = torch.from_numpy(np.asarray(jax.random.categorical(
            k2, jnp.log(pi), shape=(3, 4, 4)), np.int64))
        tgmm = {k: torch.from_numpy(a) for k, a in gmm.items()}
    got = tsamp._sample_flow_apply(
        f["tflow"], f["variables"],
        torch.from_numpy(z.transpose(0, 3, 1, 2).copy()), comp, tgmm,
        temperature=0.8)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).transpose(0, 3, 1, 2),
                               atol=1e-5)


def test_sample_flow_draws_and_saves_a_grid(small_flow, tmp_path):
    f = small_flow
    gen = torch.Generator().manual_seed(0)
    gmm = {"mu": torch.tensor([[-0.5], [0.5]]),
           "sigma": torch.tensor([[0.5], [0.8]])}
    x = tsamp.sample_flow(f["tflow"], f["variables"], 5, gen, gmm_params=gmm)
    assert x.shape == (5, 1, 8, 8) and 0.0 <= float(x.min())
    assert float(x.max()) <= 1.0
    path = tsamp.save_sample_grid(str(tmp_path / "g" / "grid.png"), x,
                                  cols=2)
    from PIL import Image

    assert Image.open(path).size == (16, 24)


def test_sampling_cli_at_a_toy_size(tmp_path, monkeypatch, capsys):
    """``scripts/torch_sample_flow_capacity.py`` with ``reference_capacity``
    swapped for a 16^2 flow: restore, sample, write the grid, the round
    trip's error."""
    cfg = port_cfg(JConfig(image_size=16, n_scales=2, blocks_per_scale=1,
                           hidden=8, n_power_series=2))
    monkeypatch.setattr(ttf, "reference_capacity", lambda: cfg)
    _, _, state, _ = ttf.init_flow_state(cfg, 3, device="cpu")
    ckpt.save_checkpoint(str(tmp_path / "ckpt"), state._replace(step=4), 4)
    main = runpy.run_path(str(ROOT / "scripts"
                              / "torch_sample_flow_capacity.py"))["main"]
    out = tmp_path / "grid.png"
    assert main(["--ckpt", str(tmp_path / "ckpt"), "--n", "2", "--out",
                 str(out), "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "restored step 4" in printed and "roundtrip_max_err" in printed
    assert out.exists()
