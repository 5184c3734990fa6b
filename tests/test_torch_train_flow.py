"""The flow trainer: the port against the JAX package and optax.

The schedule, the clip, Adam and MultiSteps against optax; one and three
train steps from a converted JAX state; the 2-rank data-parallel step on a
gloo world against JAX's ``make_train_step(mesh=make_mesh(2, data=2))``;
``encode`` at the training size and another; EMA, checkpoints and a
bit-identical resume; the training CLI.

Tolerances: the loss rtol 1e-5 (a mean of bpd values, each a sum of a few
thousand float32 terms); gradients rtol 1e-4 with atol 1e-6 (backward
through the jvp-chained logdet); the optimizer on given gradients atol
1e-7, and the schedule within one float32 ulp (optax's arithmetic
replayed in float32; only ``cos`` comes from another libm); spectral
vectors and latents atol 1e-5; gamma atol 1e-5. Parameters after an Adam
step are compared only through the gradients and the optimizer
separately: Adam's first step turns the rounding of a near-zero gradient
into a step of the full learning rate.
"""

import dataclasses
import os
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_flow_ref import (
    assert_tree_close, block_shapes, flow_probes, hsd_batch, jax_init, jit,
    port_cfg, port_tree, step_probes, to_port)
from _torch_mp_worker import ROOT, run_world
from stainlib_tpu.models import train_flow as jtf
from stainlib_tpu.parallel.mesh import make_mesh as jax_mesh
from stainlib_tpu_torch.models import train_flow as ttf
from stainlib_tpu_torch.models.resflow import update_lipschitz
from stainlib_tpu_torch.utils import checkpoint as ckpt
from stainlib_tpu_torch.utils import meters
from stainlib_tpu_torch.utils.ema import ema_init, ema_swap, ema_update

KEY = jax.random.PRNGKey(0)
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
OPT_ATOL = 1e-7
CFG = jtf.FlowConfig(image_size=16, n_scales=2, blocks_per_scale=1, hidden=8,
                     n_power_series=3, n_clusters=3, lr=5e-3, warmup_iters=2,
                     ema_decay=0.5, kernel_sizes=(3, 1, 3))
PCFG = port_cfg(CFG)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small ops: one intra-op thread, so that a test
    worker does not oversubscribe the cores beside the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed=0):
    return ttf.rng_state(seed)


@pytest.fixture(scope="module")
def chain():
    """JAX's state before and after each of three steps, the losses, and
    the gradients at each state; the port's flow and GMM."""
    hsd = hsd_batch(4, 16, seed=1)
    flow, gmm, state, tx = jax_init(CFG, KEY)
    step = jit(jtf.make_train_step(flow, gmm, CFG, tx))

    def loss(params, spectral, h, key):
        return jtf.hsd_loss_fn(flow, gmm, CFG, params, spectral, h, key)[0]

    value_and_grad = jit(jax.value_and_grad(loss))
    states, losses, grads = [state], [], []
    for _ in range(3):
        k_loss = jax.random.split(states[-1].key, 3)[0]
        grads.append(value_and_grad(states[-1].params, states[-1].spectral,
                                    jnp.asarray(hsd), k_loss)[1])
        new, loss_v = step(states[-1], jnp.asarray(hsd))
        states.append(new)
        losses.append(float(loss_v))
    tflow, tgmm = ttf.build_models(PCFG, "cpu")
    return dict(hsd=hsd, flow=flow, gmm=gmm, states=states, losses=losses,
                grads=grads, value_and_grad=value_and_grad, tflow=tflow,
                tgmm=tgmm, shapes=block_shapes(CFG, 4, 16))


@pytest.mark.parametrize("i", [0, 1, 2])
def test_train_step_parts_match_jax(chain, i):
    """From JAX's state after i steps: the loss and gradients, the
    optimizer on JAX's gradients, the EMA, the Lipschitz refresh, and the
    whole step's loss."""
    c = chain
    before, after = to_port(c["states"][i]), to_port(c["states"][i + 1])
    probes = step_probes(c["states"][i], c["shapes"])
    hsd = torch.from_numpy(c["hsd"])
    loss, grads = ttf.loss_and_grads(c["tflow"], c["tgmm"], PCFG,
                                     before.params, before.spectral, hsd,
                                     probes)
    np.testing.assert_allclose(float(loss), c["losses"][i], rtol=LOSS_RTOL)
    assert_tree_close(grads, port_tree(c["grads"][i]), **GRAD_TOL)

    tx = ttf.make_optimizer(PCFG)
    updates, opt = tx.update(port_tree(c["grads"][i]), before.opt_state)
    params = ttf.apply_updates(before.params, updates)
    assert_tree_close(params, after.params, atol=OPT_ATOL)
    assert opt.count == after.opt_state.count == i + 1
    assert_tree_close(opt.mu, after.opt_state.mu, atol=OPT_ATOL)
    assert_tree_close(opt.nu, after.opt_state.nu, atol=OPT_ATOL)
    assert_tree_close(ema_update(before.ema, after.params).params,
                      after.ema.params, atol=OPT_ATOL)
    spectral = update_lipschitz(c["tflow"], after.params["flow"],
                                before.spectral)
    assert_tree_close(spectral, after.spectral, atol=1e-5)

    step = ttf.make_train_step(c["tflow"], c["tgmm"], PCFG, tx)
    new, step_loss = step(before._replace(rng=_gen()), hsd, probes)
    np.testing.assert_allclose(float(step_loss), c["losses"][i],
                               rtol=LOSS_RTOL)
    assert new.step == before.step + 1


def test_three_train_steps_from_a_converted_state(chain):
    """The port's own chain of three steps from JAX's initial state, with
    JAX's probes: the same losses."""
    c = chain
    state = to_port(c["states"][0])._replace(rng=_gen())
    step = ttf.make_train_step(c["tflow"], c["tgmm"], PCFG,
                               ttf.make_optimizer(PCFG))
    for i in range(3):
        state, loss = step(state, torch.from_numpy(c["hsd"]),
                           step_probes(c["states"][i], c["shapes"]))
        np.testing.assert_allclose(float(loss), c["losses"][i],
                                   rtol=LOSS_RTOL)
    assert state.step == 3 and state.opt_state.count == 3


@pytest.mark.parametrize("size", [16, 8])
def test_encode_matches_jax(chain, size):
    """``encode`` at the training size and at another squeeze-divisible
    size (cf. ``tests/test_train_flow.py:543``): bpd, z and gamma."""
    c = chain
    state = c["states"][1]
    hsd = hsd_batch(2, size, seed=3)
    key = jax.random.PRNGKey(4)
    bpd, z, gamma = jit(lambda p, s, h: jtf.encode(
        c["flow"], c["gmm"], p, s, CFG, h, key))(
            state.params, state.spectral, jnp.asarray(hsd))
    p = to_port(state, with_opt=False)
    tb, tz, tg = ttf.encode(c["tflow"], c["tgmm"], p.params, p.spectral, PCFG,
                            torch.from_numpy(hsd),
                            flow_probes(key, block_shapes(CFG, 2, size)))
    np.testing.assert_allclose(tb.numpy(), bpd, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tz.numpy(), np.asarray(z).transpose(0, 3, 1, 2),
                               atol=1e-5)
    assert tg.shape == (2, CFG.n_clusters, size, size)
    np.testing.assert_allclose(tg.numpy(),
                               np.asarray(gamma).transpose(0, 3, 1, 2),
                               atol=1e-5)
    np.testing.assert_allclose(tg.sum(1).numpy(), 1.0, atol=1e-5)


def test_data_parallel_step_two_ranks_matches_jax_mesh(chain, tmp_path):
    """``make_train_step(mesh=...)`` on a 2-rank gloo world against JAX's
    on ``make_mesh(2, data=2)``: the averaged loss, gradients (each rank's
    shard with the same probes, as each JAX shard splits the same key),
    the refreshed spectral state; both ranks hold the same state."""
    c = chain
    if jax.device_count() < 2:
        pytest.skip("needs 2 simulated devices")
    state = c["states"][1]
    hsd = hsd_batch(4, 16, seed=5)
    step = jit(jtf.make_train_step(c["flow"], c["gmm"], CFG,
                                       jtf.make_optimizer(CFG),
                                       mesh=jax_mesh(2, data=2)))
    jstate, jloss = step(state, jnp.asarray(hsd))
    k_loss = jax.random.split(state.key, 3)[0]
    halves = [c["value_and_grad"](state.params, state.spectral,
                                  jnp.asarray(hsd[r * 2:(r + 1) * 2]), k_loss)
              for r in range(2)]
    jgrads = jax.tree.map(lambda a, b: (a + b) / 2, halves[0][1],
                          halves[1][1])

    ckpt.save_checkpoint(str(tmp_path / "ckpt"),
                         to_port(state)._replace(rng=_gen()), 1)
    probes = step_probes(state, block_shapes(CFG, 2, 16))
    inp = {f"cfg_{k}": np.array(v) for k, v in
           dataclasses.asdict(PCFG).items()}
    inp.update(ckpt=str(tmp_path / "ckpt"), hsd=hsd, n_probes=len(probes),
               **{f"probe_{i}": p.numpy() for i, p in enumerate(probes)})
    outs = run_world("flow", 2, tmp_path, inp)

    want_grads = port_tree(jgrads)
    want = to_port(jstate, with_opt=False)
    for out in outs:
        np.testing.assert_allclose(out["loss"], float(jloss), rtol=LOSS_RTOL)
        np.testing.assert_allclose(out["step_loss"], float(jloss),
                                   rtol=LOSS_RTOL)
        assert int(out["step"]) == 2
        for model in ("flow", "gmm"):
            for name, g in want_grads[model].items():
                np.testing.assert_allclose(out[f"grad:{model}:{name}"],
                                           g.numpy(), err_msg=name,
                                           **GRAD_TOL)
        for name, u in want.spectral.items():
            np.testing.assert_allclose(out[f"spectral:{name}"], u.numpy(),
                                       atol=1e-5, err_msg=name)
    assert all(np.array_equal(outs[0][k], outs[1][k]) for k in outs[0])


@pytest.mark.parametrize("cfg", [
    dict(lr=1e-3, warmup_iters=5),
    dict(lr=3e-4, warmup_iters=3, cosine_restart_period=4),
    dict(lr=2e-3, warmup_iters=0, cosine_restart_period=3),
])
def test_schedule_matches_optax(cfg):
    cfg = jtf.FlowConfig(**cfg)
    if cfg.cosine_restart_period > 0:
        tail = optax.sgdr_schedule([dict(
            init_value=cfg.lr, peak_value=cfg.lr,
            decay_steps=cfg.cosine_restart_period, warmup_steps=0,
            end_value=0.0)] * 64)
    else:
        tail = optax.constant_schedule(cfg.lr)
    schedule = optax.join_schedules(
        [optax.linear_schedule(0.0, cfg.lr, cfg.warmup_iters), tail],
        [cfg.warmup_iters])
    got = ttf.make_schedule(port_cfg(cfg))
    counts = list(range(0, 3 * cfg.warmup_iters + 12)) + [300]
    want = np.array([schedule(jnp.int32(n)) for n in counts], np.float32)
    have = np.array([got(n) for n in counts], np.float32)
    np.testing.assert_allclose(have, want, rtol=1.2e-7, atol=1e-12)
    assert have[0] == 0.0 or cfg.warmup_iters == 0  # lr 0 on update one


def _grad_tree(rng, scale):
    return {"flow": {"a.weight": rng.normal(0, scale, (4, 3)).astype(
                np.float32), "b.bias": rng.normal(0, scale, 5).astype(
                np.float32)},
            "gmm": {"mu": rng.normal(0, scale, (3, 1)).astype(np.float32)}}


@pytest.mark.parametrize("update_freq", [1, 2])
def test_optimizer_matches_optax_on_given_gradients(update_freq):
    """Clip (above and below the norm), Adam and MultiSteps accumulation
    over six updates, the parameters and moments against optax's."""
    cfg = jtf.FlowConfig(lr=1e-2, warmup_iters=2, update_freq=update_freq)
    tx = jtf.make_optimizer(cfg)
    ptx = ttf.make_optimizer(port_cfg(cfg))
    rng = np.random.default_rng(0)
    params = _grad_tree(rng, 1.0)
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = jax.tree.map(torch.from_numpy, params)
    jopt, topt = tx.init(jparams), ptx.init(tparams)
    for i in range(6):
        g = _grad_tree(rng, 2.0 if i % 3 == 0 else 0.05)  # clip, no clip
        upd, jopt = tx.update(jax.tree.map(jnp.asarray, g), jopt, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tupd, topt = ptx.update(jax.tree.map(torch.from_numpy, g), topt)
        tparams = ttf.apply_updates(tparams, tupd)
        assert (tupd is None) == (update_freq == 2 and i % 2 == 0)
        assert_tree_close(tparams, jax.tree.map(
            lambda a: torch.from_numpy(np.asarray(a)), jparams),
            atol=OPT_ATOL)
    inner = jopt.inner_opt_state if update_freq > 1 else jopt
    tinner = topt.inner_opt_state if update_freq > 1 else topt
    assert tinner.count == int(inner[1][0].count) == 6 // update_freq
    assert_tree_close(tinner.nu, jax.tree.map(
        lambda a: torch.from_numpy(np.asarray(a)), inner[1][0].nu),
        atol=OPT_ATOL)


def test_clip_is_optax_not_clip_grad_norm():
    """Scaled by max / norm only above the norm, with no epsilon."""
    g = {"w": torch.tensor([3.0, 4.0])}
    np.testing.assert_array_equal(ttf.clip_by_global_norm(g, 1.0)["w"],
                                  np.float32([0.6, 0.8]))
    np.testing.assert_array_equal(ttf.clip_by_global_norm(g, 5.0)["w"],
                                  g["w"])
    want, _ = optax.clip_by_global_norm(1.0).update(
        {"w": jnp.asarray([3.0, 4.0])}, optax.EmptyState())
    np.testing.assert_array_equal(ttf.clip_by_global_norm(g, 1.0)["w"],
                                  np.asarray(want["w"]))


def test_ema_math_and_gating_under_accumulation():
    p = {"w": torch.zeros(2)}
    st = ema_init(p, decay=0.9)
    st = ema_update(st, {"w": torch.ones(2)})
    np.testing.assert_allclose(st.params["w"].numpy(), 0.1, rtol=1e-6)
    assert ema_swap(st, p) == (st.params, p)

    cfg = dataclasses.replace(PCFG, update_freq=2, warmup_iters=0)
    flow, gmm, state, tx = ttf.init_flow_state(cfg, 0, device="cpu")
    step = ttf.make_train_step(flow, gmm, cfg, tx)
    hsd = torch.from_numpy(hsd_batch(2, 16, seed=6))
    s1, _ = step(state, hsd)  # accumulation: nothing applied
    assert s1.opt_state.mini_step == 1 and s1.ema is state.ema
    assert all(torch.equal(s1.params[m][k], state.params[m][k])
               for m in state.params for k in state.params[m])
    s2, _ = step(s1, hsd)  # applied: parameters and EMA move
    assert s2.opt_state.mini_step == 0 and s2.opt_state.gradient_step == 1
    assert_tree_close(s2.ema.params,
                      ema_update(s1.ema, s2.params).params)
    assert not torch.equal(s2.params["gmm"]["mu"], s1.params["gmm"]["mu"])


def test_checkpoint_round_trip_and_rotation(tmp_path):
    state = {"a": torch.arange(3, dtype=torch.float32),
             "b": {"c": torch.ones((2, 2))}, "n": 3}
    d = str(tmp_path)
    for step in range(7):
        ckpt.save_checkpoint(d, state, step, keep_last=3)
    assert ckpt.latest_step(d) == 6
    assert sorted(os.listdir(d)) == [
        "ckpt_00000004.pt", "ckpt_00000005.pt", "ckpt_00000006.pt",
        "ckpt_most_recent.pt"]
    restored = ckpt.restore_checkpoint(d, state)
    np.testing.assert_array_equal(restored["a"].numpy(), [0, 1, 2])
    assert restored["n"] == 3 and restored["b"]["c"].shape == (2, 2)
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"), state)
    with pytest.raises(ValueError, match="do not match"):
        ckpt.restore_checkpoint(d, {"a": state["a"]})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_checkpoint(d, dict(state, a=torch.zeros(4)))


def test_resume_continues_bit_identically(tmp_path):
    """Four steps straight, against two, a checkpoint, a restore into a
    state built from another seed, and two more: the same bits, the
    generator's state included."""
    cfg = PCFG
    hsd = [torch.from_numpy(hsd_batch(2, 16, seed=10 + i)) for i in range(4)]
    flow, gmm, state, tx = ttf.init_flow_state(cfg, 3, sample_hsd=hsd[0],
                                               device="cpu")
    step = ttf.make_train_step(flow, gmm, cfg, tx)
    straight, losses = state, []
    for h in hsd:
        straight, loss = step(straight, h)
        losses.append(loss)
    half = state
    for h in hsd[:2]:
        half, _ = step(half, h)
    ckpt.save_checkpoint(str(tmp_path), half, half.step)
    _, _, fresh, _ = ttf.init_flow_state(cfg, 99, device="cpu")
    resumed = ckpt.restore_checkpoint(str(tmp_path), fresh)
    assert resumed.step == 2
    for h, want in zip(hsd[2:], losses[2:]):
        resumed, loss = step(resumed, h)
        assert torch.equal(loss, want)
    a = torch.utils._pytree.tree_leaves(straight)
    b = torch.utils._pytree.tree_leaves(resumed)
    assert len(a) == len(b)
    assert all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(a, b))


def test_rng_leaf_has_one_layout_and_restores_across_templates(tmp_path):
    """The probes' state is (seed, counter), int64 on the CPU, whatever
    device or generator made the state: a checkpoint round-trips through a
    template whose ``rng`` leaf came from another generator, and the step
    draws from it the same probes as the uninterrupted state would."""
    cfg = PCFG
    hsd = torch.from_numpy(hsd_batch(2, 16, seed=20))
    flow, gmm, state, tx = ttf.init_flow_state(cfg, 5, hsd, "cpu")
    other = ttf.init_flow_state(
        cfg, torch.Generator().manual_seed(123456789), hsd, "cpu")[2]
    assert state.rng.dtype == other.rng.dtype == torch.int64
    assert tuple(state.rng.shape) == tuple(other.rng.shape) == (2,)
    assert state.rng.device.type == "cpu"
    assert state.rng.tolist() == [5, 0] and other.rng.tolist() == [123456789,
                                                                     0]
    shapes = [tuple(t.shape) for t in torch.utils._pytree.tree_leaves(state)
              if isinstance(t, torch.Tensor)]
    assert shapes == [tuple(t.shape) for t in
                      torch.utils._pytree.tree_leaves(other)
                      if isinstance(t, torch.Tensor)]
    step = ttf.make_train_step(flow, gmm, cfg, tx)
    s1, _ = step(state, hsd)
    assert s1.rng.tolist() == [5, 1]
    ckpt.save_checkpoint(str(tmp_path), s1, 1)
    back = ckpt.restore_checkpoint(str(tmp_path), other)
    assert torch.equal(back.rng, s1.rng)
    (a, la), (b, lb) = step(s1, hsd), step(back, hsd)
    assert torch.equal(la, lb) and torch.equal(a.rng, b.rng)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_checkpoint(str(tmp_path), other._replace(
            rng=torch.zeros(3, dtype=torch.int64)))


def test_remat_and_remat_logdet_change_memory_not_math():
    """``cfg.remat`` (the flow forward checkpointed) and ``remat_logdet``
    (each series term) give the same loss and gradients as neither."""
    hsd = torch.from_numpy(hsd_batch(2, 16, seed=7))
    flow, gmm, state, _ = ttf.init_flow_state(PCFG, 1, sample_hsd=hsd,
                                              device="cpu")
    probes = flow.draw_probes((2, 1, 16, 16), torch.Generator().manual_seed(2))
    results = {}
    for remat in (False, True):
        for remat_logdet in (False, True):
            cfg = dataclasses.replace(PCFG, remat=remat,
                                      remat_logdet=remat_logdet)
            f, g = ttf.build_models(cfg, "cpu")
            results[remat, remat_logdet] = ttf.loss_and_grads(
                f, g, cfg, state.params, state.spectral, hsd, probes)
    base_loss, base_grads = results[False, False]
    for loss, grads in results.values():
        np.testing.assert_allclose(float(loss), float(base_loss), rtol=1e-6)
        assert_tree_close(grads, base_grads, rtol=1e-5, atol=1e-7)


def test_multiscale_flow_trains_and_encodes():
    """The counterpart of ``tests/test_train_flow.py:417``: two scales
    squeeze the latent grid; the GMM pools its conditioning and encode
    upsamples gamma."""
    cfg = ttf.FlowConfig(image_size=16, n_scales=2, blocks_per_scale=1,
                         hidden=8, n_power_series=2, n_clusters=3, lr=1e-3,
                         warmup_iters=2)
    hsd = torch.from_numpy(hsd_batch(4, 16, seed=9))
    flow, gmm, state, tx = ttf.init_flow_state(cfg, 0, sample_hsd=hsd,
                                               device="cpu")
    state, loss = ttf.make_train_step(flow, gmm, cfg, tx)(state, hsd)
    assert np.isfinite(float(loss))
    bpd, z, gamma = ttf.encode(flow, gmm, state.params, state.spectral, cfg,
                               hsd, generator=torch.Generator().manual_seed(0))
    assert z.shape == (4, 4, 8, 8) and gamma.shape == (4, 3, 16, 16)
    assert torch.isfinite(bpd).all()


@pytest.mark.slow
def test_flow_training_reduces_bpd():
    """The counterpart of ``tests/test_train_flow.py:58``."""
    cfg = port_cfg(jtf.FlowConfig(image_size=16, n_scales=1,
                                  blocks_per_scale=2, hidden=8,
                                  n_power_series=3, n_clusters=3, lr=5e-3,
                                  warmup_iters=5, ema_decay=0.5))
    hsd = torch.from_numpy(hsd_batch(8, 16, seed=1))
    flow, gmm, state, tx = ttf.init_flow_state(cfg, 0, sample_hsd=hsd,
                                               device="cpu")
    step = ttf.make_train_step(flow, gmm, cfg, tx)
    losses = []
    for _ in range(30):
        state, loss = step(state, hsd)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3


def test_cli_trains_then_resumes(tmp_path, capsys):
    """``scripts/torch_train_flow.py`` on the CPU: 3 steps with a
    checkpoint every 2, then ``--resume`` for 3 more from step 3."""
    main = runpy.run_path(str(ROOT / "scripts" / "torch_train_flow.py"))["main"]
    args = ["--device", "cpu", "--steps", "3", "--image-size", "16",
            "--batch", "4", "--n-scales", "1", "--blocks", "1", "--hidden",
            "8", "--save", str(tmp_path), "--save-every", "2"]
    first = main(args)
    assert first.step == 3
    assert sorted(os.listdir(tmp_path)) == [
        "ckpt_00000002.pt", "ckpt_00000003.pt", "ckpt_most_recent.pt"]
    second = main(args + ["--resume"])
    out = capsys.readouterr().out
    assert "resumed at step 3" in out and "step 4: bpd" in out
    assert second.step == 6 and ckpt.latest_step(str(tmp_path)) == 6
    assert all(torch.isfinite(p).all() for part in second.params.values()
               for p in part.values())


def test_meters_and_rank_zero_logger():
    m = meters.RunningAverageMeter(0.5)
    m.update(2.0)
    m.update(4.0)
    assert (m.val, m.avg) == (4.0, 3.0)
    m.reset()
    assert m.val is None
    t = meters.Throughput()
    assert t.tick(8) > 0
    quiet = meters.get_logger("flow_test_quiet", rank=1)
    assert quiet.level > 40 and not quiet.handlers
    assert meters.get_logger("flow_test").handlers  # rank 0 without a group
