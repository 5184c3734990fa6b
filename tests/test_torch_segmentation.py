"""The port's U-Net segmenter against the JAX package's, on the CPU.

JAX on the CPU is the reference; the weights cross through
``convert.unet_params_from_jax``; inputs are numpy draws from a seed. Small
nets: base 4 and 8, depth 2, 32x32 tiles, batch 4.

Tolerances: logits atol 1e-5; the loss rtol 1e-5; gradients rtol 1e-4,
atol 1e-6; one Adam step's parameters atol 1e-7 (on JAX's gradients);
three steps of ``train_segmenter`` from JAX's initial weights atol 1e-5 and
the class maps equal on all but 1e-3 of the pixels (an argmax may flip
where two logits tie within the rounding); mIoU exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_flow_ref import jit, random_variables
from stainlib_tpu.models import segmentation as js
from stainlib_tpu_torch import convert
from stainlib_tpu_torch.models import segmentation as ts
from stainlib_tpu_torch.models.train_flow import adam


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed, n=4, side=32):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, side, side, 3), dtype=np.uint8),
            rng.integers(0, 3, (n, side, side)).astype(np.int32))


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_unet(base, depth, seed=0, drawn=True):
    """The flax U-Net and its parameters: numpy draws of its shapes
    (``random_variables``: nothing compiles), or flax's own ``init``."""
    model = js.UNet(n_classes=3, base=base, depth=depth)
    x0 = jnp.zeros((1, 32, 32, 3), jnp.float32)
    key = jax.random.PRNGKey(seed)
    if drawn:
        return model, random_variables(model, seed, key, x0)["params"]
    return model, model.init(key, x0)["params"]


@pytest.mark.parametrize("c_in,c_out", [(8, 4), (16, 8)])
def test_up_block_is_the_flipped_conv_transpose(c_in, c_out):
    """flax's ``ConvTranspose((2, 2), strides=(2, 2))`` alone against the
    port's up-convolution with the converted (flipped) kernel."""
    rng = np.random.default_rng(c_in)
    x = rng.normal(size=(2, 5, 7, c_in)).astype(np.float32)
    up = js.nn.ConvTranspose(c_out, (2, 2), strides=(2, 2))
    params = {"kernel": rng.normal(size=(2, 2, c_in, c_out)).astype(
        np.float32), "bias": rng.normal(size=c_out).astype(np.float32)}
    want = np.asarray(jit(up.apply)({"params": params}, jnp.asarray(x)))
    tp = convert.unet_params_from_jax({"ConvTranspose_0": params}, "cpu")
    mod = ts.UpConv(c_in, c_out, device="cpu")
    got = torch.func.functional_call(
        mod, {"weight": tp["ups.0.weight"], "bias": tp["ups.0.bias"]},
        (torch.from_numpy(x).permute(0, 3, 1, 2),)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 10, 14, c_out)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    # Without the flip the layouts disagree: the test can see the flip.
    unflipped = torch.from_numpy(np.ascontiguousarray(
        params["kernel"].transpose(2, 3, 0, 1)))
    bad = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), unflipped,
        torch.from_numpy(params["bias"]), stride=2).permute(0, 2, 3, 1)
    assert np.abs(bad.numpy() - want).max() > 1e-2


@pytest.mark.parametrize("base,depth", [(4, 2), (8, 2)])
def test_unet_logits_match_jax(base, depth):
    model, params = _jax_unet(base, depth)
    imgs, _ = _data(base)
    x = imgs.astype(np.float32) / np.float32(255.0)
    want = np.asarray(jit(model.apply)({"params": params}, jnp.asarray(x)))
    tm = ts.UNet(3, base, depth, device="cpu")
    tp = convert.unet_params_from_jax(_host(params), "cpu")
    assert set(tp) == {k for k, _ in tm.named_parameters()}
    got = torch.func.functional_call(tm, tp, (ts._unit(
        torch.from_numpy(imgs)),))
    assert got.shape == (4, 32, 32, 3)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)


def _jax_loss(model):
    def loss_fn(p, imgs, labels):
        logits = model.apply({"params": p},
                             jnp.asarray(imgs, jnp.float32) / 255.0)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean()

    return loss_fn


def test_unet_gradients_and_one_adam_step_match_jax():
    model, params = _jax_unet(4, 2)
    imgs, masks = _data(7)
    loss, grads = jit(jax.value_and_grad(_jax_loss(model)))(
        params, jnp.asarray(imgs), jnp.asarray(masks))
    tm = ts.UNet(3, 4, 2, device="cpu")
    tp = convert.unet_params_from_jax(_host(params), "cpu")
    tloss, tgrads = ts.loss_and_grads(tm, tp, torch.from_numpy(imgs),
                                      torch.from_numpy(masks))
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)
    want = convert.unet_params_from_jax(_host(grads), "cpu")
    for k in want:
        np.testing.assert_allclose(tgrads[k].numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    # One Adam step (optax's defaults, a constant rate) on JAX's gradients.
    tx = optax.adam(1e-3)
    upd, _ = tx.update(grads, tx.init(params))
    want_p = convert.unet_params_from_jax(
        _host(optax.apply_updates(params, upd)), "cpu")
    ptx = adam(lambda count: 1e-3)
    pupd, state = ptx.update(want, ptx.init(tp))
    assert state.count == 1
    for k in want_p:
        np.testing.assert_allclose((tp[k] + pupd[k]).numpy(),
                                   want_p[k].numpy(), atol=1e-7, err_msg=k)


def test_train_segmenter_matches_jax_from_the_same_weights(monkeypatch):
    """Three steps on ``default_rng(seed)``'s batches from JAX's initial
    weights: the parameters and the class maps ``predict_fn`` gives. JAX's
    ``UNet.init`` runs jitted here (its eager init compiles op by op)."""
    init_fn = js.UNet.init
    monkeypatch.setattr(js.UNet, "init", lambda self, key, x: jit(
        lambda k, v: init_fn(self, k, v))(key, x))
    imgs, masks = _data(11, n=12)
    jpredict, jparams = js.train_segmenter(imgs, masks, steps=3, batch=4,
                                           base=4, depth=2, seed=5)
    _, init = _jax_unet(4, 2, seed=5, drawn=False)
    monkeypatch.setattr(ts, "init_unet", lambda *a, **k: (
        ts.UNet(3, 4, 2, device="cpu"),
        convert.unet_params_from_jax(_host(init), "cpu")))
    tpredict, tparams = ts.train_segmenter(
        imgs, masks, steps=3, batch=4, base=4, depth=2, seed=5,
        device="cpu")
    want = convert.unet_params_from_jax(_host(jparams), "cpu")
    for k in want:
        np.testing.assert_allclose(tparams[k].numpy(), want[k].numpy(),
                                   atol=1e-5, err_msg=k)
    got = tpredict(imgs[:4])
    assert got.dtype == torch.int32 and got.shape == (4, 32, 32)
    diff = got.numpy() != np.asarray(jpredict(jnp.asarray(imgs[:4])))
    assert diff.mean() <= 1e-3, diff.mean()


def test_train_segmenter_learns_and_predicts_on_its_device():
    imgs, masks = _data(3, n=8, side=16)
    masks = (imgs[..., 0] > 127).astype(np.int32)  # a learnable map
    losses = []
    predict, params = ts.train_segmenter(
        imgs, masks, steps=40, batch=8, lr=1e-2, base=4, depth=1, seed=0,
        device="cpu", log=losses.append)
    assert len(losses) == 2 and set(params) == {
        k for k, _ in ts.UNet(3, 4, 1, device="cpu").named_parameters()}
    first, last = (float(s.split()[-1]) for s in losses)
    assert last < first
    out = predict(imgs)
    assert out.device.type == "cpu" and out.dtype == torch.int32
    assert out.shape == masks.shape


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mean_iou_is_the_jax_packages(seed):
    rng = np.random.default_rng(seed)
    pred = rng.integers(0, 4, (3, 9, 9))
    labels = rng.integers(0, 3 if seed else 2, (3, 9, 9))  # a class absent
    assert ts.mean_iou(pred, labels, 4) == js.mean_iou(pred, labels, 4)
    assert np.isnan(ts.mean_iou(pred, labels, 0))
