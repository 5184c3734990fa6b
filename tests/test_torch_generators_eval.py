"""The port's patch generators and classifier evaluation against the JAX
package's, on the CPU.

``data/generators.py`` is a numpy copy: batches, patches, heatmaps and
mined indices are equal. ``models/evaluation.py`` computes ROC-AUC and
macro F1 in numpy with scikit-learn's semantics (the JAX package calls
scikit-learn; the port needs torch and numpy only): both are held equal to
scikit-learn's (exact, float64), ties, labels other than {0, 1}, a class
never predicted and labels of one class included; the evaluation passes
equal the JAX package's exactly on the same predictions.
"""

import warnings

import numpy as np
import pytest
import torch
from sklearn.metrics import f1_score, roc_auc_score

from stainlib_tpu.data import generators as jg
from stainlib_tpu.models import evaluation as je
from stainlib_tpu_torch.data import generators as tg
from stainlib_tpu_torch.models import evaluation as te


@pytest.mark.parametrize("seed", range(6))
def test_roc_auc_is_sklearns(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 200))
    labels = rng.integers(0, 2, n) + (seed % 3 == 2)  # {1, 2} too
    labels[:2] = labels.min(), labels.min() + 1
    scores = np.round(rng.random(n), seed % 3 + 1).astype(np.float32)  # ties
    assert te.roc_auc(labels, scores) == roc_auc_score(labels, scores)


@pytest.mark.parametrize("case", ["separated", "inverted", "all_tied"])
def test_roc_auc_edge_cases(case):
    labels = np.array([0, 0, 1, 1, 0, 1])
    scores = {"separated": labels * 0.5 + 0.1,
              "inverted": 1.0 - labels * 0.5,
              "all_tied": np.full(6, 0.3)}[case]
    assert te.roc_auc(labels, scores) == roc_auc_score(labels, scores)


def test_roc_auc_of_one_class_is_nan_with_a_warning_as_sklearn():
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        want = roc_auc_score(np.ones(4), np.arange(4.0))
        got = te.roc_auc(np.ones(4), np.arange(4.0))
    assert np.isnan(want) and np.isnan(got)
    assert sum("Only one class" in str(w.message) for w in seen) == 2
    with pytest.raises(ValueError):
        te.roc_auc(np.array([0, 1, 2]), np.arange(3.0))


@pytest.mark.parametrize("seed", range(6))
def test_macro_f1_is_sklearns(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 100))
    if seed < 3:  # the binary sweep's form: int labels, bool predictions
        labels = rng.integers(0, 2, n)
        preds = rng.random(n) >= rng.random()
    else:  # multiclass, a class never predicted
        labels = rng.integers(0, 4, n)
        preds = rng.integers(0, 3, n)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = f1_score(labels, preds, average="macro")
    assert te.macro_f1(labels, preds) == want


def _predict(images):
    """A fixed numpy scorer: (B, 2) probabilities from the mean red."""
    p = images[..., 0].reshape(len(images), -1).mean(1) / 255.0
    return np.stack([1 - p, p], 1).astype(np.float32)


def _set(seed, n=37):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n)
    imgs = (rng.random((n, 8, 8, 3)) * 120 + labels[:, None, None, None]
            * rng.random((n, 1, 1, 1)) * 130).astype(np.uint8)
    return imgs, labels


def test_evaluation_passes_equal_the_jax_packages():
    imgs, labels = _set(0)
    assert te.evaluate_validation(_predict, imgs, labels, 16) == \
        je.evaluate_validation(_predict, imgs, labels, 16)
    assert te.evaluate_test(_predict, imgs, labels, 0.4, 16) == \
        je.evaluate_test(_predict, imgs, labels, 0.4, 16)
    assert te.evaluate_pos_neg(_predict, imgs[labels == 1],
                               imgs[labels == 0], 0.4, 8) == \
        je.evaluate_pos_neg(_predict, imgs[labels == 1], imgs[labels == 0],
                            0.4, 8)
    s = te.predict_scores(_predict, imgs, 16)
    assert s.dtype == np.float32
    np.testing.assert_array_equal(s, je.predict_scores(_predict, imgs, 16))
    assert te.sweep_threshold(labels, s) == je.sweep_threshold(labels, s)


def test_predict_fn_may_return_tensors():
    imgs, labels = _set(1)

    def as_tensor(x):
        return torch.from_numpy(_predict(x)).requires_grad_()

    np.testing.assert_array_equal(te.predict_scores(as_tensor, imgs, 16),
                                  te.predict_scores(_predict, imgs, 16))
    np.testing.assert_array_equal(
        tg.sliding_window_scores(as_tensor, imgs[0].repeat(4, 0).repeat(
            4, 1), 8, 4, 16),
        jg.sliding_window_scores(_predict, imgs[0].repeat(4, 0).repeat(
            4, 1), 8, 4, 16))


@pytest.mark.parametrize("grouped", [False, True])
def test_balanced_batches_equal_the_jax_packages(grouped):
    imgs, labels = _set(2, n=40)
    groups = np.arange(40) % 3 if grouped else None

    def aug(batch, rng):
        return batch + rng.integers(0, 2, batch.shape).astype(np.uint8)

    a = tg.balanced_batches(imgs, labels, 12, groups, seed=4, augment_fn=aug)
    b = jg.balanced_batches(imgs, labels, 12, groups, seed=4, augment_fn=aug)
    for _ in range(3):
        for x, y in zip(next(a), next(b)):
            np.testing.assert_array_equal(x, y)


def test_patches_heatmaps_and_mining_equal_the_jax_packages(tmp_path):
    rng = np.random.default_rng(5)
    image = rng.integers(0, 256, (37, 45, 3), dtype=np.uint8)
    image[:20, :20] = 250  # a white corner
    for patch, stride in ((8, 4), (9, 5)):
        np.testing.assert_array_equal(tg.extract_patches(image, patch, stride),
                                      jg.extract_patches(image, patch, stride))
    patches = tg.extract_patches(image, 8, 4)
    kept_t, idx_t = tg.filter_white_patches(patches)
    kept_j, idx_j = jg.filter_white_patches(patches)
    np.testing.assert_array_equal(idx_t, idx_j)
    assert len(idx_t) < len(patches)
    heat = tg.sliding_window_scores(_predict, image, 8, 4, 16)
    np.testing.assert_array_equal(
        heat, jg.sliding_window_scores(_predict, image, 8, 4, 16))
    labels = np.arange(len(patches)) % 2
    for got, want in zip(tg.mine_hard_negatives(_predict, patches, labels, 5,
                                                16),
                         jg.mine_hard_negatives(_predict, patches, labels, 5,
                                                16)):
        np.testing.assert_array_equal(got, want)
    assert tg.parse_domain_id("slide_07_x.png") == jg.parse_domain_id(
        "slide_07_x.png") == 7
    with pytest.raises(ValueError):
        tg.parse_domain_id("none.png")
    pytest.importorskip("PIL")
    from PIL import Image

    a = tg.save_heatmap(str(tmp_path / "t" / "h.png"), heat)
    b = jg.save_heatmap(str(tmp_path / "j" / "h.png"), heat)
    np.testing.assert_array_equal(np.asarray(Image.open(a)),
                                  np.asarray(Image.open(b)))
