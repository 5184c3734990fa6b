"""Classifier evaluation: ROC-AUC + macro-F1 threshold sweep.

Port of the JAX package's ``models/evaluation.py``, parity with
``dlmodels/stain_adversarial_learning/utils/evaluation_utils.py``:
``evaluate_model_validation`` (``:9-57``) predicts over a labeled set,
computes ROC-AUC and sweeps decision thresholds to maximize macro-F1,
returning (best_threshold, best_f1, auc); ``evaluate_model_test``
(``:66-111``) applies a fixed threshold. The device does only the batched
forward pass; the metrics are numpy on the host.

The JAX package calls scikit-learn for the two metrics; the port computes
them in numpy with scikit-learn's semantics and float64 arithmetic:
``roc_auc`` is ``roc_auc_score`` on binary labels (the ROC curve over the
distinct scores, collinear points dropped, the trapezoid area; tied scores
count half; labels of one class give NaN with a warning), ``macro_f1`` is
``f1_score(average="macro")`` (the mean over the labels present in either
argument of ``2 tp / (n_true + n_pred)``, a class never predicted scoring
0).
"""

from __future__ import annotations

import warnings

import numpy as np

from stainlib_tpu_torch.data.generators import _host

# numpy 2's name; numpy 1's ``trapz`` computes the same sum.
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def roc_auc(labels, scores) -> float:
    """ROC-AUC of positive-class ``scores``; the larger label is the
    positive class (scikit-learn's ``roc_auc_score`` on binary labels)."""
    y = np.asarray(labels).reshape(-1)
    s = np.asarray(scores).reshape(-1)
    classes = np.unique(y)
    if len(classes) > 2:
        raise ValueError("multiclass format is not supported")
    if len(classes) != 2:
        warnings.warn("Only one class is present in y_true. ROC AUC score "
                      "is not defined in that case.", stacklevel=2)
        return float("nan")
    y = (y == classes[1]).astype(np.float64)
    order = np.argsort(s, kind="mergesort")[::-1]
    s, y = s[order], y[order]
    idx = np.r_[np.where(np.diff(s))[0], y.size - 1]
    tps = np.cumsum(y, dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    if fps.shape[0] > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2),
                                                  np.diff(tps, 2)), True])[0]
        fps, tps = fps[keep], tps[keep]
    tps, fps = np.r_[0.0, tps], np.r_[0.0, fps]
    return float(_trapezoid(tps / tps[-1], fps / fps[-1]))


def macro_f1(labels, preds) -> float:
    """Macro F1 over the labels present in ``labels`` or ``preds``
    (scikit-learn's ``f1_score(average="macro")``)."""
    y = np.asarray(labels).reshape(-1)
    p = np.asarray(preds).reshape(-1)
    if y.dtype == bool:
        y = y.astype(np.int64)
    if p.dtype == bool:
        p = p.astype(np.int64)
    scores = []
    for k in np.union1d(y, p):
        tp = float(np.sum((y == k) & (p == k)))
        denom = float(np.sum(y == k)) + float(np.sum(p == k))
        scores.append(2.0 * tp / denom if denom else 0.0)
    return float(np.mean(np.asarray(scores, np.float64)))


def sweep_threshold(labels, scores, n_thresholds: int = 99):
    """Best macro-F1 over a threshold grid (``evaluation_utils.py:44-57``).

    Returns (best_threshold, best_f1).
    """
    labels = np.asarray(labels)
    scores = np.asarray(scores)
    best_t, best_f1 = 0.5, -1.0
    for t in np.linspace(0.01, 0.99, n_thresholds):
        f1 = macro_f1(labels, scores >= t)
        if f1 > best_f1:
            best_t, best_f1 = float(t), f1
    return best_t, best_f1


def evaluate_validation(predict_fn, images, labels, batch_size: int = 256):
    """Validation pass: AUC + threshold sweep.

    ``predict_fn(batch) -> (B, 2) class probabilities`` (numpy or a tensor
    on any device). Returns (best_threshold, best_f1, auc) like
    ``evaluate_model_validation``.
    """
    scores = predict_scores(predict_fn, images, batch_size)
    auc = roc_auc(labels, scores)
    best_t, best_f1 = sweep_threshold(labels, scores)
    return best_t, best_f1, auc


def evaluate_test(predict_fn, images, labels, threshold: float,
                  batch_size: int = 256):
    """Test pass at a fixed validation-chosen threshold
    (``evaluation_utils.py:66-111``). Returns (auc, macro_f1)."""
    scores = predict_scores(predict_fn, images, batch_size)
    return roc_auc(labels, scores), macro_f1(labels, scores >= threshold)


def evaluate_pos_neg(predict_fn, pos_images, neg_images, threshold: float,
                     batch_size: int = 64):
    """Separate positive/negative test directories, the TMA/TCGA evaluation
    contract (``evaluation_utils.py:115-217``): score both sets, report
    (auc, macro_f1, false_positive_rate_at_threshold)."""
    s_pos = predict_scores(predict_fn, pos_images, batch_size)
    s_neg = predict_scores(predict_fn, neg_images, batch_size)
    labels = np.concatenate([np.ones(len(s_pos)), np.zeros(len(s_neg))])
    scores = np.concatenate([s_pos, s_neg])
    fpr = float((s_neg >= threshold).mean()) if len(s_neg) else 0.0
    return roc_auc(labels, scores), macro_f1(labels, scores >= threshold), fpr


def predict_scores(predict_fn, images, batch_size: int = 256):
    """Batched positive-class scores with a padded final batch (the device
    sees one batch shape only)."""
    images = np.asarray(images)
    n = len(images)
    out = np.empty((n,), np.float32)
    for i in range(0, n, batch_size):
        chunk = images[i : i + batch_size]
        pad = batch_size - len(chunk)
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
        probs = _host(predict_fn(chunk))[:, 1]
        out[i : i + batch_size] = probs[: len(images[i : i + batch_size])]
    return out
