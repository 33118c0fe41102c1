"""Eval metrics in pure JAX (reference model/evaluation.py:8-31).

The reference computes subset accuracy + weighted/macro F1 via sklearn on
host tensors every epoch. Here the per-epoch metrics are jnp so the whole
eval fits inside jit (no host sync in the epoch loop); the final test-set
report (evaluation.py:28-30) is a host-side numpy table with the columns of
sklearn's ``classification_report``.

Prediction rule (evaluation.py:14-23):
- sigmoid path: ``round(sigmoid(logits))`` as ints (round-half-to-even,
  same as torch.round);
- softmax path: one-hot of the argmax.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax.numpy as jnp
import numpy as np


def predictions(logits: jnp.ndarray, activation: str) -> jnp.ndarray:
    if activation == "sigmoid":
        import jax

        return jnp.round(jax.nn.sigmoid(logits)).astype(jnp.int32)
    # softmax path: one-hot the argmax
    a = jnp.argmax(logits, axis=1)
    return (a[:, None] == jnp.arange(logits.shape[1])[None, :]).astype(jnp.int32)


def subset_accuracy(pred: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """sklearn ``accuracy_score`` on multilabel data = exact row match."""
    return jnp.all(pred == y.astype(pred.dtype), axis=1).mean()


def f1_score_jax(pred: jnp.ndarray, y: jnp.ndarray, average: str = "weighted") -> jnp.ndarray:
    """Binary per-class F1 with zero_division=0, sklearn-compatible."""
    y = y.astype(jnp.int32)
    tp = jnp.sum((pred == 1) & (y == 1), axis=0).astype(jnp.float32)
    fp = jnp.sum((pred == 1) & (y == 0), axis=0).astype(jnp.float32)
    fn = jnp.sum((pred == 0) & (y == 1), axis=0).astype(jnp.float32)
    precision = jnp.where(tp + fp > 0, tp / jnp.maximum(tp + fp, 1), 0.0)
    recall = jnp.where(tp + fn > 0, tp / jnp.maximum(tp + fn, 1), 0.0)
    f1 = jnp.where(precision + recall > 0,
                   2 * precision * recall / jnp.maximum(precision + recall, 1e-30), 0.0)
    if average == "macro":
        return f1.mean()
    support = jnp.sum(y == 1, axis=0).astype(jnp.float32)
    total = jnp.maximum(support.sum(), 1.0)
    return jnp.sum(f1 * support) / total


def evaluate(logits: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray,
             activation: str) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(subset accuracy, weighted F1, macro F1) on eval node subset ``x``."""
    pred = predictions(logits, activation)[x]
    return (
        subset_accuracy(pred, y),
        f1_score_jax(pred, y, "weighted"),
        f1_score_jax(pred, y, "macro"),
    )


def per_class_scores(y: np.ndarray, pred: np.ndarray) -> Dict[str, np.ndarray]:
    """Per-class precision, recall, F1 and support of multi-hot ``pred``
    against multi-hot ``y`` ([T, C] each), zero_division=0 (sklearn's
    ``precision_recall_fscore_support(average=None)``)."""
    y = np.asarray(y).astype(np.int64)
    pred = np.asarray(pred).astype(np.int64)
    tp = ((pred == 1) & (y == 1)).sum(0).astype(np.float64)
    fp = ((pred == 1) & (y == 0)).sum(0).astype(np.float64)
    fn = ((pred == 0) & (y == 1)).sum(0).astype(np.float64)
    div = lambda a, b: np.divide(a, b, out=np.zeros_like(a), where=b > 0)
    precision, recall = div(tp, tp + fp), div(tp, tp + fn)
    f1 = div(2 * precision * recall, precision + recall)
    return {"precision": precision, "recall": recall, "f1-score": f1,
            "support": (y == 1).sum(0), "tp": tp, "fp": fp, "fn": fn}


def classification_report(y: np.ndarray, pred: np.ndarray, digits: int = 2) -> str:
    """Text table: one row per class, then micro, macro and weighted averages."""
    s = per_class_scores(y, pred)
    cols = ("precision", "recall", "f1-score")
    support = s["support"]
    tp, fp, fn = s["tp"].sum(), s["fp"].sum(), s["fn"].sum()
    p_mi = tp / (tp + fp) if tp + fp else 0.0
    r_mi = tp / (tp + fn) if tp + fn else 0.0
    f_mi = 2 * p_mi * r_mi / (p_mi + r_mi) if p_mi + r_mi else 0.0
    w = support / support.sum() if support.sum() else np.zeros(len(support))
    rows = [(str(c), *(s[k][c] for k in cols), int(support[c]))
            for c in range(len(support))]
    rows.append(("micro avg", p_mi, r_mi, f_mi, int(support.sum())))
    rows.append(("macro avg", *(s[k].mean() for k in cols), int(support.sum())))
    rows.append(("weighted avg", *((s[k] * w).sum() for k in cols),
                 int(support.sum())))
    width = max(len(r[0]) for r in rows)
    lines = [f"{'':>{width}} {'precision':>9} {'recall':>9} {'f1-score':>9} "
             f"{'support':>9}"]
    for name, p, r, f, n in rows:
        lines.append(f"{name:>{width}} {p:>9.{digits}f} {r:>9.{digits}f} "
                     f"{f:>9.{digits}f} {n:>9}")
    return "\n".join(lines)
