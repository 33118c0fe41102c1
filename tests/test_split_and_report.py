"""The numpy train/val/test split and test report against sklearn.

The main path imports no sklearn; these tests hold the numpy versions to
sklearn's ``train_test_split(random_state=1, shuffle=True)`` and
``precision_recall_fscore_support`` (installed in the test environment).
"""

import numpy as np
import pytest

from scaling_rgcn_training_tpu.graphs.dataset import shuffle_split
from scaling_rgcn_training_tpu.train.metrics import (
    classification_report, per_class_scores)

sk_model_selection = pytest.importorskip("sklearn.model_selection")
sk_metrics = pytest.importorskip("sklearn.metrics")


@pytest.mark.parametrize("n", [7, 100, 1001, 8285])
def test_split_equals_sklearn_both_stages(n):
    idx = np.arange(n) * 3 + 1
    labels = np.arange(n) % 5
    a, b, ya, yb = sk_model_selection.train_test_split(
        idx, labels, test_size=0.2, random_state=1, shuffle=True)
    train, test = shuffle_split(n, 0.2)
    np.testing.assert_array_equal(idx[train], a)
    np.testing.assert_array_equal(idx[test], b)
    np.testing.assert_array_equal(labels[train], ya)
    a2, c2 = sk_model_selection.train_test_split(
        a, test_size=0.25, random_state=1, shuffle=True)
    train2, val2 = shuffle_split(len(a), 0.25)
    np.testing.assert_array_equal(a[train2], a2)
    np.testing.assert_array_equal(a[val2], c2)


@pytest.mark.parametrize("multilabel", [True, False])
def test_report_scores_equal_sklearn(multilabel):
    rng = np.random.default_rng(int(multilabel))
    t, c = 60, 5
    if multilabel:
        y = (rng.uniform(size=(t, c)) > 0.6).astype(np.int64)
        pred = (rng.uniform(size=(t, c)) > 0.5).astype(np.int64)
    else:
        y = np.eye(c, dtype=np.int64)[rng.integers(0, c, t)]
        pred = np.eye(c, dtype=np.int64)[rng.integers(0, c, t)]
    y[:, 2] = 0                                    # a class with no support
    ours = per_class_scores(y, pred)
    p, r, f, s = sk_metrics.precision_recall_fscore_support(
        y, pred, average=None, zero_division=0)
    np.testing.assert_allclose(ours["precision"], p)
    np.testing.assert_allclose(ours["recall"], r)
    np.testing.assert_allclose(ours["f1-score"], f)
    np.testing.assert_array_equal(ours["support"], s)
    text = classification_report(y, pred)
    lines = text.splitlines()
    assert len(lines) == 1 + c + 3
    for avg in ("micro", "macro", "weighted"):
        want = sk_metrics.precision_recall_fscore_support(
            y, pred, average=avg, zero_division=0)[:3]
        row = [ln for ln in lines if ln.strip().startswith(avg)][0].split()
        np.testing.assert_allclose([float(v) for v in row[2:5]], want, atol=6e-3)
