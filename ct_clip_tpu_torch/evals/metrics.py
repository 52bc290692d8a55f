"""Metrics with numpy only: the per-pathology AUROC table of a zero-shot run
and the multilabel scores of the RadBERT report classifier.

Port of ct_clip_tpu/evals/metrics.py::evaluate_internal and of the CSV
branch of ct_clip_tpu/utils.py::write_table (reference scripts/eval.py:160-203).
The JAX package computes each AUROC with scikit-learn's `roc_auc_score` and
writes the table with pandas; the machine with the card has neither, so the
AUROC here is the Mann-Whitney rank statistic with tie-averaged ranks, which
is the same number, and the table is written with `csv`.  The ROC and
precision-recall plots are not ported: the JAX package skips them too when
matplotlib is missing.

The RadBERT trainer and `multilabel_report` (ct_clip_tpu/train/
text_classifier.py) take `f1_score`, `accuracy_score`,
`multilabel_confusion_matrix` and `classification_report` from
scikit-learn; below are numpy versions of the cases they use (multilabel
indicator arrays, zero_division=0), with scikit-learn's definitions.
"""
from __future__ import annotations

import csv
import math
from pathlib import Path
from typing import Dict, Sequence

import numpy as np


def auroc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Area under the ROC curve of binary labels; NaN when `y_true` holds
    only one class.  The larger label value is the positive class, as in
    `roc_auc_score`."""
    y_true = np.asarray(y_true).ravel()
    y_score = np.asarray(y_score, np.float64).ravel()
    classes = np.unique(y_true)
    if len(classes) < 2:
        return float("nan")
    if len(classes) > 2:
        raise ValueError(f"auroc needs binary labels, got {classes}")
    pos = y_true == classes[1]
    # 1-based ranks of the scores, ties given the mean of the ranks they span
    _, inverse, counts = np.unique(y_score, return_inverse=True,
                                   return_counts=True)
    ends = np.cumsum(counts)
    ranks = (ends - (counts - 1) / 2.0)[inverse]
    n_pos = int(pos.sum())
    n_neg = len(y_true) - n_pos
    u = ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def evaluate_internal(predicted: np.ndarray, real: np.ndarray,
                      pathologies: Sequence[str]) -> Dict[str, float]:
    """One AUROC per '{pathology}_auc' column, then 'mean_auc' over the
    columns that are not NaN: the one row of the JAX package's table."""
    table = {f"{name}_auc": auroc(real[:, i], predicted[:, i])
             for i, name in enumerate(pathologies)}
    vals = [v for v in table.values() if not math.isnan(v)]
    table["mean_auc"] = float(np.mean(vals)) if vals else float("nan")
    return table


def write_table(table: Dict[str, float], path) -> Path:
    """Write the one-row table as CSV, as the JAX package's `write_table`
    does without an Excel engine: a header row, then the values (NaN as an
    empty field).  Returns the path written."""
    path = Path(path).with_suffix(".csv")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(list(table))
        w.writerow(["" if math.isnan(v) else repr(float(v)) for v in table.values()])
    return path


def multilabel_confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray,
                                samplewise: bool = False) -> np.ndarray:
    """(labels, 2, 2) [[tn, fp], [fn, tp]] per label column of (N, labels)
    indicator arrays, or per sample (row) with samplewise=True."""
    t, p = np.asarray(y_true) != 0, np.asarray(y_pred) != 0
    axis = 1 if samplewise else 0
    tp, fp = (t & p).sum(axis), (~t & p).sum(axis)
    fn, tn = (t & ~p).sum(axis), (~t & ~p).sum(axis)
    return np.stack([tn, fp, fn, tp], axis=-1).reshape(-1, 2, 2)


def _divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """num / den, 0 where den is 0 (zero_division=0)."""
    num, den = np.asarray(num, np.float64), np.asarray(den, np.float64)
    return np.where(den == 0, 0.0, num / np.where(den == 0, 1.0, den))


def precision_recall_fscore_support(y_true, y_pred, average=None):
    """scikit-learn's precision_recall_fscore_support for multilabel
    indicator arrays with beta 1 and zero_division=0: per label (average
    None, with supports) or averaged 'micro', 'macro', 'weighted' or
    'samples' (support None)."""
    mcm = multilabel_confusion_matrix(y_true, y_pred, samplewise=average == "samples")
    tp, pred, true = mcm[:, 1, 1], mcm[:, 1, 1] + mcm[:, 0, 1], mcm[:, 1, 1] + mcm[:, 1, 0]
    if average == "micro":
        tp, pred, true = tp.sum(keepdims=True), pred.sum(keepdims=True), true.sum(keepdims=True)
    precision, recall = _divide(tp, pred), _divide(tp, true)
    f1 = _divide(2.0 * tp, true + pred)
    if average is None:
        return precision, recall, f1, true
    weights = true if average == "weighted" and true.sum() > 0 else None
    return (float(np.average(precision, weights=weights)),
            float(np.average(recall, weights=weights)),
            float(np.average(f1, weights=weights)), None)


def f1_score(y_true, y_pred, average: str = "macro") -> float:
    """F1 of multilabel indicator arrays, zero_division=0."""
    return precision_recall_fscore_support(y_true, y_pred, average)[2]


def accuracy_score(y_true, y_pred) -> float:
    """Share of equal entries of two label vectors."""
    return float(np.mean(np.asarray(y_true) == np.asarray(y_pred)))


def classification_report(y_true, y_pred, target_names: Sequence[str]) -> Dict:
    """scikit-learn's classification_report(output_dict=True,
    zero_division=0) of multilabel indicator arrays: per target name and
    per 'micro avg', 'macro avg', 'weighted avg' and 'samples avg', a dict of
    precision, recall, f1-score and support, all floats."""
    headers = ("precision", "recall", "f1-score", "support")
    p, r, f1, s = precision_recall_fscore_support(y_true, y_pred)
    if len(target_names) != len(s):
        raise ValueError(f"{len(s)} label columns, {len(target_names)} target names")
    report = {name: dict(zip(headers, map(float, row)))
              for name, *row in zip(target_names, p, r, f1, s)}
    for average in ("micro", "macro", "weighted", "samples"):
        ap, ar, af, _ = precision_recall_fscore_support(y_true, y_pred, average)
        report[f"{average} avg"] = dict(zip(headers, (ap, ar, af, float(np.sum(s)))))
    return report
