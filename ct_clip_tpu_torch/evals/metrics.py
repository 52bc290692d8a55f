"""Per-pathology AUROC table of a zero-shot run, with numpy only.

Port of ct_clip_tpu/evals/metrics.py::evaluate_internal and of the CSV
branch of ct_clip_tpu/utils.py::write_table (reference scripts/eval.py:160-203).
The JAX package computes each AUROC with scikit-learn's `roc_auc_score` and
writes the table with pandas; the machine with the card has neither, so the
AUROC here is the Mann-Whitney rank statistic with tie-averaged ranks, which
is the same number, and the table is written with `csv`.  The ROC and
precision-recall plots are not ported: the JAX package skips them too when
matplotlib is missing.
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
