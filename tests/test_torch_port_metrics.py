"""The numpy AUROC table of ct_clip_tpu_torch against the JAX package's
scikit-learn one (ct_clip_tpu/evals/metrics.py::evaluate_internal), CPU.

Labels and scores carry ties, and one column holds a single class.
Tolerance: 1e-12 absolute (both are exact rank statistics; they differ only
in float summation order), NaN in the same places.
"""
import math

import numpy as np
import pytest

TOL = 1e-12


def _labels_scores(seed, n=60, k=6):
    rng = np.random.RandomState(seed)
    real = (rng.rand(n, k) < 0.35).astype(np.float64)
    real[:, 2] = 0.0  # one class only: AUROC undefined
    real[:, 4] = 1.0
    # scores on a coarse grid, so many ties within and across the classes
    predicted = np.round(rng.rand(n, k) * 8) / 8
    predicted[:, 1] = 0.5  # every score tied
    return predicted, real


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluate_internal_matches_jax(seed):
    from ct_clip_tpu.evals.metrics import evaluate_internal as jax_eval
    from ct_clip_tpu_torch.evals import evaluate_internal

    names = [f"p{i}" for i in range(6)]
    predicted, real = _labels_scores(seed)
    ref = jax_eval(predicted, real, names).iloc[0].to_dict()
    got = evaluate_internal(predicted, real, names)
    assert list(got) == list(ref) == [f"{n}_auc" for n in names] + ["mean_auc"]
    for key, value in ref.items():
        assert math.isnan(got[key]) == math.isnan(value), key
        if not math.isnan(value):
            assert abs(got[key] - value) <= TOL, (key, got[key], value)
    assert math.isnan(got["p2_auc"]) and math.isnan(got["p4_auc"])
    assert got["p1_auc"] == 0.5


def test_auroc_matches_sklearn_on_unbalanced_ties():
    from sklearn.metrics import roc_auc_score

    from ct_clip_tpu_torch.evals import auroc

    rng = np.random.RandomState(3)
    for n in (2, 7, 500):
        y = np.r_[0, 1, (rng.rand(n - 2) < 0.1).astype(int)]
        s = np.round(rng.randn(n), 1)
        assert abs(auroc(y, s) - roc_auc_score(y, s)) <= TOL


def test_write_table_matches_jax_csv(tmp_path):
    from ct_clip_tpu.evals.metrics import evaluate_internal as jax_eval
    from ct_clip_tpu.utils import write_table as jax_write
    from ct_clip_tpu_torch.evals import evaluate_internal, write_table

    names = [f"p{i}" for i in range(6)]
    predicted, real = _labels_scores(2)
    (tmp_path / "jax").mkdir()
    jax_write(jax_eval(predicted, real, names), tmp_path / "jax" / "aurocs.xlsx")
    ref = tmp_path / "jax" / "aurocs.csv"
    # without an Excel engine the JAX package falls back to the CSV the
    # port writes
    assert ref.exists()
    path = write_table(evaluate_internal(predicted, real, names),
                       tmp_path / "aurocs.xlsx")
    assert path == tmp_path / "aurocs.csv"
    got_lines, ref_lines = path.read_text().splitlines(), ref.read_text().splitlines()
    assert got_lines[0] == ref_lines[0]
    for g, r in zip(got_lines[1].split(","), ref_lines[1].split(",")):
        assert (g == "") == (r == "")
        if r:
            assert abs(float(g) - float(r)) <= TOL
