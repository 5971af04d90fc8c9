"""The port's evaluation metrics, probes and LaTeX tables (numpy only)
against the JAX package's (scikit-learn and pandas) on the same seeded
inputs: ``calculate_metrics`` within 1e-12, the k-fold merge, the per-class
rows and the 3-way filter as JAX's; the linear regression probe within
1e-6 relative on float64 inputs; LinearSVC's coefficients within 1e-5 of
scikit-learn's converged solver and its predictions as JAX's off near
ties; KNN as JAX's where the k-th and (k+1)-th distances are apart, and by
the port's tie rule on duplicated rows; the LaTeX text byte for byte."""

import warnings

import numpy as np
import pytest

from multimodal_supernovae_tpu.evaluation import metrics as jax_metrics
from multimodal_supernovae_tpu.evaluation import probes as jax_probes
from multimodal_supernovae_tpu.evaluation.reports import metrics_to_latex as jax_latex
from multimodal_supernovae_tpu_torch.evaluation import metrics, probes
from multimodal_supernovae_tpu_torch.evaluation.reports import metrics_to_latex

SVC_MARGIN = 1e-3   # rows whose top-two decisions lie closer may differ
KNN_GAP = 1e-5      # rows whose k-th and (k+1)-th distances lie closer may differ


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # sklearn's zero-division and convergence warnings
        yield


def _embeddings(rng, n, d, n_classes=5):
    """L2-normalised rows with class structure (as the encoders give), labels
    and redshifts."""
    y = rng.integers(0, n_classes, n)
    centres = rng.normal(size=(n_classes, d))
    x = centres[y] * 0.8 + rng.normal(size=(n, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    z = (0.02 + 0.1 * rng.random(n) + 0.01 * y).astype(np.float32)
    return x.astype(np.float32), y.astype(np.int32), z


# -------------------------------------------------------------- metrics

CLASS_CASES = {
    "agree": ([0, 1, 2, 3, 4, 0, 1], [0, 1, 2, 3, 4, 0, 1]),
    "predicted_not_true": ([0, 1, 1, 2, 0, 2], [0, 1, 3, 2, 3, 2]),
    "true_not_predicted": ([0, 1, 4, 2, 4, 2], [0, 1, 1, 2, 0, 2]),
    "both": ([0, 1, 4, 2, 4, 1, 1], [3, 1, 1, 2, 0, 2, 1]),
    "one_class": ([2, 2, 2], [2, 2, 2]),
}


@pytest.mark.parametrize("task,case", [("classification", c) for c in CLASS_CASES]
                         + [("regression", "seeded"), ("regression", "outliers")])
def test_calculate_metrics_matches_jax(task, case):
    rng = np.random.default_rng(len(case))
    if task == "classification":
        yt, yp = (np.asarray(a, np.int32) for a in CLASS_CASES[case])
        z = None
    else:
        yt = rng.integers(0, 5, 40).astype(np.int32)
        z = 0.02 + 0.1 * rng.random(40)
        yp = z + rng.normal(size=40) * (0.2 if case == "outliers" else 0.01)
    want, want_r = jax_metrics.calculate_metrics(z, yt, yp, "M", "lc", 3, task=task)
    got, got_r = metrics.calculate_metrics(z, yt, yp, "M", "lc", 3, task=task)
    assert list(got) == list(want)
    for k in want:
        assert type(got[k]) is type(want[k]), k
        if isinstance(want[k], float):
            assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])
        else:
            assert got[k] == want[k], k
    assert list(got_r) == list(want_r)
    for k in want_r:
        if want_r[k] is None or isinstance(want_r[k], (str, int)):
            assert got_r[k] == want_r[k]
        else:
            np.testing.assert_array_equal(got_r[k], want_r[k])


def _result_rows(rng):
    rows = []
    for fold in range(3):
        for model in ("B+KNN3", "A+Linear"):
            for combo in ("spectral", "lightcurve"):
                n = 5 + fold
                z = rng.random(n)
                y = rng.integers(0, 5, n)
                task = "classification" if model.startswith("B") else "regression"
                rows.append(jax_metrics.calculate_metrics(
                    None if task == "classification" else z, y,
                    y if task == "classification" else z + 0.1 * rng.random(n),
                    model, combo, fold % 2, task=task)[1])
    return rows


def test_merge_kfold_results_matches_jax():
    rows = _result_rows(np.random.default_rng(0))
    want = jax_metrics.merge_kfold_results(rows).to_dict("records")
    cols = metrics.merge_kfold_results(rows)
    got = [dict(zip(cols, row)) for row in zip(*cols.values())]
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            if w[k] is None or isinstance(w[k], (str, int, np.integer)):
                assert g[k] == w[k], k
            else:
                np.testing.assert_array_equal(g[k], w[k])


def test_class_dependent_regression_metrics_matches_jax():
    rng = np.random.default_rng(1)
    rows = [jax_metrics.calculate_metrics(z, y, z + 0.05 * rng.normal(size=30), m, "lc", 0)[1]
            for m in ("A", "B") for z, y in [(rng.random(30), rng.integers(0, 4, 30))]]
    names = {0: ("SLSN-I", "p"), 1: ("SN II", "b"), 2: "SN IIn", 3: ("SN Ia", "o"),
             4: ("SN Ibc", "g")}
    want = jax_metrics.class_dependent_regression_metrics(rows, names)
    got = metrics.class_dependent_regression_metrics(rows, names)
    assert len(got) == len(want) == 8  # class 4 is absent
    for g, w in zip(got, want):
        assert list(g) == list(w) and g == pytest.approx(w, abs=1e-12)


def test_filter_classes_3way_matches_jax():
    rng = np.random.default_rng(2)
    labels = rng.integers(0, 5, 50)
    embs = [rng.normal(size=(50, 4)), rng.normal(size=(50, 3))]
    extras = {"redshift": rng.random(50)}
    want = jax_metrics.filter_classes_3way(embs, labels, extras)
    got = metrics.filter_classes_3way(embs, labels, extras)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2]["redshift"], want[2]["redshift"])
    assert set(np.unique(got[1])) <= {0, 1, 2}


# ---------------------------------------------------------------- probes


@pytest.mark.parametrize("n,d,dtype,rank", [
    (60, 8, np.float64, None), (300, 32, np.float64, None), (40, 64, np.float64, None),
    (3000, 64, np.float64, None), (300, 32, np.float32, None), (3000, 128, np.float64, 32)])
def test_linear_regression_matches_jax(n, d, dtype, rank):
    """Within 1e-6 of JAX's (relative to its largest prediction) on float64
    inputs. On float32 inputs scikit-learn solves in float32 and the port in
    float64: the port then matches scikit-learn given the same values as
    float64, and JAX's own float32 answer within its rounding (1e-4). Rank
    32 in 128 columns, off by 1e-9 (collapsed embeddings, as a projection of
    a 32-wide tower to 128 gives): the singular values under 1e-6 of the
    largest are dropped, as scikit-learn's ``tol`` drops them."""
    rng = np.random.default_rng(n + d)
    x, _, z = _embeddings(rng, n + 100, d)
    if rank:
        x = x[:, :rank] @ rng.normal(size=(rank, d)) + 1e-9 * rng.normal(size=(n + 100, d))
    x = x.astype(dtype)
    xt, xv, zt = x[:n], x[n:], z[:n].astype(dtype)
    got = probes.linear_probe(xt, zt, xv, task="regression")
    want = jax_probes.linear_probe(xt, zt, xv, task="regression")
    if dtype == np.float64:
        assert np.max(np.abs(got - want)) <= 1e-6 * np.max(np.abs(want))
    else:
        exact = jax_probes.linear_probe(xt.astype(np.float64), zt.astype(np.float64),
                                        xv.astype(np.float64), task="regression")
        assert np.max(np.abs(got - exact)) <= 1e-12 * np.max(np.abs(exact))
        assert np.max(np.abs(got - want)) <= 1e-4 * np.max(np.abs(want))
    assert got.shape == want.shape == (100,)


SVC_CASES = [(200, 16, 2), (200, 16, 5), (30, 64, 2), (30, 64, 5), (400, 64, 3)]


@pytest.mark.parametrize("n,d,n_classes", SVC_CASES)
def test_linear_svc_matches_sklearn(n, d, n_classes):
    """Coefficients and intercepts within 1e-5 (relative to the largest) of
    scikit-learn's LinearSVC run to convergence, in the primal (n > d) and
    the dual (n < d)."""
    from sklearn.svm import LinearSVC

    rng = np.random.default_rng(n * d + n_classes)
    x, y, _ = _embeddings(rng, n, d, n_classes)
    coef, icpt, classes = probes.linear_svc(x, y)
    sk = LinearSVC(tol=1e-10, max_iter=100000).fit(x, y)
    np.testing.assert_array_equal(classes, sk.classes_)
    assert coef.shape == sk.coef_.shape and icpt.shape == sk.intercept_.shape
    scale = np.max(np.abs(sk.coef_))
    assert np.max(np.abs(coef - sk.coef_)) <= 1e-5 * scale
    assert np.max(np.abs(icpt - sk.intercept_)) <= 1e-5 * max(scale, np.max(
        np.abs(sk.intercept_)))


def _svc_margins(coef, icpt, x):
    d = probes.linear_svc_decision(coef, icpt, x)
    if d.shape[1] == 1:
        return np.abs(d[:, 0])
    top = np.sort(d, axis=1)
    return top[:, -1] - top[:, -2]


@pytest.mark.parametrize("n,d,n_classes,near_rows", [(200, 16, 2, 0), (200, 16, 5, 1),
                                                     (30, 64, 5, 0), (3000, 64, 5, 0)])
def test_linear_svc_predictions_match_jax(n, d, n_classes, near_rows):
    """The predictions of JAX's default linear probe (LinearSVC at tol 1e-4),
    but on rows whose top-two decisions lie within 1e-3: their number is
    pinned."""
    rng = np.random.default_rng(7 * n + d + n_classes)
    x, y, _ = _embeddings(rng, n + 500, d, n_classes)
    xt, yt, xv = x[:n], y[:n], x[n:]
    got = probes.linear_probe(xt, yt, xv, task="classification")
    want = jax_probes.linear_probe(xt, yt, xv, task="classification")
    near = _svc_margins(*probes.linear_svc(xt, yt)[:2], xv) < SVC_MARGIN
    assert int(near.sum()) == near_rows
    np.testing.assert_array_equal(got[~near], want[~near])
    assert got.dtype.kind == "i"


def _far_from_ties(xt, xv, k):
    """Rows whose k-th and (k+1)-th exact distances differ by more than KNN_GAP."""
    _, dist = probes.neighbours(xt, xv, k + 1)
    return dist[:, k] - dist[:, k - 1] > KNN_GAP


@pytest.mark.parametrize("task", ["regression", "classification"])
@pytest.mark.parametrize("k", probes.DEFAULT_KNN_KS)
def test_knn_matches_jax_off_ties(k, task):
    rng = np.random.default_rng(100 + k)
    x, y, z = _embeddings(rng, 700, 16)
    xt, xv = x[:500], x[500:]
    target = z[:500] if task == "regression" else y[:500]
    got = probes.knn_probe(xt, target, xv, k=k, task=task)
    want = jax_probes.knn_probe(xt, target, xv, k=k, task=task)
    far = _far_from_ties(xt, xv, k)
    assert far.mean() > 0.95
    if task == "regression":
        np.testing.assert_allclose(got[far], want[far], rtol=1e-6)
    else:
        np.testing.assert_array_equal(got[far], want[far])


def test_knn_ties_follow_the_port_rule():
    """Duplicated rows: equal distances go in training-index order; a tied
    vote goes to the smallest label; k clamps to the training set."""
    xt = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 0.0], [1.0, 0.0], [3.0, 0.0]])
    yt = np.array([4, 2, 1, 2, 0])
    zt = np.array([0.1, 0.2, 0.3, 0.4, 0.5])
    xv = np.array([[0.0, 0.0], [0.5, 0.0], [1.0, 0.0], [2.0, 0.0]])
    idx, dist = probes.neighbours(xt, xv, 3)
    np.testing.assert_array_equal(idx, [[0, 2, 1], [0, 1, 2], [1, 3, 0], [1, 3, 4]])
    np.testing.assert_array_equal(dist[1], [0.25, 0.25, 0.25])
    # k = 1: the first of the duplicates; k = 2 at xv[1]: rows 0 and 1 vote 4 and 2 -> 2
    np.testing.assert_array_equal(probes.knn_probe(xt, yt, xv, 1, "classification"),
                                  [4, 4, 2, 2])
    np.testing.assert_array_equal(probes.knn_probe(xt, yt, xv, 2, "classification"),
                                  [1, 2, 2, 2])
    np.testing.assert_array_equal(probes.knn_probe(xt, yt, xv, 3, "classification"),
                                  [1, 1, 2, 2])
    np.testing.assert_allclose(probes.knn_probe(xt, zt, xv, 2, "regression"),
                               [0.2, 0.15, 0.3, 0.3])
    # k beyond the set: all five, the vote 2 (twice) over 4, 1, 0
    np.testing.assert_array_equal(probes.knn_probe(xt, yt, xv, 9, "classification"),
                                  [2, 2, 2, 2])
    np.testing.assert_allclose(probes.knn_probe(xt, zt, xv, 9, "regression"), [0.3] * 4)


# ----------------------------------------------------------------- LaTeX


def _metric_rows(folds, seed):
    rng = np.random.default_rng(seed)
    reg, cls = [], []
    for fold in range(folds):
        for model in ("M+Linear", "M+KNN3", "A+KNN1"):
            for combo in ("lightcurve", "spectral", "lightcurve+spectral"):
                z = rng.random(30) * 0.1
                y = rng.integers(0, 5, 30)
                tied = model == "A+KNN1"  # equal sort keys across combinations
                zp = z if tied else z + rng.normal(size=30) * 0.02
                yp = y if tied else np.where(rng.random(30) < 0.5, y, rng.integers(0, 5, 30))
                reg.append(jax_metrics.calculate_metrics(z, y, zp, model, combo, fold % 2)[0])
                cls.append(jax_metrics.calculate_metrics(None, y, yp, model, combo, fold % 2,
                                                         task="classification")[0])
    return reg, cls


@pytest.mark.parametrize("folds", [1, 3])
@pytest.mark.parametrize("kw", [{}, {"sort": "sort"}, {"drop": ["Combination"], "sort": "sort"},
                                {"drop": ["L1", "mac-p", "absent"]}])
def test_metrics_to_latex_matches_jax_bytes(folds, kw):
    reg, cls = _metric_rows(folds, folds)
    for rows, key in ((reg, "R2"), (cls, "mac-f1")):
        args = dict(kw, sort=key) if "sort" in kw else kw
        want = jax_latex(rows, **args)
        got = metrics_to_latex(rows, **args)
        assert len(got) == len(want) >= 1
        assert got == want
    if folds == 1:
        assert "nan" in got[0]
