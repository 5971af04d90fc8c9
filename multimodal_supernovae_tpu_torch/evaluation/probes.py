"""Linear and KNN probes on frozen embeddings (port of
multimodal_supernovae_tpu/evaluation/probes.py, in numpy: the card's host
has no scikit-learn).

Each probe is the scikit-learn estimator the JAX package fits, computed in
float64:

  * ``LinearRegression``: least squares (``numpy.linalg.lstsq``, gelsd, the
    singular values below 1e-6 of the largest dropped, as scikit-learn's
    ``tol`` does) on the centred X and y, intercept y_mean - x_mean . w.
    scikit-learn computes
    in the inputs' dtype, so on float32 embeddings its own rounding (up to
    about 1e-5 relative at 3000 x 64) separates the two.
  * ``LinearSVC()``: one-vs-rest over the sorted labels (two classes: one
    classifier for the larger label, decision > 0), L2-regularised squared
    hinge at C = 1, the intercept an extra feature of value 1 whose weight
    is regularised (liblinear's ``intercept_scaling=1``). The primal is
    strictly convex, so its minimiser is unique; scikit-learn stops at tol
    1e-4, ``linear_svc`` takes Newton steps on the generalised Hessian (as
    liblinear's TRON does) until the gradient vanishes to rounding.
    Prediction: the largest decision, ties to the first class.
  * KNN with uniform weights: exact float64 squared Euclidean distances;
    among equal distances the smaller training index comes first (the
    port's own rule: scikit-learn's order among ties follows the rounding
    of its chunked float32 distances and no rule reproduces it). The
    regressor takes the neighbours' mean, the classifier their majority,
    a tie between classes going to the smallest label.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

DEFAULT_KNN_KS = (1, 2, 3, 5, 7, 8, 9)  # evaluate_models.py:35

C = 1.0
LSTSQ_RCOND = 1e-6  # LinearRegression's tol: singular values below it (relative) drop
NEWTON_MAX_STEPS = 200
ARMIJO = 1e-4


def _f64(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


def linear_regression(x_train, y_train, x_val) -> np.ndarray:
    """``LinearRegression().fit(x_train, y_train).predict(x_val)``, y (n,) or
    (n, k); the prediction has y's trailing shape."""
    xt, yt, xv = _f64(x_train), _f64(y_train), _f64(x_val)
    x_off, y_off = xt.mean(axis=0), yt.mean(axis=0)
    w = np.linalg.lstsq(xt - x_off, yt - y_off, rcond=LSTSQ_RCOND)[0]
    return xv @ w + (y_off - x_off @ w)


def _squared_hinge_fit(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """argmin_w 0.5 |w|^2 + C sum_i max(0, 1 - y_i x_i.w)^2 for y in {-1, +1}
    (x carries the intercept column): Newton steps on the generalised
    Hessian I + 2C X_A^T X_A over the rows A with a positive hinge, with an
    Armijo backtracking line search. The objective is piecewise quadratic,
    so once A settles a full step lands on the minimiser."""
    n, d = x.shape
    w = np.zeros(d)

    def objective(w):
        h = np.maximum(0.0, 1.0 - y * (x @ w))
        return 0.5 * w @ w + C * h @ h

    f = objective(w)
    for _ in range(NEWTON_MAX_STEPS):
        h = 1.0 - y * (x @ w)
        act = h > 0
        xa = x[act]
        grad = w - 2.0 * C * xa.T @ (y[act] * h[act])
        if np.linalg.norm(grad) <= 1e-13 * max(1.0, np.linalg.norm(w)):
            break
        hess = np.eye(d) + 2.0 * C * xa.T @ xa
        step = -np.linalg.solve(hess, grad)
        slope = grad @ step
        t = 1.0
        while True:
            f_new = objective(w + t * step)
            if f_new <= f + ARMIJO * t * slope or t < 1e-12:
                break
            t *= 0.5
        w, f_prev, f = w + t * step, f, f_new
        if t == 1.0 and f_prev - f <= 1e-16 * max(1.0, abs(f)):
            break
    return w


def linear_svc(x_train, y_train) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(coef (n_clf, d), intercept (n_clf,), classes) of ``LinearSVC()``:
    n_clf is 1 for two classes (the larger label's classifier), else one a
    class."""
    xt = _f64(x_train)
    y = np.asarray(y_train).ravel()
    classes = np.unique(y)
    if len(classes) < 2:
        raise ValueError(f"LinearSVC needs at least 2 classes, got {classes.tolist()}")
    xa = np.concatenate([xt, np.ones((len(xt), 1))], axis=1)
    positive = classes[1:] if len(classes) == 2 else classes
    ws = np.stack([_squared_hinge_fit(xa, np.where(y == c, 1.0, -1.0)) for c in positive])
    return ws[:, :-1], ws[:, -1], classes


def linear_svc_decision(coef, intercept, x) -> np.ndarray:
    return _f64(x) @ coef.T + intercept


def linear_svc_predict(coef, intercept, classes, x) -> np.ndarray:
    d = linear_svc_decision(coef, intercept, x)
    if len(classes) == 2:
        return classes[(d[:, 0] > 0).astype(int)]
    return classes[np.argmax(d, axis=1)]


def linear_probe(
    x_train: np.ndarray,
    y_train: np.ndarray,
    x_val: Optional[np.ndarray] = None,
    task: str = "regression",
) -> np.ndarray:
    """Fit LinearRegression (regression) or LinearSVC (classification) on
    train embeddings; predict on val (or train when no val given), flat."""
    xv = x_train if x_val is None else x_val
    if task == "regression":
        return np.asarray(linear_regression(x_train, y_train, xv)).ravel()
    if task == "classification":
        return linear_svc_predict(*linear_svc(x_train, y_train), xv)
    raise ValueError(f"unknown task {task}")


def neighbours(x_train, x_val, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """(indices, squared distances), each (n_val, k): the k nearest training
    rows of each val row by exact float64 squared Euclidean distance (the
    sum of the squared differences), equal distances in training-index
    order.

    A float64 matrix product (|v|^2 + |t|^2 - 2 v.t, within ``slack`` of
    the exact distance) picks each row's candidates, every row within
    2 slack of its k-th smallest: they hold the k nearest and every row
    tied with the k-th. Only the candidates' exact distances are summed."""
    xt, xv = _f64(x_train), _f64(x_val)
    k = min(k, len(xt))
    sq_t, sq_v = (xt ** 2).sum(axis=1), (xv ** 2).sum(axis=1)
    approx = sq_v[:, None] + sq_t[None, :] - 2.0 * (xv @ xt.T)
    # the product's rounding, |err| <= (d + 2) eps (|v|^2 + |t|^2) each, 4x over
    slack = 4 * (xt.shape[1] + 2) * np.finfo(np.float64).eps * (sq_v + sq_t.max())
    kth = np.partition(approx, k - 1, axis=1)[:, k - 1]
    idx = np.empty((len(xv), k), dtype=np.int64)
    dist = np.empty((len(xv), k))
    for i in range(len(xv)):
        cand = np.flatnonzero(approx[i] <= kth[i] + 2 * slack[i])
        d = ((xt[cand] - xv[i]) ** 2).sum(axis=1)
        order = np.lexsort((cand, d))[:k]
        idx[i], dist[i] = cand[order], d[order]
    return idx, dist


def knn_vote(y_neigh: np.ndarray) -> np.ndarray:
    """The majority label of each row of (n, k) neighbour labels, a tie to
    the smallest label."""
    classes, inv = np.unique(y_neigh, return_inverse=True)
    inv = inv.reshape(y_neigh.shape)
    counts = np.zeros((len(y_neigh), len(classes)), dtype=np.int64)
    np.add.at(counts, (np.arange(len(y_neigh))[:, None], inv), 1)
    return classes[np.argmax(counts, axis=1)]


def knn_from_neighbours(y_train, idx: np.ndarray, k: int, task: str) -> np.ndarray:
    """The KNN prediction from the first k columns of ``neighbours``' indices."""
    y = np.asarray(y_train).ravel()
    near = y[idx[:, :k]]
    if task == "regression":
        return near.astype(np.float64).mean(axis=1)
    return knn_vote(near)


def knn_probe(
    x_train: np.ndarray,
    y_train: np.ndarray,
    x_val: Optional[np.ndarray] = None,
    k: int = 5,
    task: str = "regression",
) -> np.ndarray:
    """KNeighbors{Regressor,Classifier}(k) with uniform weights; k is
    clamped to the training set's size, as the JAX package does."""
    if task not in ("regression", "classification"):
        raise ValueError(f"unknown task {task}")
    k = min(k, len(x_train))
    idx, _ = neighbours(x_train, x_train if x_val is None else x_val, k)
    return knn_from_neighbours(y_train, idx, k, task)
