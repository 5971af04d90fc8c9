"""Evaluation metric tables and k-fold merging (port of
multimodal_supernovae_tpu/evaluation/metrics.py, in numpy: no scikit-learn,
no pandas).

Regression rows carry L1/L2/R2/OLF, classification rows micro and macro
F1, precision, recall and accuracy as scikit-learn defines them: the label
set is the union of the true and predicted labels, a zero division gives
0.0, ``mic-acc`` is the accuracy and ``mac-acc`` the balanced accuracy (the
mean recall over the classes present in the truth). Rows are dicts keyed
by (Model, Combination, id), with the JAX package's keys in its order.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..data.transforms import remap_to_three_way

RESULT_KEYS = ("Model", "Combination", "id", "y_pred", "y_true", "y_true_label")


def _divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """num / den with 0.0 where den is 0 (scikit-learn's zero_division)."""
    num, den = np.asarray(num, np.float64), np.asarray(den, np.float64)
    return np.divide(num, den, out=np.zeros_like(num), where=den != 0)


def classification_scores(y_true: np.ndarray, y_pred: np.ndarray) -> Dict[str, float]:
    """The eight classification scores of ``calculate_metrics``."""
    labels = np.union1d(y_true, y_pred)
    t = y_true[:, None] == labels[None, :]
    p = y_pred[:, None] == labels[None, :]
    tp = (t & p).sum(axis=0)
    true_sum, pred_sum = t.sum(axis=0), p.sum(axis=0)
    micro_p = _divide(tp.sum(), pred_sum.sum())
    micro_r = _divide(tp.sum(), true_sum.sum())
    present = true_sum > 0
    return {
        "mic-f1": float(_divide(2 * tp.sum(), true_sum.sum() + pred_sum.sum())),
        "mic-p": float(micro_p),
        "mic-r": float(micro_r),
        "mic-acc": float(np.mean(y_true == y_pred)),
        "mac-f1": float(np.mean(_divide(2 * tp, true_sum + pred_sum))),
        "mac-p": float(np.mean(_divide(tp, pred_sum))),
        "mac-r": float(np.mean(_divide(tp, true_sum))),
        "mac-acc": float(np.mean(tp[present] / true_sum[present])),
    }


def calculate_metrics(
    y_true: Optional[np.ndarray],
    y_true_label: Optional[np.ndarray],
    y_pred: np.ndarray,
    label: str,
    combination: str,
    id: int,
    task: str = "regression",
):
    """Returns (metrics row, results row). OLF counts |dz|/(1+z) > 0.15."""
    if task == "regression":
        y_true = np.asarray(y_true, dtype=np.float64)
        y_pred = np.asarray(y_pred, dtype=np.float64)
        delta = y_true - y_pred
        ss_tot = np.sum((y_true - y_true.mean()) ** 2)
        metrics = {
            "Model": label,
            "Combination": combination,
            "L1": float(np.mean(np.abs(delta))),
            "L2": float(np.sqrt(np.mean(delta**2))),
            "R2": float(1.0 - np.sum(delta**2) / ss_tot),
            "OLF": float(np.mean(np.abs(delta) / (1.0 + y_true) > 0.15)),
            "id": id,
        }
    elif task == "classification":
        scores = classification_scores(np.asarray(y_true_label), np.asarray(y_pred))
        metrics = {"Model": label, "Combination": combination, **scores, "id": id}
    else:
        raise ValueError("task must be 'regression' or 'classification'")

    results = {
        "Model": label,
        "Combination": combination,
        "id": id,
        "y_pred": np.asarray(y_pred),
        "y_true": None if y_true is None else np.asarray(y_true),
        "y_true_label": None if y_true_label is None else np.asarray(y_true_label),
    }
    return metrics, results


def merge_kfold_results(results: List[Dict[str, Any]]) -> Dict[str, List[Any]]:
    """Predictions and labels concatenated across folds, one entry per
    (Model, Combination, id) group in sorted order, as the JAX package's
    DataFrame columns: a dict of the six ``RESULT_KEYS`` to lists. ``None``
    entries are dropped before the concatenation; a group with none left
    gets None."""
    groups: Dict[tuple, List[Dict[str, Any]]] = {}
    for row in results:
        groups.setdefault((row["Model"], row["Combination"], row["id"]), []).append(row)
    merged: Dict[str, List[Any]] = {k: [] for k in RESULT_KEYS}
    for key in sorted(groups):
        for name, value in zip(RESULT_KEYS[:3], key):
            merged[name].append(value)
        for k in RESULT_KEYS[3:]:
            vals = [r[k] for r in groups[key] if r.get(k) is not None]
            merged[k].append(np.concatenate(vals) if vals else None)
    return merged


def class_dependent_regression_metrics(
    results: List[Dict[str, Any]], class_names: Dict[int, Any]
) -> List[Dict[str, Any]]:
    """Per-class regression metric rows (for radar plots) — the reference's
    ``get_class_dependent_predictions`` (src/utils.py:1172-1221)."""
    rows = []
    for row in results:
        y_pred = np.asarray(row["y_pred"])
        y_true = np.asarray(row["y_true"])
        labels = np.asarray(row["y_true_label"])
        for label_val, name in class_names.items():
            sel = labels == label_val
            if not sel.any():
                continue
            m, _ = calculate_metrics(
                y_true[sel], labels[sel], y_pred[sel],
                row["Model"], row["Combination"], row["id"], task="regression",
            )
            m["class"] = name[0] if isinstance(name, (tuple, list)) else name
            rows.append(m)
    return rows


def filter_classes_3way(
    embeddings: List[np.ndarray], labels: np.ndarray, extras: Optional[Dict] = None
):
    """Keep 5-way classes {1: SN II, 3: SN Ia, 4: SN Ibc}, remap to 0..2 —
    the reference's 3-way evaluation path (evaluate_models.py:305-313,
    utils.py:1310-1350)."""
    new_labels, keep = remap_to_three_way(np.asarray(labels))
    new_embs = [e[keep] for e in embeddings]
    new_extras = (
        {k: v[keep] for k, v in extras.items()} if extras is not None else None
    )
    return new_embs, new_labels, new_extras
