"""Training and evaluation metrics (port of
multimodal_supernovae_tpu/ops/metrics.py): retrieval rank fractions and
their trapezoid AUC, retrieval@k, r2, macro/micro F1 and the redshift
regression metrics, as tensor functions that run where their inputs lie.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _match_ranks(embs1: torch.Tensor, embs2: torch.Tensor) -> torch.Tensor:
    """For each item i of modality 2, the number of modality-1 embeddings
    with a STRICTLY larger cosine similarity than its true match (ties
    resolve optimistically)."""
    sims = _normalize(embs2) @ _normalize(embs1).T  # (N2, N1)
    diag = torch.diagonal(sims)
    return (sims > diag[:, None]).sum(dim=1)


def retrieval_rank_fractions(embs1: torch.Tensor, embs2: torch.Tensor,
                             n_thresholds: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fraction of correct retrievals under a top-fraction threshold sweep:
    a retrieval is correct at threshold theta when the true match ranks
    within the top ``int(theta * N1)``; theta sweeps
    ``linspace(0, 1, n_thresholds)``. Returns (thresholds, fraction)."""
    ranks = _match_ranks(embs1, embs2)
    thresholds = torch.linspace(0.0, 1.0, n_thresholds, device=ranks.device)
    cutoffs = torch.floor(thresholds * embs1.shape[0]).to(torch.int32)
    correct = ranks[:, None] < cutoffs[None, :]
    return thresholds, correct.float().mean(dim=0)


def retrieval_auc(embs1: torch.Tensor, embs2: torch.Tensor,
                  n_thresholds: int = 100) -> torch.Tensor:
    """Trapezoid area under the threshold/fraction-correct curve. 1.0 is
    perfect, 0.5 random."""
    thresholds, frac = retrieval_rank_fractions(embs1, embs2, n_thresholds)
    return torch.trapezoid(frac, thresholds)


def retrieval_at_k(embs1: torch.Tensor, embs2: torch.Tensor, k: int = 1) -> torch.Tensor:
    """Top-k retrieval accuracy."""
    return (_match_ranks(embs1, embs2) < k).float().mean()


def r2_score(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Coefficient of determination."""
    ss_res = torch.sum((y_true - y_pred) ** 2)
    ss_tot = torch.sum((y_true - torch.mean(y_true)) ** 2)
    return 1.0 - ss_res / ss_tot


def _confusion_counts(y_true: torch.Tensor, y_pred: torch.Tensor, n_classes: int):
    """Per-class (tp, fp, fn) from integer label tensors."""
    classes = torch.arange(n_classes, device=y_true.device)
    t = y_true[None, :] == classes[:, None]  # (C, N)
    p = y_pred[None, :] == classes[:, None]
    tp = (t & p).sum(dim=1).float()
    fp = (~t & p).sum(dim=1).float()
    fn = (t & ~p).sum(dim=1).float()
    return tp, fp, fn


def macro_f1(y_true: torch.Tensor, y_pred: torch.Tensor, n_classes: int) -> torch.Tensor:
    """Macro-averaged F1; absent classes (tp = fp = fn = 0) count as 0."""
    tp, fp, fn = _confusion_counts(y_true, y_pred, n_classes)
    denom = 2 * tp + fp + fn
    f1 = torch.where(denom > 0, 2 * tp / torch.clamp(denom, min=1.0),
                     torch.zeros_like(denom))
    return f1.mean()


def micro_f1(y_true: torch.Tensor, y_pred: torch.Tensor, n_classes: int) -> torch.Tensor:
    tp, fp, fn = _confusion_counts(y_true, y_pred, n_classes)
    return 2 * tp.sum() / torch.clamp(2 * tp.sum() + fp.sum() + fn.sum(), min=1.0)


def regression_metrics(y_true: torch.Tensor, y_pred: torch.Tensor) -> Dict[str, torch.Tensor]:
    """L1, L2 (RMSE), R2 and the outlier fraction ``|dz| / (1 + z) > 0.15``."""
    delta = y_true - y_pred
    return {
        "L1": torch.mean(torch.abs(delta)),
        "L2": torch.sqrt(torch.mean(delta ** 2)),
        "R2": r2_score(y_true, y_pred),
        "OLF": torch.mean((torch.abs(delta) / (1.0 + y_true) > 0.15).float()),
    }
