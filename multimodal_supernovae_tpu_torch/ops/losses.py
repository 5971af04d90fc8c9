"""Contrastive and supervised losses (port of
multimodal_supernovae_tpu/ops/losses.py).

  * ``clip_loss``: symmetric InfoNCE over the pairwise logit matrix
    ``exp(logit_scale) * (e2 @ e1.T) + logit_bias``, the mean of the row- and
    column-wise ``-log softmax`` diagonals;
  * ``sigmoid_loss``: SigLIP with labels ``2I - 1`` and logits
    ``-(e2 @ e1.T) * exp(logit_scale) + logit_bias``, through
    ``F.logsigmoid`` in float32 where JAX uses ``jax.nn.log_sigmoid``;
  * the multimodal wrappers sum a pair loss over all C(n, 2) modality pairs
    with a broadcast or per-pair scale and bias;
  * ``weighted_cross_entropy`` (torch ``CrossEntropyLoss(weight=w)``
    normalisation) and ``mse_loss``.

The global-batch (sharded) variants take a data mesh
(``parallel/mesh.py:DataMesh``) where the JAX ones take a mesh axis name:
each rank's embeddings are all-gathered, in rank order, before the pair
loss, so the logit matrix spans the global batch and every rank computes
the same global loss.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F


def clip_loss(embs1: torch.Tensor, embs2: torch.Tensor,
              logit_scale: torch.Tensor, logit_bias: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE between two L2-normalised embedding sets;
    ``logit_scale`` is a log and is exponentiated here."""
    logits = embs2 @ embs1.T * torch.exp(logit_scale) + logit_bias
    diag_r = torch.diagonal(F.log_softmax(logits, dim=1))
    diag_c = torch.diagonal(F.log_softmax(logits, dim=0))
    n = min(embs1.shape[0], embs2.shape[0])
    return -(diag_r.sum() / n + diag_c.sum() / n) / 2.0


def sigmoid_loss(embs1: torch.Tensor, embs2: torch.Tensor,
                 logit_scale: torch.Tensor, logit_bias: torch.Tensor) -> torch.Tensor:
    """SigLIP pairwise sigmoid loss: ``-mean log sigmoid(-labels * logits)``."""
    bs = embs2.shape[0]
    labels = 2.0 * torch.eye(bs, dtype=embs2.dtype, device=embs2.device) - 1.0
    logits = -(embs2 @ embs1.T) * torch.exp(logit_scale) + logit_bias
    return -torch.mean(F.logsigmoid(-labels * logits))


def _pairwise(loss_fn, embeddings: Sequence[torch.Tensor],
              logit_scales: torch.Tensor, logit_biases: torch.Tensor) -> torch.Tensor:
    """Sum a pair loss over all C(n, 2) modality pairs. A 0-d scale/bias
    applies to every pair; a 1-d one gives one value per pair in (i, j)
    lexicographic order."""
    n = len(embeddings)
    n_pairs = n * (n - 1) // 2
    scales = torch.atleast_1d(torch.as_tensor(logit_scales)).expand(n_pairs)
    biases = torch.atleast_1d(torch.as_tensor(logit_biases)).expand(n_pairs)
    total = 0.0
    count = 0
    for i in range(n - 1):
        for j in range(i + 1, n):
            total = total + loss_fn(embeddings[i], embeddings[j],
                                    scales[count], biases[count])
            count += 1
    return total


def clip_loss_multimodal(embeddings, logit_scales, logit_biases) -> torch.Tensor:
    return _pairwise(clip_loss, embeddings, logit_scales, logit_biases)


def sigmoid_loss_multimodal(embeddings, logit_scales, logit_biases) -> torch.Tensor:
    return _pairwise(sigmoid_loss, embeddings, logit_scales, logit_biases)


# -- sharded (global-batch) variants --------------------------------------------


def all_gather_embeddings(embeddings: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """Each (B_local, D) embedding array -> (B_global, D), the global batch in
    rank order, so positive pairs stay on the diagonal. Differentiable: the
    backward hands each rank its rows of the all-reduced gradient."""
    return [mesh.all_gather(e) for e in embeddings]


def clip_loss_multimodal_sharded(embeddings, logit_scales, logit_biases, mesh) -> torch.Tensor:
    """Global-batch CLIP loss from each rank's embedding rows."""
    return clip_loss_multimodal(all_gather_embeddings(embeddings, mesh), logit_scales,
                                logit_biases)


def sigmoid_loss_multimodal_sharded(embeddings, logit_scales, logit_biases,
                                    mesh) -> torch.Tensor:
    return sigmoid_loss_multimodal(all_gather_embeddings(embeddings, mesh), logit_scales,
                                   logit_biases)


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           class_weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-sample losses weighted by the true-class weight and normalised by
    the SUM of the applied weights (not the sample count)."""
    logp = F.log_softmax(logits, dim=-1)
    labels = labels.long()
    nll = -torch.gather(logp, 1, labels[:, None])[:, 0]
    if class_weights is None:
        return nll.mean()
    w = class_weights[labels]
    return (nll * w).sum() / w.sum()


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)
