"""The port's losses and metrics against the JAX package's, on CPU, from the
same numpy inputs. Tolerances: float32 2e-5 for values (the means of
equal counts may round apart in the last bit), 5e-4 for gradients; the
counts of correct retrievals must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_supernovae_tpu.data.batching import ArrayDataset as JaxArrayDataset
from multimodal_supernovae_tpu.ops import losses as JL
from multimodal_supernovae_tpu.ops import metrics as JM
from multimodal_supernovae_tpu.training.trainer import (
    compute_task_metrics as jax_compute_task_metrics,
)
from multimodal_supernovae_tpu_torch.data import ArrayDataset
from multimodal_supernovae_tpu_torch.ops import losses as L
from multimodal_supernovae_tpu_torch.ops import metrics as M
from multimodal_supernovae_tpu_torch.training import compute_task_metrics

TOL = 2e-5
GRAD_TOL = 5e-4


def _embs(seed, n=12, d=8, count=2, normalize=True):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        e = rng.normal(size=(n, d)).astype(np.float32)
        if normalize:
            e /= np.linalg.norm(e, axis=-1, keepdims=True)
        out.append(e)
    return out


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", ["clip_loss", "sigmoid_loss"])
@pytest.mark.parametrize("scale,bias", [(np.log(19.55), -10.0), (0.3, 1.5)])
def test_pair_loss_and_grads_match_jax(name, scale, bias):
    e1, e2 = _embs(1)
    jfn, tfn = getattr(JL, name), getattr(L, name)
    want, jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2, 3))(
        jnp.asarray(e1), jnp.asarray(e2), jnp.float32(scale), jnp.float32(bias))
    args = [torch.tensor(a, requires_grad=True) for a in
            (e1, e2, np.float32(scale), np.float32(bias))]
    got = tfn(*args)
    got.backward()
    _close(got.item(), want)
    for a, g in zip(args, jgrads):
        _close(a.grad.numpy(), g, GRAD_TOL)


@pytest.mark.parametrize("name", ["clip_loss_multimodal", "sigmoid_loss_multimodal"])
@pytest.mark.parametrize("per_pair", [False, True])
def test_multimodal_losses_match_jax(name, per_pair):
    embs = _embs(2, count=3)
    if per_pair:  # one scale and bias per pair, (0,1), (0,2), (1,2)
        scale = np.array([2.0, 2.5, 3.0], np.float32)
        bias = np.array([-1.0, 0.5, 0.0], np.float32)
    else:
        scale, bias = np.float32(2.97), np.float32(-10.0)
    want = getattr(JL, name)([jnp.asarray(e) for e in embs], jnp.asarray(scale),
                             jnp.asarray(bias))
    got = getattr(L, name)([torch.from_numpy(e) for e in embs],
                           torch.as_tensor(scale), torch.as_tensor(bias))
    _close(got.item(), want)


@pytest.mark.parametrize("weighted", [False, True])
def test_weighted_cross_entropy_matches_jax(weighted):
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(10, 5)).astype(np.float32)
    labels = rng.integers(0, 5, size=10).astype(np.int32)
    w = rng.random(5).astype(np.float32) + 0.5 if weighted else None
    want = JL.weighted_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                     None if w is None else jnp.asarray(w))
    got = L.weighted_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                   None if w is None else torch.from_numpy(w))
    _close(got.item(), want)


def test_mse_loss_matches_jax():
    a, b = _embs(4, normalize=False)
    _close(L.mse_loss(torch.from_numpy(a), torch.from_numpy(b)).item(),
           JL.mse_loss(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("n,n_thresholds", [(12, 100), (37, 100), (50, 17)])
def test_retrieval_metrics_match_jax(n, n_thresholds):
    e1, e2 = _embs(5 + n, n=n, normalize=False)
    e2 = e2 + 1.5 * e1  # related pairs: ranks spread over the sweep
    j1, j2, t1, t2 = jnp.asarray(e1), jnp.asarray(e2), torch.from_numpy(e1), torch.from_numpy(e2)
    jth, jfrac = JM.retrieval_rank_fractions(j1, j2, n_thresholds)
    tth, tfrac = M.retrieval_rank_fractions(t1, t2, n_thresholds)
    _close(tth.numpy(), jth)
    # the same count of correct retrievals at every threshold
    np.testing.assert_array_equal(np.rint(tfrac.numpy() * n), np.rint(np.asarray(jfrac) * n))
    _close(tfrac.numpy(), jfrac)
    _close(M.retrieval_auc(t1, t2, n_thresholds).item(), JM.retrieval_auc(j1, j2, n_thresholds))
    for k in (1, 3):
        _close(M.retrieval_at_k(t1, t2, k).item(), JM.retrieval_at_k(j1, j2, k))


def test_classification_and_regression_metrics_match_jax():
    rng = np.random.default_rng(6)
    y_true = rng.integers(0, 4, size=40).astype(np.int32)  # class 4 absent
    y_pred = np.where(rng.random(40) < 0.6, y_true, rng.integers(0, 5, size=40)).astype(np.int32)
    for fn in ("macro_f1", "micro_f1"):
        _close(getattr(M, fn)(torch.from_numpy(y_true), torch.from_numpy(y_pred), 5).item(),
               getattr(JM, fn)(jnp.asarray(y_true), jnp.asarray(y_pred), 5))
    z = (rng.random(40) * 0.3).astype(np.float32)
    zp = (z + rng.normal(size=40) * 0.05).astype(np.float32)
    _close(M.r2_score(torch.from_numpy(z), torch.from_numpy(zp)).item(),
           JM.r2_score(jnp.asarray(z), jnp.asarray(zp)))
    got = M.regression_metrics(torch.from_numpy(z), torch.from_numpy(zp))
    want = JM.regression_metrics(jnp.asarray(z), jnp.asarray(zp))
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key].item(), want[key])


@pytest.mark.parametrize("steps,b,n_val", [(3, 8, 21), (2, 8, 16), (4, 5, 17), (1, 12, 9)])
def test_compute_task_metrics_matches_jax(steps, b, n_val):
    """Contrastive AUC_val from eval embeddings stacked over (steps, B, d)
    with a repeated tail, trimmed to n_val, as the trainer's eval loop hands
    them over."""
    rng = np.random.default_rng(7 + n_val)
    arrays = {"redshift": (rng.random(n_val) * 0.3).astype(np.float32)}
    base = rng.normal(size=(steps, b, 6)).astype(np.float32)
    aux = {"embeddings": [base + 0.8 * rng.normal(size=base.shape).astype(np.float32)
                          for _ in range(2)]}
    want = jax_compute_task_metrics("contrastive",
                                    jax.tree_util.tree_map(jnp.asarray, aux),
                                    JaxArrayDataset(arrays), n_val)
    got = compute_task_metrics("contrastive", jax.tree_util.tree_map(torch.from_numpy, aux),
                               None, n_val)
    assert sorted(got) == sorted(want) == ["AUC_val"]
    _close(got["AUC_val"], want["AUC_val"])
