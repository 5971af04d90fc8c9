"""The port's folds and random split against scikit-learn's, index for index
(they name a run directory's split manifests), and against the JAX package's
``split_for_run``."""

import warnings

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from sklearn.model_selection import StratifiedKFold, train_test_split

from multimodal_supernovae_tpu.data.folds import split_for_run as jax_split_for_run
from multimodal_supernovae_tpu_torch.data.folds import (
    random_split,
    split_for_run,
    stratified_kfolds,
)


def _sklearn_folds(labels, k):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return list(StratifiedKFold(n_splits=k).split(labels, labels))


def _port_folds(labels, k):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return stratified_kfolds(labels, k)


@settings(max_examples=150, deadline=None)
@given(weights=st.lists(st.integers(1, 40), min_size=1, max_size=6),
       k=st.integers(2, 6), seed=st.integers(0, 2**31 - 1))
def test_stratified_kfolds_equals_sklearn(weights, k, seed):
    """Imbalanced label sets drawn from class weights, shuffled, labels not
    in first-appearance order (sklearn numbers classes by appearance)."""
    rng = np.random.default_rng(seed)
    labels = rng.permutation(np.repeat(rng.permutation(9)[:len(weights)], weights))
    if k > len(labels) or np.all(k > np.bincount(labels)[np.bincount(labels) > 0]):
        with pytest.raises(ValueError):
            _port_folds(labels, k)
        with pytest.raises(ValueError):
            _sklearn_folds(labels, k)
        return
    want = _sklearn_folds(labels, k)
    got = _port_folds(labels, k)
    assert len(got) == len(want) == k
    for g, (tr, te) in zip(got, want):
        np.testing.assert_array_equal(g["train_indices"], tr)
        np.testing.assert_array_equal(g["test_indices"], te)
        assert g["test_indices"].dtype == te.dtype


def test_stratified_kfolds_warns_as_sklearn_on_a_small_class():
    labels = np.array([0] * 10 + [1] * 2, dtype=np.int32)
    with pytest.warns(UserWarning, match="least populated class"):
        stratified_kfolds(labels, 5)


@settings(max_examples=150, deadline=None)
@given(n=st.integers(2, 500), frac=st.floats(0.01, 0.9), seed=st.integers(0, 2**32 - 1))
def test_random_split_equals_train_test_split(n, frac, seed):
    try:
        want = train_test_split(np.arange(n), test_size=frac, random_state=seed)
    except ValueError:
        with pytest.raises(ValueError):
            random_split(n, frac, seed)
        return
    got = random_split(n, frac, seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("foldnumber", [None, 0, 3])
def test_split_for_run_equals_jax(foldnumber):
    rng = np.random.default_rng(1)
    labels = rng.choice(5, size=97, p=[0.05, 0.15, 0.05, 0.6, 0.15]).astype(np.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        folds = stratified_kfolds(labels, 5)
        from multimodal_supernovae_tpu.data.folds import stratified_kfolds as jax_kfolds

        jfolds = jax_kfolds(labels, 5)
    got = split_for_run(len(labels), 0.2, 4, folds=folds, foldnumber=foldnumber)
    want = jax_split_for_run(len(labels), 0.2, 4, folds=jfolds, foldnumber=foldnumber)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
