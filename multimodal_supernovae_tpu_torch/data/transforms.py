"""Explicitly seeded preprocessing of the host data layer, and the class
lists and weights of the classification head (port of
multimodal_supernovae_tpu/data/transforms.py; the reference's per-sample
preprocessing in src/dataloader.py, as stateless numpy functions so the
whole dataset is materialised once into fixed-shape arrays).

Semantics kept from the reference:
  * pad-or-subsample to ``n_max`` observations with a boolean validity mask
    (src/dataloader.py:419-441): subsampling is a uniform choice without
    replacement, drawn from an explicit ``numpy.random.Generator``;
  * per-band time zeroing: valid times are shifted so each band starts at 0
    (src/dataloader.py:539-541);
  * band-blocked sequence layout: per-band arrays are concatenated along the
    sequence axis, band 0 first (src/dataloader.py:543-546);
  * SN-type merging and sorted factorization (src/dataloader.py:388-405).

``pack_ragged_rows`` and ``zero_time_origin_rows`` are the vectorised
versions over whole (N, L) matrices that the simulation ingest uses
(``data/simulation.py``); they draw the same numbers as the JAX module's, in
the same order, so both packages ingest a corpus bitwise alike.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Factorized class orders produced by the reference's
# ``pd.factorize(..., sort=True)`` on the merged type strings
# (src/dataloader.py:401-405).
FIVE_WAY_CLASSES = ["SLSN-I", "SN II", "SN IIn", "SN Ia", "SN Ibc"]
THREE_WAY_CLASSES = ["SN II", "SN Ia", "SN Ibc"]

# Type-string merges applied before factorization (src/dataloader.py:389-392).
TYPE_MERGES = {
    "SN Ib": "SN Ibc",
    "SN Ic": "SN Ibc",
    "SN Ib/c": "SN Ibc",
    "SN IIP": "SN II",
}

# Per-class CE weights matching the (rough) ZTF BTS class breakdown
# (src/models_multimodal.py:337-345).
CLASS_WEIGHTS = {
    5: np.array([0.3, 0.08, 1.0, 0.01, 0.2], dtype=np.float32),
    3: np.array([0.33, 0.06, 1.0], dtype=np.float32),
}


def pad_or_subsample(
    n_obs: int, n_max: int, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    """Indices to keep + validity mask for one ragged sequence.

    If the sequence is longer than ``n_max``, sample ``n_max`` observations
    uniformly without replacement; otherwise keep everything and mark the
    zero-padded tail invalid. Mirrors ``make_padding_mask``
    (src/dataloader.py:419-441) with an explicit generator.
    """
    if n_obs > n_max:
        indices = rng.choice(n_obs, n_max, replace=False)
        mask = np.ones(n_max, dtype=bool)
    else:
        indices = np.arange(n_obs)
        mask = np.zeros(n_max, dtype=bool)
        mask[:n_obs] = True
    return indices, mask


def pad_to(values: np.ndarray, n_max: int) -> np.ndarray:
    """Zero-pad a 1-D array up to length ``n_max``."""
    out = np.zeros(n_max, dtype=np.float64)
    out[: len(values)] = values
    return out


def zero_time_origin_per_band(time: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Shift valid times so the earliest valid observation sits at t=0.

    Applied per band BEFORE band concatenation (src/dataloader.py:539-541).
    Padded entries stay exactly 0.
    """
    time = np.array(time, copy=True)
    if mask.any():
        time[mask] = time[mask] - time[mask].min()
    return time


def band_block_concat(per_band: Sequence[np.ndarray]) -> np.ndarray:
    """Concatenate per-band fixed-length arrays along the sequence axis.

    Band 0 occupies positions [0, n_max), band 1 [n_max, 2*n_max), etc. — the
    "band-blocked" layout consumed by the sequence encoder's band embedding
    (src/transformer_utils.py:219-231).
    """
    return np.concatenate(list(per_band), axis=0)


def process_ragged_series(
    time: np.ndarray,
    value: np.ndarray,
    err: Optional[np.ndarray],
    n_max: int,
    rng: np.random.Generator,
    zero_time: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Full single-band pipeline: subsample/pad + mask + optional time zeroing.

    Returns (time, value, err, mask), each of length ``n_max``. ``err`` is a
    zero array when not provided (the spectra path zero-fills missing errors,
    src/dataloader.py:659-666).
    """
    indices, mask = pad_or_subsample(len(value), n_max, rng)
    t = pad_to(np.asarray(time, dtype=np.float64)[indices], n_max)
    v = pad_to(np.asarray(value, dtype=np.float64)[indices], n_max)
    if err is not None:
        e = pad_to(np.asarray(err, dtype=np.float64)[indices], n_max)
    else:
        e = np.zeros(n_max, dtype=np.float64)
    if zero_time:
        t = zero_time_origin_per_band(t, mask)
    return t, v, e, mask


def pack_ragged_rows(
    values: Dict[str, np.ndarray],
    valid: np.ndarray,
    n_max: int,
    rng: np.random.Generator,
    sort_by: Optional[str] = None,
) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Vectorized pad-or-subsample over a whole (N, L) matrix of ragged rows.

    For each row: if it has more than ``n_max`` valid entries, keep a uniform
    random subset of ``n_max`` (without replacement); pack the kept entries
    into the first positions; zero-pad the rest. Optionally order kept
    entries by the ``sort_by`` column (e.g. time).

    This is the batch equivalent of the reference's per-sample
    ``make_padding_mask`` + ``np.pad`` pipeline (dataloader.py:419-441,
    :521-546) — one argsort instead of a Python loop per sample. Note the
    packed order differs from the reference when subsampling (which emits
    indices in ``np.random.choice`` order); the sequence encoders are
    permutation-equivariant within a band block (time-value positional
    encoding, no index PE), so this is output-equivalent.

    Args:
      values: {name: (N, L) float array} — all packed with the same layout.
      valid:  (N, L) bool.
      n_max:  output row length.
      sort_by: values key whose ascending order defines the packed order of
        kept entries (None = random order from the subsampling draw).

    Returns ({name: (N, n_max)}, mask (N, n_max) bool).
    """
    n, width = valid.shape
    if n_max > width:  # rows shorter than the target: zero-pad columns
        pad = n_max - width
        valid = np.pad(valid, ((0, 0), (0, pad)))
        values = {k: np.pad(v, ((0, 0), (0, pad))) for k, v in values.items()}
    # random rank among valid entries -> uniform subset when oversize
    r = rng.random(valid.shape)
    rank_order = np.argsort(np.where(valid, r, np.inf), axis=1)
    rank = np.argsort(rank_order, axis=1)
    selected = valid & (rank < n_max)
    if sort_by is not None:
        key = np.where(selected, values[sort_by], np.inf)
    else:
        key = np.where(selected, r, np.inf)
    order = np.argsort(key, axis=1)[:, :n_max]
    counts = np.minimum(selected.sum(axis=1), n_max)
    mask = np.arange(n_max)[None, :] < counts[:, None]
    packed = {
        name: np.where(mask, np.take_along_axis(v, order, axis=1), 0.0)
        for name, v in values.items()
    }
    return packed, mask


def zero_time_origin_rows(time: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Vectorized per-row time zeroing over packed (N, T) arrays."""
    has = mask.any(axis=1)
    tmin = np.where(mask, time, np.inf).min(axis=1)
    tmin = np.where(has, tmin, 0.0)
    return np.where(mask, time - tmin[:, None], 0.0)


def merge_sn_types(types: Sequence[str]) -> List[str]:
    """Apply the Ib/Ic/Ib-c -> Ibc and IIP -> II merges."""
    return [TYPE_MERGES.get(t, t) for t in types]


def factorize_classes(
    types: Sequence[str], n_classes: int = 5
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Map SN type strings to factorized integer labels.

    Returns (labels, keep_mask, class_names): ``labels`` only covers entries
    whose merged type is in the ``n_classes``-way class list; ``keep_mask``
    marks which input rows survived. Matches ``load_classes``
    (src/dataloader.py:368-416): merge, filter to the class set, factorize
    with sorted order.
    """
    class_names = {5: FIVE_WAY_CLASSES, 3: THREE_WAY_CLASSES}.get(n_classes)
    merged = merge_sn_types(types)
    if class_names is None:
        # No filtering: factorize whatever is present, sorted.
        class_names = sorted(set(merged))
        keep = np.ones(len(merged), dtype=bool)
    else:
        keep = np.array([t in class_names for t in merged], dtype=bool)
    lut = {name: i for i, name in enumerate(class_names)}
    labels = np.array([lut[t] for t, k in zip(merged, keep) if k], dtype=np.int32)
    return labels, keep, list(class_names)


def filter_to_available(
    filenames_avail: Sequence[str],
    filenames: Sequence[str],
    arrays: Optional[List[np.ndarray]] = None,
) -> Tuple[np.ndarray, np.ndarray, Optional[List[np.ndarray]]]:
    """Keep only entries of ``filenames`` present in ``filenames_avail``.

    Row-filters each array in ``arrays`` with the same mask. Equivalent to the
    reference's ``filter_files`` (src/utils.py:28-50) used to intersect
    modalities in ``load_data``.
    """
    keep = np.isin(np.asarray(filenames), np.asarray(filenames_avail))
    filtered_names = np.asarray(filenames)[keep]
    if arrays is not None:
        arrays = [a[keep] for a in arrays]
    return keep, filtered_names, arrays


def remap_to_three_way(labels: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Filter 5-way labels down to the 3-way set and remap to [0, 3).

    The reference evaluates both 5-way and 3-way from the same 5-way labels by
    keeping classes [1, 3, 4] (SN II, SN Ia, SN Ibc in the sorted 5-way order)
    and remapping in that order (evaluate_models.py:305-313,
    src/utils.py:1310-1350).
    """
    target = np.array([1, 3, 4])
    keep = np.isin(labels, target)
    remap = -np.ones(int(labels.max(initial=4)) + 1, dtype=np.int32)
    for new, old in enumerate(target):
        remap[old] = new
    return remap[labels[keep]], keep
