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

The JAX module's vectorised ``pack_ragged_rows`` and ``zero_time_origin_rows``
serve its HDF5 simulation reader, which is not ported (ROADMAP.md queue 1,
item 17).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

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
