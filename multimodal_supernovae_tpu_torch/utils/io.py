"""Small host-side IO helpers (port of multimodal_supernovae_tpu/utils/io.py;
the reference's src/utils.py:28-77, :145-161)."""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np


def get_valid_dir(data_dirs: Sequence[str]) -> str:
    """First existing directory from a candidate list."""
    for d in data_dirs:
        if os.path.isdir(d):
            return d
    raise ValueError(f"no valid data directory among {list(data_dirs)}")


def filter_files(
    filenames_avail: Sequence[str],
    filenames_to_filter: Sequence[str],
    data_to_filter: Optional[List[np.ndarray]] = None,
):
    """Keep entries of ``filenames_to_filter`` present in
    ``filenames_avail``; row-filter ``data_to_filter`` alongside."""
    inds = np.isin(filenames_to_filter, filenames_avail)
    if data_to_filter:
        data_to_filter = [d[inds] for d in data_to_filter]
    return inds, np.asarray(filenames_to_filter)[inds], data_to_filter


def find_indices_in_arrays(st1: Sequence[str], st2: Sequence[str]):
    """Positions of st1's elements in st2 (and which st1 entries matched)."""
    lut = {}
    for i, item in enumerate(st2):
        lut.setdefault(item, i)
    in_st2, in_st1 = [], []
    for idx, item in enumerate(st1):
        if item in lut:
            in_st2.append(lut[item])
            in_st1.append(idx)
    return in_st2, in_st1


def is_subset(subset: Sequence[str], superset: Sequence[str]) -> bool:
    return set(subset).issubset(set(superset))
