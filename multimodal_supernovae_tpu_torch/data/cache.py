"""Array cache: materialise an ingested dataset once, memory-map it after
(port of multimodal_supernovae_tpu/data/cache.py, the same on-disk layout).

An ingest output (an ArrayDataset) is written to one directory of raw
``.npy`` files, ``filenames.json`` and a JSON ``manifest.json``; later runs
``mmap`` the arrays. The directory's name hashes the ingest configuration,
so a stale cache is never read, and a cache written by either package
loads in the other under the same key.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Optional

import numpy as np

from .batching import ArrayDataset


def cache_key(**ingest_config) -> str:
    blob = json.dumps(ingest_config, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def save_dataset(cache_dir: str, ds: ArrayDataset, key: str) -> str:
    path = os.path.join(cache_dir, key)
    os.makedirs(path, exist_ok=True)
    manifest: Dict[str, Any] = {"fields": sorted(ds.arrays), "n": len(ds)}
    for name, arr in ds.arrays.items():
        np.save(os.path.join(path, f"{name}.npy"), arr)
    if ds.filenames is not None:
        with open(os.path.join(path, "filenames.json"), "w") as f:
            json.dump(ds.filenames, f)
        manifest["has_filenames"] = True
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return path


def load_dataset(cache_dir: str, key: str, mmap: bool = True) -> Optional[ArrayDataset]:
    path = os.path.join(cache_dir, key)
    manifest_path = os.path.join(path, "manifest.json")
    if not os.path.exists(manifest_path):
        return None
    with open(manifest_path) as f:
        manifest = json.load(f)
    arrays = {
        name: np.load(
            os.path.join(path, f"{name}.npy"),
            mmap_mode="r" if mmap else None,
        )
        for name in manifest["fields"]
    }
    filenames = None
    if manifest.get("has_filenames"):
        with open(os.path.join(path, "filenames.json")) as f:
            filenames = json.load(f)
    return ArrayDataset(arrays, filenames)


def load_or_ingest(cache_dir: str, ingest_fn, **ingest_config):
    """Cache-through ingest: (the cached ArrayDataset, True) when the config
    hash matches, else ``ingest_fn()``'s dataset, cached, and False."""
    key = cache_key(**ingest_config)
    cached = load_dataset(cache_dir, key)
    if cached is not None:
        return cached, True
    ds = ingest_fn()
    save_dataset(cache_dir, ds, key)
    return ds, False
