"""A sharded on-disk cache for corpora larger than device memory (port of
multimodal_supernovae_tpu/data/streaming.py, numpy only).

The corpus is ingested once into fixed-size shards, each a directory of
``.npy`` files (``shard_{i:05d}/<field>.npy``), with a JSON manifest
(``stream_manifest.json``: the fields, ``rows_per_shard``, the shard sizes
and the row count). The files and the manifest are the JAX package's, byte
for byte, so a cache written by either package serves the other.

``Trainer.fit_sharded`` trains over it one shard at a time: a shuffled shard
order an epoch, each shard's rows shuffled, every shard's plan as long as a
full shard's (``shard_epoch_schedule``, which draws the JAX package's
numbers from the same ``np.random.Generator``). The validation rows are
carved out of the chunk stream at ingest (``ValHoldout``) and kept beside
the shards (``save_val_split``), small enough to stay on the device.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from .batching import ArrayDataset, epoch_indices

MANIFEST = "stream_manifest.json"


def write_sharded_cache(cache_dir: str, chunks: Iterator[Dict[str, np.ndarray]],
                        rows_per_shard: int) -> "ShardedDataset":
    """Cut an iterator of dict-of-array chunks into shards of
    ``rows_per_shard`` rows (the last one holds the rest); a shard may take
    rows from several chunks and a chunk may be split between shards.
    Holds at most a shard and a chunk in host memory. Every chunk must have
    the same fields."""
    os.makedirs(cache_dir, exist_ok=True)
    buf: Dict[str, List[np.ndarray]] = {}
    buffered = 0
    shard_sizes: List[int] = []
    fields: Optional[List[str]] = None

    def flush(n_rows: int) -> None:
        nonlocal buffered
        take: Dict[str, List[np.ndarray]] = {k: [] for k in buf}
        left = n_rows
        while left > 0:
            head = len(buf[fields[0]][0])
            if head <= left:
                for k in buf:
                    take[k].append(buf[k].pop(0))
                left -= head
            else:  # split the front chunk
                for k in buf:
                    take[k].append(buf[k][0][:left])
                    buf[k][0] = buf[k][0][left:]
                left = 0
        path = os.path.join(cache_dir, f"shard_{len(shard_sizes):05d}")
        os.makedirs(path, exist_ok=True)
        for k, v in take.items():
            np.save(os.path.join(path, f"{k}.npy"), np.concatenate(v, axis=0))
        shard_sizes.append(n_rows)
        buffered -= n_rows

    for chunk in chunks:
        if fields is None:
            fields = sorted(chunk)
        if sorted(chunk) != fields:
            raise ValueError(f"chunk fields {sorted(chunk)} != {fields}")
        n = len(next(iter(chunk.values())))
        for k, v in chunk.items():
            if len(v) != n:
                raise ValueError(f"ragged chunk: field {k} has {len(v)} rows != {n}")
            buf.setdefault(k, []).append(np.asarray(v))
        buffered += n
        while buffered >= rows_per_shard:
            flush(rows_per_shard)
    if fields is None:
        raise ValueError("empty chunk iterator")
    if buffered > 0:
        flush(buffered)

    manifest = {"fields": fields, "rows_per_shard": rows_per_shard,
                "shard_sizes": shard_sizes, "n": int(sum(shard_sizes))}
    with open(os.path.join(cache_dir, MANIFEST), "w") as f:
        json.dump(manifest, f)
    return ShardedDataset(cache_dir)


class ShardedDataset:
    """A view of a sharded cache that reads one shard at a time."""

    def __init__(self, cache_dir: str):
        with open(os.path.join(cache_dir, MANIFEST)) as f:
            self.manifest = json.load(f)
        self.cache_dir = cache_dir
        self.fields: List[str] = self.manifest["fields"]
        self.shard_sizes: List[int] = self.manifest["shard_sizes"]

    def __len__(self) -> int:
        return self.manifest["n"]

    @property
    def n_shards(self) -> int:
        return len(self.shard_sizes)

    def shard_file(self, i: int, field: str) -> str:
        """The ``.npy`` file of shard ``i``'s ``field``."""
        return os.path.join(self.cache_dir, f"shard_{i:05d}", f"{field}.npy")

    def load_shard(self, i: int, mmap: bool = True) -> ArrayDataset:
        """Shard ``i``'s arrays, memory-mapped unless ``mmap=False``."""
        return ArrayDataset({k: np.load(self.shard_file(i, k), mmap_mode="r" if mmap else None)
                             for k in self.fields})

    def materialize(self) -> ArrayDataset:
        """Every shard concatenated (small corpora and tests)."""
        shards = [self.load_shard(i, mmap=False) for i in range(self.n_shards)]
        return ArrayDataset({k: np.concatenate([s.arrays[k] for s in shards], axis=0)
                             for k in self.fields})


class ValHoldout:
    """Carves a validation split out of a chunk stream: ``wrap`` sends each
    row to the split with probability ``val_fraction`` (drawn from a
    generator seeded with ``seed``) until the split holds ``cap`` rows, and
    yields the rest for the shard writer. The same seed gives the same
    split."""

    def __init__(self, val_fraction: float, seed: int = 0, cap: int = 50000):
        if not 0.0 < val_fraction < 1.0:
            raise ValueError(f"val_fraction must be in (0, 1): {val_fraction}")
        self.val_fraction = val_fraction
        self.cap = cap
        self._rng = np.random.default_rng(seed)
        self._parts: List[Dict[str, np.ndarray]] = []
        self._n = 0

    def wrap(self, chunks: Iterator[Dict[str, np.ndarray]]):
        for chunk in chunks:
            n = len(next(iter(chunk.values())))
            take = self._rng.random(n) < self.val_fraction
            if self._n >= self.cap:
                take[:] = False
            elif self._n + int(take.sum()) > self.cap:  # the last rows over the cap stay
                over = self._n + int(take.sum()) - self.cap
                on = np.flatnonzero(take)
                take[on[len(on) - over:]] = False
            if take.any():
                self._parts.append({k: np.asarray(v[take]) for k, v in chunk.items()})
                self._n += int(take.sum())
            keep = ~take
            if keep.any():
                yield {k: v[keep] for k, v in chunk.items()}

    def dataset(self) -> ArrayDataset:
        if not self._parts:
            raise ValueError("no validation rows collected: iterate wrap() first")
        return ArrayDataset({k: np.concatenate([p[k] for p in self._parts], axis=0)
                             for k in self._parts[0]})


def save_val_split(cache_dir: str, val_ds: ArrayDataset) -> None:
    """The validation split beside the shards (``val/<field>.npy``), so a
    cache read again gives the same split."""
    path = os.path.join(cache_dir, "val")
    os.makedirs(path, exist_ok=True)
    for k, v in val_ds.arrays.items():
        np.save(os.path.join(path, f"{k}.npy"), np.asarray(v))


def load_val_split(cache_dir: str) -> Optional[ArrayDataset]:
    path = os.path.join(cache_dir, "val")
    if not os.path.isdir(path):
        return None
    return ArrayDataset({f[:-4]: np.load(os.path.join(path, f))
                         for f in sorted(os.listdir(path)) if f.endswith(".npy")})


def shard_epoch_schedule(ds: ShardedDataset, batch_size: int,
                         rng: np.random.Generator) -> List[tuple]:
    """One epoch's ``(shard_index, step_plan)`` list: the shards in a
    shuffled order, each shard's rows shuffled (``epoch_indices``, wrapped),
    and a shard shorter than the first (the tail) wrapped to the first's
    step count, so that every shard runs as many steps."""
    steps_full = -(-ds.shard_sizes[0] // batch_size)
    schedule = []
    for si in rng.permutation(ds.n_shards):
        plan = epoch_indices(ds.shard_sizes[si], batch_size, rng=rng, shuffle=True,
                             pad="wrap")
        if plan.shape[0] < steps_full:
            reps = -(-steps_full // plan.shape[0])
            plan = np.concatenate([plan] * reps, axis=0)[:steps_full]
        schedule.append((int(si), plan))
    return schedule
