"""Profiling and step-time observability (port of
multimodal_supernovae_tpu/utils/profiling.py).

  * ``profiler_trace(logdir)``: ``torch.profiler`` over the CPU and, where
    there is one, the card, written as a Chrome trace into ``logdir``
    (``trace-rank<r>-<pid>.json``, one a process, so the ranks of a
    data-parallel run do not overwrite each other); the counterpart of the
    JAX ``xprof_trace``. It records every operator and kernel of what it
    wraps, so it is meant for short runs (``--epochs 1 --max-runs 1``).
  * ``fetch_barrier(tree)``: waits for the device of the tree's last tensor
    (``torch.cuda.synchronize``); nothing on the CPU.
  * ``Throughput``: a wall-clock meter with the JAX one's warmup discard
    and ``summary`` keys.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch


def _trace_name() -> str:
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    return f"trace-rank{rank}-{os.getpid()}.json"


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """Trace what the block runs; the Chrome trace is written into
    ``logdir`` when the block ends, also when it raises. Yields the
    ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, _trace_name()))


def _leaves(tree) -> List[torch.Tensor]:
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return []


def fetch_barrier(tree) -> None:
    """Wait until the device that holds the tree's last tensor has run
    everything queued on it; a CPU tensor (or no tensor) needs no wait."""
    leaves = _leaves(tree)
    if leaves and leaves[-1].is_cuda:
        torch.cuda.synchronize(leaves[-1].device)


class Throughput:
    """Wall-clock throughput meter with warmup discard and device sync."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.samples: List[float] = []
        self._count = 0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, sync_on=None) -> float:
        if sync_on is not None:
            fetch_barrier(sync_on)
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.samples.append(dt)
        return dt

    def summary(self, items_per_call: int = 1) -> Dict[str, float]:
        if not self.samples:
            return {}
        mean = sum(self.samples) / len(self.samples)
        return {
            "mean_s": mean,
            "min_s": min(self.samples),
            "items_per_s": items_per_call / mean,
            "calls": len(self.samples),
        }
