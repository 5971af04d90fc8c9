"""The shards of a sharded cache on the device, one after another, with the
next shard's upload under the current shard's steps (``Trainer.fit_sharded``;
data/streaming.py holds the cache).

On the card the feed keeps two pinned host buffers, allocated once at the
first shard's size (the largest). A shard's ``.npy`` files are read straight
into a free buffer (``readinto`` after the header: one read a file, no page
faults of a memory map, and the GIL released, so a staging thread does not
hold back the thread that launches the kernels) and uploaded with
``non_blocking`` copies on a side CUDA stream; an event recorded after the
copies makes the current stream's first use of the shard wait for them, and
``record_stream`` tells the caching allocator that the current stream uses
the shard's tensors, so their memory is not handed out again before its
steps have run. With
``prefetch`` a worker thread stages and uploads shard i + 1 while the
caller runs shard i's steps, so two shards are on the device at the peak;
without it each shard is uploaded when its turn comes. Before a buffer is
refilled the feed waits for its last copy to finish.

The JAX package's guard is kept: when two shards would take more than 75%
of the card's memory (``torch.cuda.mem_get_info``), prefetch is turned off
and the feed says so. On the CPU a shard is read when its turn comes.

Each upload's device time (CUDA events on the side stream), each shard's
host staging time and the host time the caller waited for each shard are
kept (``stats``).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

PREFETCH_MEMORY_SHARE = 0.75


def _read_npy_into(path: str, out: torch.Tensor) -> torch.Tensor:
    """The array of the ``.npy`` file ``path`` read into ``out`` (a
    contiguous CPU tensor of its shape and dtype); returns ``out``."""
    with open(path, "rb") as f:
        major, _ = np.lib.format.read_magic(f)
        read_header = (np.lib.format.read_array_header_1_0 if major == 1
                       else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read_header(f)
        view = out.numpy()
        if fortran or tuple(shape) != view.shape or dtype != view.dtype:
            raise ValueError(f"{path}: {dtype} {shape} does not fit {view.dtype} {view.shape}")
        if f.readinto(memoryview(view).cast("B")) != view.nbytes:
            raise ValueError(f"{path}: short read")
    return out


class ShardFeed:
    def __init__(self, sds, device, prefetch: Optional[bool] = None):
        self.sds = sds
        self.device = torch.device(device)
        first = sds.load_shard(0)
        self.shard_bytes = int(sum(a.nbytes for a in first.arrays.values()))
        self.on_card = self.device.type == "cuda"
        if self.on_card and prefetch is None:
            total = torch.cuda.mem_get_info(self.device)[1]
            prefetch = 2 * self.shard_bytes <= PREFETCH_MEMORY_SHARE * total
            if not prefetch:
                print(f"fit_sharded: shard size {self.shard_bytes / 1e9:.2f} GB: two shards "
                      "would not fit on the card; shard prefetch disabled", flush=True)
        self.prefetch = bool(prefetch) and self.on_card
        self.stage_ms: List[float] = []
        self.wait_ms: List[float] = []
        self._events: List[tuple] = []
        self._pool = None
        if self.on_card:
            self._pinned = [{k: torch.from_numpy(np.empty_like(a)).pin_memory()
                             for k, a in first.arrays.items()} for _ in range(2)]
            self._slot_done = [None, None]
            self._side = torch.cuda.Stream(self.device)
            if self.prefetch:
                self._pool = ThreadPoolExecutor(1, thread_name_prefix="shard-upload")

    def _upload(self, slot: int, si: int):
        """Shard ``si`` through pinned buffer ``slot`` into new device
        tensors on the side stream; returns (tensors, the copies' end event)."""
        t0 = time.perf_counter()
        done = self._slot_done[slot]
        if done is not None:
            done.synchronize()  # the buffer's last copy has left it
        n = self.sds.shard_sizes[si]
        host = {k: _read_npy_into(self.sds.shard_file(si, k), buf[:n])
                for k, buf in self._pinned[slot].items()}
        self.stage_ms.append((time.perf_counter() - t0) * 1e3)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with torch.cuda.stream(self._side):
            start.record()
            dev = {k: torch.empty(h.shape, dtype=h.dtype, device=self.device)
                   for k, h in host.items()}
            for k, h in host.items():
                dev[k].copy_(h, non_blocking=True)
            end.record()
        self._slot_done[slot] = end
        self._events.append((start, end))
        return dev, end

    def shards(self, order: Sequence[int]) -> Iterator[Dict[str, torch.Tensor]]:
        """Each shard of ``order`` as a dict of tensors on the device, ready
        for the current stream. Drop a shard's dict before asking for the
        next, so that at most two shards are held."""
        if not self.on_card:
            for si in order:
                yield {k: torch.from_numpy(np.array(a))
                       for k, a in self.sds.load_shard(si).arrays.items()}
            return
        pending = None
        try:
            for i, si in enumerate(order):
                t0 = time.perf_counter()
                if pending is None:
                    dev, ready = self._upload(i % 2, si)
                else:
                    dev, ready = pending.result()
                    pending = None
                if self.prefetch and i + 1 < len(order):
                    pending = self._pool.submit(self._upload, (i + 1) % 2, order[i + 1])
                current = torch.cuda.current_stream(self.device)
                current.wait_event(ready)
                for t in dev.values():
                    t.record_stream(current)
                self.wait_ms.append((time.perf_counter() - t0) * 1e3)
                yield dev
                del dev
        finally:
            if pending is not None:
                pending.result()

    def stats(self) -> Dict[str, object]:
        """Whether prefetch was on, each shard's upload in device ms (the side
        stream's copies) and its host staging in ms, in upload order, and the
        host ms the caller waited for each shard, in its order."""
        if self.on_card:
            torch.cuda.synchronize(self.device)
        return {"prefetch": self.prefetch, "shard_bytes": self.shard_bytes,
                "upload_ms": [s.elapsed_time(e) for s, e in self._events],
                "stage_ms": list(self.stage_ms), "wait_ms": list(self.wait_ms)}

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
