"""Dynamic micro-batching onto a fixed device batch (port of
multimodal_supernovae_tpu/serving/batcher.py, numpy only).

The served model runs at ONE batch size B, but clients send 1..n samples
whenever they like. This module bridges the two:

  * requests are split into chunks of <= B samples and queued;
  * a single device-owner thread coalesces queued chunks up to B samples,
    waiting at most ``max_wait_ms`` after the first arrival so a lone
    request is never stuck behind an empty queue;
  * the tail is zero-padded to B (every row of the encoder is
    sample-independent in eval mode, so pad rows cannot perturb real rows);
  * one device call serves every coalesced request; results are split and
    delivered through per-chunk futures.

One thread owns all device calls, so HTTP handler threads only enqueue and
wait. A fetcher thread turns each call's outputs into host arrays with
``np.asarray``, so ``fn`` must return host arrays (``load_live``'s ``fn``
copies its CUDA outputs back before it returns). The ingress queue has no
bound, as in the JAX package.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["DynamicBatcher", "BatcherStats"]

LATENCY_WINDOW = 2048  # requests kept in the latency reservoir
INFLIGHT = 2           # device calls that may wait for the fetcher


class BatcherStats:
    """Counters + a bounded latency reservoir; thread-safe snapshots."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0
        self.samples = 0
        self.device_calls = 0
        self.padded_samples = 0
        self._lat_ms = collections.deque(maxlen=LATENCY_WINDOW)

    def record_request(self, n: int):
        with self._lock:
            self.requests += 1
            self.samples += n

    def record_call(self, real: int, batch: int):
        with self._lock:
            self.device_calls += 1
            self.padded_samples += batch - real

    def record_latency(self, ms: float):
        with self._lock:
            self._lat_ms.append(ms)

    def snapshot(self) -> Dict:
        with self._lock:
            lat = np.asarray(self._lat_ms, dtype=np.float64)
            calls = self.device_calls
            fill = None
            if calls and getattr(self, "batch_size", 0):
                fill = 1.0 - self.padded_samples / (calls * self.batch_size)
            out = {
                "requests": self.requests,
                "samples": self.samples,
                "device_calls": calls,
                "padded_samples": self.padded_samples,
            }
            if lat.size:
                out["latency_ms"] = {
                    "p50": float(np.percentile(lat, 50)),
                    "p95": float(np.percentile(lat, 95)),
                    "p99": float(np.percentile(lat, 99)),
                    "max": float(lat.max()),
                    "n": int(lat.size),
                }
            if fill is not None:
                out["batch_fill"] = round(fill, 4)
            return out


class _Chunk:
    __slots__ = ("arrays", "n", "future", "offset")

    def __init__(self, arrays: Dict[str, np.ndarray], n: int, future: Future):
        self.arrays = arrays
        self.n = n
        self.future = future
        self.offset = 0  # row offset inside the coalesced device batch


class DynamicBatcher:
    """Coalesce variable-size requests onto a fixed-batch callable.

    Parameters
    ----------
    fn: takes ``{field: np.ndarray[B, ...]}`` and returns a sequence of
        arrays whose leading dim is B.
    input_spec: ``{field: (trailing_shape, dtype)}``; the leading (batch)
        dim is implicit.
    batch_size: the B ``fn`` runs at.
    max_wait_ms: how long the device thread waits for more work after the
        FIRST queued chunk before padding and launching. 0 = launch
        immediately (lowest latency, worst fill).
    """

    def __init__(
        self,
        fn: Callable[[Dict[str, np.ndarray]], Sequence],
        input_spec: Dict[str, Tuple[Tuple[int, ...], np.dtype]],
        batch_size: int,
        max_wait_ms: float = 5.0,
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.fn = fn
        self.input_spec = {
            k: (tuple(shape), np.dtype(dt)) for k, (shape, dt) in input_spec.items()
        }
        self.batch_size = int(batch_size)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.stats = BatcherStats()
        self.stats.batch_size = self.batch_size
        self._queue: "queue.Queue" = queue.Queue()
        self._closed = threading.Event()
        # bounded: the launch thread blocks once INFLIGHT batches are
        # un-fetched, so queueing behind the device stays shallow.
        self._inflight: "queue.Queue" = queue.Queue(maxsize=INFLIGHT)
        self._thread = threading.Thread(
            target=self._run, name="mmsn-serving-batcher", daemon=True
        )
        self._fetcher = threading.Thread(
            target=self._fetch, name="mmsn-serving-fetcher", daemon=True
        )
        self._thread.start()
        self._fetcher.start()

    # ---------------------------------------------------------------- API

    def validate(self, arrays: Dict[str, np.ndarray]) -> Tuple[Dict[str, np.ndarray], int]:
        """Check a request against the input spec; returns (cast arrays, n)."""
        missing = sorted(set(self.input_spec) - set(arrays))
        extra = sorted(set(arrays) - set(self.input_spec))
        if missing or extra:
            raise ValueError(
                f"input fields mismatch: missing={missing} unexpected={extra} "
                f"(contract: {sorted(self.input_spec)})"
            )
        n = None
        cast = {}
        for k, (trail, dt) in self.input_spec.items():
            a = np.asarray(arrays[k])
            if a.ndim != 1 + len(trail) or tuple(a.shape[1:]) != trail:
                raise ValueError(
                    f"field '{k}': expected shape (n, {', '.join(map(str, trail))}"
                    f"{',' if len(trail) == 1 else ''}), got {a.shape}"
                )
            if n is None:
                n = a.shape[0]
            elif a.shape[0] != n:
                raise ValueError(
                    f"field '{k}': leading dim {a.shape[0]} != {n} of the "
                    "other fields"
                )
            try:
                cast[k] = a.astype(dt, copy=False)
            except (TypeError, ValueError) as e:
                raise ValueError(f"field '{k}': cannot cast {a.dtype} to {dt}: {e}")
        if not n:
            raise ValueError("empty request (leading dim 0)")
        return cast, n

    def submit(self, arrays: Dict[str, np.ndarray]) -> List[np.ndarray]:
        """Validate, enqueue (chunked to <= B), block until served.

        Returns the per-modality output arrays for exactly the submitted n
        samples, in the model's canonical output order.
        """
        if self._closed.is_set():
            raise RuntimeError("batcher is closed")
        cast, n = self.validate(arrays)
        self.stats.record_request(n)
        t0 = time.monotonic()
        futures = []
        for lo in range(0, n, self.batch_size):
            hi = min(lo + self.batch_size, n)
            chunk = _Chunk({k: v[lo:hi] for k, v in cast.items()}, hi - lo, Future())
            futures.append(chunk.future)
            self._queue.put(chunk)
        parts = [f.result() for f in futures]  # re-raises device errors
        self.stats.record_latency((time.monotonic() - t0) * 1e3)
        return [np.concatenate([p[i] for p in parts], axis=0)
                for i in range(len(parts[0]))]

    def close(self, timeout: float = 10.0):
        self._closed.set()
        self._queue.put(None)  # wake the worker
        self._thread.join(timeout=timeout)
        self._inflight.put(None)  # wake the fetcher
        self._fetcher.join(timeout=timeout)

    # ------------------------------------------------------------- worker

    def _gather(self) -> List[_Chunk]:
        """Block for the first chunk, then fill up to B within max_wait."""
        first = self._queue.get()
        if first is None:
            return []
        chunks, total = [first], first.n
        deadline = time.monotonic() + self.max_wait_s
        while total < self.batch_size:
            remaining = deadline - time.monotonic()
            try:
                nxt = self._queue.get(
                    timeout=max(remaining, 0) if remaining > 0 else None,
                    block=remaining > 0,
                )
            except queue.Empty:
                break
            if nxt is None:
                self._queue.put(None)  # keep the shutdown signal visible
                break
            if total + nxt.n > self.batch_size:
                # a full chunk that no longer fits starts the next batch
                self._queue.put(nxt)
                break
            chunks.append(nxt)
            total += nxt.n
        return chunks

    def _run(self):
        while not (self._closed.is_set() and self._queue.empty()):
            chunks = self._gather()
            if not chunks:
                continue
            total = sum(c.n for c in chunks)
            off = 0
            for c in chunks:
                c.offset = off
                off += c.n
            batch = {}
            for k, (trail, dt) in self.input_spec.items():
                buf = np.zeros((self.batch_size,) + trail, dtype=dt)
                for c in chunks:
                    buf[c.offset:c.offset + c.n] = c.arrays[k]
                batch[k] = buf
            self.stats.record_call(total, self.batch_size)
            try:
                outs = self.fn(batch)
            except Exception as e:  # deliver, don't kill the worker
                for c in chunks:
                    c.future.set_exception(e)
                continue
            # blocks only when INFLIGHT batches already await fetch
            self._inflight.put((chunks, outs))

    def _fetch(self):
        """Turn each call's outputs into host arrays and resolve futures,
        concurrently with the launch thread assembling the next batch."""
        while True:
            item = self._inflight.get()
            if item is None:
                return
            chunks, outs = item
            try:
                host = [np.asarray(o) for o in outs]
            except Exception as e:
                for c in chunks:
                    c.future.set_exception(e)
                continue
            for c in chunks:
                c.future.set_result(
                    [o[c.offset:c.offset + c.n] for o in host])
