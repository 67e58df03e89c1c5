"""Host-side real-time primitives (rt/mod.rs: ringbuffer.rs, pool.rs,
thread.rs, latency.rs, stats.rs, alloc_audit.rs).

PyTorch counterpart of ``r4w_tpu.rt``. The card's hot path is batch
compute, so these primitives serve the host IO side: feeding device
buffers from sockets and files, timing the feed loop, and auditing
allocations out of it. The lock-free SPSC ring itself is the C++
`NativeRingBuffer` (``native/iqcore.cpp``); this module adds the pool,
latency, thread and audit layers around it.
"""

from __future__ import annotations

import os
import threading
import time
import tracemalloc
from typing import Callable

import numpy as np

from r4w_tpu_torch.native import NativeRingBuffer  # re-export (rt ringbuffer)

__all__ = ["NativeRingBuffer", "BufferPool", "LatencyHistogram",
           "ProcessingTimer", "RtStats", "spawn_rt_thread",
           "AllocationAudit"]


class BufferPool:
    """Preallocated reusable buffers (rt/pool.rs BufferPool): zero
    allocation on the hot path; acquire blocks when exhausted."""

    def __init__(self, n_buffers: int, samples: int,
                 dtype=np.complex64):
        self._free: list[np.ndarray] = [
            np.zeros(samples, dtype) for _ in range(n_buffers)]
        self._cond = threading.Condition()
        self.capacity = n_buffers

    def acquire(self, timeout: float | None = None) -> np.ndarray | None:
        with self._cond:
            if not self._free and not self._cond.wait_for(
                    lambda: bool(self._free), timeout):
                return None
            return self._free.pop()

    def release(self, buf: np.ndarray):
        with self._cond:
            self._free.append(buf)
            self._cond.notify()

    @property
    def available(self) -> int:
        with self._cond:
            return len(self._free)


class LatencyHistogram:
    """Fixed-bucket latency histogram with percentile queries
    (rt/latency.rs LatencyHistogram: p50/p99/p999). Buckets are
    logarithmic from 100 ns to 10 s; recording is O(1), no allocation."""

    N_BUCKETS = 160

    def __init__(self):
        self._counts = np.zeros(self.N_BUCKETS, np.int64)
        self._min = np.inf
        self._max = 0.0
        self.count = 0

    def _bucket(self, seconds: float) -> int:
        if seconds <= 1e-7:
            return 0
        return min(int((np.log10(seconds) + 7.0) * 20.0),
                   self.N_BUCKETS - 1)

    def record(self, seconds: float):
        self._counts[self._bucket(seconds)] += 1
        self.count += 1
        self._min = min(self._min, seconds)
        self._max = max(self._max, seconds)

    def percentile(self, p: float) -> float:
        """Upper edge of the bucket containing percentile p (0-100)."""
        if self.count == 0:
            return 0.0
        target = self.count * p / 100.0
        cum = np.cumsum(self._counts)
        b = int(np.searchsorted(cum, target))
        return 10.0 ** (b / 20.0 - 7.0 + 0.05)

    @property
    def p50(self) -> float:
        return self.percentile(50.0)

    @property
    def p99(self) -> float:
        return self.percentile(99.0)

    @property
    def p999(self) -> float:
        return self.percentile(99.9)

    def summary(self) -> dict:
        return {"count": self.count, "min_s": self._min,
                "max_s": self._max, "p50_s": self.p50,
                "p99_s": self.p99, "p999_s": self.p999}


class ProcessingTimer:
    """Context manager feeding a LatencyHistogram (rt/stats.rs)."""

    def __init__(self, hist: LatencyHistogram):
        self.hist = hist

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.hist.record(time.perf_counter() - self._t0)
        return False


class RtStats:
    """Rolling throughput/latency stats for a streaming loop."""

    def __init__(self):
        self.hist = LatencyHistogram()
        self.samples_processed = 0
        self._t_start = time.perf_counter()

    def record_block(self, n_samples: int, elapsed_s: float):
        self.hist.record(elapsed_s)
        self.samples_processed += n_samples

    def throughput_sps(self) -> float:
        dt = time.perf_counter() - self._t_start
        return self.samples_processed / dt if dt > 0 else 0.0


def spawn_rt_thread(target: Callable, name: str = "r4w-rt",
                    priority: int = 10) -> threading.Thread:
    """Start a thread and try to give it SCHED_FIFO priority
    (rt/thread.rs spawn_rt_thread). Falls back silently to normal
    scheduling when unprivileged — same contract as the reference,
    which logs and continues (thread.rs)."""

    def runner():
        try:
            os.sched_setscheduler(
                0, os.SCHED_FIFO, os.sched_param(priority))
        except (PermissionError, OSError):
            pass  # unprivileged: normal scheduling
        target()

    t = threading.Thread(target=runner, name=name, daemon=True)
    t.start()
    return t


class AllocationAudit:
    """Count Python-level allocations inside a hot region
    (rt/alloc_audit.rs AllocationTracker role): use as a context
    manager; `.blocks_delta` afterwards should be ~0 for a clean path."""

    def __enter__(self):
        self._was_tracing = tracemalloc.is_tracing()
        if not self._was_tracing:
            tracemalloc.start()
        gc_before = tracemalloc.take_snapshot()
        self._before = sum(s.count for s in gc_before.statistics("filename"))
        return self

    def __exit__(self, *exc):
        snap = tracemalloc.take_snapshot()
        after = sum(s.count for s in snap.statistics("filename"))
        self.blocks_delta = after - self._before
        if not self._was_tracing:
            tracemalloc.stop()
        return False
