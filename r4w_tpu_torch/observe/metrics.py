"""Metrics registry with Prometheus text export (observe/metrics.rs
re-design): Counter / Gauge / Histogram + `to_prometheus`, plus an
optional HTTP server for `r4w metrics --serve` (main.rs:5227).

PyTorch counterpart of ``r4w_tpu.observe.metrics`` (host-side only; no
tensor reaches it)."""

from __future__ import annotations

import http.server
import threading
import time


class Counter:
    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self.value = 0.0

    def inc(self, amount: float = 1.0):
        self.value += amount


class Gauge:
    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self.value = 0.0

    def set(self, v: float):
        self.value = float(v)

    def inc(self, amount: float = 1.0):
        self.value += amount

    def dec(self, amount: float = 1.0):
        self.value -= amount


class Histogram:
    DEFAULT_BUCKETS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)

    def __init__(self, name: str, help_: str = "", buckets=None):
        self.name = name
        self.help = help_
        self.buckets = tuple(buckets or self.DEFAULT_BUCKETS)
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.total = 0

    def observe(self, v: float):
        self.sum += v
        self.total += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def quantile(self, q: float) -> float:
        """Approximate quantile from bucket counts."""
        if self.total == 0:
            return 0.0
        target = q * self.total
        acc = 0
        for i, b in enumerate(self.buckets):
            acc += self.counts[i]
            if acc >= target:
                return b
        return float("inf")


class MetricsRegistry:
    """Process-wide registry (observe/metrics.rs Metrics)."""

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "") -> Counter:
        with self._lock:
            return self._metrics.setdefault(name, Counter(name, help_))

    def gauge(self, name: str, help_: str = "") -> Gauge:
        with self._lock:
            return self._metrics.setdefault(name, Gauge(name, help_))

    def histogram(self, name: str, help_: str = "", buckets=None) -> Histogram:
        with self._lock:
            return self._metrics.setdefault(
                name, Histogram(name, help_, buckets)
            )

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (observe/metrics.rs:36-371)."""
        lines = []
        with self._lock:
            for m in self._metrics.values():
                if m.help:
                    lines.append(f"# HELP {m.name} {m.help}")
                if isinstance(m, Counter):
                    lines.append(f"# TYPE {m.name} counter")
                    lines.append(f"{m.name} {m.value}")
                elif isinstance(m, Gauge):
                    lines.append(f"# TYPE {m.name} gauge")
                    lines.append(f"{m.name} {m.value}")
                elif isinstance(m, Histogram):
                    lines.append(f"# TYPE {m.name} histogram")
                    acc = 0
                    for i, b in enumerate(m.buckets):
                        acc += m.counts[i]
                        lines.append(f'{m.name}_bucket{{le="{b}"}} {acc}')
                    lines.append(
                        f'{m.name}_bucket{{le="+Inf"}} {m.total}'
                    )
                    lines.append(f"{m.name}_sum {m.sum}")
                    lines.append(f"{m.name}_count {m.total}")
        return "\n".join(lines) + "\n"


REGISTRY = MetricsRegistry()


class Timer:
    """Context manager feeding a Histogram in seconds (rt/stats.rs
    ProcessingTimer equivalent)."""

    def __init__(self, histogram: Histogram):
        self.histogram = histogram

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.histogram.observe(time.perf_counter() - self._t0)
        return False


def serve_metrics(port: int = 9090, registry: MetricsRegistry = REGISTRY,
                  blocking: bool = False, host: str = "0.0.0.0"):
    """Serve /metrics over HTTP (r4w metrics --serve) on `host` (every
    interface by default, as the reference; 127.0.0.1 keeps it local).
    Port 0 takes a free port: read it from ``server.server_address``."""

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path in ("/", "/metrics"):
                body = registry.to_prometheus().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_response(404)
                self.end_headers()

        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer((host, port), Handler)
    if blocking:
        server.serve_forever()
        return server
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server
