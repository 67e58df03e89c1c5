"""Observability: logs, metrics, capture (observe/mod.rs family root).

PyTorch counterpart of ``r4w_tpu.observe``."""

from r4w_tpu_torch.observe.capture import CaptureConfig, CaptureManager, CaptureState
from r4w_tpu_torch.observe.logging import get_logger, init_logging
from r4w_tpu_torch.observe.metrics import (
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Timer,
    serve_metrics,
)

__all__ = [
    "CaptureConfig", "CaptureManager", "CaptureState",
    "get_logger", "init_logging",
    "REGISTRY", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Timer", "serve_metrics",
]
