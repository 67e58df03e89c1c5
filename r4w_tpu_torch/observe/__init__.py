"""Observability: logs, metrics, capture (observe/mod.rs family root), and
the spans at the layer boundaries of the port's hot paths (`spans`).

PyTorch counterpart of ``r4w_tpu.observe``; `spans` has none."""

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
from r4w_tpu_torch.observe.spans import Recorder, Span, recording, traced

__all__ = [
    "CaptureConfig", "CaptureManager", "CaptureState",
    "get_logger", "init_logging",
    "REGISTRY", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Timer", "serve_metrics",
    "Recorder", "Span", "recording", "traced",
]
