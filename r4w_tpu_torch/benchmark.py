"""Benchmark harness (benchmark/): UDP IQ receiver + per-waveform runner +
throughput/latency metrics + report.

PyTorch counterpart of ``r4w_tpu.benchmark``, mirroring benchmark/mod.rs:
runner.rs:52 (WaveformRunner), receiver.rs:79 (BenchmarkReceiver),
metrics.rs:14 (BenchmarkMetrics), report.rs. The runner demodulates each
received batch on its device (the card unless named); a batch's latency
runs from the host array to the bits read back to the host, as the
reference's ``np.asarray(res.bits)`` does, so it times the demodulation
and not a queue of launches. The runner also feeds an
`rt.LatencyHistogram`.

On the native path `packets_dropped` is the receiver's count of sequence
discontinuities, not of lost packets (the reference's quirk: a gap of
three packets counts one).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from r4w_tpu_torch.core.types import DEFAULT_DEVICE, IQ_DTYPE, resolve_device
from r4w_tpu_torch.net import UdpConfig, UdpSource
from r4w_tpu_torch.rt import LatencyHistogram


@dataclasses.dataclass
class BenchmarkMetrics:
    """Throughput + latency percentiles (benchmark/metrics.rs:14)."""

    samples_processed: int = 0
    bytes_decoded: int = 0
    batches: int = 0
    start_time: float = dataclasses.field(default_factory=time.perf_counter)
    latencies_ms: list = dataclasses.field(default_factory=list)

    def update(self, n_samples: int, n_bytes: int, latency_s: float):
        self.samples_processed += n_samples
        self.bytes_decoded += n_bytes
        self.batches += 1
        self.latencies_ms.append(latency_s * 1e3)

    @property
    def elapsed_s(self) -> float:
        return time.perf_counter() - self.start_time

    def throughput_msps(self) -> float:
        el = self.elapsed_s
        return self.samples_processed / el / 1e6 if el > 0 else 0.0

    def latency_stats(self) -> dict:
        if not self.latencies_ms:
            return {"min": 0, "avg": 0, "max": 0, "p99": 0}
        arr = np.asarray(self.latencies_ms)
        return {"min": float(arr.min()), "avg": float(arr.mean()),
                "max": float(arr.max()), "p99": float(np.percentile(arr, 99))}

    def report(self) -> str:
        lat = self.latency_stats()
        return (f"samples:    {self.samples_processed}\n"
                f"batches:    {self.batches}\n"
                f"elapsed:    {self.elapsed_s:.2f} s\n"
                f"throughput: {self.throughput_msps():.3f} Msamples/s\n"
                f"latency ms: avg {lat['avg']:.2f}  min {lat['min']:.2f}  "
                f"max {lat['max']:.2f}  p99 {lat['p99']:.2f}")


class WaveformRunner:
    """Demodulates batches through a factory waveform on `device`
    (benchmark/runner.rs:40-52)."""

    def __init__(self, waveform_name: str, sample_rate: float = 125_000.0,
                 device=DEFAULT_DEVICE):
        from r4w_tpu_torch.waveforms import create_waveform

        self.device = resolve_device(device)
        self.waveform = create_waveform(waveform_name, sample_rate, self.device)
        if self.waveform is None:
            raise ValueError(f"unknown waveform {waveform_name}")
        self.metrics = BenchmarkMetrics()
        self.histogram = LatencyHistogram()

    def process(self, samples) -> np.ndarray:
        """Demodulate one batch (host samples or a tensor); the decoded bytes
        come back to the host."""
        t0 = time.perf_counter()
        x = torch.as_tensor(samples, dtype=IQ_DTYPE).to(self.device)
        res = self.waveform.demodulate(x)
        bits = res.bits.cpu().numpy()
        latency = time.perf_counter() - t0
        self.metrics.update(len(samples), len(bits), latency)
        self.histogram.record(latency)
        return bits


class BenchmarkReceiver:
    """UDP receive loop feeding a WaveformRunner (benchmark/receiver.rs:79-95
    + cmd_benchmark main.rs:1895)."""

    def __init__(self, port: int, waveform_name: str, sample_rate: float = 125_000.0,
                 native: bool = True, device=DEFAULT_DEVICE):
        """native=True drains the socket with the C++ iqcore receiver thread +
        lock-free ring (no per-packet interpreter work); the Python
        UdpSource is used when the library is unavailable, and
        `self.native` is then None. Either binds 127.0.0.1."""
        self.native = None
        if native:
            try:
                from r4w_tpu_torch.native import NativeUdpReceiver

                self.native = NativeUdpReceiver(port=port)
            except (RuntimeError, ImportError):
                self.native = None
        self.source = (None if self.native is not None
                       else UdpSource(UdpConfig(host="127.0.0.1", port=port, timeout_s=0.25)))
        self.runner = WaveformRunner(waveform_name, sample_rate, device)

    @property
    def port(self) -> int:
        return self.native.port if self.native else self.source.port

    def _recv_batch(self) -> np.ndarray:
        if self.native is not None:
            out = self.native.read(1 << 16)
            if not len(out):
                time.sleep(0.002)
            return out
        return self.source.recv_batch()

    def run(self, duration_s: float = 5.0, report_every_s: float = 0.0,
            print_fn=print) -> BenchmarkMetrics:
        """Measure for duration_s of steady state: the clock starts after the
        first processed batch, so one-time set-up (the first launches, the
        kernel's library load) does not consume the measurement window."""
        t_end = time.perf_counter() + duration_s
        t_report = time.perf_counter() + (report_every_s or 1e9)
        first_done = False
        while time.perf_counter() < t_end:
            batch = self._recv_batch()
            if len(batch):
                self.runner.process(batch)
                if not first_done:
                    first_done = True
                    t_end = time.perf_counter() + duration_s
            if time.perf_counter() >= t_report:
                print_fn(self.runner.metrics.report())
                t_report += report_every_s
        m = self.runner.metrics
        if self.native is not None:
            stats = self.native.stats
            m.packets_received = stats["packets"]
            m.packets_dropped = stats["seq_gaps"]
        else:
            m.packets_received = self.source.packets_received
            m.packets_dropped = self.source.packets_dropped
        return m

    def close(self):
        if self.native is not None:
            self.native.close()
        if self.source is not None:
            self.source.close()
