"""Clocks and timestamps: `Timestamp` (integer seconds and picoseconds),
`SampleClock`, `WallClock` and `HardwareClock`.

PyTorch counterpart of ``r4w_tpu.timing`` (timing.rs: SampleClock,
WallClock, HardwareClock, Timestamp), a copy of its host Python as it is:
nothing here touches a tensor. The sample clock is the authoritative clock
for DSP, converting between sample counts and timestamps without float
drift; `Timestamp.from_samples` rounds n·10¹²/fs once in float64, so its
picoseconds are the reference's. The wall and hardware clocks serve the
host's control plane (schedulers, capture metadata); `HardwareClock` draws
its jitter from a numpy generator seeded as the reference's.
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass(frozen=True, order=True)
class Timestamp:
    """Integer seconds + fractional picoseconds (timing.rs Timestamp):
    exact arithmetic, no float accumulation."""

    secs: int
    picos: int  # 0 <= picos < 1e12

    PICOS_PER_SEC = 1_000_000_000_000

    @staticmethod
    def from_seconds(s: float) -> "Timestamp":
        secs = int(s)
        return Timestamp(secs, int(round((s - secs) * Timestamp.PICOS_PER_SEC)))

    @staticmethod
    def from_samples(n: int, sample_rate: float) -> "Timestamp":
        picos = round(n * Timestamp.PICOS_PER_SEC / sample_rate)
        return Timestamp(int(picos // Timestamp.PICOS_PER_SEC),
                         int(picos % Timestamp.PICOS_PER_SEC))

    def to_seconds(self) -> float:
        return self.secs + self.picos / self.PICOS_PER_SEC

    def to_samples(self, sample_rate: float) -> int:
        return round(self.to_seconds() * sample_rate)

    def __add__(self, other: "Timestamp") -> "Timestamp":
        p = self.picos + other.picos
        return Timestamp(self.secs + other.secs + p // self.PICOS_PER_SEC,
                         p % self.PICOS_PER_SEC)

    def __sub__(self, other: "Timestamp") -> "Timestamp":
        p = (self.secs - other.secs) * self.PICOS_PER_SEC \
            + (self.picos - other.picos)
        return Timestamp(int(p // self.PICOS_PER_SEC),
                         int(p % self.PICOS_PER_SEC))


class SampleClock:
    """Sample-count clock (timing.rs SampleClock): integer samples at a
    fixed rate; conversion to time is derived, never accumulated."""

    def __init__(self, sample_rate: float, start_sample: int = 0):
        if sample_rate <= 0:
            raise ValueError("sample_rate must be positive")
        self.sample_rate = float(sample_rate)
        self._samples = int(start_sample)

    def advance(self, n: int) -> int:
        self._samples += int(n)
        return self._samples

    @property
    def samples(self) -> int:
        return self._samples

    def elapsed_seconds(self) -> float:
        return self._samples / self.sample_rate

    def timestamp(self) -> Timestamp:
        return Timestamp.from_samples(self._samples, self.sample_rate)

    def samples_until(self, t: Timestamp) -> int:
        return max(0, t.to_samples(self.sample_rate) - self._samples)


class WallClock:
    """Monotonic wall clock with pause and time-scale (timing.rs
    WallClock + scheduler.rs time-scale semantics)."""

    def __init__(self, scale: float = 1.0):
        self.scale = scale
        self._base = time.monotonic()
        self._accum = 0.0
        self._paused = False

    def now(self) -> float:
        if self._paused:
            return self._accum
        return self._accum + (time.monotonic() - self._base) * self.scale

    def pause(self):
        if not self._paused:
            self._accum = self.now()
            self._paused = True

    def resume(self):
        if self._paused:
            self._base = time.monotonic()
            self._paused = False

    def set_scale(self, scale: float):
        self._accum = self.now()
        self._base = time.monotonic()
        self.scale = scale


class HardwareClock:
    """Simulated hardware clock with drift and jitter (timing.rs
    HardwareClock): deterministic given a seed, for testing clock
    recovery and scheduler robustness."""

    def __init__(self, sample_rate: float, drift_ppm: float = 0.0,
                 jitter_ps: float = 0.0, seed: int = 0):
        import numpy as np

        self.sample_rate = sample_rate
        self.drift_ppm = drift_ppm
        self.jitter_ps = jitter_ps
        self._rng = np.random.default_rng(seed)
        self._samples = 0

    def advance(self, n: int):
        self._samples += int(n)

    def apparent_time(self) -> float:
        """Time this (imperfect) clock reports."""
        ideal = self._samples / self.sample_rate
        drifted = ideal * (1.0 + self.drift_ppm * 1e-6)
        jitter = (float(self._rng.standard_normal()) * self.jitter_ps
                  * 1e-12 if self.jitter_ps else 0.0)
        return drifted + jitter

    def true_time(self) -> float:
        return self._samples / self.sample_rate

    def offset(self) -> float:
        """Accumulated error vs ideal (what a tracking loop must remove)."""
        return self.apparent_time() - self.true_time()
