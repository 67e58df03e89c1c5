"""Layered YAML configuration (crates/r4w-core/src/config.rs re-design).

PyTorch counterpart of ``r4w_tpu.config``: `R4wConfig` with per-domain
sections (config.rs:71-353), profile overlays, search paths, validation,
and example generation (config.rs:353-504). PyYAML is imported only by
the functions that read or write YAML.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

SEARCH_PATHS = (
    "./r4w.yaml",
    "./config/r4w.yaml",
    "~/.config/r4w/config.yaml",
)


@dataclasses.dataclass
class DeviceConfig:
    driver: str = "simulator"
    sample_rate: float = 125_000.0
    frequency: float = 868.1e6
    gain_db: float = 30.0
    antenna: str = "TX/RX"


@dataclasses.dataclass
class BufferConfig:
    block_size: int = 1 << 16
    num_buffers: int = 4


@dataclasses.dataclass
class RealtimeConfig:
    enabled: bool = False
    priority: int = 80
    lock_memory: bool = False


@dataclasses.dataclass
class LogConfig:
    profile: str = "dev"
    level: str = "info"
    json: bool = False


@dataclasses.dataclass
class MetricsConfig:
    enabled: bool = False
    port: int = 9090


@dataclasses.dataclass
class TracingConfig:
    enabled: bool = False
    profile_dir: str = "/tmp/r4w_trace"


@dataclasses.dataclass
class CaptureConfig:
    pre_trigger_samples: int = 4096
    post_trigger_samples: int = 65536
    directory: str = "./captures"


@dataclasses.dataclass
class WaveformConfig:
    default: str = "BPSK"
    sample_rate: float = 125_000.0
    amplitude: float = 1.0


@dataclasses.dataclass
class R4wConfig:
    device: DeviceConfig = dataclasses.field(default_factory=DeviceConfig)
    buffer: BufferConfig = dataclasses.field(default_factory=BufferConfig)
    realtime: RealtimeConfig = dataclasses.field(default_factory=RealtimeConfig)
    log: LogConfig = dataclasses.field(default_factory=LogConfig)
    metrics: MetricsConfig = dataclasses.field(default_factory=MetricsConfig)
    tracing: TracingConfig = dataclasses.field(default_factory=TracingConfig)
    capture: CaptureConfig = dataclasses.field(default_factory=CaptureConfig)
    waveform: WaveformConfig = dataclasses.field(default_factory=WaveformConfig)
    profiles: dict = dataclasses.field(default_factory=dict)

    _SECTIONS = ("device", "buffer", "realtime", "log", "metrics",
                 "tracing", "capture", "waveform")

    # -- loading ----------------------------------------------------------
    @classmethod
    def load(cls) -> "R4wConfig":
        """First config found on the search paths, else defaults
        (config.rs:403 `load`)."""
        for p in SEARCH_PATHS:
            path = os.path.expanduser(p)
            if os.path.exists(path):
                return cls.load_from(path)
        return cls()

    @classmethod
    def load_from(cls, path: str) -> "R4wConfig":
        import yaml  # the card's machine has no PyYAML; nothing there reads YAML

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: dict) -> "R4wConfig":
        cfg = cls()
        cfg._apply(raw)
        cfg.profiles = raw.get("profiles", {}) or {}
        return cfg

    def _apply(self, raw: dict):
        for section in self._SECTIONS:
            if section in raw and isinstance(raw[section], dict):
                obj = getattr(self, section)
                for k, v in raw[section].items():
                    if hasattr(obj, k):
                        setattr(obj, k, v)

    def with_profile(self, name: str) -> "R4wConfig":
        """Overlay a named profile (config.rs `with_profile`)."""
        if name not in self.profiles:
            raise KeyError(
                f"unknown profile '{name}'; have {list(self.profiles)}"
            )
        clone = R4wConfig.from_dict(self.to_dict())
        clone.profiles = self.profiles
        clone._apply(self.profiles[name])
        return clone

    # -- validation / output ----------------------------------------------
    def validate(self) -> list[str]:
        """Returns a list of problems (empty = valid, config.rs:504)."""
        errs = []
        if self.device.sample_rate <= 0:
            errs.append("device.sample_rate must be positive")
        if not (0 < self.buffer.block_size <= (1 << 26)):
            errs.append("buffer.block_size out of range")
        if not (0 <= self.realtime.priority <= 99):
            errs.append("realtime.priority must be 0-99")
        if not (0 < self.metrics.port < 65536):
            errs.append("metrics.port must be a valid TCP port")
        if self.waveform.amplitude <= 0:
            errs.append("waveform.amplitude must be positive")
        return errs

    def to_dict(self) -> dict:
        out: dict[str, Any] = {}
        for section in self._SECTIONS:
            out[section] = dataclasses.asdict(getattr(self, section))
        return out

    def to_yaml(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    @classmethod
    def example_yaml(cls) -> str:
        """Commented example config (config.rs example generation)."""
        base = cls().to_yaml()
        return (
            "# r4w_tpu configuration (all values shown are defaults)\n"
            + base
            + "\n# profiles:\n#   lab:\n#     device:\n#       gain_db: 10\n"
        )
