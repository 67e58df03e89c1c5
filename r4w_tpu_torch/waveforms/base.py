"""Waveform framework: the `Waveform` API + registry/factory.

PyTorch counterpart of ``r4w_tpu.waveforms.base``. Waveforms are frozen
dataclasses that hold the device their `modulate` creates tensors on;
`demodulate` runs wherever its samples lie. ``GPS-L1CA-PRN<n>`` names
resolve for n = 1-32; unknown names give None.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Callable

import numpy as np
import torch

from r4w_tpu_torch.core.types import DEFAULT_DEVICE, IQ_DTYPE, CommonParams, resolve_device


@dataclasses.dataclass(frozen=True)
class WaveformInfo:
    """Educational/display metadata."""

    name: str
    full_name: str
    description: str = ""
    complexity: int = 1
    bits_per_symbol: int = 1
    carries_data: bool = True
    characteristics: tuple[str, ...] = ()
    history: str = ""
    modern_usage: str = ""


@dataclasses.dataclass
class DemodResult:
    """Demodulation output.

    bits: packed bytes (int32 tensor, one byte per element, for multi-bit
    schemes). symbols: per-symbol decisions.
    """

    bits: torch.Tensor
    symbols: torch.Tensor
    ber_estimate: float | None = None
    snr_estimate: float | None = None
    metadata: dict = dataclasses.field(default_factory=dict)


def coerce_data_bytes(data) -> np.ndarray:
    """Accept bytes / list / array of byte values -> int32 numpy array."""
    if isinstance(data, (bytes, bytearray)):
        return np.frombuffer(bytes(data), dtype=np.uint8).astype(np.int32)
    if isinstance(data, torch.Tensor):
        data = data.cpu().numpy()
    return np.asarray(data).astype(np.int32)


def as_iq(samples, device) -> torch.Tensor:
    """`samples` as complex64: a tensor stays on its own device, anything
    else (numpy arrays, lists) is put on `device`."""
    if isinstance(samples, torch.Tensor):
        return samples.to(IQ_DTYPE)
    return torch.as_tensor(np.array(samples, np.complex64), device=device)


def host_table(values: np.ndarray, device) -> torch.Tensor:
    """A numpy table built on the host, as a tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(values)).to(device)


def empty_result(device) -> "DemodResult":
    """No bits and no symbols: a capture shorter than one symbol."""
    empty = torch.zeros(0, dtype=torch.int32, device=device)
    return DemodResult(bits=empty, symbols=empty)


def is_packed_bytes(data: np.ndarray) -> bool:
    """Values > 1 mean packed bytes, not bits."""
    return bool(np.any(data > 1))


def data_to_bits(data) -> np.ndarray:
    """Accept packed bytes or a 0/1 bit vector; return bit vector (MSB-first)."""
    arr = coerce_data_bytes(data)
    if arr.size and not is_packed_bytes(arr):
        return arr  # already bits
    bits = np.unpackbits(arr.astype(np.uint8)[:, None], axis=1).reshape(-1)
    return bits.astype(np.int32)


class Waveform(abc.ABC):
    """Abstract waveform. Implementations are frozen dataclasses with a
    `device`; `modulate` and `demodulate` are batch functions on tensors."""

    device: torch.device

    @abc.abstractmethod
    def info(self) -> WaveformInfo: ...

    @property
    @abc.abstractmethod
    def common_params(self) -> CommonParams: ...

    @abc.abstractmethod
    def modulate(self, data) -> torch.Tensor: ...

    @abc.abstractmethod
    def demodulate(self, samples) -> DemodResult: ...

    @abc.abstractmethod
    def samples_per_symbol(self) -> int: ...

    # Educational defaults --------------------------------------------------
    def generate_demo(self, duration_ms: float = 10.0) -> torch.Tensor:
        n = int(self.common_params.sample_rate * duration_ms / 1000.0)
        demo = np.arange(16) % 2
        return self.modulate(demo.astype(np.int32))[:n]

    def get_visualization(self, data) -> dict:
        points = getattr(self, "constellation_points", None)
        return {
            "samples": self.modulate(data),
            "constellation": (points() if points is not None else
                              torch.zeros(0, dtype=IQ_DTYPE, device=self.device)),
            "description": f"{self.info().name} modulated signal",
        }

    def get_modulation_stages(self, data) -> list[tuple[str, object]]:
        """Named intermediate signals for the educational pipeline view."""
        return [("input bits", data_to_bits(data)),
                ("modulated IQ", self.modulate(data))]

    def get_demodulation_steps(self, samples) -> list[tuple[str, object]]:
        """Named receiver steps."""
        res = self.demodulate(samples)
        return [("received IQ", samples),
                ("decisions", res.symbols),
                ("bits", res.bits)]


# --------------------------------------------------------------------------
# Registry / factory
# --------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[float, torch.device], Waveform]] = {}
_CANONICAL: list[str] = []


def _norm(name: str) -> str:
    return name.upper().replace("-", "").replace("_", "").replace(".", "")


def register_waveform(canonical: str, aliases: tuple[str, ...] = ()):
    """Register a builder fn(sample_rate, device) under a canonical name + aliases."""

    def deco(builder: Callable[[float, torch.device], Waveform]):
        if canonical not in _CANONICAL:
            _CANONICAL.append(canonical)
        for name in (canonical, *aliases):
            _REGISTRY[_norm(name)] = builder
        return builder

    return deco


def list_waveforms() -> list[str]:
    """Canonical waveform names, in registration order."""
    return list(_CANONICAL)


def create_waveform(name: str, sample_rate: float = 125_000.0,
                    device=DEFAULT_DEVICE) -> Waveform | None:
    """Create a waveform by (aliased) name on `device` (the CUDA card
    unless named); None if the name is unknown."""
    key = _norm(name)
    builder = _REGISTRY.get(key)
    if builder is not None:
        return builder(sample_rate, resolve_device(device))
    # GPS-L1CA-PRN<n> dynamic names (mod.rs:591-597)
    if key.startswith("GPSL1CAPRN") and key[10:].isdigit() and 1 <= int(key[10:]) <= 32:
        from r4w_tpu_torch.waveforms.gnss_waveforms import GpsL1CaWaveform

        return GpsL1CaWaveform(sample_rate, int(key[10:]), resolve_device(device))
    return None


class WaveformFactory:
    """Namespace for the factory functions."""

    list = staticmethod(list_waveforms)
    create = staticmethod(create_waveform)
