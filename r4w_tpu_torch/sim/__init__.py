"""Simulation & HAL layer (crates/r4w-sim re-design).

PyTorch counterpart of ``r4w_tpu.sim``: `SdrDevice` protocol
(device.rs:121), `SdrConfig` with regional presets (device.rs:43),
`DeviceCapabilities`, `discover_devices` (device.rs:191), the loopback
`Simulator` (simulator.rs:42-373) — TX feeds an internal buffer through
the channel model into RX, with signal injection and a sample clock —
and the SigMF file-replay 'hardware' (hal/sigmf.rs equivalent). Buffers
are tensors on the device's `device` (the CUDA card unless named). The
simulator's channel is `channel.apply_channel` on the reference's
threefry key, drawn from the simulator's own ``default_rng`` as the
reference draws it; the idle noise floor comes from that generator too.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from r4w_tpu_torch.core.types import IQ_DTYPE, resolve_device, to_tensor
from r4w_tpu_torch.observe.logging import get_logger

log = get_logger("sim")


@dataclasses.dataclass
class SdrConfig:
    """Device configuration (device.rs:20-80)."""

    frequency_hz: float = 868.1e6
    sample_rate: float = 125_000.0
    tx_gain_db: float = 30.0
    rx_gain_db: float = 40.0
    bandwidth_hz: float = 125_000.0
    antenna: str = "TX/RX"

    @classmethod
    def eu868(cls) -> "SdrConfig":
        return cls(frequency_hz=868.1e6)

    @classmethod
    def us915(cls) -> "SdrConfig":
        return cls(frequency_hz=915.0e6)


@dataclasses.dataclass(frozen=True)
class DeviceCapabilities:
    name: str
    min_freq_hz: float
    max_freq_hz: float
    max_sample_rate: float
    full_duplex: bool
    tx_capable: bool


@runtime_checkable
class SdrDevice(Protocol):
    """Device protocol (device.rs:121 SdrDevice trait)."""

    def configure(self, config: SdrConfig) -> None: ...
    def transmit(self, samples) -> int: ...
    def receive(self, num_samples: int) -> torch.Tensor: ...
    def capabilities(self) -> DeviceCapabilities: ...


@dataclasses.dataclass
class SimulatorConfig:
    sample_rate: float = 125_000.0
    noise_floor_db: float = -90.0
    channel_model: str = "awgn"
    channel_snr_db: float = 30.0
    loopback_delay_samples: int = 0
    seed: int = 0


class Simulator:
    """Loopback SDR (simulator.rs:42): transmit() → channel → receive(),
    plus inject_signal for scenario composition."""

    def __init__(self, config: SimulatorConfig = SimulatorConfig(), device=None):
        self.config = config
        self.device = resolve_device(device)
        self._buffer = torch.zeros(0, dtype=IQ_DTYPE, device=self.device)
        self._injected = torch.zeros(0, dtype=IQ_DTYPE, device=self.device)
        self._sdr_config = SdrConfig(sample_rate=config.sample_rate)
        self._rng = np.random.default_rng(config.seed)
        self._sample_clock = 0  # samples elapsed (timing.rs SampleClock)

    def _iq(self, samples) -> torch.Tensor:
        return to_tensor(samples, IQ_DTYPE, self.device)

    # -- SdrDevice --------------------------------------------------------
    def configure(self, config: SdrConfig) -> None:
        self._sdr_config = config
        log.debug("simulator configured: %s", config)

    def transmit(self, samples) -> int:
        samples = self._iq(samples)
        if self.config.loopback_delay_samples:
            samples = torch.cat([
                torch.zeros(self.config.loopback_delay_samples, dtype=IQ_DTYPE,
                            device=self.device),
                samples,
            ])
        self._buffer = torch.cat([self._buffer, samples])
        return samples.shape[0]

    def inject_signal(self, samples) -> None:
        """Add an arbitrary signal to the RX path (simulator.rs:141)."""
        samples = self._iq(samples)
        if samples.shape[0] > self._injected.shape[0]:
            pad = torch.zeros(samples.shape[0] - self._injected.shape[0], dtype=IQ_DTYPE,
                              device=self.device)
            self._injected = torch.cat([self._injected, pad])
        self._injected[: samples.shape[0]] += samples

    def receive(self, num_samples: int) -> torch.Tensor:
        """Pull samples through the channel (simulator.rs:226)."""
        from r4w_tpu_torch.channel import ChannelConfig, apply_channel, threefry

        out = torch.zeros(num_samples, dtype=IQ_DTYPE, device=self.device)
        n_buf = min(self._buffer.shape[0], num_samples)
        out[:n_buf] = self._buffer[:n_buf]
        self._buffer = self._buffer[n_buf:]
        n_inj = min(self._injected.shape[0], num_samples)
        out[:n_inj] += self._injected[:n_inj]
        self._injected = self._injected[n_inj:]
        # channel + thermal noise floor
        has_signal = bool(torch.any(out != 0))
        if has_signal:
            cfg = ChannelConfig(
                model=self.config.channel_model,
                snr_db=self.config.channel_snr_db,
                sample_rate=self.config.sample_rate,
            )
            key = threefry.key(int(self._rng.integers(0, 2**31)))
            out = apply_channel(out, cfg, key=key)
        else:
            noise_amp = 10.0 ** (self.config.noise_floor_db / 20.0)
            out = torch.from_numpy((noise_amp / np.sqrt(2) * (
                self._rng.standard_normal(num_samples)
                + 1j * self._rng.standard_normal(num_samples)
            )).astype(np.complex64)).to(self.device)
        self._sample_clock += num_samples
        return out

    def capabilities(self) -> DeviceCapabilities:
        return DeviceCapabilities(
            name="simulator", min_freq_hz=0.0, max_freq_hz=6e9,
            max_sample_rate=61.44e6, full_duplex=True, tx_capable=True,
        )

    @property
    def sample_clock(self) -> int:
        return self._sample_clock

    def elapsed_seconds(self) -> float:
        return self._sample_clock / self.config.sample_rate


class SigmfReplayDevice:
    """File-replay 'hardware' (hal/sigmf.rs): receive() streams a SigMF
    recording, read from the file once and held on `device`; transmit()
    appends to an output recording."""

    def __init__(self, path: str, device=None):
        from r4w_tpu_torch.io import sigmf

        self.device = resolve_device(device)
        samples, self._meta = sigmf.read_sigmf(path)
        self._samples = torch.from_numpy(samples).to(self.device)
        self._pos = 0
        self._tx: list[torch.Tensor] = []

    def configure(self, config: SdrConfig) -> None:
        pass

    def receive(self, num_samples: int) -> torch.Tensor:
        out = self._samples[self._pos: self._pos + num_samples]
        self._pos += out.shape[0]
        if out.shape[0] < num_samples:
            out = torch.cat([
                out, torch.zeros(num_samples - out.shape[0], dtype=IQ_DTYPE, device=self.device)
            ])
        return out

    def transmit(self, samples) -> int:
        samples = to_tensor(samples, IQ_DTYPE, self.device)
        self._tx.append(samples)
        return samples.shape[0]

    def save_transmitted(self, path: str):
        from r4w_tpu_torch.io import sigmf

        data = (torch.cat(self._tx) if self._tx
                else torch.zeros(0, dtype=IQ_DTYPE, device=self.device))
        sigmf.write_sigmf(path, data, self._meta.sample_rate)

    def capabilities(self) -> DeviceCapabilities:
        return DeviceCapabilities(
            name="sigmf-replay", min_freq_hz=0.0, max_freq_hz=6e9,
            max_sample_rate=self._meta.sample_rate, full_duplex=False,
            tx_capable=True,
        )


def discover_devices() -> list[DeviceCapabilities]:
    """Enumerate available 'hardware' (device.rs:191). In this build only
    simulation backends exist; real SDR HALs (UHD/Soapy/RTL) would
    register here."""
    return [Simulator(device="cpu").capabilities()]
