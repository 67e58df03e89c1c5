"""Hardware abstraction layer (r4w-sim hal/ re-design: hal/mod.rs:333
DriverRegistry, hal/uhd.rs, hal/soapysdr.rs + hal/soapysdr_ffi.rs,
hal/rtlsdr.rs + hal/rtlsdr_ffi.rs, hal/attenuator.rs, hal/sigmf.rs).

Real SDR hardware is absent in a TPU deployment, so the UHD/Soapy/RTL
drivers here are *honest stubs*: they probe for their native libraries,
report availability, and raise `DeviceNotFound` with a useful message
when opened without hardware. The functional drivers are the simulator
loopback and the SigMF file-replay device. The digital step attenuator
is fully modeled (sensitivity sweeps need it).

PyTorch counterpart of ``r4w_tpu.sim.hal``: the attenuator scales tensors
on their device; the registry opens the port's simulator and replay
device."""

from __future__ import annotations

import ctypes.util
import dataclasses
from typing import Callable

import numpy as np

from r4w_tpu_torch.core.types import to_tensor


class DeviceNotFound(RuntimeError):
    pass


# ----------------------------------------------------------- attenuator


@dataclasses.dataclass
class AttenuatorSpec:
    """Step-attenuator limits (hal/attenuator.rs)."""

    max_db: float = 95.0
    step_db: float = 0.25
    insertion_loss_db: float = 1.5


class DigitalAttenuator:
    """Programmable RF step attenuator model (hal/attenuator.rs):
    quantizes to the hardware step, applies insertion loss, scales IQ."""

    def __init__(self, spec: AttenuatorSpec = AttenuatorSpec()):
        self.spec = spec
        self._setting_db = 0.0

    def set_attenuation(self, db: float) -> float:
        """Request attenuation; returns the quantized actual value."""
        if db < 0:
            raise ValueError("attenuation must be >= 0 dB")
        q = round(db / self.spec.step_db) * self.spec.step_db
        self._setting_db = min(q, self.spec.max_db)
        return self._setting_db

    @property
    def attenuation_db(self) -> float:
        return self._setting_db

    @property
    def total_loss_db(self) -> float:
        return self._setting_db + self.spec.insertion_loss_db

    def apply(self, samples):
        """Scale IQ by the configured loss."""
        gain = 10.0 ** (-self.total_loss_db / 20.0)
        return to_tensor(samples) * gain

    def sweep(self, start_db: float, stop_db: float, step_db: float):
        """Sensitivity-sweep settings list (attenuator.rs sweep role)."""
        vals = np.arange(start_db, stop_db + step_db / 2, step_db)
        return [self.set_attenuation(float(v)) or self._setting_db
                for v in vals]


# --------------------------------------------------------------- drivers


@dataclasses.dataclass(frozen=True)
class DriverInfo:
    name: str
    description: str
    available: bool
    reason: str = ""


def _lib_available(*names: str) -> str | None:
    for n in names:
        path = ctypes.util.find_library(n)
        if path:
            return path
    return None


class _StubDriver:
    """Shared behavior for hardware drivers without hardware."""

    name = "stub"
    lib_names: tuple = ()
    description = ""

    @classmethod
    def probe(cls) -> DriverInfo:
        lib = _lib_available(*cls.lib_names) if cls.lib_names else None
        return DriverInfo(cls.name, cls.description, available=bool(lib),
                          reason="" if lib else
                          f"native library not found ({'/'.join(cls.lib_names)})")

    @classmethod
    def open(cls, *a, **k):
        info = cls.probe()
        if not info.available:
            raise DeviceNotFound(
                f"{cls.name}: {info.reason}; use device='simulator' or a "
                "SigMF recording (sim.SigmfReplayDevice) instead")
        raise DeviceNotFound(
            f"{cls.name}: library present but no device attached")


class UhdDriver(_StubDriver):
    """Ettus USRP via UHD (hal/uhd.rs role)."""

    name = "uhd"
    lib_names = ("uhd",)
    description = "Ettus USRP (UHD)"


class SoapyDriver(_StubDriver):
    """SoapySDR universal wrapper (hal/soapysdr*.rs role)."""

    name = "soapysdr"
    lib_names = ("SoapySDR",)
    description = "SoapySDR devices"


class RtlSdrDriver(_StubDriver):
    """RTL2832U dongles (hal/rtlsdr*.rs role)."""

    name = "rtlsdr"
    lib_names = ("rtlsdr",)
    description = "RTL-SDR dongles"


class DriverRegistry:
    """Name -> driver factory with availability reporting
    (hal/mod.rs:333 DriverRegistry)."""

    def __init__(self):
        self._drivers: dict[str, Callable] = {}
        for d in (UhdDriver, SoapyDriver, RtlSdrDriver):
            self.register(d.name, d)

    def register(self, name: str, driver):
        self._drivers[name] = driver

    def list_drivers(self) -> list[DriverInfo]:
        out = []
        for name, d in self._drivers.items():
            out.append(d.probe() if hasattr(d, "probe")
                       else DriverInfo(name, "", True))
        # the always-available software devices
        out.append(DriverInfo("simulator", "loopback simulator", True))
        out.append(DriverInfo("sigmf", "SigMF file replay", True))
        return out

    def open(self, name: str, *a, **k):
        if name == "simulator":
            from r4w_tpu_torch.sim import Simulator

            return Simulator(*a, **k)
        if name == "sigmf":
            from r4w_tpu_torch.sim import SigmfReplayDevice

            return SigmfReplayDevice(*a, **k)
        if name not in self._drivers:
            raise DeviceNotFound(
                f"unknown driver '{name}'; know "
                f"{[i.name for i in self.list_drivers()]}")
        return self._drivers[name].open(*a, **k)


default_registry = DriverRegistry()
