"""General multi-emitter RF scenario engine.

Re-design of crates/r4w-sim/src/scenario/mod.rs — scenario/engine.rs,
scenario/emitter.rs, scenario/trajectory.rs, scenario/config.rs
(614 LoC): arbitrary signal sources (waveform transmitters,
tones, jammers) placed in WGS-84 geometry around a moving receiver;
the engine computes per-emitter range/Doppler/FSPL, applies continuous
Doppler rotation with carried carrier phase, sums the composite, and
adds a kT·NF thermal noise floor.

PyTorch counterpart of ``r4w_tpu.sim.scenario``. Geometry is evaluated
closed-form per block on the host in float64 (midpoint state, like
engine.rs:70-75); the per-sample work (emitter waveforms, Doppler
rotation, scaling, accumulation, noise) is tensor expressions over the
whole block on the engine's device (the CUDA card unless named), and the
composite never leaves it. The float arithmetic is the reference's: the
Doppler ramp in float64 rounded to float32, tone and sweep time as
float32 ``t0 + arange/fs`` (whose resolution coarsens late in a long
scene, as the reference's does), and the noise its threefry draws
(`channel.normal` with a key: the engine's key split once a block, the
noise jammer's ``fold_in`` of the block's first sample).

The GNSS-specific generator (gnss/scenario.py) remains the high-fidelity
satellite path (orbits, nav overlay, code Doppler); this engine is the
general scene: mixed waveforms, jammers, moving receivers.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol

import numpy as np
import torch

from r4w_tpu_torch.channel import channel as chan
from r4w_tpu_torch.channel import threefry
from r4w_tpu_torch.core.hostio import cis
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, real_scalar, resolve_device
from r4w_tpu_torch.gnss.coordinates import (
    ecef_to_enu_matrix,
    free_space_path_loss_db,
    lla_to_ecef,
)

SPEED_OF_LIGHT = 299_792_458.0
BOLTZMANN = 1.380649e-23


# --------------------------------------------------------- trajectory


@dataclasses.dataclass
class TrajectoryState:
    position_ecef: np.ndarray  # (3,)
    velocity_ecef: np.ndarray  # (3,)
    time_s: float


def _enu_to_ecef(lat_deg: float, lon_deg: float, enu: np.ndarray
                 ) -> np.ndarray:
    """Rotate an ENU vector into ECEF at the given origin."""
    m = np.asarray(ecef_to_enu_matrix(lat_deg, lon_deg))  # ecef->enu
    return m.T @ np.asarray(enu, np.float64)


@dataclasses.dataclass
class Trajectory:
    """Receiver/emitter motion (trajectory.rs:19): one of
    static | linear | waypoints | circular."""

    kind: str = "static"
    position: tuple[float, float, float] = (0.0, 0.0, 0.0)  # lat,lon,alt
    velocity_enu: tuple[float, float, float] = (0.0, 0.0, 0.0)
    waypoints: tuple[tuple[float, float, float, float], ...] = ()
    # circular:
    radius_m: float = 0.0
    omega_rad_s: float = 0.0
    initial_bearing_deg: float = 0.0

    @classmethod
    def static(cls, lat, lon, alt=0.0):
        return cls("static", (lat, lon, alt))

    @classmethod
    def linear(cls, lat, lon, alt, velocity_enu):
        return cls("linear", (lat, lon, alt),
                   tuple(float(v) for v in velocity_enu))

    @classmethod
    def from_waypoints(cls, points):
        """points: iterable of (time_s, lat, lon, alt)."""
        return cls("waypoints",
                   waypoints=tuple((float(t), float(a), float(b), float(c))
                                   for t, a, b, c in points))

    @classmethod
    def circular(cls, lat, lon, alt, radius_m, omega_rad_s,
                 initial_bearing_deg=0.0):
        return cls("circular", (lat, lon, alt), radius_m=radius_m,
                   omega_rad_s=omega_rad_s,
                   initial_bearing_deg=initial_bearing_deg)

    def state_at(self, t: float) -> TrajectoryState:
        lat, lon, alt = self.position
        if self.kind == "static":
            return TrajectoryState(
                np.asarray(lla_to_ecef(lat, lon, alt), np.float64),
                np.zeros(3), t)
        if self.kind == "linear":
            p0 = np.asarray(lla_to_ecef(lat, lon, alt), np.float64)
            v = _enu_to_ecef(lat, lon, self.velocity_enu)
            return TrajectoryState(p0 + v * t, v, t)
        if self.kind == "waypoints":
            pts = self.waypoints
            if not pts:
                return TrajectoryState(np.zeros(3), np.zeros(3), t)
            ecefs = [np.asarray(lla_to_ecef(a, b, c), np.float64)
                     for _, a, b, c in pts]
            times = [p[0] for p in pts]
            if len(pts) == 1 or t <= times[0]:
                return TrajectoryState(ecefs[0], np.zeros(3), t)
            if t >= times[-1]:
                return TrajectoryState(ecefs[-1], np.zeros(3), t)
            i = int(np.searchsorted(times, t, side="right")) - 1
            dt = times[i + 1] - times[i]
            frac = (t - times[i]) / dt
            pos = ecefs[i] + (ecefs[i + 1] - ecefs[i]) * frac
            vel = (ecefs[i + 1] - ecefs[i]) / dt
            return TrajectoryState(pos, vel, t)
        if self.kind == "circular":
            center = np.asarray(lla_to_ecef(lat, lon, alt), np.float64)
            bearing = np.radians(self.initial_bearing_deg) \
                + self.omega_rad_s * t
            enu_off = np.asarray([self.radius_m * np.sin(bearing),
                                  self.radius_m * np.cos(bearing), 0.0])
            speed = self.radius_m * self.omega_rad_s
            enu_vel = np.asarray([speed * np.cos(bearing),
                                  -speed * np.sin(bearing), 0.0])
            return TrajectoryState(center + _enu_to_ecef(lat, lon, enu_off),
                                   _enu_to_ecef(lat, lon, enu_vel), t)
        raise ValueError(f"unknown trajectory kind {self.kind}")


# ----------------------------------------------------------- emitters


def _block_time(t0: float, n: int, fs: float, device) -> torch.Tensor:
    """The reference's float32 sample times ``t0 + arange(n) / fs``."""
    return (torch.arange(n, dtype=REAL_DTYPE, device=device) / real_scalar(fs, device)
            + real_scalar(t0, device))


class Emitter(Protocol):
    """Signal source seam (emitter.rs:22 Emitter trait)."""

    id: str
    carrier_hz: float
    power_dbm: float

    def state_at(self, t: float) -> TrajectoryState: ...

    def generate_iq(self, t0: float, n: int, fs: float, device) -> torch.Tensor: ...

    def active_at(self, t: float) -> bool: ...


@dataclasses.dataclass
class BaseEmitter:
    id: str = "emitter"
    carrier_hz: float = 1e9
    power_dbm: float = 30.0
    trajectory: Trajectory = dataclasses.field(
        default_factory=lambda: Trajectory.static(0.0, 0.0, 0.0))
    t_on: float = 0.0
    t_off: float = float("inf")

    def state_at(self, t: float) -> TrajectoryState:
        return self.trajectory.state_at(t)

    def active_at(self, t: float) -> bool:
        return self.t_on <= t < self.t_off


@dataclasses.dataclass
class ToneEmitter(BaseEmitter):
    """CW tone at a baseband offset."""

    offset_hz: float = 0.0

    def generate_iq(self, t0: float, n: int, fs: float, device) -> torch.Tensor:
        t = _block_time(t0, n, fs, device)
        return cis(real_scalar(2 * np.pi * self.offset_hz, device) * t)


@dataclasses.dataclass
class WaveformEmitter(BaseEmitter):
    """Repeats a modulated payload from any factory waveform."""

    waveform_name: str = "BPSK"
    payload: bytes = b"\xa5\x5a"
    sample_rate: float = 125_000.0

    def __post_init__(self):
        from r4w_tpu_torch.waveforms import create_waveform

        # made on the host once, so every device repeats the same burst
        wf = create_waveform(self.waveform_name, self.sample_rate, device="cpu")
        self._burst = wf.modulate(self.payload).numpy().astype(np.complex64)
        self._on_device: dict[str, torch.Tensor] = {}

    def generate_iq(self, t0: float, n: int, fs: float, device) -> torch.Tensor:
        burst = self._on_device.get(str(device))
        if burst is None:
            burst = self._on_device[str(device)] = torch.from_numpy(self._burst).to(device)
        start = int(round(t0 * fs)) % len(self._burst)
        idx = torch.remainder(torch.arange(start, start + n, device=device), len(self._burst))
        return burst[idx]


@dataclasses.dataclass
class NoiseJammerEmitter(BaseEmitter):
    """Band-limited Gaussian noise jammer."""

    seed: int = 0

    def generate_iq(self, t0: float, n: int, fs: float, device) -> torch.Tensor:
        key = threefry.fold_in(threefry.key(self.seed), int(round(t0 * fs)) & 0x7FFFFFFF)
        re, im = chan.normal((2, n), key=key, device=device)
        return torch.complex(re, im) * float(np.float32(np.sqrt(0.5)))


@dataclasses.dataclass
class SweepJammerEmitter(BaseEmitter):
    """Linear FM sweep jammer across ±sweep_hz/2."""

    sweep_hz: float = 100_000.0
    period_s: float = 0.01

    def generate_iq(self, t0: float, n: int, fs: float, device) -> torch.Tensor:
        t = torch.remainder(_block_time(t0, n, fs, device), real_scalar(self.period_s, device))
        # instantaneous freq sweeps -s/2 -> +s/2 each period
        f0 = -self.sweep_hz / 2.0
        k = self.sweep_hz / self.period_s
        phase = real_scalar(2 * np.pi, device) * (
            real_scalar(f0, device) * t + real_scalar(0.5 * k, device) * t * t)
        return cis(phase)


# ------------------------------------------------------------- engine


@dataclasses.dataclass
class EmitterStatus:
    """Per-emitter snapshot (engine.rs:19)."""

    id: str
    range_m: float
    doppler_hz: float
    path_loss_db: float
    received_power_dbm: float
    active: bool


@dataclasses.dataclass
class SceneConfig:
    """engine config (scenario/config.rs:10)."""

    sample_rate: float = 1_000_000.0
    duration_s: float = 0.1
    block_size: int = 65_536
    noise_figure_db: float = 6.0
    temperature_k: float = 290.0
    seed: int = 0

    @property
    def total_samples(self) -> int:
        return int(round(self.sample_rate * self.duration_s))

    def noise_power(self) -> float:
        """kT·NF·fs thermal noise power (linear, relative scale)."""
        nf = 10.0 ** (self.noise_figure_db / 10.0)
        return BOLTZMANN * self.temperature_k * nf * self.sample_rate


class ScenarioEngine:
    """Compose emitters into one IQ stream (engine.rs:32) on `device`
    (default: the CUDA card)."""

    def __init__(self, config: SceneConfig, emitters: list,
                 rx_trajectory: Trajectory | None = None,
                 reference_power_dbm: float = -100.0, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.emitters = list(emitters)
        self.rx = rx_trajectory or Trajectory.static(0.0, 0.0, 0.0)
        self.current_sample = 0
        self._phases = np.zeros(len(self.emitters))
        # amplitude scale: reference_power_dbm maps to unit amplitude,
        # keeping float32-friendly magnitudes regardless of absolute dBm
        self._ref_dbm = reference_power_dbm
        self._key = threefry.key(config.seed)

    # ---------------------------------------------------- geometry

    def _geometry(self, emitter, t: float):
        rx = self.rx.state_at(t)
        em = emitter.state_at(t)
        d = em.position_ecef - rx.position_ecef
        rng = float(np.linalg.norm(d))
        if rng < 1e-6:
            return 0.0, 0.0, 0.0
        los = d / rng
        rr = float(np.dot(em.velocity_ecef - rx.velocity_ecef, los))
        doppler = -rr * emitter.carrier_hz / SPEED_OF_LIGHT
        pl_db = float(free_space_path_loss_db(rng, emitter.carrier_hz))
        return rng, doppler, pl_db

    def emitter_status(self, t: float = 0.0) -> list[EmitterStatus]:
        out = []
        for em in self.emitters:
            rng, dop, pl = self._geometry(em, t)
            out.append(EmitterStatus(
                id=em.id, range_m=rng, doppler_hz=dop, path_loss_db=pl,
                received_power_dbm=em.power_dbm - pl,
                active=em.active_at(t)))
        return out

    # -------------------------------------------------- generation

    def generate_block(self, n: int | None = None) -> torch.Tensor:
        remaining = self.config.total_samples - self.current_sample
        n = min(n or self.config.block_size, remaining)
        dev = self.device
        if n <= 0:
            return torch.zeros(0, dtype=IQ_DTYPE, device=dev)
        fs = self.config.sample_rate
        t0 = self.current_sample / fs
        t_mid = t0 + n / (2.0 * fs)

        composite = torch.zeros(n, dtype=IQ_DTYPE, device=dev)
        ramp = None
        for i, em in enumerate(self.emitters):
            if not em.active_at(t_mid):
                continue
            rng_m, doppler, pl_db = self._geometry(em, t_mid)
            rx_dbm = em.power_dbm - pl_db
            amp = np.float32(10.0 ** ((rx_dbm - self._ref_dbm) / 20.0))
            base = em.generate_iq(t0, n, fs, dev)
            # continuous Doppler rotation: closed-form phase ramp from
            # the carried phase accumulator (engine.rs:104-118, batched),
            # float64 as the reference's host ramp, rounded to float32
            dphi = 2.0 * np.pi * doppler / fs
            if ramp is None:
                ramp = torch.arange(1, n + 1, dtype=torch.float64, device=dev)
            ph = torch.remainder(self._phases[i] + dphi * ramp, 2 * np.pi)
            composite = composite + base * float(amp) * cis(ph.to(REAL_DTYPE))
            self._phases[i] = (self._phases[i] + dphi * n) % (2 * np.pi)

        # thermal noise floor on the same relative scale
        noise_p = self.config.noise_power() / 10.0 ** (
            (self._ref_dbm - 30.0) / 10.0)
        self._key, sub = threefry.split(self._key)
        re, im = chan.normal((2, n), key=sub, device=dev)
        noise = torch.complex(re, im) * float(np.float32(np.sqrt(noise_p / 2.0)))
        self.current_sample += n
        return composite + noise

    def generate_all(self) -> torch.Tensor:
        blocks = []
        while self.current_sample < self.config.total_samples:
            blocks.append(self.generate_block())
        return (torch.cat(blocks) if blocks
                else torch.zeros(0, dtype=IQ_DTYPE, device=self.device))

    def reset(self):
        self.current_sample = 0
        self._phases[:] = 0.0
        self._key = threefry.key(self.config.seed)

    @property
    def progress(self) -> float:
        return self.current_sample / max(self.config.total_samples, 1)

    @property
    def is_done(self) -> bool:
        return self.current_sample >= self.config.total_samples
