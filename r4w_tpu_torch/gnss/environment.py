"""Orbits + atmosphere: Keplerian propagation, Klobuchar ionosphere,
Saastamoinen troposphere, antenna patterns.

Re-design of waveform/gnss/environment/mod.rs: environment/orbit.rs,
environment/ionosphere.rs (Klobuchar), environment/troposphere.rs
(Saastamoinen), environment/multipath.rs, environment/antenna.rs
(SURVEY.md §2.4 Environment row).
"""

from __future__ import annotations

import dataclasses

import numpy as np

MU_EARTH = 3.986_004_418e14  # m^3/s^2
OMEGA_EARTH = 7.292_115_1467e-5  # rad/s


@dataclasses.dataclass(frozen=True)
class KeplerianOrbit:
    """Classical elements; GPS-like defaults (environment/orbit.rs)."""

    semi_major_axis: float = 26_559_710.0
    eccentricity: float = 0.01
    inclination_deg: float = 55.0
    raan_deg: float = 0.0
    arg_perigee_deg: float = 0.0
    mean_anomaly_deg: float = 0.0

    def period(self) -> float:
        return 2.0 * np.pi * np.sqrt(self.semi_major_axis**3 / MU_EARTH)

    def propagate(self, t_s):
        """ECEF position (…,3) and velocity (…,3) at times t_s (vectorized)."""
        t = np.atleast_1d(np.asarray(t_s, np.float64))
        a = self.semi_major_axis
        e = self.eccentricity
        n = np.sqrt(MU_EARTH / a**3)
        m = np.deg2rad(self.mean_anomaly_deg) + n * t
        # Kepler's equation (Newton iterations — fixed count, vectorized)
        ecc_anom = m.copy()
        for _ in range(8):
            ecc_anom = ecc_anom - (
                (ecc_anom - e * np.sin(ecc_anom) - m)
                / (1.0 - e * np.cos(ecc_anom))
            )
        nu = 2.0 * np.arctan2(
            np.sqrt(1 + e) * np.sin(ecc_anom / 2),
            np.sqrt(1 - e) * np.cos(ecc_anom / 2),
        )
        r = a * (1.0 - e * np.cos(ecc_anom))
        # perifocal
        xp = r * np.cos(nu)
        yp = r * np.sin(nu)
        p_semi = a * (1 - e * e)
        vxp = -np.sqrt(MU_EARTH / p_semi) * np.sin(nu)
        vyp = np.sqrt(MU_EARTH / p_semi) * (e + np.cos(nu))
        # rotation to ECI
        i = np.deg2rad(self.inclination_deg)
        raan = np.deg2rad(self.raan_deg)
        argp = np.deg2rad(self.arg_perigee_deg)
        co, so = np.cos(raan), np.sin(raan)
        ci, si = np.cos(i), np.sin(i)
        cw, sw = np.cos(argp), np.sin(argp)
        r11 = co * cw - so * sw * ci
        r12 = -co * sw - so * cw * ci
        r21 = so * cw + co * sw * ci
        r22 = -so * sw + co * cw * ci
        r31 = sw * si
        r32 = cw * si
        x = r11 * xp + r12 * yp
        y = r21 * xp + r22 * yp
        z = r31 * xp + r32 * yp
        vx = r11 * vxp + r12 * vyp
        vy = r21 * vxp + r22 * vyp
        vz = r31 * vxp + r32 * vyp
        # ECI -> ECEF: rotate by Earth rotation angle θ = ω·t
        th = OMEGA_EARTH * t
        ct, st_ = np.cos(th), np.sin(th)
        xe = ct * x + st_ * y
        ye = -st_ * x + ct * y
        # velocity in rotating frame
        vxe = ct * vx + st_ * vy + OMEGA_EARTH * ye
        vye = -st_ * vx + ct * vy - OMEGA_EARTH * xe
        pos = np.stack([xe, ye, z], axis=-1)
        vel = np.stack([vxe, vye, vz], axis=-1)
        return np.squeeze(pos), np.squeeze(vel)


# Klobuchar broadcast model defaults (environment ionosphere)
KLOBUCHAR_ALPHA = (1.1176e-8, 7.4506e-9, -5.9605e-8, -5.9605e-8)
KLOBUCHAR_BETA = (90112.0, 0.0, -196610.0, -65536.0)


def klobuchar_delay(lat_deg, lon_deg, az_deg, el_deg, gps_seconds,
                    alpha=KLOBUCHAR_ALPHA, beta=KLOBUCHAR_BETA):
    """Ionospheric delay in seconds (L1), standard Klobuchar algorithm."""
    el_sc = np.asarray(el_deg, np.float64) / 180.0  # semicircles
    az = np.deg2rad(np.asarray(az_deg, np.float64))
    psi = 0.0137 / (el_sc + 0.11) - 0.022
    phi_i = lat_deg / 180.0 + psi * np.cos(az)
    phi_i = np.clip(phi_i, -0.416, 0.416)
    lam_i = lon_deg / 180.0 + psi * np.sin(az) / np.cos(phi_i * np.pi)
    phi_m = phi_i + 0.064 * np.cos((lam_i - 1.617) * np.pi)
    t = np.mod(43200.0 * lam_i + np.asarray(gps_seconds, np.float64), 86400.0)
    amp = sum(a * phi_m**i for i, a in enumerate(alpha))
    per = sum(b * phi_m**i for i, b in enumerate(beta))
    amp = np.maximum(amp, 0.0)
    per = np.maximum(per, 72000.0)
    x = 2.0 * np.pi * (t - 50400.0) / per
    f = 1.0 + 16.0 * (0.53 - el_sc) ** 3
    delay = np.where(
        np.abs(x) < 1.57,
        f * (5e-9 + amp * (1.0 - x**2 / 2.0 + x**4 / 24.0)),
        f * 5e-9,
    )
    return delay


def saastamoinen_delay(el_deg, alt_m=0.0, pressure_hpa=1013.25,
                       temp_k=291.15, humidity=0.5):
    """Tropospheric delay in meters (Saastamoinen)."""
    el = np.deg2rad(np.maximum(np.asarray(el_deg, np.float64), 1.0))
    e_s = 6.108 * humidity * np.exp(
        (17.15 * temp_k - 4684.0) / (temp_k - 38.45)
    )
    z = np.pi / 2.0 - el
    return (0.002277 / np.cos(z)) * (
        pressure_hpa + (1255.0 / temp_k + 0.05) * e_s
        - 1.16 * np.tan(z) ** 2
    )


def antenna_gain_db(el_deg, pattern: str = "patch"):
    """Simple receiver antenna patterns (environment/antenna.rs)."""
    el = np.asarray(el_deg, np.float64)
    if pattern == "isotropic":
        return np.zeros_like(el)
    if pattern == "patch":
        # ~3 dB at zenith rolling off toward horizon
        return 3.0 * np.sin(np.deg2rad(np.clip(el, 0, 90))) - 1.0
    if pattern == "hemispherical":
        return np.where(el > 0, 0.0, -30.0)
    raise ValueError(f"unknown antenna pattern {pattern}")
