"""WGS-84 coordinate transforms and geometry (coordinates.rs re-design).

ECEF ↔ LLA, ENU look angles, range/range-rate, free-space path loss —
all as vectorized numpy/jnp-compatible functions (pure math, used both
host-side for scenario setup and in-kernel).
"""

from __future__ import annotations

import numpy as np

WGS84_A = 6_378_137.0
WGS84_F = 1.0 / 298.257_223_563
WGS84_E2 = WGS84_F * (2.0 - WGS84_F)
LIGHT_SPEED = 299_792_458.0


def lla_to_ecef(lat_deg, lon_deg, alt_m):
    lat = np.deg2rad(np.asarray(lat_deg, np.float64))
    lon = np.deg2rad(np.asarray(lon_deg, np.float64))
    alt = np.asarray(alt_m, np.float64)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * np.sin(lat) ** 2)
    x = (n + alt) * np.cos(lat) * np.cos(lon)
    y = (n + alt) * np.cos(lat) * np.sin(lon)
    z = (n * (1.0 - WGS84_E2) + alt) * np.sin(lat)
    return np.stack([x, y, z], axis=-1)


def ecef_to_lla(ecef):
    ecef = np.asarray(ecef, np.float64)
    x, y, z = ecef[..., 0], ecef[..., 1], ecef[..., 2]
    lon = np.arctan2(y, x)
    p = np.hypot(x, y)
    lat = np.arctan2(z, p * (1.0 - WGS84_E2))
    for _ in range(5):  # Bowring iteration
        n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * np.sin(lat) ** 2)
        alt = p / np.cos(lat) - n
        lat = np.arctan2(z, p * (1.0 - WGS84_E2 * n / (n + alt)))
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * np.sin(lat) ** 2)
    alt = p / np.cos(lat) - n
    return np.stack([np.rad2deg(lat), np.rad2deg(lon), alt], axis=-1)


def ecef_to_enu_matrix(lat_deg, lon_deg):
    lat = np.deg2rad(lat_deg)
    lon = np.deg2rad(lon_deg)
    sl, cl = np.sin(lat), np.cos(lat)
    so, co = np.sin(lon), np.cos(lon)
    return np.array([
        [-so, co, 0.0],
        [-sl * co, -sl * so, cl],
        [cl * co, cl * so, sl],
    ])


def look_angles(rx_lla, sat_ecef):
    """(azimuth_deg, elevation_deg, range_m) from receiver to satellite."""
    rx_ecef = lla_to_ecef(*rx_lla)
    d = np.asarray(sat_ecef, np.float64) - rx_ecef
    m = ecef_to_enu_matrix(rx_lla[0], rx_lla[1])
    enu = d @ m.T
    e, n, u = enu[..., 0], enu[..., 1], enu[..., 2]
    rng = np.linalg.norm(enu, axis=-1)
    az = np.rad2deg(np.arctan2(e, n)) % 360.0
    el = np.rad2deg(np.arcsin(np.clip(u / np.maximum(rng, 1e-9), -1, 1)))
    return az, el, rng


def range_rate(rx_ecef, rx_vel, sat_ecef, sat_vel):
    """Line-of-sight closing speed (m/s), positive = receding."""
    d = np.asarray(sat_ecef) - np.asarray(rx_ecef)
    u = d / np.linalg.norm(d, axis=-1, keepdims=True)
    dv = np.asarray(sat_vel) - np.asarray(rx_vel)
    return np.sum(dv * u, axis=-1)


def doppler_from_range_rate(rr_mps, carrier_hz):
    return -np.asarray(rr_mps) * carrier_hz / LIGHT_SPEED


def free_space_path_loss_db(range_m, freq_hz):
    return (20.0 * np.log10(np.maximum(range_m, 1.0))
            + 20.0 * np.log10(freq_hz) - 147.55)
