"""Precise ephemeris: RINEX navigation, SP3 orbit files, IONEX TEC maps.

Re-design of waveform/gnss/{ephemeris,sp3,ionex,cddis}.rs (feature
`ephemeris`, ~2.1k LoC): text parsers + broadcast-ephemeris satellite
position computation (IS-GPS-200 algorithm). The CDDIS downloader role
is a local-file loader here (zero-egress environment); point it at
mirrored files.
"""

from __future__ import annotations

import dataclasses
import math
import re

import numpy as np

MU = 3.986005e14          # WGS-84 gravitational parameter (GPS value)
OMEGA_E = 7.2921151467e-5  # earth rotation rate


@dataclasses.dataclass
class BroadcastEphemeris:
    """One RINEX-nav record (subset used for position)."""

    prn: int
    toe: float          # time of ephemeris (seconds of week)
    sqrt_a: float
    e: float
    i0: float
    omega0: float       # RAAN at toe
    omega: float        # argument of perigee
    m0: float
    delta_n: float
    idot: float
    omega_dot: float
    cuc: float = 0.0
    cus: float = 0.0
    crc: float = 0.0
    crs: float = 0.0
    cic: float = 0.0
    cis: float = 0.0
    af0: float = 0.0
    af1: float = 0.0
    af2: float = 0.0

    def position(self, t_sow: float):
        """ECEF position at GPS seconds-of-week t (IS-GPS-200 20.3.3.4.3)."""
        a = self.sqrt_a**2
        n = math.sqrt(MU / a**3) + self.delta_n
        tk = t_sow - self.toe
        if tk > 302400:
            tk -= 604800
        if tk < -302400:
            tk += 604800
        mk = self.m0 + n * tk
        ek = mk
        for _ in range(10):
            ek = mk + self.e * math.sin(ek)
        nu = math.atan2(math.sqrt(1 - self.e**2) * math.sin(ek),
                        math.cos(ek) - self.e)
        phi = nu + self.omega
        du = self.cus * math.sin(2 * phi) + self.cuc * math.cos(2 * phi)
        dr = self.crs * math.sin(2 * phi) + self.crc * math.cos(2 * phi)
        di = self.cis * math.sin(2 * phi) + self.cic * math.cos(2 * phi)
        u = phi + du
        r = a * (1 - self.e * math.cos(ek)) + dr
        i = self.i0 + di + self.idot * tk
        x_orb = r * math.cos(u)
        y_orb = r * math.sin(u)
        omega_k = (self.omega0 + (self.omega_dot - OMEGA_E) * tk
                   - OMEGA_E * self.toe)
        x = (x_orb * math.cos(omega_k)
             - y_orb * math.cos(i) * math.sin(omega_k))
        y = (x_orb * math.sin(omega_k)
             + y_orb * math.cos(i) * math.cos(omega_k))
        z = y_orb * math.sin(i)
        return np.array([x, y, z])

    def clock_bias(self, t_sow: float) -> float:
        dt = t_sow - self.toe
        return self.af0 + self.af1 * dt + self.af2 * dt * dt


def _f(s: str) -> float:
    """RINEX float: fortran D exponents."""
    return float(s.replace("D", "E").replace("d", "e"))


def parse_rinex_nav(text: str) -> dict[int, list[BroadcastEphemeris]]:
    """Parse RINEX 2.x GPS navigation message text (ephemeris.rs)."""
    lines = text.splitlines()
    # skip header
    i = 0
    for i, ln in enumerate(lines):
        if "END OF HEADER" in ln:
            i += 1
            break
    out: dict[int, list[BroadcastEphemeris]] = {}
    while i + 7 < len(lines):
        hdr = lines[i]
        if len(hdr) < 22 or not hdr[:2].strip().isdigit():
            i += 1
            continue
        prn = int(hdr[:2])
        try:
            af0, af1, af2 = _f(hdr[22:41]), _f(hdr[41:60]), _f(hdr[60:79])
            rows = []
            for j in range(1, 8):
                ln = lines[i + j].ljust(79)
                rows.append([
                    _f(ln[3:22]) if ln[3:22].strip() else 0.0,
                    _f(ln[22:41]) if ln[22:41].strip() else 0.0,
                    _f(ln[41:60]) if ln[41:60].strip() else 0.0,
                    _f(ln[60:79]) if ln[60:79].strip() else 0.0,
                ])
            eph = BroadcastEphemeris(
                prn=prn,
                crs=rows[0][1], delta_n=rows[0][2], m0=rows[0][3],
                cuc=rows[1][0], e=rows[1][1], cus=rows[1][2],
                sqrt_a=rows[1][3],
                toe=rows[2][0], cic=rows[2][1], omega0=rows[2][2],
                cis=rows[2][3],
                i0=rows[3][0], crc=rows[3][1], omega=rows[3][2],
                omega_dot=rows[3][3],
                idot=rows[4][0],
                af0=af0, af1=af1, af2=af2,
            )
            out.setdefault(prn, []).append(eph)
        except (ValueError, IndexError):
            pass
        i += 8
    return out


# --------------------------------------------------------------------------
# SP3 precise orbits (sp3.rs)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Sp3Record:
    epoch_index: int
    prn: str       # e.g. "G01"
    pos_km: np.ndarray  # (3,)
    clock_us: float


def parse_sp3(text: str):
    """Parse SP3-c position records → (epochs list of seconds, records)."""
    epochs: list[float] = []
    records: list[Sp3Record] = []
    for ln in text.splitlines():
        if ln.startswith("*"):
            parts = ln.split()
            # *  2024  1  1  0  0  0.0000
            h, m, s = float(parts[4]), float(parts[5]), float(parts[6])
            epochs.append(h * 3600 + m * 60 + s)
        elif ln.startswith("P") and epochs:
            prn = ln[1:4].strip()
            try:
                x, y, z, clk = (float(ln[4:18]), float(ln[18:32]),
                                float(ln[32:46]), float(ln[46:60]))
            except ValueError:
                continue
            records.append(Sp3Record(len(epochs) - 1, prn,
                                     np.array([x, y, z]), clk))
    return epochs, records


def sp3_interpolate(epochs, records, prn: str, t_s: float,
                    order: int = 7) -> np.ndarray:
    """Lagrange-interpolated ECEF position (km) at time t (sp3.rs)."""
    pts = [(epochs[r.epoch_index], r.pos_km) for r in records
           if r.prn == prn]
    if len(pts) < 2:
        raise ValueError(f"not enough SP3 points for {prn}")
    pts.sort(key=lambda p: p[0])
    ts = np.array([p[0] for p in pts])
    xs = np.stack([p[1] for p in pts])
    k = min(order + 1, len(pts))
    i0 = int(np.clip(np.searchsorted(ts, t_s) - k // 2, 0, len(pts) - k))
    tt, xx = ts[i0 : i0 + k], xs[i0 : i0 + k]
    out = np.zeros(3)
    for j in range(k):
        lj = 1.0
        for m in range(k):
            if m != j:
                lj *= (t_s - tt[m]) / (tt[j] - tt[m])
        out += lj * xx[j]
    return out


# --------------------------------------------------------------------------
# IONEX TEC maps (ionex.rs)
# --------------------------------------------------------------------------


def parse_ionex(text: str):
    """Parse IONEX TEC maps → dict epoch_index -> 2-D TEC grid plus the
    (lat, lon) axes."""
    lines = text.splitlines()
    lat1 = lat2 = dlat = lon1 = lon2 = dlon = None
    exponent = -1
    maps: dict[int, np.ndarray] = {}
    i = 0
    current = None
    cur_idx = None
    cur_rows: list[float] = []
    lat_count = 0
    for ln in lines:
        if "LAT1 / LAT2 / DLAT" in ln:
            lat1, lat2, dlat = (float(ln[2:8]), float(ln[8:14]),
                                float(ln[14:20]))
        elif "LON1 / LON2 / DLON" in ln:
            lon1, lon2, dlon = (float(ln[2:8]), float(ln[8:14]),
                                float(ln[14:20]))
        elif "EXPONENT" in ln:
            exponent = int(ln.split()[0])
        elif "START OF TEC MAP" in ln:
            cur_idx = int(ln.split()[0]) - 1
            current = []
            cur_rows = []
        elif "LAT/LON1/LON2/DLON/H" in ln and current is not None:
            if cur_rows:
                current.append(cur_rows)
            cur_rows = []
        elif "END OF TEC MAP" in ln and current is not None:
            if cur_rows:
                current.append(cur_rows)
            maps[cur_idx] = np.asarray(current, float) * (10.0 ** exponent)
            current = None
        elif current is not None and ln[:60].strip() and not ln[60:].strip():
            cur_rows.extend(float(v) for v in ln.split())
    lats = (np.arange(lat1, lat2 + dlat / 2, dlat)
            if lat1 is not None else None)
    lons = (np.arange(lon1, lon2 + dlon / 2, dlon)
            if lon1 is not None else None)
    return maps, lats, lons


def load_ephemeris_file(path: str):
    """Auto-detecting loader (the cddis.rs role, local files only)."""
    text = open(path).read()
    if "NAV DATA" in text[:200] or "NAVIGATION DATA" in text[:200]:
        return "rinex_nav", parse_rinex_nav(text)
    if text.startswith("#c") or text.startswith("#d"):
        return "sp3", parse_sp3(text)
    if "IONEX VERSION" in text[:200]:
        return "ionex", parse_ionex(text)
    raise ValueError(f"unrecognized ephemeris format: {path}")


def circular_ephemeris_for_position(pos_ecef, receiver_ecef,
                                    t_eval: float, prn: int = 1,
                                    af0: float = 0.0, af1: float = 0.0,
                                    af2: float = 0.0,
                                    toe_quantum: float = 16.0,
                                    range_rate_mps: float = 0.0
                                    ) -> BroadcastEphemeris:
    """Synthesize a circular-orbit broadcast ephemeris whose IS-GPS
    `position(t_eval)` equals pos_ecef exactly, with the along-track
    velocity oriented so the ECEF range rate toward the receiver is
    `range_rate_mps` (default 0: velocity PERPENDICULAR to the line
    of sight).

    Scenario-synthesis seam for signal-only PVT gates
    (tools/gps_pvt_fix.py): a static-geometry IQ scenario needs nav
    bits whose decoded ephemeris reproduces the configured satellite
    position at whatever transmit time the receiver computes. Making
    v ⟂ LOS at t_eval kills the first-order range sensitivity to the
    receiver's exact evaluation epoch (per-SV transit-time spread):
    a ±50 ms epoch error moves the predicted range by ~|vδt|²/2r ≈
    millimeters instead of v·δt ≈ hundreds of meters.

    t_oe is snapped to the broadcast field's LSB (toe_quantum: 2^4 s
    for GPS LNAV nav_message.SF2_FIELDS, 60 s for Galileo I/NAV
    inav_words word 1) so encode/decode through the bit layout is
    exact.
    """
    p = np.asarray(pos_ecef, np.float64)
    rcv = np.asarray(receiver_ecef, np.float64)
    r = float(np.linalg.norm(p))
    p_hat = p / r
    los = p - rcv
    l_hat = los / np.linalg.norm(los)
    # The range rate seen by an ECEF-fixed receiver is (v_in − Ωe ẑ×p)·L̂
    # (the ephemeris algorithm rotates the orbit into ECEF, so the
    # effective ECEF velocity carries the −Ωe ẑ×p term). Pick the
    # inertial tangential direction, v_in = s(cosφ ê1 + sinφ ê2) ⟂ p̂
    # with s = n·r, that makes it equal the target:
    # s(a1 cosφ + a2 sinφ) = w where w = Ωe (ẑ×p)·L̂ + rdot_target.
    n_mot0 = math.sqrt(MU / r ** 3)
    s = n_mot0 * r
    e1 = np.cross(p_hat, [0.0, 0.0, 1.0])
    if np.linalg.norm(e1) < 1e-9:
        e1 = np.cross(p_hat, [1.0, 0.0, 0.0])
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(p_hat, e1)
    a1, a2 = float(e1 @ l_hat), float(e2 @ l_hat)
    w = (OMEGA_E * float(np.cross([0.0, 0.0, 1.0], p) @ l_hat)
         + float(range_rate_mps))
    amp = s * math.hypot(a1, a2)
    phi0 = math.atan2(a2, a1)
    if amp > 1e-9 and abs(w) <= amp:
        phi = phi0 + math.acos(w / amp)
    else:  # degenerate geometry: best-effort minimum |v_ecef·L̂|
        phi = phi0 + math.pi / 2.0
    v_hat = math.cos(phi) * e1 + math.sin(phi) * e2
    h_hat = np.cross(p_hat, v_hat)  # orbit normal (motion along +v_hat)
    i0 = math.acos(float(np.clip(h_hat[2], -1.0, 1.0)))
    node = np.cross([0.0, 0.0, 1.0], h_hat)
    nn = np.linalg.norm(node)
    node = node / nn if nn > 1e-12 else np.array([1.0, 0.0, 0.0])
    # argument of latitude of p measured from the ascending node
    u = math.atan2(float(np.dot(np.cross(node, p_hat), h_hat)),
                   float(np.dot(node, p_hat)))
    lam_node = math.atan2(node[1], node[0])  # ECEF longitude at t_eval
    toe = float(np.clip(round(t_eval / toe_quantum) * toe_quantum,
                        0.0, 604800.0 - toe_quantum))
    n_mot = math.sqrt(MU / r ** 3)
    m0 = math.remainder(u - n_mot * (t_eval - toe), 2 * math.pi)
    omega0 = math.remainder(lam_node + OMEGA_E * t_eval, 2 * math.pi)
    return BroadcastEphemeris(
        prn=prn, toe=toe, sqrt_a=math.sqrt(r), e=0.0, i0=i0,
        omega0=omega0, omega=0.0, m0=m0, delta_n=0.0, idot=0.0,
        omega_dot=0.0, af0=af0, af1=af1, af2=af2)
