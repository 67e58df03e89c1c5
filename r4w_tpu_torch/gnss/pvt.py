"""PVT: position/velocity/time solution from pseudoranges.

The navigation-solution capstone over the GNSS stack (the reference
stops at tracking + coordinates; this closes the loop from correlator
outputs to a fix): iterative Gauss-Newton least squares on
ρ_i = |p_sat,i − p| + c·b  with 4 unknowns (ECEF position + receiver
clock bias), the matching linear velocity/clock-drift solve from range
rates, and DOP factors from the geometry matrix.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from r4w_tpu_torch.gnss.coordinates import ecef_to_enu_matrix, ecef_to_lla

SPEED_OF_LIGHT = 299_792_458.0


@dataclasses.dataclass
class PvtSolution:
    position_ecef: np.ndarray      # (3,) m
    clock_bias_m: float            # c·dt (meters)
    velocity_ecef: np.ndarray | None  # (3,) m/s
    clock_drift_mps: float | None
    residuals_m: np.ndarray        # (N,) post-fit
    gdop: float
    pdop: float
    hdop: float
    vdop: float
    iterations: int
    # multi-constellation solves: c·dt per system label (the first
    # system's bias also lands in clock_bias_m); None for single-system
    system_biases_m: dict | None = None

    @property
    def lla(self) -> np.ndarray:
        return np.asarray(ecef_to_lla(self.position_ecef))


def solve_position(sat_positions, pseudoranges, x0=None,
                   max_iter: int = 10, tol_m: float = 1e-4
                   ) -> PvtSolution:
    """Gauss-Newton point solution. sat_positions (N,3) ECEF m,
    pseudoranges (N,) m. Needs N >= 4."""
    sats = np.asarray(sat_positions, np.float64)
    rho = np.asarray(pseudoranges, np.float64)
    n = len(rho)
    if n < 4:
        raise ValueError("PVT needs >= 4 satellites")
    x = np.zeros(4) if x0 is None else np.concatenate(
        [np.asarray(x0, np.float64), [0.0]])
    it = 0
    for it in range(1, max_iter + 1):
        d = sats - x[:3]
        r = np.linalg.norm(d, axis=1)
        pred = r + x[3]
        resid = rho - pred
        # Jacobian: ∂ρ/∂p = −unit vector, ∂ρ/∂(cb) = 1
        g = np.concatenate([-d / r[:, None], np.ones((n, 1))], axis=1)
        dx, *_ = np.linalg.lstsq(g, resid, rcond=None)
        x = x + dx
        if np.linalg.norm(dx[:3]) < tol_m:
            break

    d = sats - x[:3]
    r = np.linalg.norm(d, axis=1)
    resid = rho - (r + x[3])
    g = np.concatenate([-d / r[:, None], np.ones((n, 1))], axis=1)
    q = np.linalg.inv(g.T @ g)
    gdop = float(np.sqrt(np.trace(q)))
    pdop = float(np.sqrt(np.trace(q[:3, :3])))
    # horizontal/vertical in the local ENU frame
    lla = np.asarray(ecef_to_lla(x[:3]))
    m = np.asarray(ecef_to_enu_matrix(lla[0], lla[1]))
    q_enu = m @ q[:3, :3] @ m.T
    hdop = float(np.sqrt(q_enu[0, 0] + q_enu[1, 1]))
    vdop = float(np.sqrt(q_enu[2, 2]))
    return PvtSolution(position_ecef=x[:3], clock_bias_m=float(x[3]),
                       velocity_ecef=None, clock_drift_mps=None,
                       residuals_m=resid, gdop=gdop, pdop=pdop,
                       hdop=hdop, vdop=vdop, iterations=it)


def solve_position_multi(sat_positions, pseudoranges, systems,
                         x0=None, max_iter: int = 10,
                         tol_m: float = 1e-4) -> PvtSolution:
    """Joint multi-constellation Gauss-Newton fix: 3 position unknowns
    plus ONE receiver clock-bias state PER SYSTEM (the standard
    inter-system-bias / GGTO formulation — each constellation's time
    base and receiver-chain group delay folds into its own c·dt).

    systems: length-N sequence of hashable labels (e.g. "gps"/"gal").
    Needs N >= 3 + n_systems. DOP factors are computed from the
    position block of the full (3+K)-state geometry matrix.
    """
    sats = np.asarray(sat_positions, np.float64)
    rho = np.asarray(pseudoranges, np.float64)
    labels = list(systems)
    n = len(rho)
    order = list(dict.fromkeys(labels))          # first-seen order
    k = len(order)
    ind = np.zeros((n, k))
    for i, lab in enumerate(labels):
        ind[i, order.index(lab)] = 1.0
    if n < 3 + k:
        raise ValueError(f"multi-system PVT needs >= {3 + k} satellites")
    x = np.zeros(3 + k)
    if x0 is not None:
        x[:3] = np.asarray(x0, np.float64)
    it = 0
    for it in range(1, max_iter + 1):
        d = sats - x[:3]
        r = np.linalg.norm(d, axis=1)
        resid = rho - (r + ind @ x[3:])
        g = np.concatenate([-d / r[:, None], ind], axis=1)
        dx, *_ = np.linalg.lstsq(g, resid, rcond=None)
        x = x + dx
        if np.linalg.norm(dx[:3]) < tol_m:
            break

    d = sats - x[:3]
    r = np.linalg.norm(d, axis=1)
    resid = rho - (r + ind @ x[3:])
    g = np.concatenate([-d / r[:, None], ind], axis=1)
    q = np.linalg.inv(g.T @ g)
    gdop = float(np.sqrt(np.trace(q[:4, :4])))
    pdop = float(np.sqrt(np.trace(q[:3, :3])))
    lla = np.asarray(ecef_to_lla(x[:3]))
    m = np.asarray(ecef_to_enu_matrix(lla[0], lla[1]))
    q_enu = m @ q[:3, :3] @ m.T
    hdop = float(np.sqrt(q_enu[0, 0] + q_enu[1, 1]))
    vdop = float(np.sqrt(q_enu[2, 2]))
    return PvtSolution(
        position_ecef=x[:3], clock_bias_m=float(x[3]),
        velocity_ecef=None, clock_drift_mps=None, residuals_m=resid,
        gdop=gdop, pdop=pdop, hdop=hdop, vdop=vdop, iterations=it,
        system_biases_m={lab: float(x[3 + j])
                         for j, lab in enumerate(order)})


def solve_velocity(solution: PvtSolution, sat_positions, sat_velocities,
                   range_rates) -> PvtSolution:
    """Linear velocity + clock-drift solve from measured range rates
    (e.g. Doppler·λ): ρ̇_i = u_i·(v_sat,i − v) + ḃ."""
    sats = np.asarray(sat_positions, np.float64)
    svel = np.asarray(sat_velocities, np.float64)
    rr = np.asarray(range_rates, np.float64)
    d = sats - solution.position_ecef
    r = np.linalg.norm(d, axis=1)
    u = d / r[:, None]
    # rr_i = u_i · (v_sat − v_rx) + drift
    b = rr - np.sum(u * svel, axis=1)
    g = np.concatenate([-u, np.ones((len(rr), 1))], axis=1)
    sol, *_ = np.linalg.lstsq(g, b, rcond=None)
    return dataclasses.replace(solution, velocity_ecef=sol[:3],
                               clock_drift_mps=float(sol[3]))


def pseudoranges_from_code_phase(code_phases_chips, chip_rate_hz: float,
                                 transit_time_ms,
                                 code_period_ms: float = 1.0
                                 ) -> np.ndarray:
    """Code-phase (sub-ms) + integer-ms transit counts -> pseudoranges.

    The tracking loop gives the sub-millisecond part; the integer
    milliseconds come from nav-data framing (or are supplied by a
    coarse position in cold start)."""
    frac_ms = (np.asarray(code_phases_chips, np.float64)
               / chip_rate_hz * 1e3) % code_period_ms
    total_ms = np.asarray(transit_time_ms, np.float64) + frac_ms
    return total_ms * 1e-3 * SPEED_OF_LIGHT
