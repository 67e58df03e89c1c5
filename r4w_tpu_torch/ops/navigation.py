"""Inertial navigation and state-estimation fills.

PyTorch counterpart of ``r4w_tpu.ops.navigation``
(quaternion_attitude_tracker.rs, imu_aided_tracking.rs,
inertial_nav_processor.rs, particle_filter_tracker.rs,
magnetometer_vector_rotator.rs, digital_twin_state_observer.rs,
spatio_temporal_fusion.rs), on the inputs' device.

The Mahony filter, the strapdown integration, the particle filter and the
Luenberger observer are the reference's ``lax.scan`` recursions, so they
are step loops here, batched over leading rows (a row is one track; its
result is the reference's on that row) with the carried state a tensor on
the device and no host read inside the loop. The reference's compiled
step fuses the integrations q + dq·dt, v + a·dt and p + v·dt into single
multiply-adds; the loops round them once too (`core.hostio.fma`). Norms
take their root in float64 and round once, the correctly rounded root of
the reference's.

The particle filter splits its key as the reference does (one split for
the start, one split into three at every step) and draws JAX's own
normals and uniforms with `channel.threefry` on the host before the loop;
they are uploaded once. Its weights are a softmax with the maximum
subtracted, the resampling edges a cumulative sum accumulated in float64
and rounded once (`filters._cumsum`), searched with the left side's rule
and clipped, as ``jnp.searchsorted`` is. An edge an ulp away from the
reference's float32 cumulative sum can move a resampled index, so the
track is held to the reference within a tolerance, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from r4w_tpu_torch.channel import threefry
from r4w_tpu_torch.core.hostio import fma
from r4w_tpu_torch.core.types import REAL_DTYPE, real_scalar, to_tensor
from r4w_tpu_torch.ops.filters import _cumsum

# ---------------------------------------------------------- quaternion


def quat_multiply(q1, q2):
    q1, q2 = to_tensor(q1), to_tensor(q2)
    q2 = q2.to(q1.device)
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(torch.broadcast_tensors(
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ), dim=-1)


def _conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=REAL_DTYPE, device=q.device)


def quat_rotate(q, v):
    """Rotate vector(s) v by quaternion q (body→nav)."""
    q = to_tensor(q, REAL_DTYPE)
    v = to_tensor(v, REAL_DTYPE, device=q.device)
    qv = torch.cat([v.new_zeros(v.shape[:-1] + (1,)), v], dim=-1)
    return quat_multiply(quat_multiply(q, qv), _conjugate(q))[..., 1:]


def quat_to_euler(q):
    """Quaternion → roll/pitch/yaw (rad)."""
    q = to_tensor(q, REAL_DTYPE)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return roll, pitch, yaw


def _norm(v: torch.Tensor) -> torch.Tensor:
    """‖v‖ over the last axis, keepdim: the sum of squares in float32, its
    root in float64 rounded once (a correctly rounded float32 root)."""
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True).double()).to(REAL_DTYPE)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _integrate(state: torch.Tensor, rate: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
    """state + rate·dt rounded once, as the reference's compiled step fuses it."""
    return fma(rate, dt.expand_as(rate), state)


def _start(q0, shape, device) -> torch.Tensor:
    if q0 is None:
        q0 = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=REAL_DTYPE, device=device)
    return to_tensor(q0, REAL_DTYPE, device=device).expand(shape + (4,)).clone()


def _stack(steps: list, like: torch.Tensor, width: int) -> torch.Tensor:
    """The per-step outputs on the step axis (-2): (..., N, width)."""
    if not steps:
        return like.new_zeros(like.shape[:-2] + (0, width))
    return torch.stack(steps, dim=-2)


def attitude_track_mahony(gyro_rad_s, accel_mps2, dt: float,
                          kp: float = 1.0, q0=None):
    """Mahony complementary attitude filter
    (quaternion_attitude_tracker.rs): gyro integration corrected
    toward the accelerometer gravity direction. Returns the (..., N, 4)
    quaternion track of gyro and accel (..., N, 3)."""
    g = to_tensor(gyro_rad_s, REAL_DTYPE)
    a = to_tensor(accel_mps2, REAL_DTYPE, device=g.device)
    a = a / torch.clamp(_norm(a), min=1e-9)
    q = _start(q0, g.shape[:-2], g.device)
    down = torch.tensor([0.0, 0.0, 1.0], dtype=REAL_DTYPE, device=g.device)
    zero = g.new_zeros(g.shape[:-2] + (1,))
    step_dt = real_scalar(dt, g.device)
    track = []
    for t in range(g.shape[-2]):
        # estimated gravity in body frame: rotate nav-down by q⁻¹
        v = quat_rotate(_conjugate(q), down)
        err = _cross(a[..., t, :], v)
        w_corr = g[..., t, :] + kp * err
        dq = 0.5 * quat_multiply(q, torch.cat([zero, w_corr], dim=-1))
        q = _integrate(q, dq, step_dt)
        q = q / torch.clamp(_norm(q), min=1e-9)
        track.append(q)
    return _stack(track, g, 4)


# ------------------------------------------------------------ strapdown


def strapdown_integrate(accel_body, gyro_rad_s, dt: float,
                        q0=None, v0=None, p0=None,
                        gravity: float = 9.81):
    """Strapdown inertial navigation (inertial_nav_processor.rs):
    attitude from gyro, specific force rotated to nav frame, gravity
    removed, double-integrated. Returns (positions, velocities,
    quaternions), each (..., N, ·)."""
    a = to_tensor(accel_body, REAL_DTYPE)
    g = to_tensor(gyro_rad_s, REAL_DTYPE, device=a.device)
    lead = a.shape[:-2]
    q = _start(q0, lead, a.device)
    v = (a.new_zeros(lead + (3,)) if v0 is None
         else to_tensor(v0, REAL_DTYPE, device=a.device).expand(lead + (3,)).clone())
    p = (a.new_zeros(lead + (3,)) if p0 is None
         else to_tensor(p0, REAL_DTYPE, device=a.device).expand(lead + (3,)).clone())
    grav = torch.tensor([0.0, 0.0, -gravity], dtype=REAL_DTYPE, device=a.device)
    zero = a.new_zeros(lead + (1,))
    step_dt = real_scalar(dt, a.device)
    ps, vs, qs = [], [], []
    for t in range(a.shape[-2]):
        dq = 0.5 * quat_multiply(q, torch.cat([zero, g[..., t, :]], dim=-1))
        q = _integrate(q, dq, step_dt)
        q = q / torch.clamp(_norm(q), min=1e-9)
        a_nav = quat_rotate(q, a[..., t, :]) + grav
        v = _integrate(v, a_nav, step_dt)
        p = _integrate(p, v, step_dt)
        ps.append(p)
        vs.append(v)
        qs.append(q)
    return _stack(ps, a, 3), _stack(vs, a, 3), _stack(qs, a, 4)


def imu_aided_update(ins_pos, ins_vel, fix_pos, fix_weight: float = 0.2):
    """Loose GNSS/INS aiding step (imu_aided_tracking.rs):
    complementary blend of the INS solution toward the fix."""
    p = to_tensor(ins_pos, REAL_DTYPE)
    f = to_tensor(fix_pos, REAL_DTYPE, device=p.device)
    blended = (1.0 - fix_weight) * p + fix_weight * f
    return blended, to_tensor(ins_vel, REAL_DTYPE, device=p.device)


def magnetometer_rotate(mag_body, q):
    """Body→nav magnetometer rotation + heading
    (magnetometer_vector_rotator.rs)."""
    q = to_tensor(q, REAL_DTYPE)
    m_nav = quat_rotate(q, to_tensor(mag_body, REAL_DTYPE, device=q.device))
    heading = torch.atan2(-m_nav[..., 1], m_nav[..., 0])
    return m_nav, heading


# ------------------------------------------------------ particle filter


def particle_draws(key, n_particles: int, steps: int):
    """The reference's draws for `particle_filter_track` under `key` (a
    `channel.threefry` key; any two-int sequence): the start's position and
    velocity normals (n_particles each), then each step's process-noise
    normals (steps, n_particles) and resampling uniform (steps,), from the
    key chain key → split → split into three at every step."""
    key = tuple(int(k) for k in key)
    k1, k2 = threefry.split(key)
    pos0 = threefry.normal(k1, (n_particles,))
    vel0 = threefry.normal(k2, (n_particles,))
    carry = threefry.split(key)[0]
    noise = np.empty((steps, n_particles), np.float32)
    uniform = np.empty(steps, np.float32)
    for t in range(steps):
        carry, kq, kr = threefry.split(carry, 3)
        noise[t] = threefry.normal(kq, (n_particles,))
        uniform[t] = threefry.uniform(kr, ())
    return pos0, vel0, noise, uniform


def particle_filter_track(measurements, key, n_particles: int = 512,
                          q_std: float = 0.1, r_std: float = 1.0):
    """Bootstrap particle filter for a 1-D constant-velocity target
    (particle_filter_tracker.rs): predict → weight → systematic
    resample, all ensemble ops batched. Returns the posterior-mean
    track of measurements (..., T); every row draws the key's numbers."""
    z = to_tensor(measurements, REAL_DTYPE)
    dev = z.device
    steps = z.shape[-1]
    pos0, vel0, noise, uniform = (torch.from_numpy(np.asarray(d, np.float32)).to(dev)
                                  for d in particle_draws(key, n_particles, steps))
    lead = z.shape[:-1]
    n = n_particles
    pos = (z[..., :1] + r_std * pos0).expand(lead + (n,))
    vel = vel0.expand(lead + (n,))
    r = real_scalar(r_std, dev)
    count = real_scalar(float(n), dev)
    ramp = torch.arange(n, dtype=REAL_DTYPE, device=dev)
    track = []
    for t in range(steps):
        vel = fma(real_scalar(q_std, dev).expand(lead + (n,)), noise[t].expand(lead + (n,)),
                  vel)
        pos = pos + vel
        logw = -0.5 * ((z[..., t:t + 1] - pos) / r) ** 2
        w = torch.softmax(logw, dim=-1)
        track.append(torch.sum(w * pos, dim=-1))
        # systematic resampling
        edges = _cumsum(w)
        u = (uniform[t] + ramp) / count
        idx = torch.clamp(torch.searchsorted(edges, u.expand(lead + (n,)).contiguous()),
                          0, n - 1)
        pos = torch.gather(pos, -1, idx)
        vel = torch.gather(vel, -1, idx)
    if not track:
        return z.new_zeros(z.shape)
    return torch.stack(track, dim=-1)


# ------------------------------------------------------- observers


def _matvec(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """m @ x of a small matrix (n, k) and vectors x (..., k), as elementwise
    products summed (no TF32, no matmul)."""
    return torch.sum(m * x[..., None, :], dim=-1)


def luenberger_observe(measurements, a, b, c, l_gain, u=None):
    """Digital-twin state observer (digital_twin_state_observer.rs):
    x̂ₖ₊₁ = A x̂ₖ + B uₖ + L(yₖ − C x̂ₖ). Returns the state track
    (..., T, n) of scalar measurements (..., T) and inputs (..., T, p)."""
    y = to_tensor(measurements, REAL_DTYPE)
    dev = y.device
    a = to_tensor(a, REAL_DTYPE, device=dev)
    b = to_tensor(b, REAL_DTYPE, device=dev)
    c = to_tensor(c, REAL_DTYPE, device=dev)
    l_g = to_tensor(l_gain, REAL_DTYPE, device=dev)
    n = a.shape[0]
    lead = y.shape[:-1]
    u = (y.new_zeros(lead + (y.shape[-1], b.shape[1])) if u is None
         else to_tensor(u, REAL_DTYPE, device=dev))
    x = y.new_zeros(lead + (n,))
    xs = []
    for t in range(y.shape[-1]):
        innov = y[..., t] - torch.sum(c * x, dim=-1)
        x = _matvec(a, x) + _matvec(b, u[..., t, :]) + l_g * innov[..., None]
        xs.append(x)
    return _stack(xs, y[..., None], n)


def spatio_temporal_fuse(sensor_tracks, sensor_vars):
    """Variance-weighted multi-sensor track fusion
    (spatio_temporal_fusion.rs): per-time-step inverse-variance
    weighting across sensors. tracks: (S, T[, D])."""
    x = to_tensor(sensor_tracks, REAL_DTYPE)
    v = to_tensor(sensor_vars, REAL_DTYPE, device=x.device)
    w = 1.0 / torch.clamp(v, min=1e-12)
    while w.ndim < x.ndim:
        w = w[..., None]
    fused = torch.sum(x * w, dim=0) / torch.sum(w, dim=0)
    fused_var = 1.0 / torch.sum(1.0 / torch.clamp(v, min=1e-12), dim=0)
    return fused, fused_var


BLOCKS = {
    "quaternion_attitude_tracker": ("attitude_track_mahony", "math",
                                    "Mahony complementary filter "
                                    "(quaternion_attitude_"
                                    "tracker.rs)", ("dt", "kp")),
    "inertial_nav_processor": ("strapdown_integrate", "math",
                               "strapdown INS integration "
                               "(inertial_nav_processor.rs)",
                               ("dt", "gravity")),
    "imu_aided_tracking": ("imu_aided_update", "math",
                           "loose GNSS/INS blend "
                           "(imu_aided_tracking.rs)",
                           ("fix_weight",)),
    "magnetometer_vector_rotator": ("magnetometer_rotate", "math",
                                    "body->nav + heading "
                                    "(magnetometer_vector_"
                                    "rotator.rs)"),
    "particle_filter_tracker": ("particle_filter_track", "math",
                                "bootstrap PF, batched ensemble "
                                "(particle_filter_tracker.rs)",
                                ("n_particles", "q_std", "r_std")),
    "digital_twin_state_observer": ("luenberger_observe", "math",
                                    "Luenberger observer "
                                    "(digital_twin_state_"
                                    "observer.rs)"),
    "spatio_temporal_fusion": ("spatio_temporal_fuse", "math",
                               "inverse-variance track fusion "
                               "(spatio_temporal_fusion.rs)"),
}
