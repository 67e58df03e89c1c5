"""Kalman-family state estimators (kalman_filter.rs,
unscented_kalman_filter.rs).

PyTorch counterpart of ``r4w_tpu.ops.kalman``: a filter is
``(params, measurements) -> (states, covs)``, a step loop over time, as
the reference's ``lax.scan`` is, each step a handful of small float32
matrix products (no TF32: the port never enables it). The solves and the
Cholesky factor are ``torch.linalg``'s. `ukf_filter` takes torch
callables for the process and measurement models, applied to each sigma
point.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from r4w_tpu_torch.core.types import REAL_DTYPE, resolve_device, to_tensor


@dataclasses.dataclass(frozen=True)
class KalmanParams:
    """Linear-Gaussian model x' = F x + w, z = H x + v.

    Matrices are (n,n), (m,n), (n,n), (m,m) (kalman_filter.rs:126 layout).
    """

    f: torch.Tensor
    h: torch.Tensor
    q: torch.Tensor
    r: torch.Tensor

    @staticmethod
    def constant_velocity(dt: float, q_accel: float, r_meas: float,
                          device=None) -> "KalmanParams":
        """2-state position/velocity tracker (kalman_filter.rs new_2d role)."""
        device = resolve_device(device)
        f = torch.tensor([[1.0, dt], [0.0, 1.0]], dtype=REAL_DTYPE, device=device)
        h = torch.tensor([[1.0, 0.0]], dtype=REAL_DTYPE, device=device)
        g = torch.tensor([[0.5 * dt * dt], [dt]], dtype=REAL_DTYPE, device=device)
        q = q_accel * (g @ g.T)
        r = torch.tensor([[r_meas]], dtype=REAL_DTYPE, device=device)
        return KalmanParams(f, h, q, r)

    @staticmethod
    def scalar(process_var: float, meas_var: float, device=None) -> "KalmanParams":
        """1-state tracker (kalman_filter.rs new_1d)."""
        eye = torch.ones((1, 1), dtype=REAL_DTYPE, device=resolve_device(device))
        return KalmanParams(eye, eye, process_var * eye, meas_var * eye)


def kalman_step(p: KalmanParams, x, cov, z):
    """One predict + update. x (n,), cov (n,n), z (m,) -> (x', cov')."""
    x_pred = p.f @ x
    cov_pred = p.f @ cov @ p.f.T + p.q
    innov = z - p.h @ x_pred
    s = p.h @ cov_pred @ p.h.T + p.r
    k = torch.linalg.solve(s, p.h @ cov_pred).T  # (n, m)
    x_new = x_pred + k @ innov
    eye = torch.eye(x.shape[0], dtype=cov.dtype, device=cov.device)
    cov_new = (eye - k @ p.h) @ cov_pred
    return x_new, cov_new


def _measurements(measurements, device) -> torch.Tensor:
    z = to_tensor(measurements, REAL_DTYPE, device=device)
    return z[:, None] if z.ndim == 1 else z


def kalman_filter(p: KalmanParams, measurements, x0=None, cov0=None):
    """Run the filter over (T, m) measurements -> states (T, n), covs
    (T, n, n). A scalar stream (T,) is lifted to (T, 1)."""
    dev = p.f.device
    z = _measurements(measurements, dev)
    n = p.f.shape[0]
    x = (torch.zeros(n, dtype=REAL_DTYPE, device=dev) if x0 is None
         else to_tensor(x0, REAL_DTYPE, device=dev))
    cov = (torch.eye(n, dtype=REAL_DTYPE, device=dev) if cov0 is None
           else to_tensor(cov0, REAL_DTYPE, device=dev))
    xs, covs = [], []
    for t in range(z.shape[0]):
        x, cov = kalman_step(p, x, cov, z[t])
        xs.append(x)
        covs.append(cov)
    return torch.stack(xs), torch.stack(covs)


# ---------------------------------------------------------------- UKF


@dataclasses.dataclass(frozen=True)
class UkfParams:
    """Unscented transform weights (unscented_kalman_filter.rs:107)."""

    alpha: float = 1e-1
    beta: float = 2.0
    kappa: float = 0.0


def _sigma_points(x, cov, lam):
    n = x.shape[0]
    # a Cholesky factor of (n + λ)·P, guarded by a small ridge
    eye = torch.eye(n, dtype=cov.dtype, device=cov.device)
    a = torch.linalg.cholesky((n + lam) * (cov + 1e-9 * eye))
    return torch.cat([x[None, :], x[None, :] + a.T, x[None, :] - a.T], dim=0)  # (2n+1, n)


def _ut_weights(n: int, p: UkfParams, device):
    lam = p.alpha ** 2 * (n + p.kappa) - n
    wm = torch.full((2 * n + 1,), 1.0 / (2 * (n + lam)), dtype=REAL_DTYPE, device=device)
    wm[0] = lam / (n + lam)
    wc = wm.clone()
    wc[0] = wc[0] + (1.0 - p.alpha ** 2 + p.beta)
    return lam, wm, wc


def _each(fn: Callable, pts: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.as_tensor(fn(pt), dtype=REAL_DTYPE, device=pts.device).reshape(-1)
                        for pt in pts])


def ukf_step(fx: Callable, hx: Callable, q, r, x, cov, z, params: UkfParams = UkfParams()):
    """One UKF predict + update with process fx(x) -> x' and measurement
    hx(x) -> z (unscented_kalman_filter.rs:143,182 semantics)."""
    n = x.shape[0]
    lam, wm, wc = _ut_weights(n, params, x.device)
    pts_f = _each(fx, _sigma_points(x, cov, lam))
    x_pred = wm @ pts_f
    d = pts_f - x_pred
    cov_pred = torch.einsum("i,ij,ik->jk", wc, d, d) + q
    pts2 = _sigma_points(x_pred, cov_pred, lam)
    pts_h = _each(hx, pts2)
    z_pred = wm @ pts_h
    dz = pts_h - z_pred
    dx = pts2 - x_pred
    s = torch.einsum("i,ij,ik->jk", wc, dz, dz) + r
    c = torch.einsum("i,ij,ik->jk", wc, dx, dz)
    k = torch.linalg.solve(s.T, c.T).T
    return x_pred + k @ (z - z_pred), cov_pred - k @ s @ k.T


def ukf_filter(fx: Callable, hx: Callable, q, r, measurements, x0, cov0,
               params: UkfParams = UkfParams(), device=None):
    """Run the UKF over (T, m) measurements -> states (T, n), covs (T, n, n)."""
    x = to_tensor(x0, REAL_DTYPE, device=device)
    dev = x.device
    z = _measurements(measurements, dev)
    q = to_tensor(q, REAL_DTYPE, device=dev)
    r = to_tensor(r, REAL_DTYPE, device=dev)
    cov = to_tensor(cov0, REAL_DTYPE, device=dev)
    xs, covs = [], []
    for t in range(z.shape[0]):
        x, cov = ukf_step(fx, hx, q, r, x, cov, z[t], params)
        xs.append(x)
        covs.append(cov)
    return torch.stack(xs), torch.stack(covs)


def nees(xs, covs, truth):
    """Normalised estimation error squared (unscented_kalman_filter.rs:316)."""
    xs = to_tensor(xs, REAL_DTYPE)
    e = xs - to_tensor(truth, REAL_DTYPE, device=xs.device)
    covs = to_tensor(covs, REAL_DTYPE, device=xs.device)
    return torch.sum(e * torch.linalg.solve(covs, e[..., None])[..., 0], dim=-1)
