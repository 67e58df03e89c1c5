"""Measurement ops: EVM, SNR and the BER tooling.

PyTorch counterpart of the BER half of ``r4w_tpu.ops.measure``: EVM, the
M2M4 SNR estimator, bit-error counting, the Wilson confidence interval
(numpy, on the host) and the closed-form AWGN bit error rates, in float32
with `torch.special.erfc`. Functions follow the device of a tensor input;
other inputs go to `resolve_device(device)`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, real_scalar, to_tensor


def evm_rms(received, reference, normalize: bool = True):
    """RMS error-vector magnitude, optionally normalised by the reference's
    RMS; a linear ratio (×100 = %)."""
    rx = to_tensor(received, IQ_DTYPE)
    ref = to_tensor(reference, IQ_DTYPE, rx.device)
    err = rx - ref
    e = torch.sqrt(torch.mean(err.real ** 2 + err.imag ** 2, dim=-1))
    if normalize:
        p = torch.sqrt(torch.mean(ref.real ** 2 + ref.imag ** 2, dim=-1))
        return e / torch.clamp_min(p, 1e-12)
    return e


def snr_estimate_m2m4(x):
    """Blind M2M4 SNR estimate in dB for constant-modulus signals:
    SNR = sqrt(2·M2² − M4) / (M2 − sqrt(2·M2² − M4))."""
    x = to_tensor(x, IQ_DTYPE)
    p = x.real ** 2 + x.imag ** 2
    m2 = torch.mean(p, dim=-1)
    m4 = torch.mean(p ** 2, dim=-1)
    s = torch.sqrt(torch.clamp_min(2.0 * m2 ** 2 - m4, 0.0))
    n = torch.clamp_min(m2 - s, 1e-12)
    return 10.0 * torch.log10(torch.clamp_min(s / n, 1e-12))


def ber_count(tx_bits, rx_bits):
    """(errors (...,) int64, total) over the common length."""
    tx = to_tensor(tx_bits)
    rx = to_tensor(rx_bits, device=tx.device)
    n = min(tx.shape[-1], rx.shape[-1])
    errs = torch.sum(tx[..., :n] != rx[..., :n], dim=-1, dtype=torch.int64)
    return errs, n


def _norm_ppf(p: float) -> float:
    """Inverse normal CDF (Acklam's approximation)."""
    a = [-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        q = np.sqrt(-2 * np.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
               ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if p <= phigh:
        q = p - 0.5
        r = q * q
        return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / \
               (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)
    q = np.sqrt(-2 * np.log(1 - p))
    return -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
           ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)


def ber_confidence_interval(errors: int, total: int, confidence: float = 0.95):
    """Wilson score interval for a BER measurement."""
    if total == 0:
        return 0.0, 1.0
    z = _norm_ppf(1.0 - (1.0 - confidence) / 2.0)
    p = errors / total
    denom = 1.0 + z * z / total
    center = (p + z * z / (2 * total)) / denom
    half = z * np.sqrt(p * (1 - p) / total + z * z / (4 * total * total)) / denom
    return max(0.0, center - half), min(1.0, center + half)


def _ebn0_linear(ebn0_db, device) -> torch.Tensor:
    """10^(dB/10) in float32; the divisor is a float32 tensor, as the
    reference divides (see `real_scalar`)."""
    db = to_tensor(ebn0_db, REAL_DTYPE, device)
    return 10.0 ** (db / real_scalar(10.0, db.device))


def _q(x: torch.Tensor) -> torch.Tensor:
    """Gaussian tail Q(x) = ½·erfc(x/√2), x/√2 a float32 division."""
    return 0.5 * torch.special.erfc(x / real_scalar(math.sqrt(2.0), x.device))


def theoretical_ber_bpsk(ebn0_db, device=None):
    return 0.5 * torch.special.erfc(torch.sqrt(_ebn0_linear(ebn0_db, device)))


def theoretical_ber_qpsk(ebn0_db, device=None):
    return theoretical_ber_bpsk(ebn0_db, device)


def theoretical_ber_mpsk(ebn0_db, m: int, device=None):
    """Gray-coded M-PSK bit error rate.

    Exact for M = 2, 4; the nearest-neighbour approximation
    Pb ≈ (2/k)·Q(√(2k·γb)·sin(π/M)) for M ≥ 8 (tight for Pb ≲ 1e-2).
    """
    if m in (2, 4):
        return theoretical_ber_bpsk(ebn0_db, device)
    k = math.log2(m)
    e = _ebn0_linear(ebn0_db, device) * k
    arg = torch.sqrt(2.0 * e) * math.sin(math.pi / m)
    return 2.0 * _q(arg) / k


def theoretical_ber_fsk_noncoherent(ebn0_db, device=None):
    """Noncoherent orthogonal BFSK: Pb = ½·exp(−γb/2)."""
    return 0.5 * torch.exp(-_ebn0_linear(ebn0_db, device) / 2.0)


def theoretical_ber_mqam_exact(ebn0_db, m: int, device=None):
    """Exact Gray-coded square M-QAM bit error rate (Cho & Yoon 2002, "On
    the general BER expression of one- and two-dimensional amplitude
    modulations"): both dimensions are √M-PAM, and the exact per-bit
    error probabilities are averaged."""
    gamma = _ebn0_linear(ebn0_db, device)
    k_tot = int(np.log2(m))
    sqrt_m = int(round(np.sqrt(m)))
    k_dim = int(np.log2(sqrt_m))
    base = torch.sqrt(3.0 * k_tot * gamma / (m - 1.0))
    total = torch.zeros_like(gamma)
    for k in range(1, k_dim + 1):
        n_terms = int((1 - 2.0 ** (-k)) * sqrt_m)
        for i in range(n_terms):
            f = math.floor(i * 2.0 ** (k - 1) / sqrt_m)
            w = ((-1.0) ** f) * (2.0 ** (k - 1) - math.floor(i * 2.0 ** (k - 1) / sqrt_m + 0.5))
            total = total + (2.0 / sqrt_m) * w * _q((2 * i + 1) * base)
    return total / k_dim


def theoretical_ber_mqam(ebn0_db, m: int, device=None):
    """Gray-coded square M-QAM approximation."""
    k = math.log2(m)
    e = _ebn0_linear(ebn0_db, device) * k
    arg = torch.sqrt(3.0 * e / (m - 1))
    return 4.0 * (1.0 - 1.0 / math.sqrt(m)) * _q(arg) / k
