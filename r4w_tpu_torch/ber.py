"""Batched BER-vs-theory acceptance gates.

PyTorch counterpart of ``r4w_tpu.ber``: every scheme runs its bits as one
(points × symbols × constellation) tensor program, and the gate holds the
measured BER to the closed-form Gray-coded AWGN curves (within 10%).

* `linear_ber_monte_carlo`: constellation level (map → AWGN → nearest
  point → count), which checks the Gray maps, the constellation
  normalisation and the noise calibration against closed forms.
* `waveform_ber_monte_carlo`: the `Waveform` classes through
  `channel.awgn`, the per-sample SNR converted to Eb/N0 by the
  samples-per-symbol integration gain.

Randomness comes from a `torch.Generator` (Philox on the card) seeded from
`seed`; it gives other draws than the reference's `jax.random`, so the
Monte-Carlo functions also take the draws themselves (`values=`,
`noise=`), a hook for tests that feed both packages the same numbers. Bit
errors are counted in int64. Every entry point runs on the CUDA card unless
the caller names another device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from r4w_tpu_torch.channel import awgn
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, resolve_device, to_tensor
from r4w_tpu_torch.ops.measure import (
    _ebn0_linear,
    ber_confidence_interval,
    theoretical_ber_bpsk,
    theoretical_ber_fsk_noncoherent,
    theoretical_ber_mpsk,
    theoretical_ber_mqam_exact,
)
from r4w_tpu_torch.waveforms.linear_mod import (
    index_to_value,
    psk_constellation,
    psk_value_to_index,
    qam_constellation,
    qam_value_to_index,
)

LINEAR_SCHEMES = ("bpsk", "qpsk", "8psk", "16qam", "64qam")


def _scheme_tables(scheme: str) -> tuple[np.ndarray, np.ndarray, int]:
    """(constellation, value_to_index, bits_per_symbol)."""
    if scheme.endswith("psk"):
        m = {"bpsk": 2, "qpsk": 4, "8psk": 8}[scheme]
        return psk_constellation(m), psk_value_to_index(m), int(np.log2(m))
    m = int(scheme[:-3])
    return qam_constellation(m), qam_value_to_index(m), int(np.log2(m))


def theoretical_ber(scheme: str, ebn0_db, device=None) -> torch.Tensor:
    """Closed-form Gray-coded AWGN BER of a linear scheme or 'fsk-noncoherent'."""
    if scheme == "fsk-noncoherent":
        return theoretical_ber_fsk_noncoherent(ebn0_db, device)
    if scheme in ("bpsk", "qpsk"):
        return theoretical_ber_bpsk(ebn0_db, device)
    if scheme.endswith("psk"):
        return theoretical_ber_mpsk(ebn0_db, {"8psk": 8}[scheme], device)
    return theoretical_ber_mqam_exact(ebn0_db, int(scheme[:-3]), device)


def _normal(shape, generator, noise, device) -> torch.Tensor:
    """`noise` on `device` if given, else standard normal float32 draws."""
    if noise is not None:
        return to_tensor(noise, REAL_DTYPE, device)
    return torch.randn(shape, generator=generator, dtype=REAL_DTYPE, device=device)


def linear_ber_monte_carlo(scheme: str, ebn0_db, n_bits: int,
                           generator: torch.Generator | None = None, *, values=None,
                           noise=None, device=None) -> torch.Tensor:
    """Measured BER (P,) float64 over n_bits random bits at each of the P
    Eb/N0 points (dB), all points and symbols at once.

    Draws from `generator` (on `device`) the symbol values (S,) and the
    noise (2, P, S); `values` and `noise` replace those draws.
    """
    con, v2i, k = _scheme_tables(scheme)
    ebn0 = _ebn0_linear(ebn0_db, device)  # (P,)
    dev = ebn0.device
    n_sym = n_bits // k
    conj = torch.from_numpy(con).to(dev)
    if values is None:
        values = torch.randint(0, 1 << k, (n_sym,), generator=generator, device=dev)
    vals = to_tensor(values, torch.int64, dev)
    tx = conj[torch.from_numpy(v2i).to(dev).long()[vals]]  # (S,), Es == 1
    # N0 = Es / (k·γb); complex noise with total variance N0 per sample
    n0 = 1.0 / (k * ebn0)
    nz = _normal((2, ebn0.shape[0], n_sym), generator, noise, dev)
    rx = tx[None, :] + torch.complex(nz[0], nz[1]) * torch.sqrt(n0 / 2.0)[:, None]  # (P, S)
    d2 = torch.abs(rx[..., None] - conj) ** 2  # (P, S, M)
    got = torch.from_numpy(index_to_value(v2i)).to(dev).long()[torch.argmin(d2, dim=-1)]
    diff = got ^ vals[None, :]
    shifts = torch.arange(k, device=dev)
    errors = torch.sum((diff[..., None] >> shifts) & 1, dim=(-1, -2), dtype=torch.int64)
    return errors.to(torch.float64) / (n_sym * k)


def fsk_noncoherent_ber_monte_carlo(ebn0_db, n_bits: int,
                                    generator: torch.Generator | None = None, *,
                                    noise=None, device=None) -> torch.Tensor:
    """Orthogonal noncoherent BFSK, deciding on the larger |tone correlation|:
    (P,) float64 BER from noise draws (4, P, n_bits) (`noise` replaces them).
    The carrier phase does not enter the |·| statistic, and the bit values
    do not enter the decision, so neither is drawn."""
    ebn0 = _ebn0_linear(ebn0_db, device)
    dev = ebn0.device
    nz = _normal((4, ebn0.shape[0], n_bits), generator, noise, dev)
    scale = torch.sqrt((1.0 / ebn0) / 2.0)[:, None]  # Es = Eb = 1
    r_sig = torch.abs(1.0 + torch.complex(nz[0], nz[1]) * scale)
    r_oth = torch.abs(torch.complex(nz[2], nz[3]) * scale)
    errors = torch.sum(r_oth > r_sig, dim=-1, dtype=torch.int64)
    return errors.to(torch.float64) / n_bits


def waveform_ber_monte_carlo(name: str, snr_db: float, n_bytes: int = 64, lanes: int = 16,
                             seed: int = 0, sample_rate: float = 125_000.0, device=None, *,
                             noise=None):
    """Measured BER and implied Eb/N0 through the real Waveform chain.

    Returns (ber, ebn0_db): the per-sample `snr_db` maps to
    Eb/N0 = snr + 10·log10(sps / bits_per_symbol), the coherent gain of
    integrating sps samples a symbol. All lanes draw their noise in one
    `awgn` call from a generator seeded with `seed` (`noise`, unit variance
    a component, replaces the draw), then demodulate lane by lane.
    """
    from r4w_tpu_torch.waveforms import create_waveform

    dev = resolve_device(device)
    wf = create_waveform(name, sample_rate, device=dev)
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, n_bytes).astype(np.uint8)
    tx = wf.modulate(payload.tobytes())
    ref_bits = np.unpackbits(payload)
    batch = tx.expand(lanes, tx.shape[-1])
    if noise is None:
        rx = awgn(batch, snr_db, generator=torch.Generator(device=dev).manual_seed(seed))
    else:
        rx = awgn(batch, snr_db, noise=to_tensor(noise, IQ_DTYPE, dev))
    errors = total = 0
    for lane in range(lanes):
        got = wf.demodulate(rx[lane]).bits[:n_bytes].cpu().numpy().astype(np.uint8)
        got_bits = np.unpackbits(got)
        n = min(len(got_bits), len(ref_bits))
        errors += int(np.sum(got_bits[:n] != ref_bits[:n]))
        errors += len(ref_bits) - n  # missing bits count as errors
        total += len(ref_bits)
    k = wf.info().bits_per_symbol
    ebn0_db = snr_db + 10.0 * math.log10(wf.samples_per_symbol() / k)
    return errors / total, ebn0_db


@dataclasses.dataclass
class BerGateResult:
    scheme: str
    ebn0_db: float
    measured: float
    theory: float
    deviation: float          # |measured − theory| / theory
    ci_low: float
    ci_high: float
    n_bits: int

    @property
    def theory_in_ci(self) -> bool:
        return self.ci_low <= self.theory <= self.ci_high


def ber_acceptance_report(schemes_points: dict[str, tuple[float, ...]],
                          n_bits: int = 1_000_000, seed: int = 0,
                          device=None) -> list[BerGateResult]:
    """Run the constellation-level acceptance sweep.

    schemes_points: scheme -> Eb/N0 points (dB), where theory is tight
    (Pb ≈ 1e-3..3e-2) and n_bits keeps the relative CI under a few percent.
    Scheme i (in sorted order) draws from a generator seeded seed + 7·i.
    """
    dev = resolve_device(device)
    out = []
    for i, (scheme, points) in enumerate(sorted(schemes_points.items())):
        pts = torch.tensor(points, dtype=REAL_DTYPE, device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed + 7 * i)
        if scheme == "fsk-noncoherent":
            measured = fsk_noncoherent_ber_monte_carlo(pts, n_bits, gen)
        else:
            measured = linear_ber_monte_carlo(scheme, pts, n_bits, gen)
        measured = measured.cpu().numpy()
        theory = theoretical_ber(scheme, pts).cpu().numpy()
        for p, m, t in zip(points, measured, theory):
            errs = int(round(float(m) * n_bits))
            lo, hi = ber_confidence_interval(errs, n_bits)
            out.append(BerGateResult(
                scheme=scheme, ebn0_db=float(p), measured=float(m), theory=float(t),
                deviation=abs(float(m) - float(t)) / max(float(t), 1e-12),
                ci_low=lo, ci_high=hi, n_bits=n_bits))
    return out


DEFAULT_GATE_POINTS: dict[str, tuple[float, ...]] = {
    # points where Pb ∈ ~[1e-3, 3e-2]: the approximations are tight and
    # 1M bits give <5% relative statistical error
    "bpsk": (4.0, 6.0, 7.0),
    "qpsk": (4.0, 6.0, 7.0),
    "8psk": (7.0, 9.0, 10.0),
    "16qam": (8.0, 10.0, 11.0),
    "64qam": (11.0, 12.5, 14.0),
    "fsk-noncoherent": (8.0, 10.0),
}


def main(device=None):  # pragma: no cover - CLI entry
    """Print the default gate as JSON: every point, the worst deviation and
    whether it is under 10%. Runs on the CUDA card unless told otherwise."""
    import json

    results = ber_acceptance_report(DEFAULT_GATE_POINTS, device=device)
    worst = max(r.deviation for r in results)
    print(json.dumps({
        "gates": [dataclasses.asdict(r) for r in results],
        "worst_deviation": worst,
        "pass": worst < 0.10,
    }, indent=1))


if __name__ == "__main__":  # pragma: no cover
    main()
