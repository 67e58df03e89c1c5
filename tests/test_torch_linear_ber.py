"""The port's linear modems, measurement ops and BER gate against the JAX package.

Constellations and Gray maps must equal the reference's; on the same IQ
the demodulator's indices must be equal and its EVM within 1e-6; the
closed-form curves within rtol 1e-6; the Wilson interval equal; with the
JAX package's own draws injected, the Monte-Carlo bit errors equal. The
gate itself runs here at its full 1,000,000 bits a point (within 10% of
theory or theory inside the measured CI, the reference's bar).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu import ber as ref_ber
from r4w_tpu.channel import channel as ref_channel
from r4w_tpu.ops import measure as ref_measure
from r4w_tpu.waveforms import create_waveform as ref_create_waveform
from r4w_tpu.waveforms import linear_mod as ref_lm
from r4w_tpu_torch import ber, create_waveform
from r4w_tpu_torch.core import fftops, types
from r4w_tpu_torch.entry import ber_gate
from r4w_tpu_torch.fec import crc
from r4w_tpu_torch.ops import measure
from r4w_tpu_torch.waveforms import linear_mod as lm
from r4w_tpu_torch.waveforms import lora
from r4w_tpu_torch.waveforms.lora import sync
from r4w_tpu_torch.waveforms.psk import PSK
from r4w_tpu_torch.waveforms.qam import QAM

CPU = torch.device("cpu")
NAMES = ("BPSK", "QPSK", "8-PSK", "16-QAM", "64-QAM", "256-QAM")
EVM_TOL = 1e-6
THEORY_RTOL = 1e-6        # at the gate's points
# Over a sweep the float32 erfc arguments are equal bit for bit, but JAX's
# float32 erfc is off a float64 erfc by up to 1.01e-6 (relative) between
# -2 and 16 dB where torch's is off by 4.7e-8, so the two differ by a hair
# more than 1e-6 at some points.
SWEEP_RTOL = 2e-6
SCHEMES = sorted(ber.DEFAULT_GATE_POINTS)


def _noisy(tx: np.ndarray, std: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = rng.standard_normal(tx.shape) + 1j * rng.standard_normal(tx.shape)
    return (tx + std * n).astype(np.complex64)


@pytest.mark.parametrize("m", [2, 4, 8, 16])
def test_psk_tables_match_reference(m):
    np.testing.assert_array_equal(lm.psk_constellation(m), ref_lm.psk_constellation(m))
    np.testing.assert_array_equal(lm.psk_constellation(m, 0.5), ref_lm.psk_constellation(m, 0.5))
    np.testing.assert_array_equal(lm.psk_value_to_index(m), ref_lm.psk_value_to_index(m))
    np.testing.assert_array_equal(lm.index_to_value(lm.psk_value_to_index(m)),
                                  ref_lm.index_to_value(ref_lm.psk_value_to_index(m)))


@pytest.mark.parametrize("order", [4, 16, 64, 256])
def test_qam_tables_match_reference(order):
    np.testing.assert_array_equal(lm.qam_constellation(order), ref_lm.qam_constellation(order))
    np.testing.assert_array_equal(lm.qam_value_to_index(order), ref_lm.qam_value_to_index(order))
    np.testing.assert_array_equal(lm.index_to_value(lm.qam_value_to_index(order)),
                                  ref_lm.index_to_value(ref_lm.qam_value_to_index(order)))
    assert lm.GRAY_1D == ref_lm.GRAY_1D


@pytest.mark.parametrize("name", NAMES)
def test_waveform_modulate_and_demodulate_match_reference(name):
    """The same bytes give the same IQ; the same noisy IQ gives the same
    indices and bytes, EVM and SNR within 1e-6."""
    wf, ref = create_waveform(name, 8_000.0, device=CPU), ref_create_waveform(name, 8_000.0)
    assert dataclasses.asdict(wf.info()) == dataclasses.asdict(ref.info())
    assert wf.samples_per_symbol() == ref.samples_per_symbol() == 8
    data = bytes(np.random.default_rng(len(name)).integers(0, 256, 45).astype(np.uint8))
    tx = wf.modulate(data)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(ref.modulate(data)))
    np.testing.assert_array_equal(wf.constellation_points().numpy(),
                                  np.asarray(ref.constellation_points()))
    rx = _noisy(tx.numpy(), 0.15, 3)
    got, want = wf.demodulate(torch.from_numpy(rx)), ref.demodulate(jnp.asarray(rx))
    np.testing.assert_array_equal(got.symbols.numpy(), np.asarray(want.symbols))
    np.testing.assert_array_equal(got.bits.numpy(), np.asarray(want.bits))
    assert abs(got.metadata["evm_rms"] - want.metadata["evm_rms"]) < EVM_TOL
    assert abs(got.snr_estimate - want.snr_estimate) < 1e-4
    clean = wf.demodulate(tx)
    assert bytes(clean.bits[: len(data)].numpy().astype(np.uint8)) == data


@pytest.mark.parametrize("name", NAMES)
def test_linear_core_batched_matches_reference(name):
    """The cores on a batch of rows, with a bit stream that needs padding at
    the waveform level."""
    wf = create_waveform(name, 4_000.0, device=CPU)
    con, v2i = wf._tables()
    bps, sps = wf.bits_per_symbol, wf.samples_per_symbol()
    bits = np.random.default_rng(7).integers(0, 2, (3, 24 * bps)).astype(np.int32)
    tx = lm.linear_modulate(torch.from_numpy(bits), con, v2i, bps, sps)
    want = ref_lm.linear_modulate(jnp.asarray(bits), con, jnp.asarray(v2i), bps, sps)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(want))
    rx = _noisy(tx.numpy(), 0.2, 4)
    idx, evm, snr = lm.linear_demodulate_symbols(torch.from_numpy(rx), con, sps)
    ridx, revm, rsnr = ref_lm.linear_demodulate_symbols(jnp.asarray(rx), con, sps)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_allclose(evm.numpy(), np.asarray(revm), rtol=0, atol=EVM_TOL)
    np.testing.assert_allclose(snr.numpy(), np.asarray(rsnr), rtol=0, atol=1e-4)
    i2v = lm.index_to_value(v2i)
    np.testing.assert_array_equal(lm.indices_to_bits(idx, i2v, bps).numpy(),
                                  np.asarray(ref_lm.indices_to_bits(ridx, jnp.asarray(i2v), bps)))
    odd = wf.modulate(np.array([1, 0, 1], np.int32))  # 3 bits, padded to whole symbols
    np.testing.assert_array_equal(odd.numpy(), np.asarray(
        ref_create_waveform(name, 4_000.0).modulate(np.array([1, 0, 1], np.int32))))


def test_factory_names_and_defaults():
    for name, alias in (("8-PSK", "psk8"), ("16-QAM", "qam16"), ("64-QAM", "64qam"),
                        ("256-QAM", "QAM256")):
        assert create_waveform(alias, device=CPU).info().name == name
    assert isinstance(create_waveform("BPSK"), PSK) and isinstance(create_waveform("qam64"), QAM)
    assert create_waveform("BPSK").device == torch.device("cuda")  # the card unless named
    assert create_waveform("QPSK", device=CPU).info().bits_per_symbol == 2


@pytest.mark.parametrize("scheme", SCHEMES)
def test_theoretical_ber_matches_reference(scheme):
    gate = np.array(ber.DEFAULT_GATE_POINTS[scheme], np.float32)
    got = ber.theoretical_ber(scheme, torch.from_numpy(gate))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_ber.theoretical_ber(scheme, gate)),
                               rtol=THEORY_RTOL, atol=0)
    sweep = np.linspace(-2.0, 16.0, 19).astype(np.float32)
    np.testing.assert_allclose(ber.theoretical_ber(scheme, torch.from_numpy(sweep)).numpy(),
                               np.asarray(ref_ber.theoretical_ber(scheme, sweep)),
                               rtol=SWEEP_RTOL, atol=0)


@pytest.mark.parametrize("fn,arg", [("theoretical_ber_bpsk", None), ("theoretical_ber_qpsk", None),
                                    ("theoretical_ber_mpsk", 16), ("theoretical_ber_mpsk", 4),
                                    ("theoretical_ber_fsk_noncoherent", None),
                                    ("theoretical_ber_mqam", 16), ("theoretical_ber_mqam", 256),
                                    ("theoretical_ber_mqam_exact", 256),
                                    ("theoretical_ber_mqam_exact", 4)])
def test_theory_curves_match_reference(fn, arg):
    """0-16.5 dB: above that JAX's float32 erfc flushes BPSK's tail to 0."""
    pts = np.arange(0.0, 18.0, 1.5, dtype=np.float32)
    args = () if arg is None else (arg,)
    got = getattr(measure, fn)(pts, *args, device=CPU)
    np.testing.assert_allclose(got.numpy(), np.asarray(getattr(ref_measure, fn)(pts, *args)),
                               rtol=SWEEP_RTOL, atol=0)


def test_theory_known_values():
    assert abs(float(measure.theoretical_ber_bpsk(0.0, device=CPU)) - 0.0786) < 2e-3
    assert float(measure.theoretical_ber_bpsk(9.6, device=CPU)) < 1.2e-5
    assert abs(float(measure.theoretical_ber_fsk_noncoherent(10.0, device=CPU))
               - 0.5 * np.exp(-5.0)) < 1e-6


@pytest.mark.parametrize("errors,total,confidence", [
    (0, 1000, 0.95), (37, 1000, 0.95), (5000, 10_000, 0.99), (999, 1000, 0.9),
    (12, 1_000_000, 0.95), (0, 0, 0.95), (3, 7, 0.999)])
def test_confidence_interval_matches_reference(errors, total, confidence):
    assert (measure.ber_confidence_interval(errors, total, confidence)
            == ref_measure.ber_confidence_interval(errors, total, confidence))


def test_norm_ppf_and_measures_match_reference():
    for p in (1e-6, 0.01, 0.02425, 0.3, 0.5, 0.9, 0.975, 0.999999):
        assert measure._norm_ppf(p) == ref_measure._norm_ppf(p)
    rng = np.random.default_rng(8)
    ref_sym = lm.psk_constellation(8)[rng.integers(0, 8, (3, 200))]
    rx = _noisy(ref_sym, 0.1, 9)
    np.testing.assert_allclose(measure.evm_rms(torch.from_numpy(rx), ref_sym).numpy(),
                               np.asarray(ref_measure.evm_rms(rx, ref_sym)), rtol=1e-6)
    np.testing.assert_allclose(
        measure.evm_rms(torch.from_numpy(rx), ref_sym, normalize=False).numpy(),
        np.asarray(ref_measure.evm_rms(rx, ref_sym, normalize=False)), rtol=1e-6)
    np.testing.assert_allclose(measure.snr_estimate_m2m4(torch.from_numpy(rx)).numpy(),
                               np.asarray(ref_measure.snr_estimate_m2m4(rx)), rtol=0, atol=1e-4)
    tx_bits = rng.integers(0, 2, (4, 50))
    rx_bits = tx_bits ^ (rng.random((4, 53))[:, :50] < 0.1)
    errs, n = measure.ber_count(torch.from_numpy(tx_bits), torch.from_numpy(
        np.concatenate([rx_bits, np.zeros((4, 3), np.int64)], axis=1)))
    want, want_n = ref_measure.ber_count(tx_bits, np.concatenate(
        [rx_bits, np.zeros((4, 3), np.int64)], axis=1))
    assert n == want_n == 50 and errs.dtype == torch.int64
    np.testing.assert_array_equal(errs.numpy(), np.asarray(want))


def _jax_linear_draws(scheme: str, n_points: int, n_bits: int, seed: int):
    """The reference's symbol values and noise for `linear_ber_monte_carlo`."""
    k = ref_ber._scheme_tables(scheme)[2]
    kb, kn = jax.random.split(jax.random.key(seed))
    n_sym = n_bits // k
    vals = np.asarray(jax.random.randint(kb, (n_sym,), 0, 1 << k))
    noise = np.asarray(jax.random.normal(kn, (2, n_points, n_sym), jnp.float32))
    return vals, noise


@pytest.mark.parametrize("scheme", ber.LINEAR_SCHEMES)
def test_linear_monte_carlo_with_jax_draws_counts_the_same_errors(scheme):
    pts = np.array(ber.DEFAULT_GATE_POINTS[scheme], np.float32)
    n_bits = 60_000
    vals, noise = _jax_linear_draws(scheme, len(pts), n_bits, 11)
    got = ber.linear_ber_monte_carlo(scheme, torch.from_numpy(pts), n_bits,
                                     values=torch.from_numpy(vals), noise=torch.from_numpy(noise))
    want = np.asarray(ref_ber.linear_ber_monte_carlo(scheme, jnp.asarray(pts), n_bits,
                                                     jax.random.key(11)))
    k = ref_ber._scheme_tables(scheme)[2]
    total = (n_bits // k) * k
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(np.round(got.numpy() * total), np.round(want * total))
    assert (np.round(want * total) > 0).all()


def test_fsk_monte_carlo_with_jax_draws_counts_the_same_errors():
    pts = np.array([6.0, 8.0, 10.0], np.float32)
    n_bits = 50_000
    kb, kn, _ = jax.random.split(jax.random.key(5), 3)
    noise = np.asarray(jax.random.normal(kn, (4, 3, n_bits), jnp.float32))
    got = ber.fsk_noncoherent_ber_monte_carlo(torch.from_numpy(pts), n_bits,
                                              noise=torch.from_numpy(noise))
    want = np.asarray(ref_ber.fsk_noncoherent_ber_monte_carlo(jnp.asarray(pts), n_bits,
                                                              jax.random.key(5)))
    np.testing.assert_array_equal(np.round(got.numpy() * n_bits), np.round(want * n_bits))


def test_waveform_monte_carlo_with_jax_noise_matches_reference():
    """BPSK at -16 dB a sample, 32 bytes, 3 lanes: the reference's lane keys'
    noise injected gives its BER and Eb/N0."""
    n_bytes, lanes, seed = 32, 3, 1
    wf = create_waveform("BPSK", device=CPU)
    n = 8 * n_bytes * wf.samples_per_symbol()
    noise = np.stack([np.asarray(ref_channel._complex_normal(
        jax.random.key(seed * 1000 + lane), (n,), 1.0)) for lane in range(lanes)])
    got = ber.waveform_ber_monte_carlo("BPSK", -16.0, n_bytes, lanes, seed, device=CPU,
                                       noise=torch.from_numpy(noise))
    want = ref_ber.waveform_ber_monte_carlo("BPSK", -16.0, n_bytes, lanes, seed)
    assert got[0] == want[0] and got[1] == pytest.approx(want[1], abs=1e-12)
    assert 0.0 < got[0] < 0.05


def test_waveform_level_ber_matches_theory():
    """The reference's bar (tests/test_ber_theory.py:56-68): BPSK at -16 dB a
    sample (125 samples a symbol, Eb/N0 ≈ 5 dB), 256 bytes × 24 lanes,
    within 25% of theory."""
    measured, ebn0 = ber.waveform_ber_monte_carlo("BPSK", snr_db=-16.0, n_bytes=256, lanes=24,
                                                  seed=1, device=CPU)
    theory = float(measure.theoretical_ber_bpsk(ebn0, device=CPU))
    assert abs(measured - theory) / theory < 0.25, (measured, theory, ebn0)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_gate_at_one_million_bits_within_ten_percent(scheme):
    results = ber.ber_acceptance_report({scheme: ber.DEFAULT_GATE_POINTS[scheme]},
                                        n_bits=1_000_000, seed=3, device=CPU)
    assert len(results) == len(ber.DEFAULT_GATE_POINTS[scheme])
    for r in results:
        assert r.n_bits == 1_000_000 and r.ci_low < r.measured < r.ci_high
        assert r.deviation < 0.10 or r.theory_in_ci, (r.scheme, r.ebn0_db, r.measured, r.theory)


def test_ber_gate_entry_on_cpu():
    out = ber_gate("cpu", n_bits=200_000, seed=2)
    assert len(out["results"]) == sum(len(v) for v in ber.DEFAULT_GATE_POINTS.values())
    assert out["worst_deviation"] == max(r.deviation for r in out["results"])
    assert all(isinstance(r, ber.BerGateResult) for r in out["results"])
    assert {r.scheme for r in out["results"]} == set(ber.DEFAULT_GATE_POINTS)
    assert out["pass"] == (out["worst_deviation"] < 0.10)


def test_gate_report_fields_match_reference_on_the_same_measurement(monkeypatch):
    """With each package's Monte-Carlo replaced by the same numbers, the
    reports (theory, deviation, interval) are equal."""
    fake = {"bpsk": [0.0126, 0.0024, 0.00077], "fsk-noncoherent": [0.0091, 0.0034]}
    pts = {k: ber.DEFAULT_GATE_POINTS[k] for k in fake}
    monkeypatch.setattr(ber, "linear_ber_monte_carlo",
                        lambda s, p, n, g: torch.tensor(fake[s], dtype=torch.float64))
    monkeypatch.setattr(ber, "fsk_noncoherent_ber_monte_carlo",
                        lambda p, n, g: torch.tensor(fake["fsk-noncoherent"], dtype=torch.float64))
    monkeypatch.setattr(ref_ber, "linear_ber_monte_carlo",
                        lambda s, p, n, k: jnp.asarray(fake[s], jnp.float32))
    monkeypatch.setattr(ref_ber, "fsk_noncoherent_ber_monte_carlo",
                        lambda p, n, k: jnp.asarray(fake["fsk-noncoherent"], jnp.float32))
    got = ber.ber_acceptance_report(pts, n_bits=100_000, device=CPU)
    want = ref_ber.ber_acceptance_report(pts, n_bits=100_000)
    assert [(r.scheme, r.ebn0_db) for r in got] == [(r.scheme, r.ebn0_db) for r in want]
    for g, w in zip(got, want):
        assert g.measured == pytest.approx(w.measured, rel=1e-6)
        assert g.theory == pytest.approx(w.theory, rel=THEORY_RTOL)
        assert g.deviation == pytest.approx(w.deviation, rel=1e-4)
        assert g.theory_in_ci == w.theory_in_ci


@pytest.mark.cuda
def test_linear_paths_on_card_equal_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name in NAMES:
        wf = create_waveform(name, 8_000.0)
        tx = wf.modulate(bytes(range(64)))
        rx = _noisy(tx.cpu().numpy(), 0.15, 5)
        got = wf.demodulate(torch.from_numpy(rx).cuda())
        want = dataclasses.replace(wf, device=CPU).demodulate(torch.from_numpy(rx))
        assert torch.equal(got.symbols.cpu(), want.symbols)
    out = ber.linear_ber_monte_carlo("16qam", torch.tensor([10.0]).cuda(), 100_000,
                                     torch.Generator(device="cuda").manual_seed(0))
    assert out.is_cuda and 0.0 < float(out) < 0.05


# ------------------------------------------- numpy inputs go to the device

_RX = np.zeros(1024, np.complex64)
NUMPY_ENTRY_POINTS = {
    "crc_compute": lambda: crc.crc_compute(np.arange(5, dtype=np.int32), "crc16-lora"),
    "fletcher16": lambda: crc.fletcher16(np.arange(5, dtype=np.int32)),
    "fftops_fft": lambda: fftops.fft(_RX),
    "find_peak_interpolated": lambda: fftops.find_peak_interpolated(_RX)[0],
    "dechirp_windows": lambda: sync.dechirp_windows(lora.LoRaParams(sf=7), _RX)[0],
    "detect_preamble": lambda: sync.detect_preamble(lora.LoRaParams(sf=7), _RX).cfo_hz,
    "linear_demodulate_symbols": lambda: lm.linear_demodulate_symbols(
        _RX, lm.psk_constellation(4), 8)[0],
    "linear_modulate": lambda: lm.linear_modulate(np.ones(8, np.int32), lm.psk_constellation(4),
                                                  lm.psk_value_to_index(4), 2, 4),
    "evm_rms": lambda: measure.evm_rms(_RX, _RX),
    "theoretical_ber": lambda: ber.theoretical_ber("16qam", np.array([8.0], np.float32)),
    "linear_ber_monte_carlo": lambda: ber.linear_ber_monte_carlo(
        "bpsk", np.array([4.0], np.float32), 16, values=np.zeros(16, np.int64),
        noise=np.zeros((2, 1, 16), np.float32)),
    "psk_demodulate": lambda: PSK(device=torch.device("meta")).demodulate(_RX),
}


@pytest.mark.parametrize("name", sorted(NUMPY_ENTRY_POINTS))
def test_numpy_inputs_go_to_the_default_device(name, monkeypatch):
    """With the default device set to meta, numpy handed to the slice's
    functions lands there (a meta result, or an op refusing meta), never on
    the CPU."""
    monkeypatch.setattr(types, "DEFAULT_DEVICE", torch.device("meta"))
    try:
        out = NUMPY_ENTRY_POINTS[name]()
    except (ValueError, RuntimeError, NotImplementedError) as err:
        assert "meta" in str(err).lower(), err
    else:
        out = out if isinstance(out, torch.Tensor) else out.symbols
        assert out.device.type == "meta", out.device
