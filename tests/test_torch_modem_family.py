"""The rest of the port's ``ops.modem`` against ``r4w_tpu.ops.modem`` on
the same numpy inputs, made from seeds; then the JAX package's own tests
of it (``tests/test_modem_ops.py`` and the FBMC/OQAM and NR tests of
``tests/test_named_blocks.py``) run on the port.

Host tables (the CPM pulse, PHYDYAS, the OQAM phase map, the NR grid and
its DMRS values, the combinations of index modulation) and every hard
decision are exact. Floats are max|port − reference| / max|reference|
within FFT_TOL (float32 transforms and sums in another order; measured
values in the comments). `frequency_modulate`'s phase is a cumulative sum
that the reference's float32 scan rounds at each partial sum and the port
accumulates in float64 and rounds once; it stays within FFT_TOL too.
"""

import numpy as np
import pytest
import torch

from r4w_tpu.ops import modem as ref_modem
from r4w_tpu.waveforms.linear_mod import psk_constellation, qam_constellation
from r4w_tpu_torch.ops import modem
from torch_port_proxy import run_reference_test

FFT_TOL = 1e-5      # float32 FFTs and sums, pocketfft against XLA (measured 1.9e-6)
PHASE_TOL = 2e-6    # cis of a float32 phase built on the host (measured 8.4e-8)


def _rel(got, want) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if not want.size:
        return 0.0
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) or 1.0))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _iq(rng, *shape) -> np.ndarray:
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("shape", [(500,), (3, 500)])
def test_analog_and_differential(shape):
    rng = np.random.default_rng(len(shape))
    x = _iq(rng, *shape)
    assert _rel(modem.quadrature_demod(_t(x), 0.7), ref_modem.quadrature_demod(x, 0.7)) < FFT_TOL
    assert _rel(modem.diff_phasor(_t(x)), ref_modem.diff_phasor(x)) < FFT_TOL
    m = rng.standard_normal(shape).astype(np.float32)
    assert _rel(modem.phase_modulate(_t(m), 0.8), ref_modem.phase_modulate(m, 0.8)) < PHASE_TOL
    bits = rng.integers(0, 2, shape)
    enc = modem.differential_encode(_t(bits))
    np.testing.assert_array_equal(enc.numpy(), np.asarray(ref_modem.differential_encode(bits)))
    np.testing.assert_array_equal(modem.differential_decode(enc).numpy(), bits)


def test_frequency_modulate_phase_sum():
    m = 0.5 * np.random.default_rng(1).standard_normal(2000).astype(np.float32)
    assert _rel(modem.frequency_modulate(_t(m), 0.8),
                ref_modem.frequency_modulate(m, 0.8)) < FFT_TOL  # measured 3.9e-6


@pytest.mark.parametrize("pulse,span", [("rect", 1), ("rc", 2), ("gaussian", 4)])
def test_cpm_family(pulse, span):
    bits = np.random.default_rng(span).integers(0, 2, (3, 64))
    a = 2 * bits - 1
    assert _rel(modem.cpm_modulate(a, 4, 0.5, pulse, span, device="cpu"),
                ref_modem.cpm_modulate(a, 4, 0.5, pulse, span)) < PHASE_TOL
    np.testing.assert_array_equal(modem._phase_pulse(pulse, 8, span, 0.3),
                                  ref_modem._phase_pulse(pulse, 8, span, 0.3))
    assert _rel(modem.msk_modulate(_t(bits[0]), 8), ref_modem.msk_modulate(bits[0], 8)) < PHASE_TOL
    assert _rel(modem.gmsk_modulate(_t(bits[0]), 8), ref_modem.gmsk_modulate(bits[0], 8)) < PHASE_TOL
    assert modem.msk_modulate(_t(bits[0]), 8).device.type == "cpu"


@pytest.mark.parametrize("n_fft,n_sc,cp,start", [(64, 32, 8, 0), (64, 24, 4, 5),
                                                 (2048, 1200, 144, 0)])
def test_sc_fdma_and_papr(n_fft, n_sc, cp, start):
    rng = np.random.default_rng(n_sc)
    s = psk_constellation(4)[rng.integers(0, 4, (2, 3, n_sc))]
    tx = modem.sc_fdma_modulate(_t(s), n_fft, n_sc, cp, start)
    rtx = ref_modem.sc_fdma_modulate(s, n_fft, n_sc, cp, start)
    assert _rel(tx, rtx) < FFT_TOL
    assert _rel(modem.sc_fdma_demodulate(tx, n_fft, n_sc, cp, start),
                ref_modem.sc_fdma_demodulate(rtx, n_fft, n_sc, cp, start)) < FFT_TOL
    assert _rel(modem.papr_db(tx), ref_modem.papr_db(rtx)) < FFT_TOL
    for band in (1.0, 0.6):
        assert _rel(modem.papr_reduce_clip_filter(tx, 3.0, band=band),
                    ref_modem.papr_reduce_clip_filter(rtx, 3.0, band=band)) < FFT_TOL
    assert _rel(modem.papr_reduce_clip_filter(tx[0], 2.0, 3, 2 * tx.shape[-1]),
                ref_modem.papr_reduce_clip_filter(rtx[0], 2.0, 3, 2 * tx.shape[-1])) < FFT_TOL


def test_cyclic_prefix():
    b = _iq(np.random.default_rng(6), 2, 4, 64)
    cp = modem.add_cyclic_prefix(_t(b), 16)
    np.testing.assert_array_equal(cp.numpy(), np.asarray(ref_modem.add_cyclic_prefix(b, 16)))
    np.testing.assert_array_equal(modem.remove_cyclic_prefix(cp, 16).numpy(), b)


@pytest.mark.parametrize("n_sub,n_active,order", [(8, 2, 4), (16, 4, 4), (12, 3, 16)])
def test_index_modulation(n_sub, n_active, order):
    con = psk_constellation(order) if order == 4 else qam_constellation(order)
    np.testing.assert_array_equal(modem._combinations_table(n_sub, n_active),
                                  ref_modem._combinations_table(n_sub, n_active))
    rng = np.random.default_rng(n_sub)
    k = int(np.floor(np.log2(__import__("math").comb(n_sub, n_active)))) + n_active * int(
        np.log2(order))
    bits = rng.integers(0, 2, (3, 10, k))
    grid, active = modem.index_modulation_map(_t(bits), n_sub, n_active, con)
    rgrid, ractive = ref_modem.index_modulation_map(bits, n_sub, n_active, con)
    np.testing.assert_array_equal(grid.numpy(), np.asarray(rgrid))
    np.testing.assert_array_equal(active.numpy(), np.asarray(ractive))
    noisy = np.asarray(rgrid) + 0.3 * _iq(rng, *rgrid.shape)
    np.testing.assert_array_equal(
        modem.index_modulation_demap(_t(noisy), n_sub, n_active, con).numpy(),
        np.asarray(ref_modem.index_modulation_demap(noisy, n_sub, n_active, con)))


@pytest.mark.parametrize("m,t,k", [(16, 8, 4), (32, 5, 3), (8, 12, 2), (16, 4, 5)])
def test_fbmc_against_jax(m, t, k):
    np.testing.assert_array_equal(modem.phydyas_filter(m, k), ref_modem.phydyas_filter(m, k))
    np.testing.assert_array_equal(modem._fbmc_theta(2 * t, m), ref_modem._fbmc_theta(2 * t, m))
    rng = np.random.default_rng(m + t)
    q = _iq(rng, t, m)
    oq = modem.oqam_stagger(_t(q))
    roq = ref_modem.oqam_stagger(q)
    np.testing.assert_array_equal(oq.numpy(), np.asarray(roq))
    np.testing.assert_array_equal(modem.oqam_destagger(oq).numpy(),
                                  np.asarray(ref_modem.oqam_destagger(roq)))
    tx = modem.fbmc_modulate(oq, k)
    rtx = ref_modem.fbmc_modulate(roq, k)
    assert _rel(tx, rtx) < FFT_TOL
    for n_half in (2 * t, 2 * t + 3):  # the extra half-symbols read past the end, clamped
        assert _rel(modem.fbmc_demodulate(tx, m, n_half, k),
                    ref_modem.fbmc_demodulate(rtx, m, n_half, k)) < FFT_TOL
    assert modem.fbmc_spectral_efficiency(m, k) == ref_modem.fbmc_spectral_efficiency(m, k)


@pytest.mark.parametrize("cfg", [dict(num_prbs=4), dict(num_prbs=2, slot_number=3, ptrs_density=4),
                                 dict(numerology=1, num_prbs=6, dmrs_symbols=(2,),
                                      frame_number=5)])
def test_nr_grid_against_jax(cfg):
    pc, rc = modem.NrGridConfig(**cfg), ref_modem.NrGridConfig(**cfg)
    np.testing.assert_array_equal(modem.nr_re_types(pc), ref_modem.nr_re_types(rc))
    np.testing.assert_array_equal(modem.nr_dmrs_values(pc), ref_modem.nr_dmrs_values(rc))
    cap = modem.nr_data_capacity(pc)
    assert cap == ref_modem.nr_data_capacity(rc)
    rng = np.random.default_rng(cap)
    for d in (_iq(rng, cap), _iq(rng, 2, cap - 7)):
        g = modem.nr_map(_t(d), pc)
        np.testing.assert_array_equal(g.numpy(), np.asarray(ref_modem.nr_map(d, rc)))
        np.testing.assert_array_equal(modem.nr_demap(g, pc).numpy(),
                                      np.asarray(ref_modem.nr_demap(np.asarray(g), rc)))
    assert (pc.num_subcarriers, pc.subcarrier_spacing_khz, pc.slot_duration_ms) == (
        rc.num_subcarriers, rc.subcarrier_spacing_khz, rc.slot_duration_ms)


MODEM_OPS_TESTS = [
    "test_soft_llr_signs_match_hard_qpsk", "test_soft_llr_magnitude_tracks_confidence",
    "test_fm_modulate_quadrature_demod_roundtrip", "test_phase_modulate",
    "test_differential_roundtrip", "test_diff_phasor_dqpsk",
    "test_msk_constant_envelope_and_phase_steps", "test_gmsk_spectrum_narrower_than_msk",
    "test_cpm_bad_pulse", "test_sc_fdma_roundtrip_and_papr", "test_papr_clip_filter_reduces",
    "test_cyclic_prefix_roundtrip", "test_ofdm_im_roundtrip", "test_ofdm_im_wrong_bit_count",
    "test_soft_llr_16qam_noisy_better_than_hard",
]


@pytest.mark.parametrize("name", MODEM_OPS_TESTS)
def test_reference_modem_ops_tests_on_the_port(monkeypatch, name):
    run_reference_test(monkeypatch, "test_modem_ops", name, modem="r4w_tpu_torch.ops.modem")


NAMED_BLOCK_TESTS = [
    "test_phydyas_filter_properties", "test_oqam_stagger_destagger_roundtrip",
    "test_fbmc_modulate_demodulate_decisions", "test_fbmc_lower_sidelobes_than_ofdm",
    "test_nr_grid_config_numerology", "test_nr_grid_dmrs_comb2_positions",
    "test_nr_map_demap_roundtrip", "test_nr_dmrs_seed_changes_with_slot",
]


@pytest.mark.parametrize("name", NAMED_BLOCK_TESTS)
def test_reference_fbmc_and_nr_tests_on_the_port(monkeypatch, name):
    run_reference_test(monkeypatch, "test_named_blocks", name, modem="r4w_tpu_torch.ops.modem")
