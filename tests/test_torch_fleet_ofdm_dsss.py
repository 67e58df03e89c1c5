"""The port's OFDM (and its channel estimation and equalisers), DSSS,
Zigbee, UWB and FMCW waveforms and the spreading codes against the JAX
package: IQ and decisions per tests/torch_fleet_parity.py; the equalisers
within 1e-5 (a multiply and a sum over the pilots in place of the
reference's float32 matmul), through the reference's 2-ray multipath and
residual-CFO cases; the codes equal."""

import jax
import numpy as np
import pytest
import torch

from r4w_tpu.channel import awgn as ref_awgn
from r4w_tpu.channel.channel import cfo as ref_cfo, multipath_2ray
from r4w_tpu.ops import ofdm as ref_ofdm
from r4w_tpu.ops import spreading as ref_spreading
from r4w_tpu.waveforms import ofdm as ref_ofdm_wf
from r4w_tpu_torch.ops import ofdm, spreading
from r4w_tpu_torch.waveforms import ofdm as ofdm_wf
from torch_fleet_parity import CPU, KEY, check_decisions, check_modulation, waveforms

DATA = bytes([0xA7, 0x1B, 0x3C, 0xD2])
EQ_TOL = 1e-5  # absolute, on unit-scale points


@pytest.mark.parametrize("name", ["OFDM", "DSSS", "DSSS-QPSK", "Zigbee", "UWB", "FMCW"])
def test_modulation_and_decisions_match_reference(name):
    iq = check_modulation(name)
    check_decisions(name, iq, noisy=False)
    check_decisions(name, iq, noisy=True)


def _rand_iq(rng, shape) -> np.ndarray:
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=EQ_TOL)


def test_pilot_patterns_and_interpolator_match_reference():
    for n, p in ((52, 4), (52, 7), (16, 2)):
        a = ofdm.PilotPattern.edges_and_uniform(n, p)
        b = ref_ofdm.PilotPattern.edges_and_uniform(n, p)
        assert (a.positions, a.values, a.n_occupied) == (b.positions, b.values, b.n_occupied)
        np.testing.assert_array_equal(a.data_positions, b.data_positions)
        np.testing.assert_array_equal(ofdm._interp_operator(a.positions, n),
                                      ref_ofdm._interp_operator(b.positions, n))
    u, ru = ofdm.PilotPattern.uniform(48, 6), ref_ofdm.PilotPattern.uniform(48, 6)
    assert (u.positions, u.num_pilots, u.num_data) == (ru.positions, ru.num_pilots, ru.num_data)
    np.testing.assert_array_equal(ofdm.training_sequence(52), ref_ofdm.training_sequence(52))
    with pytest.raises(ValueError):
        ofdm.PilotPattern((0, 60), (1.0, 1.0), 52)


@pytest.mark.parametrize("method", ["mmse", "zf"])
def test_equalizers_match_reference(method):
    """Every ops.ofdm function on a random 2-lane packet of 6 symbols."""
    rng = np.random.default_rng(5)
    pat, ref_pat = (m.PilotPattern.edges_and_uniform(52, 5) for m in (ofdm, ref_ofdm))
    rx = _rand_iq(rng, (2, 6, 52))
    t_rx = torch.from_numpy(rx)
    _close(ofdm.estimate_pilot_ls(t_rx, pat), ref_ofdm.estimate_pilot_ls(rx, ref_pat))
    h_ls = ref_ofdm.estimate_pilot_ls(rx, ref_pat)
    h_ref = np.array(h_ls)[..., :1, :]
    _close(ofdm.common_phase_error(torch.from_numpy(np.array(h_ls)), torch.from_numpy(h_ref)),
           ref_ofdm.common_phase_error(h_ls, h_ref))
    for got, want in zip(ofdm.estimate_channel(t_rx, pat), ref_ofdm.estimate_channel(rx, ref_pat)):
        _close(got, want)
    h = _rand_iq(rng, (52,))
    _close(ofdm.equalize_zf(t_rx, torch.from_numpy(h)), ref_ofdm.equalize_zf(rx, h))
    _close(ofdm.equalize_mmse(t_rx, torch.from_numpy(h), 0.1), ref_ofdm.equalize_mmse(rx, h, 0.1))
    for nv in (None, 0.05):
        for got, want in zip(ofdm.equalize_frame(t_rx, pat, method, nv),
                             ref_ofdm.equalize_frame(rx, ref_pat, method, nv)):
            _close(got, want)
        train = ofdm.training_sequence(52)
        for got, want in zip(ofdm.equalize_packet(t_rx, pat, train, 2, method, nv),
                             ref_ofdm.equalize_packet(rx, ref_pat, train, 2, method, nv)):
            _close(got, want)
    _close(ofdm.estimate_channel_from_training(t_rx, torch.from_numpy(train)),
           ref_ofdm.estimate_channel_from_training(rx, train))
    np.testing.assert_allclose(ofdm.channel_magnitude_db(torch.from_numpy(h)).numpy(),
                               np.asarray(ref_ofdm.channel_magnitude_db(h)), atol=1e-4)
    with pytest.raises(ValueError):
        ofdm.equalize_frame(t_rx, pat, "lms")


def _ofdm_case(rx: np.ndarray, rate: float, n_bytes: int) -> None:
    wf = ofdm_wf.OFDM(common=ofdm_wf.CommonParams(sample_rate=rate), device=CPU)
    ref = ref_ofdm_wf.OFDM(common=ref_ofdm_wf.CommonParams(sample_rate=rate))
    _close(wf.demodulate_subcarriers(torch.from_numpy(np.array(rx))), ref.demodulate_subcarriers(rx))
    got, want = wf.demodulate(rx), ref.demodulate(rx)
    np.testing.assert_array_equal(got.bits.numpy(), np.asarray(want.bits))
    assert got.bits[:n_bytes].numpy().tolist() == np.asarray(want.bits)[:n_bytes].tolist()


def test_ofdm_multipath_equalized_like_reference():
    """tests/test_waveform_fleet.py:89: a 2-ray echo inside the CP at 25 dB."""
    ref = ref_ofdm_wf.OFDM(common=ref_ofdm_wf.CommonParams(sample_rate=20e6))
    tx = ref.modulate(DATA)
    rx = np.asarray(ref_awgn(jax.random.key(7), multipath_2ray(tx, 12, 0.8), 25.0))
    _ofdm_case(rx, 20e6, len(DATA))


def test_ofdm_residual_cfo_tracked_like_reference():
    """tests/test_waveform_fleet.py:119: a 40 Hz residual CFO at 1 MS/s, 25 dB."""
    ref = ref_ofdm_wf.OFDM(common=ref_ofdm_wf.CommonParams(sample_rate=1e6))
    tx = ref.modulate(DATA * 4)
    rx = np.asarray(ref_awgn(jax.random.key(13), ref_cfo(tx, 40.0, 1e6), 25.0))
    _ofdm_case(rx, 1e6, 4 * len(DATA))


def test_ofdm_schemes_and_pilotless_frame_match_reference():
    for scheme in ("bpsk", "qpsk", "qam16", "qam64"):
        np.testing.assert_array_equal(ofdm_wf.subcarrier_constellation(scheme),
                                      ref_ofdm_wf.subcarrier_constellation(scheme))
    data = bytes(range(40))
    for kw in ({"num_pilots": 0}, {"num_training_symbols": 0}, {"subcarrier_mod": "qam16"},
               {"equalizer": "zf"}):
        wf = ofdm_wf.OFDM(device=CPU, **kw)
        ref = ref_ofdm_wf.OFDM(**kw)
        want = np.asarray(ref.modulate(data))
        _close(wf.modulate(data), want)
        np.testing.assert_array_equal(wf.demodulate(want).bits.numpy(),
                                      np.asarray(ref.demodulate(want).bits))


def test_spreading_codes_equal_reference():
    assert spreading.MSEQ_POLY == ref_spreading.MSEQ_POLY
    assert spreading.GOLD_PREFERRED_PAIRS == ref_spreading.GOLD_PREFERRED_PAIRS
    assert spreading.BARKER_CODES == ref_spreading.BARKER_CODES
    for degree in range(3, 11):
        poly = spreading.MSEQ_POLY[degree]
        np.testing.assert_array_equal(spreading.m_sequence(degree), ref_spreading.m_sequence(degree))
        np.testing.assert_array_equal(spreading.lfsr_bits(degree, poly, 5, 300),
                                      ref_spreading.lfsr_bits(degree, poly, 5, 300))
    for degree in range(5, 11):
        for index in (0, 1, 2, 17, (1 << degree) + 1, (1 << degree) + 5):
            np.testing.assert_array_equal(spreading.gold_code(degree, index),
                                          ref_spreading.gold_code(degree, index))
    np.testing.assert_array_equal(spreading.gold_family(7, 12), ref_spreading.gold_family(7, 12))
    np.testing.assert_array_equal(spreading.gold_family(5), ref_spreading.gold_family(5))
    for length in ref_spreading.BARKER_CODES:
        np.testing.assert_array_equal(spreading.barker_code(length),
                                      ref_spreading.barker_code(length))
    with pytest.raises(ValueError):
        spreading.barker_code(6)
    for root, length, shift in ((25, 63, 0), (29, 139, 3), (1, 64, 0)):
        np.testing.assert_array_equal(spreading.zadoff_chu(root, length, shift),
                                      ref_spreading.zadoff_chu(root, length, shift))
    m = spreading.m_sequence(7)
    ac = spreading.pn_autocorrelation(m)
    np.testing.assert_array_equal(ac, ref_spreading.pn_autocorrelation(m))
    assert ac[0] == 127 and np.all(ac[1:] == -1)


def test_dsss_processing_gain_like_reference():
    """tests/test_waveform_fleet.py:165: 127 chips decode at -10 dB at 500 kS/s."""
    wf, ref = waveforms("DSSS", 500_000.0)
    assert abs(wf.processing_gain_db() - 21.07) < 0.1
    rx = np.asarray(ref_awgn(jax.random.key(11), ref.modulate(DATA), -10.0))
    got = wf.demodulate(rx)
    np.testing.assert_array_equal(got.bits.numpy(), np.asarray(ref.demodulate(rx).bits))
    assert bytes(got.bits[:4].numpy().astype(np.uint8)) == DATA
    for kw in ({"pn_type": "msequence"}, {"pn_type": "barker"}):
        a = type(wf)(device=CPU, **kw)
        b = type(ref)(**kw)
        want = np.asarray(b.modulate(DATA))
        np.testing.assert_array_equal(a.modulate(DATA).numpy(), want)
        np.testing.assert_array_equal(a.demodulate(want).bits.numpy(),
                                      np.asarray(b.demodulate(want).bits))


def test_fmcw_range_matches_reference():
    """tests/test_fleet_noisy.py:107: a 1500 m echo at 0 dB, the reference's noise."""
    from r4w_tpu_torch.entry import FMCW_RANGE_M, fmcw_echo

    wf, ref = waveforms("FMCW", 1_000_000.0)
    echo = fmcw_echo(wf, wf.modulate(), FMCW_RANGE_M).numpy()
    rx = np.asarray(ref_awgn(jax.random.key(KEY), echo, 0.0))
    np.testing.assert_allclose(wf.beat_spectrum(rx).numpy(), np.asarray(ref.beat_spectrum(rx)),
                               rtol=1e-4)
    assert wf.estimate_range(rx) == ref.estimate_range(rx)
    assert abs(wf.estimate_range(rx) - FMCW_RANGE_M) < 2 * 299_792_458.0 / (2 * wf.sweep_bandwidth)
