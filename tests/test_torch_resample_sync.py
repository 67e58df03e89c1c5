"""The rest of the port's resampling, and its `sync` and `sync2`, against
``r4w_tpu.ops.resample``, ``.sync`` and ``.sync2`` on the same numpy
inputs, made from seeds; then the JAX package's own tests of those
modules (``tests/test_sync2.py``, ``tests/test_resample_sync_extras.py``
and the resample and sync tests of ``tests/test_ops.py``) run on the port.

Decisions (indices, offsets, masks, gates, argmaxes, symbol signs) are
exact. Floats are max|port − reference| / max|reference| within the
tolerance named beside each check, with the measured value in its
comment: float32 sums in another order, and the loops' float32
recursions, which XLA's compiled scan fuses into FMAs (and whose sin, cos
and atan2 are XLA's own polynomials) where the port rounds each product.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.ops import pulse as ref_pulse
from r4w_tpu.ops import resample as ref_rs
from r4w_tpu.ops import sync as ref_sync
from r4w_tpu.ops import sync2 as ref_sync2
from r4w_tpu_torch.ops import resample, sync, sync2
from torch_port_proxy import run_reference_test

SUM_TOL = 5e-6      # gathers, float32 sums and FFTs in another order (measured 2.6e-6)
CUMSUM_TOL = 2e-5   # differences of cumulative sums, XLA's against torch's (measured 5.1e-6)
LOOP_TOL = 1e-4     # phase, frequency and timing loops over a few thousand steps (measured 2.9e-5)


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


def _eq(got, want) -> None:
    np.testing.assert_array_equal(got.numpy() if isinstance(got, torch.Tensor) else got,
                                  np.asarray(want))


def _qpsk_rrc(n_sym: int, seed: int, sps: int = 4) -> np.ndarray:
    rng = np.random.default_rng(seed)
    syms = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, n_sym)))
    up = np.zeros(n_sym * sps, complex)
    up[::sps] = syms
    taps = ref_pulse.root_raised_cosine_taps(sps, 8, 0.35)
    return np.convolve(up, taps)[: n_sym * sps].astype(np.complex64)


# ---------------------------------------------------------------- resample


@pytest.mark.parametrize("ratio,taps,filters_", [(1.5, 8, 32), (0.7, 8, 32), (2.37, 12, 16)])
def test_arbitrary_resample(ratio, taps, filters_):
    rng = np.random.default_rng(1)
    for x in (_iq(rng, 2, 700), rng.standard_normal(501).astype(np.float32)):
        assert _rel(resample.arbitrary_resample(_t(x), ratio, taps, filters_),
                    ref_rs.arbitrary_resample(jnp.asarray(x), ratio, taps, filters_)) < SUM_TOL


def test_float32_positions_as_the_reference():
    """With 64-bit types off the reference's float64 positions are float32:
    at ratio 1.1 over 20,000 samples, 1,023 of the float32 positions k/1.1
    round up onto the next integer where float64 stays below it; the port
    takes the reference's (float32) samples there."""
    ratio, x = 1.1, np.arange(20000, dtype=np.float32)
    k = np.arange(int(np.floor(len(x) * ratio)))
    f32 = np.floor(k.astype(np.float32) / np.float32(ratio))
    assert np.count_nonzero(np.floor(k / ratio) != f32) == 1023
    y = resample.arbitrary_resample(_t(x), ratio, 2, 1)
    _eq(y, ref_rs.arbitrary_resample(jnp.asarray(x), ratio, 2, 1))


@pytest.mark.parametrize("channels,taps", [(8, 8), (4, 6), (16, 4)])
def test_pfb_channelizer_and_synthesizer(channels, taps):
    rng = np.random.default_rng(2)
    x = _iq(rng, 2, 1030)
    ch = resample.pfb_channelizer(_t(x), channels, taps)
    assert _rel(ch, ref_rs.pfb_channelizer(jnp.asarray(x), channels, taps)) < SUM_TOL
    assert _rel(resample.pfb_synthesizer(ch, taps),
                ref_rs.pfb_synthesizer(jnp.asarray(ch.numpy()), taps)) < SUM_TOL
    assert resample.pfb_channelizer(_t(x[:, :10]), channels, taps).shape == (2, 0, channels)


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("ratio", [1.25, 0.7, 1.0002])
def test_farrow_resample(order, ratio):
    rng = np.random.default_rng(3)
    for x in (_iq(rng, 2, 400), rng.standard_normal(333).astype(np.float32)):
        assert _rel(resample.farrow_resample(_t(x), ratio, order),
                    ref_rs.farrow_resample(jnp.asarray(x), ratio, order)) < SUM_TOL
    with pytest.raises(ValueError):
        resample.farrow_resample(torch.ones(16), 1.0, order=5)


@pytest.mark.parametrize("channels,taps,window", [(8, 1, None), (8, 4, None), (16, 2, None),
                                                  (4, 3, "hann")])
def test_wola(channels, taps, window):
    rng = np.random.default_rng(4)
    x = _iq(rng, 2, 640)
    w = np.hanning(channels * taps) if window else None
    ch = resample.wola_channelize(_t(x), channels, taps, w)
    want = ref_rs.wola_channelize(jnp.asarray(x), channels, taps, w)
    assert _rel(ch, want) < SUM_TOL
    assert _rel(resample.wola_synthesize(ch, taps, w),
                ref_rs.wola_synthesize(jnp.asarray(ch.numpy()), taps, w)) < SUM_TOL


def _branches(track: np.ndarray, n: int, sps: float = 4.0, nf: int = 32) -> np.ndarray:
    """The branch index of each pfb_clock_sync step, from the phase before it."""
    phase = np.concatenate([[np.float32(0)], track[:-1]]).astype(np.float32)
    pos = np.arange(len(track), dtype=np.float32) * np.float32(sps) + phase
    frac = pos - np.floor(pos)
    return np.round((np.float32(1) - frac) * nf).astype(np.int32) % nf


@pytest.mark.parametrize("n_sym,snr", [(600, None), (3000, 12.0)])
def test_pfb_clock_sync(n_sym, snr):
    x = _qpsk_rrc(n_sym, 5)
    taps = ref_pulse.root_raised_cosine_taps(4, 8, 0.35)
    mf = np.convolve(x, taps)[: len(x)].astype(np.complex64)
    if snr is not None:
        rng = np.random.default_rng(6)
        mf = (mf + 10 ** (-snr / 20) * _iq(rng, len(mf)) / np.sqrt(2)).astype(np.complex64)
    syms, track = resample.pfb_clock_sync(_t(mf), 4, rrc_beta=0.35)
    rsyms, rtrack = ref_rs.pfb_clock_sync(jnp.asarray(mf), 4, rrc_beta=0.35)
    b, rb = _branches(track.numpy(), len(mf)), _branches(np.asarray(rtrack), len(mf))
    first = np.flatnonzero(b != rb)
    assert not first.size, f"branch indices first differ at step {first[0]}"
    # the reference's summation order and fused multiply-adds: bit for bit
    _eq(syms, rsyms)
    _eq(track, rtrack)
    with pytest.raises(ValueError):
        resample.pfb_clock_sync(_t(mf).reshape(2, -1), 4)
    assert resample.pfb_clock_sync(_t(mf[:30]), 4)[0].shape == (0,)


# ---------------------------------------------------------------- sync


def test_cfo_estimate_and_correct():
    rng = np.random.default_rng(7)
    fs = 100_000.0
    x = (np.exp(2j * np.pi * 1234.5 * np.arange(3000) / fs) * _qpsk_rrc(750, 7)
         + 0.05 * _iq(rng, 3000)).astype(np.complex64)
    xb = np.stack([x, x[::-1].copy()])
    for order in (1, 2, 4):
        for method in ("fft", "phase"):
            assert _rel(sync.cfo_estimate(_t(xb), fs, order, method),
                        ref_sync.cfo_estimate(jnp.asarray(xb), fs, order, method)) < SUM_TOL
    assert _rel(sync.cfo_correct(_t(xb), 1234.5, fs, 0.3),
                ref_sync.cfo_correct(jnp.asarray(xb), 1234.5, fs, 0.3)) < SUM_TOL


@pytest.mark.parametrize("order", [2, 4])
def test_costas_loop(order):
    rng = np.random.default_rng(8)
    n = 2000
    bits = rng.integers(0, order, n)
    x = np.exp(2j * np.pi * bits / order + 1j * np.pi / 4 * (order == 4))
    x = (x * np.exp(1j * (0.02 * np.arange(n) + 0.5)) + 0.05 * _iq(rng, n)).astype(np.complex64)
    got = sync.costas_loop(_t(x), 0.02, order, 0.1, 0.01)
    want = ref_sync.costas_loop(jnp.asarray(x), 0.02, order, 0.1, 0.01)
    assert type(got).__name__ == "LoopOut" and got._fields == want._fields
    for g, w in zip(got, want):
        assert _rel(g, w) < LOOP_TOL


def test_pll_track_tone():
    x = (np.exp(1j * (0.05 * np.arange(1500) + 1.0))).astype(np.complex64)
    for g, w in zip(sync.pll_track_tone(_t(x), 0.02),
                    ref_sync.pll_track_tone(jnp.asarray(x), 0.02)):
        assert _rel(g, w) < LOOP_TOL


def test_timing_detectors():
    x = _qpsk_rrc(300, 9)
    xb = np.stack([x, np.roll(x, 3)])
    for sps in (4, 8):
        for fn in ("gardner_ted", "mueller_muller_ted", "early_late_gate"):
            assert _rel(getattr(sync, fn)(_t(xb), sps),
                        getattr(ref_sync, fn)(jnp.asarray(xb), sps)) < SUM_TOL, fn
        _eq(sync.best_timing_offset(_t(xb), sps), ref_sync.best_timing_offset(jnp.asarray(xb), sps))


def test_correlate_sync_and_schmidl_cox():
    rng = np.random.default_rng(10)
    pre = _iq(rng, 64)
    x = (0.1 * _iq(rng, 2, 500)).astype(np.complex64)
    x[0, 137:201] += pre
    x[1, 40:104] += pre
    best, peak, metric = sync.correlate_sync(_t(x), _t(pre))
    rbest, rpeak, rmetric = ref_sync.correlate_sync(jnp.asarray(x), jnp.asarray(pre))
    _eq(best, rbest)
    assert _rel(peak, rpeak) < SUM_TOL and _rel(metric, rmetric) < SUM_TOL
    half = _iq(rng, 32)
    y = (0.05 * _iq(rng, 2, 300)).astype(np.complex64)
    y[:, 100:164] += np.concatenate([half, half])
    d, m, p = sync.schmidl_cox(_t(y), 32)
    rd, rm, rp = ref_sync.schmidl_cox(jnp.asarray(y), 32)
    _eq(d, rd)
    assert _rel(m, rm) < CUMSUM_TOL and _rel(p, rp) < CUMSUM_TOL
    d, m, p = sync.schmidl_cox(_t(y[:, :40]), 32)
    assert d.dtype == torch.int32 and m.shape == (2, 0)


def test_dpll_and_fll():
    rng = np.random.default_rng(11)
    e = (0.3 * rng.standard_normal(800) + 0.05).astype(np.float32)
    for g, w in zip(sync.dpll_advance(_t(e), 0.1, 0.01, 0.5),
                    ref_sync.dpll_advance(jnp.asarray(e), 0.1, 0.01, 0.5)):
        assert _rel(g, w) < LOOP_TOL
    x = (_qpsk_rrc(500, 12) * np.exp(1j * 0.02 * np.arange(2000))).astype(np.complex64)
    for g, w in zip(sync.fll_band_edge(_t(x), 4, loop_bw=0.01),
                    ref_sync.fll_band_edge(jnp.asarray(x), 4, loop_bw=0.01)):
        assert _rel(g, w) < LOOP_TOL


def test_access_code_pn_and_bursts():
    rng = np.random.default_rng(12)
    code = rng.integers(0, 2, 24)
    bits = rng.integers(0, 2, (2, 300))
    bits[:, 100:124] = code
    _eq(sync.access_code_correlate(_t(bits), _t(code)),
        ref_sync.access_code_correlate(jnp.asarray(bits), jnp.asarray(code)))
    for errs in (0, 2):
        _eq(sync.access_code_detect(_t(bits), _t(code), errs),
            ref_sync.access_code_detect(jnp.asarray(bits), jnp.asarray(code), errs))
    from r4w_tpu_torch.ops.spreading import m_sequence

    pn = m_sequence(7).astype(np.float32)
    for rx in ((np.tile(np.roll(pn, 37), 4) + 0.5 * rng.standard_normal(508)).astype(np.float32),
               (np.tile(np.roll(pn, 5), 3)[:300] * (1 + 1j)).astype(np.complex64)):
        off, peak, mag = sync.pn_sync_correlate(_t(rx), _t(pn))
        roff, rpeak, rmag = ref_sync.pn_sync_correlate(jnp.asarray(rx), jnp.asarray(pn))
        _eq(off, roff)
        assert _rel(peak, rpeak) < SUM_TOL and _rel(mag, rmag) < SUM_TOL
    tx = (np.asarray([1.0, -1.0, 1.0])[:, None] * np.roll(pn, 5)[None, :]).reshape(-1)
    assert _rel(sync.despread_pn(_t(tx), _t(pn), 5),
                ref_sync.despread_pn(jnp.asarray(tx), jnp.asarray(pn), 5)) < SUM_TOL
    x = (0.05 * _iq(rng, 3000)).astype(np.complex64)
    pre = np.exp(2j * np.pi * 0.1 * np.arange(64)).astype(np.complex64)
    x[1000:1064] += pre
    x[1064:1464] += np.exp(2j * np.pi * 0.02 * np.arange(400)).astype(np.complex64)
    mask, pdb = sync.burst_detect(_t(x), 64, 6.0)
    rmask, rpdb = ref_sync.burst_detect(jnp.asarray(x), 64, 6.0)
    _eq(mask, rmask)
    assert np.max(np.abs(pdb.numpy() - np.asarray(rpdb))) < 1e-4  # dB (measured 4e-6)
    got = sync.burst_synchronize(_t(x), _t(pre))
    want = ref_sync.burst_synchronize(jnp.asarray(x), jnp.asarray(pre))
    _eq(got[0], want[0])
    assert _rel(got[1], want[1]) < SUM_TOL and _rel(got[2], want[2]) < SUM_TOL


# ---------------------------------------------------------------- sync2


def test_carrier_loops():
    rng = np.random.default_rng(13)
    fs = 10_000.0
    tone = (np.exp(2j * np.pi * 200.0 * np.arange(1500) / fs) + 0.05 * _iq(rng, 1500)
            ).astype(np.complex64)
    for g, w in zip(sync2.afc(_t(tone), fs, 0.05, 10.0), ref_sync2.afc(jnp.asarray(tone), fs, 0.05,
                                                                       10.0)):
        assert _rel(g, w) < LOOP_TOL
    qpsk = (np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, 1500)) + 0.3j)
            ).astype(np.complex64)
    for order in (2, 4):
        for g, w in zip(sync2.carrier_recovery_mpsk(_t(qpsk), order, 0.05),
                        ref_sync2.carrier_recovery_mpsk(jnp.asarray(qpsk), order, 0.05)):
            assert _rel(g, w) < LOOP_TOL
    for g, w in zip(sync2.pll_carrier_tracking(_t(tone), 0.05),
                    ref_sync2.pll_carrier_tracking(jnp.asarray(tone), 0.05)):
        assert _rel(g, w) < LOOP_TOL
    for g, w in zip(sync2.pll_biquad(_t(tone)), ref_sync2.pll_biquad(jnp.asarray(tone))):
        assert _rel(g, w) < LOOP_TOL
    freqs = (0.01 * rng.standard_normal(1000)).astype(np.float32)
    _eq(sync2.freq_lock_detector(_t(freqs), 0.01, 64),
        ref_sync2.freq_lock_detector(jnp.asarray(freqs), 0.01, 64))
    assert _rel(sync2.constellation_rotation_detect(_t(qpsk)),
                ref_sync2.constellation_rotation_detect(jnp.asarray(qpsk))) < SUM_TOL
    for nfft in (4096, 1024, 8):
        assert _rel(sync2.tuning_estimate(_t(tone), fs, nfft),
                    ref_sync2.tuning_estimate(jnp.asarray(tone), fs, nfft)) < SUM_TOL


def test_symbol_timing():
    sps = 4
    rng = np.random.default_rng(14)
    bits = 2.0 * rng.integers(0, 2, 600) - 1.0
    up = np.zeros(600 * sps)
    up[::sps] = bits
    x = (np.convolve(up, np.hanning(2 * sps))[: 600 * sps] + 0.05 * rng.standard_normal(2400)
         ).astype(np.complex64)
    for mu0 in (0.0, 1.3):
        assert _rel(sync2.symbol_sync_mm(_t(x), sps, 0.05, mu0),
                    ref_sync2.symbol_sync_mm(jnp.asarray(x), sps, 0.05, mu0)) < LOOP_TOL
    for kind in ("gardner", "early_late"):
        assert _rel(sync2.timing_error_detector(_t(x), 8, kind),
                    ref_sync2.timing_error_detector(jnp.asarray(x), 8, kind)) < SUM_TOL
    with pytest.raises(ValueError):
        sync2.timing_error_detector(_t(x), 8, "zero_crossing")
    assert _rel(sync2.hybrid_timing_phase_detector(_t(x), 8),
                ref_sync2.hybrid_timing_phase_detector(jnp.asarray(x), 8)) < SUM_TOL
    assert _rel(sync2.feedforward_timing_estimate(_t(x), 8),
                ref_sync2.feedforward_timing_estimate(jnp.asarray(x), 8)) < SUM_TOL
    got, want = sync2.blind_timing_recover(_t(x), 8), ref_sync2.blind_timing_recover(
        jnp.asarray(x), 8)
    _eq(got[0], want[0])
    chips = 2.0 * rng.integers(0, 2, 32) - 1.0
    ref = np.repeat(chips, sps).astype(np.complex64)
    y = np.zeros(512, np.complex64)
    y[6:6 + ref.shape[0]] = ref
    for g, w in zip(sync2.delay_lock_loop(_t(y), _t(ref), sps, 0.2),
                    ref_sync2.delay_lock_loop(jnp.asarray(y), jnp.asarray(ref), sps, 0.2)):
        assert _rel(g, w) < LOOP_TOL


def test_correlators_and_preambles():
    rng = np.random.default_rng(15)
    b = _iq(rng, 64)
    x = (0.1 * _iq(rng, 256)).astype(np.complex64)
    x[50:114] += b * np.exp(1j * 0.7).astype(np.complex64)
    for pat in (b, b[:1]):
        for norm in (True, False):
            lags, c = sync2.cross_correlator(_t(x), _t(pat), norm)
            rlags, rc = ref_sync2.cross_correlator(jnp.asarray(x), jnp.asarray(pat), norm)
            _eq(lags, rlags)
            assert _rel(c, rc) < SUM_TOL
    got = sync2.correlate_estimate(_t(x), _t(b), 0.3)
    want = ref_sync2.correlate_estimate(jnp.asarray(x), jnp.asarray(b), 0.3)
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    assert _rel(got[2], want[2]) < SUM_TOL and _rel(got[3], want[3]) < SUM_TOL
    assert _rel(sync2.periodic_autocorrelator(_t(x), 32, 4),
                ref_sync2.periodic_autocorrelator(jnp.asarray(x), 32, 4)) < SUM_TOL
    for n in (1, 8, 32):
        for g, w in zip(sync2.golay_complementary_pair(n, "cpu"),
                        ref_sync2.golay_complementary_pair(n)):
            _eq(g, w)
    for g, w in zip(sync2.golay_correlate(_t(x), 16),
                    ref_sync2.golay_correlate(jnp.asarray(x), 16)):
        assert _rel(g, w) < SUM_TOL
    for kind, n in (("alternating", 16), ("barker13", 30), ("golay", 32)):
        _eq(sync2.preamble_gen(kind, n, "cpu"), ref_sync2.preamble_gen(kind, n))
    with pytest.raises(ValueError):
        sync2.preamble_gen("zadoff", 8, "cpu")


def test_agc_gating_and_control():
    rng = np.random.default_rng(16)
    x = np.concatenate([0.1 * _iq(rng, 300), 10 * _iq(rng, 330)]).astype(np.complex64)
    for window in (64, 100):
        assert _rel(sync2.feedforward_agc(_t(x), 2.0, window),
                    ref_sync2.feedforward_agc(jnp.asarray(x), 2.0, window)) < SUM_TOL
    for g, w in zip(sync2.agc_attack_decay(_t(x), 1.0, 0.2, 0.05),
                    ref_sync2.agc_attack_decay(jnp.asarray(x), 1.0, 0.2, 0.05)):
        assert _rel(g, w) < LOOP_TOL
    p = np.full(300, -40.0, np.float32)
    p[10:30] = 0.0
    p[100:103] = -20.0
    p[150:200] = -5.0
    _eq(sync2.burst_gating_controller(_t(p), -10.0, -30.0, 8),
        ref_sync2.burst_gating_controller(jnp.asarray(p), -10.0, -30.0, 8))
    e = rng.standard_normal(400).astype(np.float32)
    got = sync2.pid_controller(_t(e), 1.0, 0.1, 0.5, (0.5, -0.2))
    want = ref_sync2.pid_controller(jnp.asarray(e), 1.0, 0.1, 0.5, (0.5, -0.2))
    assert _rel(got[0], want[0]) < LOOP_TOL
    assert _rel(got[1][0], want[1][0]) < LOOP_TOL and _rel(got[1][1], want[1][1]) == 0.0
    got = sync2.control_loop_2nd(_t(e), 0.1, 0.707, (0.3, 0.01))
    want = ref_sync2.control_loop_2nd(jnp.asarray(e), 0.1, 0.707, (0.3, 0.01))
    for g, w in zip(got[:2] + got[2], want[:2] + want[2]):
        assert _rel(g, w) < LOOP_TOL


def test_clocks_and_block_table():
    g, r = sync2.GpsTime.from_unix(1_700_000_123.5), ref_sync2.GpsTime.from_unix(1_700_000_123.5)
    assert (g.week, g.tow, g.to_unix()) == (r.week, r.tow, r.to_unix())
    for tod in (0, 3661, 45296, 86398):
        w, s = sync2.irig_b_encode(tod, device="cpu")
        rw, rs = ref_sync2.irig_b_encode(tod)
        _eq(w, rw)
        _eq(s, rs)
        assert sync2.irig_b_decode(w) == ref_sync2.irig_b_decode(rw) == tod
    assert sync2.network_time_offset(0.0, 5.1, 5.2, 0.3) == ref_sync2.network_time_offset(
        0.0, 5.1, 5.2, 0.3)
    clk, rclk = sync2.MultiRateClock(1000.0, (2, 5, 7)), ref_sync2.MultiRateClock(1000.0, (2, 5, 7))
    for n in (10, 3, 101):
        assert clk.advance(n) == rclk.advance(n)
    assert clk.time() == rclk.time()
    y = np.random.default_rng(17).standard_normal(10_000).astype(np.float32)
    for tau in (1, 10, 100):
        assert _rel(sync2.csac_allan_deviation(_t(y), tau),
                    ref_sync2.csac_allan_deviation(jnp.asarray(y), tau)) < SUM_TOL
    assert sync2.BLOCKS == ref_sync2.BLOCKS
    for fn_name, *_ in sync2.BLOCKS.values():
        assert hasattr(sync2, fn_name), fn_name


# ------------------------------------------- the reference's own tests


_SYNC2_TESTS = [
    "TestCarrier.test_afc_centers_tone", "TestCarrier.test_carrier_recovery_qpsk",
    "TestCarrier.test_pll_tracks_freq", "TestCarrier.test_rotation_detector",
    "TestCarrier.test_tuning_estimator", "TestTiming.test_feedforward_timing_estimate",
    "TestTiming.test_blind_timing_recover_decodes", "TestTiming.test_symbol_sync_mm_converges",
    "TestTiming.test_ted_zero_at_aligned", "TestTiming.test_delay_lock_loop_converges",
    "TestCorrelators.test_cross_correlator_lag", "TestCorrelators.test_correlate_estimate_phase",
    "TestCorrelators.test_periodic_autocorrelator_cyclic",
    "TestCorrelators.test_golay_pair_perfect_autocorr", "TestCorrelators.test_preamble_gen",
    "TestAgcGate.test_feedforward_agc_normalizes", "TestAgcGate.test_agc_attack_decay",
    "TestAgcGate.test_burst_gate_hang", "TestControl.test_pid_settles_error",
    "TestControl.test_control_loop_tracks", "TestClocks.test_gps_time_roundtrip",
    "TestClocks.test_irig_b_roundtrip", "TestClocks.test_network_time_offset",
    "TestClocks.test_multi_rate_clock", "TestClocks.test_allan_deviation_white_noise",
]


@pytest.mark.parametrize("name", _SYNC2_TESTS)
def test_reference_sync2_tests_on_the_port(monkeypatch, name):
    """tests/test_sync2.py's 25 tests, their bars applied to the port's outputs."""
    run_reference_test(monkeypatch, "test_sync2", name, sync2="r4w_tpu_torch.ops.sync2")


@pytest.mark.parametrize("name", [
    "test_farrow_tone_preserved", "test_farrow_orders_and_downsample", "test_farrow_complex",
    "test_farrow_bad_order", "test_wola_rect_perfect_reconstruction",
    "test_wola_tone_isolation", "test_pfb_clock_sync_recovers_bpsk", "test_fll_band_edge_locks",
    "test_dpll_integrates_constant_error", "test_access_code_detect", "test_pn_sync_finds_offset",
    "test_despread_pn", "test_burst_detect_and_synchronize",
    "test_equiripple_lowpass_beats_windowed", "test_equiripple_bandpass",
    "test_equiripple_rejects_even_taps", "test_remez_exchange_matches_scipy_taps",
    "test_remez_exchange_equiripple_alternation",
])
def test_reference_resample_sync_extras_on_the_port(monkeypatch, name):
    """tests/test_resample_sync_extras.py's 18 tests on the port (its filter
    designs through the package attribute its last five import)."""
    run_reference_test(monkeypatch, "test_resample_sync_extras", name,
                       rs="r4w_tpu_torch.ops.resample", sy="r4w_tpu_torch.ops.sync",
                       **{"r4w_tpu.ops.filters": "r4w_tpu_torch.ops.filters"})


@pytest.mark.parametrize("name", [
    "test_polyphase_decimate_tone", "test_rational_resample_length",
    "test_halfband_decimate_preserves_low_tone", "test_arbitrary_resample_tone_ratio",
    "test_pfb_channelizer_isolates_tone", "test_cfo_estimate_and_correct",
    "test_costas_locks_bpsk", "test_correlate_sync_finds_offset",
    "test_schmidl_cox_detects_repeated_halves", "test_best_timing_offset",
])
def test_reference_ops_resample_sync_tests_on_the_port(monkeypatch, name):
    """tests/test_ops.py's resample and sync tests on the port."""
    run_reference_test(monkeypatch, "test_ops", name, filters="r4w_tpu_torch.ops.filters",
                       pulse="r4w_tpu_torch.ops.pulse", resample="r4w_tpu_torch.ops.resample",
                       sync="r4w_tpu_torch.ops.sync")
