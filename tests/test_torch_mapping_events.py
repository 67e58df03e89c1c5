"""The port's ``ops.mapping`` and ``ops.events`` against ``r4w_tpu.ops.mapping``
and ``r4w_tpu.ops.events`` on the same numpy inputs, made from seeds (the
broadcast FM functions at ``tests/test_mapping.py``'s sizes); then the JAX
package's own mapping tests run on the port, and its event tests' host
models held against the port.

Decisions (symbol indices, slicer outputs, RDS bits, event masks and
indices) are exact. Floats are max|port − reference| / max|reference|
within FIR_TOL: FIR taps, FFTs and complex products in another order
(measured values in the comments). The de-emphasis recursion of
`fm_receiver` and `am_demod`'s DC blocker agree within RECURSION_TOL: the
reference's compiled scan may fuse a step's product and sum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.ops import events as ref_events
from r4w_tpu.ops import mapping as ref_mapping
from r4w_tpu_torch.channel import threefry
from r4w_tpu_torch.ops import events, mapping
from test_events import _ref_deadtime_runs, _ref_refractory
from torch_port_proxy import run_reference_test

FIR_TOL = 1e-5         # FIRs of up to 301 taps on tones, products and FFTs (measured 1.3e-6)
RECURSION_TOL = 1e-5   # one-pole recursions against a scan that may fuse (measured 2.4e-7)


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


# ----------------------------------------------------------------- events


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("refractory", [1, 3, 16])
def test_refractory_trigger(seed, refractory):
    mask = np.random.default_rng(seed).random((3, 400)) < 0.25
    got = events.refractory_trigger(_t(mask), refractory).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref_events.refractory_trigger(mask, refractory)))
    for row in range(3):
        np.testing.assert_array_equal(got[row], _ref_refractory(mask[row], refractory))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("dead_time", [1, 4, 32])
def test_deadtime_runs(seed, dead_time):
    mask = np.random.default_rng(seed).random((2, 300)) < 0.3
    s, e = events.deadtime_runs(_t(mask), dead_time)
    rs, re_ = ref_events.deadtime_runs(mask, dead_time)
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(e.numpy(), np.asarray(re_))
    starts = np.nonzero(s[0].numpy())[0].tolist()
    ends = np.nonzero(e[0].numpy())[0].tolist()
    if len(ends) < len(starts):
        ends.append(mask.shape[1])
    assert list(zip(starts, ends)) == _ref_deadtime_runs(mask[0], dead_time)


@pytest.mark.parametrize("p,size", [(0.05, 64), (0.3, 16), (0.0, 8), (1.0, 300)])
def test_masked_indices(p, size):
    mask = np.random.default_rng(int(100 * p)).random(300) < p
    idx, valid = events.masked_indices(_t(mask), size)
    ridx, rvalid = ref_events.masked_indices(mask, size)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(rvalid))
    assert idx.dtype == torch.int32


# --------------------------------------------------------------- mapping


@pytest.mark.parametrize("name", ["bpsk", "qpsk", "8psk", "qam16", "qam64", "qam256"])
def test_tables_map_and_demap(name):
    table = mapping.constellation_table(name, "cpu")
    np.testing.assert_array_equal(table.numpy(), np.asarray(ref_mapping.constellation_table(name)))
    rng = np.random.default_rng(len(name))
    idx = rng.integers(0, table.shape[0], 300)
    pts = mapping.symbol_map(_t(idx), table)
    np.testing.assert_array_equal(pts.numpy(), np.asarray(ref_mapping.symbol_map(idx, table.numpy())))
    noisy = pts.numpy() + 0.2 * _iq(rng, 300)
    np.testing.assert_array_equal(mapping.symbol_demap(_t(noisy), table).numpy(),
                                  np.asarray(ref_mapping.symbol_demap(noisy, table.numpy())))
    got = mapping.constellation_receiver(_t(noisy), table)
    want = ref_mapping.constellation_receiver(noisy, table.numpy())
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert _rel(got[1], want[1]) < 1e-5 and _rel(got[2], want[2]) < 1e-5


def test_slicers_chunks_lut_soft_and_vq():
    rng = np.random.default_rng(3)
    x = _iq(rng, 200)
    for kind in ("bpsk", "qpsk"):
        np.testing.assert_array_equal(mapping.symbol_slicer(_t(x), kind).numpy(),
                                      np.asarray(ref_mapping.symbol_slicer(x, kind)))
    bits = rng.integers(0, 2, 99)
    table = ref_mapping.constellation_table("8psk")
    np.testing.assert_array_equal(mapping.chunks_to_symbols(_t(bits), np.asarray(table), 3).numpy(),
                                  np.asarray(ref_mapping.chunks_to_symbols(bits, table, 3)))
    lut = rng.permutation(256)
    data = rng.integers(0, 256, 50)
    np.testing.assert_array_equal(mapping.map_bb(_t(data), _t(lut)).numpy(),
                                  np.asarray(ref_mapping.map_bb(data, lut)))
    llr = (3 * rng.standard_normal(64)).astype(np.float32)
    got, want = mapping.soft_decision_decode(_t(llr)), ref_mapping.soft_decision_decode(llr)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert _rel(got[1], want[1]) < 1e-6
    pts = rng.standard_normal((40, 3)).astype(np.float32)
    cb = rng.standard_normal((6, 3)).astype(np.float32)
    got, want = mapping.vector_quantize(_t(pts), _t(cb)), ref_mapping.vector_quantize(pts, cb)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("sps", [2, 4, 8])
def test_oqpsk(sps):
    bits = np.random.default_rng(sps).integers(0, 2, 128)
    tx = mapping.oqpsk_modulate(_t(bits), sps)
    rtx = ref_mapping.oqpsk_modulate(jnp.asarray(bits, jnp.int32), sps)
    assert _rel(tx, rtx) < 1e-6
    np.testing.assert_array_equal(mapping.oqpsk_demodulate(tx, sps).numpy(),
                                  np.asarray(ref_mapping.oqpsk_demodulate(rtx, sps)))


@pytest.mark.parametrize("m,snr", [(16, None), (16, 20.0), (64, 24.0), (4, 3.0)])
def test_qam_transceiver_on_the_references_noise(m, snr):
    bits = np.random.default_rng(m).integers(0, 2, 4 * 6 * 50)
    kw = {} if snr is None else {"snr_db": snr}
    tx, rx = mapping.qam_transceiver(_t(bits), m, key=threefry.key(0) if snr else None, **kw)
    rtx, rrx = ref_mapping.qam_transceiver(jnp.asarray(bits, jnp.int32), m,
                                           key=jax.random.key(0) if snr else None, **kw)
    assert _rel(tx, rtx) < 1e-6
    np.testing.assert_array_equal(rx.numpy(), np.asarray(rrx))


def test_analog_modems():
    fs = 48_000.0
    t = np.arange(9600) / fs
    x = (1.0 + 0.5 * np.sin(2 * np.pi * 1000 * t)).astype(np.complex64)
    for coherent in (False, True):
        assert _rel(mapping.am_demod(_t(x), coherent),
                    ref_mapping.am_demod(x, coherent)) < RECURSION_TOL
    audio = np.sin(2 * np.pi * 700 * np.arange(8192) / 8000.0).astype(np.float32)
    for upper in (True, False):
        usb = mapping.ssb_modulate(_t(audio), 8000.0, upper)
        assert _rel(usb, ref_mapping.ssb_modulate(audio, 8000.0, upper)) < FIR_TOL
        np.testing.assert_array_equal(mapping.ssb_demodulate(usb).numpy(), usb.real.numpy())


def _fm_tone(fs=240_000.0, n=48_000):
    t = np.arange(n) / fs
    phase = 2 * np.pi * 75_000.0 * np.cumsum(np.sin(2 * np.pi * 1000 * t)) / fs
    return np.exp(1j * phase).astype(np.complex64)


@pytest.mark.parametrize("audio_rate", [None, 48_000.0])
def test_fm_receiver(audio_rate):
    x = _fm_tone()
    assert _rel(mapping.fm_receiver(_t(x), 240_000.0, audio_rate=audio_rate),
                ref_mapping.fm_receiver(x, 240_000.0, audio_rate=audio_rate)) < FIR_TOL


def _mpx(fs=192_000.0, n=96_000, seed=4):
    """``tests/test_mapping.py``'s stereo multiplex and its RDS multiplex."""
    t = np.arange(n) / fs
    left, right = np.sin(2 * np.pi * 800 * t), np.sin(2 * np.pi * 2000 * t)
    stereo = ((left + right) / 2 + 0.1 * np.sin(2 * np.pi * 19_000 * t)
              + (left - right) / 2 * np.sin(2 * np.pi * 38_000 * t)).astype(np.float32)
    rng = np.random.default_rng(seed)
    n_bits = int(n / fs * 1187.5) + 2
    diff_bits = rng.integers(0, 2, n_bits)
    enc = np.cumsum(diff_bits) % 2
    bpsk = 2.0 * enc[np.minimum((t * 1187.5).astype(int), n_bits - 1)] - 1.0
    rds = (0.1 * np.sin(2 * np.pi * 19_000 * t)
           + 0.3 * bpsk * np.cos(2 * np.pi * 57_000 * t)).astype(np.float32)
    return stereo, rds, diff_bits


def test_fm_stereo_decode():
    stereo, _, _ = _mpx()
    left, right, present = mapping.fm_stereo_decode(_t(stereo), 192_000.0)
    rl, rr, rp = ref_mapping.fm_stereo_decode(stereo, 192_000.0)
    assert bool(present) == bool(rp)
    assert _rel(left, rl) < FIR_TOL and _rel(right, rr) < FIR_TOL


@pytest.mark.parametrize("fs", [192_000.0, 240_000.0])
def test_rds_subcarrier_demod(fs):
    _, rds, diff_bits = _mpx(fs, int(fs / 2))
    bits, soft = mapping.rds_subcarrier_demod(_t(rds), fs)
    rbits, rsoft = ref_mapping.rds_subcarrier_demod(rds, fs)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(rbits))
    assert _rel(soft, rsoft) < FIR_TOL
    match = np.mean(bits.numpy()[4:-4] == diff_bits[4:4 + bits.shape[0] - 8])
    assert match > 0.9 or match < 0.1


def test_rds_positions_are_float32_products():
    """At a minute of samples float32 products of k·sps differ from the
    float64 ones: the port picks the reference's samples."""
    fs, n = 240_000.0, 14_400_000
    got = mapping.rds_symbol_positions(n, fs, 300, "cpu").numpy()
    sps = fs / 1187.5
    want = (np.arange(got.shape[0], dtype=np.float32) * np.float32(sps)).astype(np.int32) \
        + int(sps / 2) + 300
    np.testing.assert_array_equal(got, want)
    f64 = (np.arange(got.shape[0]) * sps).astype(np.int64) + int(sps / 2) + 300
    assert np.any(f64 != got)


def test_ofdm_allocation_waterfill_pilots():
    rng = np.random.default_rng(5)
    occ, pil = [-10, -5, -2, 2, 5, 10], [-7, 7]
    data = _iq(rng, 20)
    grid = mapping.ofdm_carrier_allocate(_t(data), 32, occ, pil)
    rgrid = ref_mapping.ofdm_carrier_allocate(data, 32, occ, pil)
    np.testing.assert_array_equal(grid.numpy(), np.asarray(rgrid))
    np.testing.assert_array_equal(mapping.ofdm_carrier_deallocate(grid, occ).numpy(),
                                  np.asarray(ref_mapping.ofdm_carrier_deallocate(rgrid, occ)))
    gains = rng.random(16).astype(np.float32) + 0.01
    assert _rel(mapping.multicarrier_waterfill(_t(gains), 10.0),
                ref_mapping.multicarrier_waterfill(gains, 10.0)) < 1e-6
    s = _iq(rng, 11)
    np.testing.assert_array_equal(mapping.pilot_insert(_t(s), 9 + 1j, 4).numpy(),
                                  np.asarray(ref_mapping.pilot_insert(s, 9 + 1j, 4)))


def test_papr_cfr_detector_regenerate():
    rng = np.random.default_rng(6)
    x = _iq(rng, 4096)
    assert _rel(mapping.peak_to_average(_t(x)), ref_mapping.peak_to_average(x)) < 1e-6
    assert _rel(mapping.crest_factor_reduce(_t(x), 3.0),
                ref_mapping.crest_factor_reduce(x, 3.0)) < FIR_TOL
    freqs, sym_len = [500.0, 1000.0, 1500.0, 2000.0], 80
    syms = rng.integers(0, 4, 50)
    t = np.arange(sym_len) / 8000.0
    tones = np.concatenate([np.exp(2j * np.pi * freqs[s] * t) for s in syms]).astype(np.complex64)
    tones = tones + 0.5 * _iq(rng, tones.shape[0])
    got, energy = mapping.incoherent_detect(_t(tones), freqs, 8000.0, sym_len)
    rgot, renergy = ref_mapping.incoherent_detect(tones, freqs, 8000.0, sym_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(rgot))
    assert _rel(energy, renergy) < FIR_TOL
    trig = rng.random(300) < 0.05
    for n in (100, 300, 400):
        np.testing.assert_array_equal(mapping.regenerate_bb(_t(trig), 20, 5, n).numpy(),
                                      np.asarray(ref_mapping.regenerate_bb(trig, 20, 5, n)))


def test_blocks_table_is_the_references():
    assert mapping.BLOCKS == ref_mapping.BLOCKS


MAPPING_TESTS = [
    "TestMapping.test_map_demap_roundtrip_all_constellations",
    "TestMapping.test_symbol_slicer_qpsk", "TestMapping.test_chunks_to_symbols",
    "TestMapping.test_map_bb", "TestMapping.test_constellation_receiver_metrics",
    "TestMapping.test_soft_decision_decode", "TestMapping.test_vector_quantize",
    "TestOqpskQam.test_oqpsk_roundtrip", "TestOqpskQam.test_oqpsk_no_zero_crossings",
    "TestAnalog.test_am_demod_recovers_tone", "TestAnalog.test_ssb_suppresses_opposite_sideband",
    "TestAnalog.test_fm_receiver_tone", "TestAnalog.test_fm_stereo_decoder_separates",
    "TestAnalog.test_rds_subcarrier_demod_runs",
    "TestOfdmAlloc.test_allocate_deallocate_roundtrip", "TestOfdmAlloc.test_waterfill_properties",
    "TestOfdmAlloc.test_pilot_insert", "TestPaprDetect.test_cfr_reduces_papr",
    "TestPaprDetect.test_incoherent_detector_mfsk", "TestPaprDetect.test_regenerate_bb",
]


@pytest.mark.parametrize("name", MAPPING_TESTS)
def test_reference_mapping_tests_on_the_port(monkeypatch, name):
    run_reference_test(monkeypatch, "test_mapping", name, mp="r4w_tpu_torch.ops.mapping")
