"""`ops.stream_blocks` against the JAX package.

Each function gets the inputs of its JAX test (tests/test_stream_blocks.py)
on both sides, made from the same seeds in numpy: decisions equal, floats
within TOL of the largest reference magnitude. The recursions run on the
recursion kernel's plain version and equal JAX bit for bit: the probes and
the squelch (kind ``ema``), the envelope detector (``attack_release``) and
the peak hold (``peak_hold``). The plateau detector's parallel run counter
is held against a numpy step loop; the random source's draws and
`channel.threefry`'s `randint` and `bernoulli` equal ``jax.random``'s. The
reference's own test functions also run on the port's module.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.ops import stream_blocks as ref_sb
from r4w_tpu_torch.channel import threefry
from r4w_tpu_torch.ops import stream_blocks as sb
from torch_port_proxy import check_parity, run_reference_test

TOL = 1e-5  # float32 arithmetic in another order (libm, sums)


def _cplx(rng, n) -> np.ndarray:
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


R = np.random.default_rng(7)
X = _cplx(R, 4000)
MAG = np.abs(X).astype(np.float32)
WORDS = R.integers(0, 1 << 16, 16).astype(np.int32)

CASES = [
    ("probe_power", (np.full(128, 3.0 + 4.0j, np.complex64),), {}, TOL),
    ("probe_power", (X,), {}, TOL),
    ("peak_detector", (np.where(np.arange(64) == 20, 5.0, 0.0).astype(np.float32),),
     {"threshold": 1.0}, 0.0),
    ("peak_detector", (R.standard_normal(500).astype(np.float32),), {"look": 3}, 0.0),
    ("plateau_detector", (np.isin(np.arange(40), list(range(5, 15)) + [20, 21, 22])
                          .astype(np.int32),), {"min_len": 8}, 0.0),
    ("sample_and_hold", (np.arange(8.0, dtype=np.float32), np.asarray([1, 0, 0, 1, 0, 0, 1, 0])),
     {}, 0.0),
    ("sample_and_hold", (X[:50], (R.uniform(size=50) < 0.2).astype(np.int32)), {}, 0.0),
    ("sample_counter", (np.zeros(100, np.float32),), {"state": 50}, 0.0),
    ("integrate_and_dump", (np.ones(16, np.float32), 4), {}, 0.0),
    ("keep_m_in_n", (np.arange(12, dtype=np.int32),), {"m": 2, "n": 4, "offset": 1}, 0.0),
    ("moving_avg_decim", (np.ones(64, np.float32),), {"length": 4, "decim": 2}, TOL),
    ("moving_avg_decim", (X[:300],), {"length": 5, "decim": 3, "scale": 2.0}, TOL),
    ("stretch", (np.asarray([-5.0, 0.0, 5.0], np.float32), -1.0), {}, 0.0),
    ("mute", (X[:16], 1.0), {}, 0.0),
    ("mute", (X[:16], (R.uniform(size=16) < 0.5).astype(np.float32)), {}, 0.0),
    ("signal_source", (1000, 1000.0, 100.0, "exp"), {}, TOL),
    ("signal_source", (1000, 1000.0, 100.0, "square"), {}, 0.0),
    ("signal_source", (1000, 1000.0, 100.0, "triangle"), {}, TOL),
    ("signal_source", (1000, 1000.0, 100.0, "sawtooth"), {"amplitude": 2.0, "offset": 0.5}, TOL),
    ("signal_source", (256, 1000.0, 37.0, "cos"), {"phase": 0.3}, TOL),
    ("signal_generator_sweep", (4096, 4096.0, 100.0, 900.0), {}, TOL),
    ("null_source", (64,), {}, 0.0),
    ("vector_insert", (np.zeros(8, np.float32), np.ones(2, np.float32)), {"period": 4}, 0.0),
    ("vector_insert", (np.arange(10, dtype=np.float32), np.ones(3, np.float32)),
     {"period": 4, "offset": 2}, 0.0),
    ("magnitude_squared", (X[:64],), {}, 0.0),
    ("nlog10", (MAG[:64],), {}, TOL),
    ("log_block", (MAG[:64],), {"base": 2.0}, TOL),
    ("max_block", (MAG[:8], MAG[8:16], MAG[16:24]), {}, 0.0),
    ("exponentiate", (MAG[:16], 3), {}, 0.0),
    ("exponentiate", (MAG[:16], 0.5), {}, TOL),
    ("transcendental", (MAG[:16], "tanh"), {}, TOL),
    ("phase_shift", (X[:64], np.pi / 2), {}, TOL),
    ("phase_unwrap", (np.cumsum(R.uniform(0, 3, 64)).astype(np.float32) % np.float32(2 * np.pi),),
     {}, TOL),
    ("phase_wrap", (R.uniform(-20, 20, 64).astype(np.float32),), {}, TOL),
    ("frequency_shift", (X[:100], 100.0, 1000.0), {}, TOL),
    ("frequency_shift", (X[:100], 100.0, 1000.0), {"phase0": 1.2566}, TOL),
    ("rf_mixer", (X[:64], X[64:128]), {}, TOL),
    ("rf_mixer", (X[:64], X[64:128]), {"mode": "real"}, TOL),
    ("multiply_matrix", (np.asarray([[1.0, 1.0]], np.float32),
                         np.asarray([[1.0, 2.0], [3.0, 4.0]], np.float32)), {}, 0.0),
    ("endian_swap", (WORDS,), {"word_bits": 16}, 0.0),
    ("endian_swap", (WORDS,), {"word_bits": 32}, 0.0),
    ("bitwise_op", (WORDS, WORDS[::-1].copy(), "and"), {}, 0.0),
    ("bitwise_op", (WORDS, WORDS[::-1].copy(), "xor"), {}, 0.0),
    ("bitwise_op", (WORDS, None, "not"), {}, 0.0),
    ("short_to_float", (np.asarray([16384, -3, 32767], np.int16),), {}, 0.0),
    ("float_to_short", (R.uniform(-1.2, 1.2, 32).astype(np.float32),), {}, 0.0),
    ("float_to_complex", (MAG[:8], MAG[8:16]), {}, 0.0),
    ("repack_bits", (np.asarray([0xAB, 0xCD], np.int32), 8, 4), {}, 0.0),
    ("repack_bits", (np.asarray([0xA, 0xB, 0xC, 0xD, 0x5], np.int32), 4, 8), {"msb_first": False},
     0.0),
    ("stream_to_streams", (np.arange(12, dtype=np.int32), 3), {}, 0.0),
]


SOURCES = {"signal_source", "signal_generator_sweep", "null_source"}


@pytest.mark.parametrize("name,args,kwargs,tol", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_stream_blocks_against_jax(name, args, kwargs, tol):
    port = getattr(sb, name)
    if name in SOURCES:  # sources make their stream on the card unless told
        port = functools.partial(port, device="cpu")
    check_parity(port, getattr(ref_sb, name), args, kwargs, tol, name)


def _prbs9(n: int) -> np.ndarray:
    taps, state, bits = (1 << 8) | (1 << 4), 0x1FF, []
    for _ in range(n):
        fb = bin(state & taps).count("1") & 1
        bits.append(fb)
        state = ((state << 1) | fb) & 0x1FF
    return np.asarray(bits, np.int32)


@pytest.mark.parametrize("flips", [(), (100,), (20, 300, 301)])
def test_check_lfsr_against_jax(flips):
    bits = _prbs9(600)
    bits[list(flips)] ^= 1
    got = sb.check_lfsr(torch.from_numpy(bits), (1 << 8) | (1 << 4), 9)
    want = ref_sb.check_lfsr(jnp.asarray(bits), (1 << 8) | (1 << 4), 9)
    assert (int(got[0]), got[1]) == (int(want[0]), want[1])
    wide = (R.uniform(size=200) < 0.5).astype(np.int32)
    assert sb.check_lfsr(wide, 0x80000057, 32) == ref_sb.check_lfsr(wide, 0x80000057, 32)


def test_matrix_eigenvalue_against_jax():
    a = np.asarray([[2.0, 1.0], [1.0, 5.0]], np.float32)
    check_parity(lambda m: sb.matrix_eigenvalue(m)[0], lambda m: ref_sb.matrix_eigenvalue(m)[0],
                 (a,), {}, TOL)
    check_parity(lambda m: sb.matrix_eigenvalue(m, hermitian=False),
                 lambda m: ref_sb.matrix_eigenvalue(m, hermitian=False), (a,), {}, TOL)


def test_stream_selection_and_sinks():
    xs = [np.arange(4, dtype=np.float32), np.arange(4, 8, dtype=np.float32)]
    check_parity(lambda a, b: sb.stream_switch([a, b], 1),
                 lambda a, b: ref_sb.stream_switch([a, b], 1), xs)
    check_parity(lambda a, b: sb.streams_to_stream([a, b]),
                 lambda a, b: ref_sb.streams_to_stream([a, b]), xs)
    sink = sb.VectorSink()
    sink.process(torch.arange(4))
    sink.process(np.arange(4, 8))
    np.testing.assert_array_equal(sink.data(), np.arange(8))
    assert sb.null_sink(torch.zeros(9)) == 9 and sb.probe_rate(1000, 0.0, 2.0) == 500.0
    assert sb.BLOCKS == ref_sb.BLOCKS


# ------------------------------------------------- recursions, bit for bit

RECURSION_CASES = [
    ("probe_avg_mag_sqrd", (X,), {"alpha": 0.01}),
    ("probe_avg_mag_sqrd", (X[:3000].real.copy(),), {"alpha": 0.2, "state": 1.5}),
    ("probe_density", ((R.uniform(size=5000) < 0.3).astype(np.int32),), {"alpha": 0.01}),
    ("envelope_detector", (X,), {}),
    ("envelope_detector", (MAG,), {"attack": 0.5, "release": 0.01, "state": 0.7}),
    ("peak_hold", (X,), {"decay": 0.999}),
    ("peak_hold", (MAG,), {"decay": 0.9, "state": 4.0}),
    ("power_squelch", (X * np.float32(0.4), -10.0), {"alpha": 0.05}),
    ("power_squelch", (MAG, 0.0), {"alpha": 0.01, "state": 0.2}),
]


@pytest.mark.parametrize("name,args,kwargs", RECURSION_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(RECURSION_CASES)])
def test_recursions_equal_jax_bit_for_bit(name, args, kwargs):
    check_parity(getattr(sb, name), getattr(ref_sb, name), args, kwargs, 0.0, name)


def test_recursions_carry_one_state_a_row():
    """Rows as independent streams, each equal to the reference's 1-D scan."""
    x = _cplx(np.random.default_rng(3), 1200).reshape(3, 400)
    states = [0.0, 0.5, 2.0]
    for name in ("probe_avg_mag_sqrd", "envelope_detector", "peak_hold"):
        got, final = getattr(sb, name)(torch.from_numpy(x), state=torch.tensor(states))
        for row, y0 in enumerate(states):
            want, rfinal = getattr(ref_sb, name)(jnp.asarray(x[row]), state=y0)
            np.testing.assert_array_equal(got[row].numpy(), np.asarray(want), err_msg=name)
            assert float(final[row]) == float(rfinal)


def _plateau_loop(g: np.ndarray, min_len: int) -> np.ndarray:
    run, runs = 0, np.empty_like(g)
    for t, gt in enumerate(g):
        run = (run + gt) * gt
        runs[t] = run
    ended = np.concatenate([runs[:-1] * (1 - g[1:]), runs[-1:]])
    return ended >= min_len


@pytest.mark.parametrize("p,min_len", [(0.5, 2), (0.8, 5), (0.95, 12)])
def test_parallel_run_counter_equals_the_step_loop(p, min_len):
    g = (np.random.default_rng(int(p * 100)).uniform(size=3000) < p).astype(np.int32)
    np.testing.assert_array_equal(sb.plateau_detector(torch.from_numpy(g), min_len).numpy(),
                                  _plateau_loop(g, min_len))


# ------------------------------------------------------------ random draws


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("lo,hi", [(0, 256), (-7, 11), (3, 1000), (0, 2 ** 31 - 1), (5, 5)])
def test_randint_equals_jax_bit_for_bit(seed, lo, hi):
    want = np.asarray(jax.random.randint(jax.random.key(seed), (1000,), lo, hi, jnp.int32))
    np.testing.assert_array_equal(threefry.randint(threefry.key(seed), (1000,), lo, hi), want)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("p,shape", [(0.5, (999,)), (0.3, (4, 5)), (0.01, (2000,))])
def test_bernoulli_equals_jax_bit_for_bit(seed, p, shape):
    want = np.asarray(jax.random.bernoulli(jax.random.key(seed), p, shape))
    np.testing.assert_array_equal(threefry.bernoulli(threefry.key(seed), p, shape), want)


@pytest.mark.parametrize("kind", ["uniform_byte", "bits", "uniform", "gaussian"])
def test_random_source_draws_the_reference_stream(kind):
    got = sb.random_source(threefry.key(0), 256, kind, device="cpu").numpy()
    want = np.asarray(ref_sb.random_source(jax.random.key(0), 256, kind))
    if kind == "gaussian":  # normals within 3e-7 (channel.threefry)
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-7 * np.max(np.abs(want)))
    else:
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        sb.random_source(threefry.key(0), 4, "poisson", device="cpu")


REFERENCE_TESTS = [
    "TestProbes.test_probe_avg_mag_sqrd_converges", "TestProbes.test_probe_power",
    "TestProbes.test_probe_density", "TestProbes.test_probe_rate",
    "TestPeaks.test_peak_detector_finds_single_peak", "TestPeaks.test_peak_hold_decay",
    "TestPeaks.test_plateau_detector", "TestPeaks.test_sample_and_hold",
    "TestPeaks.test_sample_counter", "TestRates.test_integrate_and_dump",
    "TestRates.test_keep_m_in_n", "TestRates.test_moving_avg_decim",
    "TestRates.test_stretch_and_mute", "TestRates.test_power_squelch_gates_noise",
    "TestRates.test_envelope_detector_tracks", "TestSources.test_signal_source_tones",
    "TestSources.test_sweep_covers_band", "TestSources.test_null_and_vector_sink",
    "TestSources.test_vector_insert", "TestSources.test_throttle_limits_rate",
    "TestScalarMath.test_magnitude_squared", "TestScalarMath.test_nlog10_log_max_exp",
    "TestScalarMath.test_transcendental", "TestPhaseMix.test_phase_shift_unwrap_wrap",
    "TestPhaseMix.test_frequency_shift_continuity", "TestPhaseMix.test_rf_mixer_real_products",
    "TestMatrices.test_multiply_matrix", "TestMatrices.test_matrix_eigenvalue_hermitian_and_power",
    "TestBits.test_endian_swap", "TestBits.test_bitwise_ops", "TestBits.test_numeric_conversions",
    "TestBits.test_repack_bits_roundtrip", "TestBits.test_check_lfsr_clean_and_errored",
    "TestStreamSelect.test_stream_switch", "TestStreamSelect.test_stream_to_streams_roundtrip",
]


@pytest.mark.parametrize("name", REFERENCE_TESTS)
def test_reference_stream_blocks_tests_on_the_port(monkeypatch, name):
    run_reference_test(monkeypatch, "test_stream_blocks", name, sb="r4w_tpu_torch.ops.stream_blocks")
