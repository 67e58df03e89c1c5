"""The port's ``ops.scramblers`` and its RAKE receiver (``ops.spreading``)
against ``r4w_tpu.ops.scramblers`` and ``r4w_tpu.ops.spreading`` on the
same numpy inputs, made from seeds; then the JAX package's own scrambler
tests (``tests/test_known_answers_scramblers.py``,
``tests/test_scramblers_packets.py:12-86``) and RAKE tests
(``tests/test_named_blocks.py:86-129``, ``tests/test_known_answers_r4n.py``'s
``TestRakeReceiver``) run on the port.

Keystreams, scrambled bits, CRCs, the FEC table's round trips and the
RAKE's delays and validity are exact; the RAKE's complex gains and
combined symbols agree within RAKE_TOL of the reference's peak (float32
correlations summed in another order; measured in the comments).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.ops import scramblers as ref_sc
from r4w_tpu.ops import spreading as ref_spreading
from r4w_tpu_torch.fec import convolutional
from r4w_tpu_torch.kernels import viterbi
from r4w_tpu_torch.ops import scramblers as sc
from r4w_tpu_torch.ops import spreading
from torch_port_proxy import run_reference_test

RAKE_TOL = 2e-6  # one code period's correlations in float32 (measured 2.3e-7)

PN_GRID = [(0b1100000, 0x7F, 7), (0x110, 0x1FF, 9), (0x9, 0x5, 4), (0x80004, 0xABCDE, 20),
           (0x60000000, 0x7FFFFFFF, 31), (0x100000057, 0x1234567890, 33)]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _rel(got, want) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) or 1.0))


@pytest.mark.parametrize("taps,seed,nbits", PN_GRID)
def test_pn_scrambler_pair_against_jax(taps, seed, nbits):
    rng = np.random.default_rng(nbits)
    bits = rng.integers(0, 2, 300)
    line = sc.pn_scramble(_t(bits), taps, seed, nbits)
    np.testing.assert_array_equal(line.numpy(), np.asarray(ref_sc.pn_scramble(bits, taps, seed,
                                                                              nbits)))
    back = sc.pn_descramble(line, taps, seed, nbits)
    np.testing.assert_array_equal(back.numpy(), bits)
    # the descrambler from a wrong seed: the reference's bits, right after nbits
    wrong = sc.pn_descramble(line, taps, 0, nbits).numpy()
    np.testing.assert_array_equal(wrong, np.asarray(ref_sc.pn_descramble(line.numpy(), taps, 0,
                                                                         nbits)))
    np.testing.assert_array_equal(wrong[nbits:], bits[nbits:])


def test_pn_scrambler_batches_rows():
    bits = np.random.default_rng(4).integers(0, 2, (3, 200))
    line = sc.pn_scramble(_t(bits), 0x21, 0x5A, 7)
    back = sc.pn_descramble(line, 0x21, 0x5A, 7)
    for row in range(3):
        np.testing.assert_array_equal(line[row].numpy(),
                                      np.asarray(ref_sc.pn_scramble(bits[row], 0x21, 0x5A, 7)))
    np.testing.assert_array_equal(back.numpy(), bits)


@pytest.mark.parametrize("n", [1, 128, 1000])
def test_keystreams_against_jax(n):
    rng = np.random.default_rng(n)
    bits = rng.integers(0, 2, n)
    np.testing.assert_array_equal(sc.additive_scramble(_t(bits), 0b1100000, 0x7F, 7).numpy(),
                                  np.asarray(ref_sc.additive_scramble(bits, 0b1100000, 0x7F, 7)))
    data = rng.integers(0, 256, n)
    for seed in (0x12345678, 7):
        np.testing.assert_array_equal(sc.lcg_whiten(_t(data), seed).numpy(),
                                      np.asarray(ref_sc.lcg_whiten(data, seed)))
    np.testing.assert_array_equal(sc._lcg_keystream(n, 5), ref_sc._lcg_keystream(n, 5))
    np.testing.assert_array_equal(sc.glfsr_source(0b1100000, 1, 7, n, "cpu").numpy(),
                                  np.asarray(ref_sc.glfsr_source(0b1100000, 1, 7, n)))
    for degree, index in ((5, 2), (7, 0), (10, 9)):
        np.testing.assert_array_equal(sc.gold_code_generator(degree, index, device="cpu").numpy(),
                                      np.asarray(ref_sc.gold_code_generator(degree, index)))
        np.testing.assert_array_equal(
            sc.gold_code_generator(degree, index, n, "cpu").numpy(),
            np.asarray(ref_sc.gold_code_generator(degree, index, n)))


def test_crc_covert_timing_against_jax():
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (8, 37))
    np.testing.assert_array_equal(sc.crc16_parallel(_t(frames)).numpy(),
                                  np.asarray(ref_sc.crc16_parallel(frames)))
    bits = rng.integers(0, 2, (2, 40))
    ev = sc.covert_timing_encode(_t(bits), 100, 30)
    np.testing.assert_array_equal(ev.numpy(), np.asarray(ref_sc.covert_timing_encode(bits, 100, 30)))
    np.testing.assert_array_equal(sc.covert_timing_decode(ev, 100, 30).numpy(), bits)


@pytest.mark.parametrize("name,n", [("repetition", 60), ("golay", (3, 12)), ("convolutional", 200)])
def test_fec_table_round_trips_against_jax(name, n):
    assert sc.fec_list() == ref_sc.fec_list()
    bits = np.random.default_rng(np.prod(n)).integers(0, 2, n)
    enc = sc.fec_encode(name, _t(bits))
    np.testing.assert_array_equal(enc.numpy(), np.asarray(ref_sc.fec_encode(name, bits)))
    noisy = enc.clone()
    noisy[..., 5] ^= 1  # one error every code corrects
    dec = sc.fec_decode(name, noisy)
    np.testing.assert_array_equal(dec.numpy(), np.asarray(ref_sc.fec_decode(name,
                                                                            noisy.numpy())))
    np.testing.assert_array_equal(dec.numpy(), bits)
    with pytest.raises(ValueError):
        sc.fec_encode("nope", _t(bits))


def test_convolutional_codec_runs_the_viterbi_dispatchers(monkeypatch):
    calls = []
    for name in ("viterbi_forward_dispatch", "viterbi_traceback_dispatch"):
        orig = getattr(viterbi, name)

        def spy(*args, _orig=orig, _name=name, **kwargs):
            calls.append(_name)
            return _orig(*args, **kwargs)
        monkeypatch.setattr(convolutional.viterbi_kernels, name, spy)
    bits = np.random.default_rng(0).integers(0, 2, 12_000)
    dec = sc.fec_decode("convolutional", sc.fec_encode("convolutional", _t(bits)))
    np.testing.assert_array_equal(dec.numpy(), bits)
    assert calls == ["viterbi_forward_dispatch", "viterbi_traceback_dispatch"]


def test_aes_ctr_round_trip():
    pytest.importorskip("cryptography")
    key, nonce = bytes(range(32)), b"\x01" * 12
    ct = sc.aes_ctr_keystream_xor(b"hello world", key, nonce)
    assert ct == ref_sc.aes_ctr_keystream_xor(b"hello world", key, nonce)
    assert sc.aes_ctr_keystream_xor(ct, key, nonce) == b"hello world"


def test_blocks_table_is_the_references():
    assert sc.BLOCKS == ref_sc.BLOCKS


def _rake_setup(h1=0.6 * np.exp(1j * 1.0), noise=0.1, seed=0, l=31, n_sym=40, delay=7):
    rng = np.random.default_rng(seed)
    code = (2.0 * rng.integers(0, 2, l) - 1.0).astype(np.float32)
    bits = 2 * rng.integers(0, 2, n_sym) - 1
    tx = (bits[:, None] * code[None, :]).reshape(-1).astype(np.complex64)
    rx = tx.copy()
    rx[delay:] += h1 * tx[:-delay]
    rx += noise * (rng.normal(0, 1, len(rx)) + 1j * rng.normal(0, 1, len(rx))).astype(np.complex64)
    return code, rx.astype(np.complex64)


@pytest.mark.parametrize("seed,fingers,window", [(0, 3, None), (1, 4, 20), (3, 2, 31)])
def test_rake_against_jax(seed, fingers, window):
    code, rx = _rake_setup(seed=seed)
    got = spreading.rake_search(_t(rx), _t(code), fingers, window)
    want = ref_spreading.rake_search(jnp.asarray(rx), code, fingers, window)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert _rel(got[1], want[1]) < RAKE_TOL
    for delay in (0, 7, 30):
        assert _rel(spreading.rake_despread(_t(rx), _t(code), delay),
                    ref_spreading.rake_despread(jnp.asarray(rx), code, delay)) < RAKE_TOL
    for mode in ("mrc", "egc", "selection"):
        assert _rel(spreading.rake_combine(_t(rx), _t(code), *got, mode=mode),
                    ref_spreading.rake_combine(jnp.asarray(rx), code, *want, mode=mode)) < RAKE_TOL
    with pytest.raises(ValueError):
        spreading.rake_combine(_t(rx), _t(code), *got, mode="max")


SCRAMBLER_TESTS = [
    ("test_known_answers_scramblers", name) for name in (
        "test_pn_descrambler_self_synchronizes", "test_lcg_whiten_first_bytes_pinned",
        "test_lcg_whiten_self_inverse", "test_additive_scrambler_self_inverse_and_keystream",
        "test_crc16_x25_parallel_check_value", "test_crc16_parallel_batch_lockstep",
        "test_covert_timing_roundtrip_and_gap_values", "test_gold_code_generator_alias_properties",
        "test_pn_wide_register_host_fallback")
] + [
    ("test_scramblers_packets", f"TestScramblers.{name}") for name in (
        "test_additive_scrambler_self_inverse", "test_pn_scrambler_roundtrip_and_selfsync",
        "test_lcg_whitener_self_inverse", "test_glfsr_full_period", "test_gold_alias_extends",
        "test_crc16_parallel_matches_serial", "test_fec_generic_api", "test_covert_timing_roundtrip")
]


@pytest.mark.parametrize("module,name", SCRAMBLER_TESTS)
def test_reference_scrambler_tests_on_the_port(monkeypatch, module, name):
    run_reference_test(monkeypatch, module, name, sc="r4w_tpu_torch.ops.scramblers")


@pytest.mark.parametrize("taps,seed,nbits", [(0b1100000, 0x7F, 7), (0x110, 0x1FF, 9),
                                             (0x9, 0x5, 4), (0x80004, 0xABCDE, 20)])
@pytest.mark.parametrize("name", ["test_pn_scramble_matches_bit_serial_reference",
                                  "test_pn_descramble_matches_bit_serial_reference",
                                  "test_pn_roundtrip_identity"])
def test_reference_pn_known_answers_on_the_port(monkeypatch, name, taps, seed, nbits):
    getattr(_reference_scrambler_tests(monkeypatch), name)(taps, seed, nbits)


@pytest.mark.parametrize("nbits,taps", [(3, 0b110), (4, 0b1100), (5, 0b10100), (7, 0b1100000)])
def test_reference_glfsr_maximal_length_on_the_port(monkeypatch, nbits, taps):
    _reference_scrambler_tests(monkeypatch).test_glfsr_is_maximal_length(nbits, taps)


def _reference_scrambler_tests(monkeypatch):
    """The reference's scrambler known-answer module, its ``sc`` the port's
    (on the CPU), for its parametrised tests."""
    import test_known_answers_scramblers as ref_tests
    from r4w_tpu_torch.core import types
    from torch_port_proxy import PortModule
    monkeypatch.setattr(types, "DEFAULT_DEVICE", torch.device("cpu"))
    monkeypatch.setattr(ref_tests, "sc", PortModule(sc))
    return ref_tests


RAKE_TESTS = [("test_named_blocks", name) for name in (
    "test_rake_search_finds_true_fingers", "test_rake_mrc_beats_noisy_single_finger")]


@pytest.mark.parametrize("module,name", RAKE_TESTS)
def test_reference_rake_tests_on_the_port(monkeypatch, module, name):
    run_reference_test(monkeypatch, module, name, spreading="r4w_tpu_torch.ops.spreading")


@pytest.mark.parametrize("mode", ["mrc", "egc", "selection"])
def test_reference_rake_combine_modes_on_the_port(monkeypatch, mode):
    import test_named_blocks as ref_tests
    from torch_port_proxy import PortModule
    from r4w_tpu_torch.core import types
    monkeypatch.setattr(types, "DEFAULT_DEVICE", torch.device("cpu"))
    monkeypatch.setattr(ref_tests, "spreading", PortModule(spreading))
    ref_tests.test_rake_combine_modes_decode(mode)


def test_reference_rake_known_answer_on_the_port(monkeypatch):
    import r4w_tpu.ops.spreading as ref_module
    from test_known_answers_r4n import TestRakeReceiver
    from torch_port_proxy import PortModule
    from r4w_tpu_torch.core import types
    monkeypatch.setattr(types, "DEFAULT_DEVICE", torch.device("cpu"))
    port = PortModule(spreading)
    monkeypatch.setattr(ref_module, "rake_search", port.rake_search)
    monkeypatch.setattr(ref_module, "rake_combine", port.rake_combine)
    TestRakeReceiver().test_two_path_search_and_mrc_combine()
