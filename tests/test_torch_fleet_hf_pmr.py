"""The port's ALE/3G-ALE and PMR (P25, TETRA, DMR) waveforms, their word,
frame-sync and NID helpers, and the block codes under them (Golay,
repetition and matrix codes, and the Reed-Solomon and BCH codecs of the
copied `fec.galois`) against the JAX package: IQ and decisions per
tests/torch_fleet_parity.py; codes bit for bit with error patterns up to
their t and one beyond; helpers to the JAX tests' known answers
(tests/test_waveform_fleet2.py:120-255)."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from r4w_tpu.channel import awgn as ref_awgn
from r4w_tpu.fec import block as ref_block
from r4w_tpu.fec import galois as ref_galois
from r4w_tpu.waveforms import hf_waveforms as ref_hf
from r4w_tpu.waveforms import pmr_waveforms as ref_pmr
from r4w_tpu_torch.core.types import CommonParams
from r4w_tpu_torch.fec import block, galois
from r4w_tpu_torch.waveforms import hf_waveforms as hf
from r4w_tpu_torch.waveforms import pmr_waveforms as pmr
from torch_fleet_parity import CPU, check_decisions, check_modulation

REPO = Path(__file__).resolve().parents[1]
NAMES = ["ALE", "3G-ALE", "P25", "P25-Phase2", "TETRA", "TETRA-DMO", "DMR", "DMR-Tier3",
         "DMR-Direct"]


@pytest.mark.parametrize("name", NAMES)
def test_modulation_and_decisions_match_reference(name):
    iq = check_modulation(name)
    check_decisions(name, iq, noisy=False)
    check_decisions(name, iq, noisy=True)


def _errors(rng, n: int, length: int, weight: int) -> np.ndarray:
    e = np.zeros((n, length), np.int32)
    for row in e:
        row[rng.choice(length, weight, replace=False)] = 1
    return e


def test_golay_encodes_and_decodes_like_reference():
    data = ((np.arange(4096)[:, None] >> np.arange(11, -1, -1)) & 1).astype(np.int32)
    cw = block.golay_encode(torch.from_numpy(data))
    np.testing.assert_array_equal(cw.numpy(), np.asarray(ref_block.golay_encode(data)))
    rng = np.random.default_rng(1)
    for weight in range(5):  # t = 3, and one beyond
        bad = (cw.numpy()[::7] + _errors(rng, len(data[::7]), 24, weight)) % 2
        got, n = block.golay_decode(torch.from_numpy(bad))
        want, want_n = ref_block.golay_decode(bad)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(n.numpy(), np.asarray(want_n))
        if weight <= 3:
            np.testing.assert_array_equal(got.numpy(), data[::7])
            assert (n.numpy() == weight).all()
    np.testing.assert_array_equal(block._golay_syndrome_table(), ref_block._golay_syndrome_table())


def test_repetition_and_matrix_codes_match_reference():
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, (3, 40)).astype(np.int32)
    for n in (3, 5):
        enc = block.repetition_encode(torch.from_numpy(bits), n)
        np.testing.assert_array_equal(enc.numpy(), np.asarray(ref_block.repetition_encode(bits, n)))
        noisy = (enc.numpy() + (rng.random(enc.shape) < 0.2)) % 2
        np.testing.assert_array_equal(block.repetition_decode(torch.from_numpy(noisy), n).numpy(),
                                      np.asarray(ref_block.repetition_decode(noisy, n)))
    g = rng.integers(0, 2, (7, 15)).astype(np.int32)
    h = rng.integers(0, 2, (8, 15)).astype(np.int32)
    d = rng.integers(0, 2, (5, 7)).astype(np.int32)
    np.testing.assert_array_equal(block.matrix_encode(torch.from_numpy(d), g).numpy(),
                                  np.asarray(ref_block.matrix_encode(d, g)))
    r = rng.integers(0, 2, (5, 15)).astype(np.int32)
    np.testing.assert_array_equal(block.syndrome(torch.from_numpy(r), h).numpy(),
                                  np.asarray(ref_block.syndrome(r, h)))
    assert block.golay_encode(torch.from_numpy(d[:, :6].repeat(2, 1))).dtype == torch.int32


def test_galois_is_a_byte_copy():
    assert (REPO / "r4w_tpu_torch/fec/galois.py").read_bytes() == \
        (REPO / "r4w_tpu/fec/galois.py").read_bytes()


@pytest.mark.parametrize("n,k,m", [(31, 15, 5), (31, 22, 5), (255, 223, 8)])
def test_reed_solomon_matches_reference(n, k, m):
    rs, ref = galois.ReedSolomon(n, k, m=m), ref_galois.ReedSolomon(n, k, m=m)
    t = (n - k) // 2
    rng = np.random.default_rng(n + k)
    for weight in (0, 1, t, t + 1):
        data = rng.integers(0, 1 << m, k).astype(np.int32)
        cw = rs.encode(data)
        np.testing.assert_array_equal(cw, ref.encode(data))
        bad = np.array(cw)
        pos = rng.choice(n, weight, replace=False)
        bad[pos] ^= rng.integers(1, 1 << m, weight).astype(bad.dtype)
        got, want = rs.decode(bad), ref.decode(bad)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        if weight <= t:
            assert got[1] == weight and np.array_equal(got[0], data)


@pytest.mark.parametrize("m,t", [(6, 11), (4, 2), (5, 3)])
def test_bch_matches_reference(m, t):
    code, ref = galois.BCH(m=m, t=t), ref_galois.BCH(m=m, t=t)
    rng = np.random.default_rng(m * t)
    for weight in (0, 1, t, t + 1):
        data = rng.integers(0, 2, code.k).astype(np.int32)
        cw = code.encode(data)
        np.testing.assert_array_equal(cw, ref.encode(data))
        bad = np.array(cw)
        bad[rng.choice(code.n, weight, replace=False)] ^= 1
        got, want = code.decode(bad), ref.decode(bad)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_p25_sync_and_nid_match_reference():
    d = pmr.p25_sync_dibits()
    np.testing.assert_array_equal(d, ref_pmr.p25_sync_dibits())
    assert d[:8].tolist() == [1, 1, 1, 1, 1, 3, 1, 1]
    nid = pmr.p25_encode_nid(0x293, 0x7)
    np.testing.assert_array_equal(nid, ref_pmr.p25_encode_nid(0x293, 0x7))
    assert nid.shape == (64,) and pmr.p25_decode_nid(nid) == (0x293, 0x7, 0)
    bad = nid.copy()
    bad[[0, 7, 13, 21, 29, 35, 41, 47, 53, 59, 62]] ^= 1  # t = 11
    assert pmr.p25_decode_nid(bad) == ref_pmr.p25_decode_nid(bad) == (0x293, 0x7, 11)
    worse = bad.copy()
    worse[3] ^= 1  # one beyond t
    assert pmr.p25_decode_nid(worse) == ref_pmr.p25_decode_nid(worse)


def test_p25_metadata_through_noise_like_reference():
    """tests/test_waveform_fleet2.py:152: NAC 0x123, LDU1 at 12 dB."""
    data = bytes([0x5A, 0xC3, 0x0F, 0x99])
    wf = pmr.P25(common=CommonParams(sample_rate=48_000.0), symbol_rate=4800.0,
                 deviation_unit=600.0, nac=0x123, duid="LDU1", device=CPU)
    ref = ref_pmr.P25(common=ref_pmr.CommonParams(sample_rate=48_000.0), symbol_rate=4800.0,
                      deviation_unit=600.0, nac=0x123, duid="LDU1")
    tx = np.asarray(ref.modulate(data))
    np.testing.assert_allclose(wf.modulate(data).numpy(), tx, atol=1e-5)
    rx = np.asarray(ref_awgn(jax.random.key(5), tx, 12.0))
    got, want = wf.demodulate(rx), ref.demodulate(rx)
    np.testing.assert_array_equal(got.bits.numpy(), np.asarray(want.bits))
    assert got.metadata == want.metadata
    assert got.metadata["nac"] == 0x123 and got.metadata["duid"] == "LDU1"
    assert bytes(got.bits[:4].numpy().astype(np.uint8)) == data


def test_ale_words_match_reference():
    assert hf.ALE_WORD_TYPES == ref_hf.ALE_WORD_TYPES
    assert hf.ALE3G_WORD_TYPES == ref_hf.ALE3G_WORD_TYPES
    assert set(hf.ALE3G_3G_SPECIFIC) == {"AMD", "DTM"}
    w = hf.AleWord("TIS", "K1A")
    assert w.encode() == ref_hf.AleWord("TIS", "K1A").encode() and (w.encode() >> 21) == 0b011
    assert hf.AleWord.decode(w.encode()) == w and hf.AleWord.from_bits(w.to_bits()) == w
    with pytest.raises(ValueError):
        hf.AleWord.decode(0)
    words = hf.AmdMessage("ABC").encode_words()
    assert words == ref_hf.AmdMessage("ABC").encode_words() and (words[0] >> 21) == 0b100
    assert hf.AmdMessage.decode_words(words).text == "ABC"
    frs = hf.DtmMessage.fragment(bytes(range(150)), 64)
    assert [(f.sequence, f.final) for f in frs] == [(0, False), (1, False), (2, True)]
    for ber, sinad in ((0.0, 30.0), (0.1, 0.0), (0.05, 12.0)):
        assert hf.ale3g_lqa_score(ber, sinad) == ref_hf.ale3g_lqa_score(ber, sinad)


def test_ale_calls_through_noise_like_reference():
    """tests/test_waveform_fleet2.py:202 and :233: an individual call at 5 dB
    and an AMD message at 6 dB, on the reference's IQ and noise."""
    radio, ref = hf.Ale(device=CPU), ref_hf.Ale()
    call = ref_hf.ale_individual_call("BOB", "ANN")
    tx = np.asarray(ref_hf.ale_modulate_words(ref, call))
    np.testing.assert_allclose(
        hf.ale_modulate_words(radio, hf.ale_individual_call("BOB", "ANN")).numpy(), tx, atol=1e-5)
    rx = np.asarray(ref_awgn(jax.random.key(0), tx, 5.0))
    got = [(w.word_type, w.chars) for w in hf.ale_demodulate_words(radio, rx)]
    assert got == [(w.word_type, w.chars) for w in ref_hf.ale_demodulate_words(ref, rx)]
    assert got == [("TO", "BOB"), ("TO", "BOB"), ("TIS", "ANN")]
    msg = "QSL UR 59 FT WAYNE"
    tx = np.asarray(ref_hf.ale3g_send_amd(ref, ref_hf.AmdMessage(msg)))
    np.testing.assert_allclose(hf.ale3g_send_amd(radio, hf.AmdMessage(msg)).numpy(), tx, atol=1e-5)
    rx = np.asarray(ref_awgn(jax.random.key(2), tx, 6.0))
    assert hf.ale3g_receive_amd(radio, rx).text == ref_hf.ale3g_receive_amd(ref, rx).text == msg
