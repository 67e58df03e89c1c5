"""The port's frequency-hopping waveforms (FHSS, FHSS-AntiJam, SINCGARS,
HAVEQUICK), Link-16 and SINCGARS data framing against the JAX package:
IQ and decisions per tests/torch_fleet_parity.py; hop schedules, CCSK
tables, RS words, the interleaver and slot symbols equal; the batched
SINCGARS decode (every frame a lane of one Viterbi call) equal to the
reference's frame-by-frame decode, with and without channel errors
(tests/test_link16_sincgars.py)."""

import jax
import numpy as np
import pytest
import torch

from r4w_tpu.channel import awgn as ref_awgn
from r4w_tpu.waveforms import fhss as ref_fhss
from r4w_tpu.waveforms import link16 as ref_l16
from r4w_tpu.waveforms import milfh_waveforms as ref_milfh
from r4w_tpu_torch.kernels import viterbi
from r4w_tpu_torch.waveforms import fhss
from r4w_tpu_torch.waveforms import link16 as l16
from r4w_tpu_torch.waveforms import milfh_waveforms as milfh
from torch_fleet_parity import CPU, check_decisions, check_modulation, waveforms

DATA = bytes([0xA7, 0x1B, 0x3C, 0xD2])


@pytest.mark.parametrize("name", ["FHSS", "FHSS-AntiJam", "SINCGARS", "HAVEQUICK", "Link-16"])
def test_modulation_and_decisions_match_reference(name):
    iq = check_modulation(name)
    check_decisions(name, iq, noisy=False)
    check_decisions(name, iq, noisy=True)


def test_hop_schedules_match_reference():
    for channels, seed in ((50, 0x12345), (64, 7), (1000, 3), (20, 1 << 20)):
        assert fhss.hop_sequence(channels, seed) == ref_fhss.hop_sequence(channels, seed)
    for name in ("FHSS", "SINCGARS", "HAVEQUICK"):
        wf, ref = waveforms(name)
        np.testing.assert_array_equal(wf.hop_schedule(300), ref.hop_schedule(300))
    seq = fhss.FHSS(device=CPU, hop_pattern="sequential")
    np.testing.assert_array_equal(seq.hop_schedule(120),
                                  ref_fhss.FHSS(hop_pattern="sequential").hop_schedule(120))
    np.testing.assert_array_equal(milfh.SimulatorHopProvider(64).hop_channels(40),
                                  ref_milfh.SimulatorHopProvider(64).hop_channels(40))


def test_antijam_avoids_channels_like_reference():
    """tests/test_waveform_fleet2.py:78."""
    jammed = tuple(range(10))
    wf = fhss.FhssAntiJam(device=CPU, jammed_channels=jammed)
    ref = ref_fhss.FhssAntiJam(jammed_channels=jammed)
    sched = wf.hop_schedule(200)
    np.testing.assert_array_equal(sched, ref.hop_schedule(200))
    assert not set(sched.tolist()) & set(jammed)
    tx = np.asarray(ref.modulate(DATA))
    np.testing.assert_allclose(wf.modulate(DATA).numpy(), tx, atol=1e-5)
    got = wf.demodulate(tx)
    np.testing.assert_array_equal(got.bits.numpy(), np.asarray(ref.demodulate(tx).bits))
    assert bytes(got.bits[:4].numpy().astype(np.uint8)) == DATA
    assert wf.info().name == "FHSS-AntiJam"
    with pytest.raises(ValueError):
        fhss.FhssAntiJam(device=CPU, jammed_channels=tuple(range(50))).hop_schedule(3)


def test_link16_tables_match_reference():
    wf = l16.Link16(device=CPU)
    assert (wf.slot_samples, wf.burst_samples, wf.pulse_window_samples) == (78125, 64, 130)
    assert (l16.SLOTS_PER_FRAME, l16.PULSES_PER_SLOT_P2, l16.DP_PER_SLOT) == (1536, 258, 129)
    np.testing.assert_array_equal(l16.ccsk_base(), ref_l16.ccsk_base())
    assert l16.ccsk_base()[:12].tolist() == [1, 1, 1, 1, 1, 0, 0, 0, 1, 1, 0, 1]
    np.testing.assert_array_equal(l16.ccsk_table(), ref_l16.ccsk_table())
    np.testing.assert_array_equal(l16.data_interleave_pattern(), ref_l16.data_interleave_pattern())
    transec, ref_transec = l16.SimulatorTransec(), ref_l16.SimulatorTransec()
    np.testing.assert_array_equal(transec.chip_scramble(258), ref_transec.chip_scramble(258))
    np.testing.assert_array_equal(transec.hop_indices(258), ref_transec.hop_indices(258))
    bits = np.random.default_rng(3).integers(0, 2, l16.SLOT_PAYLOAD_BITS).astype(np.int32)
    np.testing.assert_array_equal(wf.slot_symbols(bits), ref_l16.Link16().slot_symbols(bits))
    with pytest.raises(ValueError):
        wf.slot_symbols(bits[:-1])


def test_link16_rs_words_match_reference():
    data = np.arange(15, dtype=np.int32) % 32
    cw = l16.rs_encode_data(data)
    np.testing.assert_array_equal(cw, ref_l16.rs_encode_data(data))
    bad = cw.copy()
    bad[[0, 3, 7, 12, 18, 22, 27, 30]] ^= np.int32(21)  # t = 8
    dec, n = l16.rs_decode_data(bad)
    assert n == 8 and dec.tolist() == data.tolist()
    worse = cw.copy()
    worse[:9] ^= np.int32(13)  # one beyond
    assert l16.rs_decode_data(worse)[1] == ref_l16.rs_decode_data(worse)[1] == -1
    hdr = np.asarray([3, 14, 15, 9, 2, 6, 5], np.int32)
    h16 = l16.rs_encode_header(hdr)
    np.testing.assert_array_equal(h16, ref_l16.rs_encode_header(hdr))
    bad = h16.copy()
    bad[[1, 5, 9, 14]] ^= np.int32(17)
    dec, n = l16.rs_decode_header(bad)
    assert n == 4 and dec.tolist() == hdr.tolist()


@pytest.mark.parametrize("case", ["awgn", "jammed", "multislot"])
def test_link16_receiver_matches_reference(case):
    """tests/test_link16_sincgars.py:122-151: -6 dB, 8 double pulses zeroed,
    and 60 bytes over 3 slots."""
    wf, ref = l16.Link16(device=CPU), ref_l16.Link16()
    payload = bytes(range(60)) if case == "multislot" else DATA
    tx = np.array(ref.modulate(payload))
    np.testing.assert_allclose(wf.modulate(payload).numpy(), tx, atol=1e-5)
    if case == "awgn":
        tx = np.asarray(ref_awgn(jax.random.key(2), tx, -6.0))
    elif case == "jammed":
        win = wf.pulse_window_samples
        start = (l16.SYNC_DP + l16.REFINE_DP + l16.HEADER_DP) * 2 * win
        for dp in range(8):
            tx[start + dp * 2 * win: start + (dp + 1) * 2 * win] = 0
    got, want = wf.demodulate(tx), ref.demodulate(tx)
    np.testing.assert_array_equal(got.bits.numpy(), np.asarray(want.bits))
    np.testing.assert_array_equal(got.symbols.numpy(), np.asarray(want.symbols))
    assert got.metadata == want.metadata
    assert bytes(got.bits[: len(payload)].numpy().astype(np.uint8)) == payload
    if case == "jammed":
        assert got.metadata["rs_symbols_corrected"] >= 7


def test_sincgars_crc_and_wire_format_match_reference():
    def bitwise_crc(data: bytes) -> int:  # tests/test_link16_sincgars.py:160
        crc = 0xFFFF
        for byte in data:
            crc ^= byte << 8
            for _ in range(8):
                crc = ((crc << 1) ^ 0x1021 if crc & 0x8000 else crc << 1) & 0xFFFF
        return crc ^ 0xFFFF

    for vec in (b"123456789", b"\x00", b"SINCGARS", bytes(range(32)), b""):
        assert milfh._sincgars_crc(vec) == ref_milfh._sincgars_crc(vec)
        if vec:
            assert milfh._sincgars_crc(vec) == bitwise_crc(vec)
    assert milfh.SINCGARS_DATA_MODES == ref_milfh.SINCGARS_DATA_MODES
    for fec in (False, True):
        fr, ref_fr = milfh.SincgarsDataFramer(1200, fec), ref_milfh.SincgarsDataFramer(1200, fec)
        assert fr.max_payload_size() == ref_fr.max_payload_size()
        frame = fr.frame_data(b"AB")[0]
        np.testing.assert_array_equal(fr.frame_to_bits(frame),
                                      ref_fr.frame_to_bits(ref_fr.frame_data(b"AB")[0]))
    wire = np.packbits(milfh.SincgarsDataFramer(1200, False).frame_to_bits(frame)
                       .astype(np.uint8)).tobytes()
    assert wire[:8] == b"\xaa\xaa\x7e\x00\x00\x02AB"
    with pytest.raises(ValueError):
        milfh.SincgarsDataFramer(1234)


def test_sincgars_frames_roundtrip_and_reject_like_reference():
    """tests/test_link16_sincgars.py:164-185: 200 bytes in 3 frames, scattered
    channel errors corrected, a CRC failure raised without FEC."""
    fr, ref_fr = milfh.SincgarsDataFramer(1200), ref_milfh.SincgarsDataFramer(1200)
    frames = fr.frame_data(bytes(range(200)))
    assert [f.sequence for f in frames] == [0, 1, 2]
    for f in frames:
        back = fr.bits_to_frame(fr.frame_to_bits(f), device=CPU)
        assert (back.payload, back.sequence) == (f.payload, f.sequence)
    fr600 = milfh.SincgarsDataFramer(600)
    bits = fr600.frame_to_bits(fr600.frame_data(b"FEC TEST")[0])
    bits[::97] ^= 1
    assert fr600.bits_to_frame(bits, device=CPU).payload == b"FEC TEST"
    assert ref_milfh.SincgarsDataFramer(600).bits_to_frame(bits).payload == b"FEC TEST"
    plain = milfh.SincgarsDataFramer(1200, use_fec=False)
    bits = plain.frame_to_bits(plain.frame_data(b"PAYLOAD")[0])
    bits[60] ^= 1
    with pytest.raises(ValueError, match="CRC"):
        plain.bits_to_frame(bits)


@pytest.mark.parametrize("flip_every", [0, 97, 41])
def test_batched_decode_equals_reference_per_frame(flip_every):
    """A 200-byte message (3 frames) and a 4th frame of noise bits through
    the port's one-call decode, against the reference's frame-by-frame loop
    on the same bits: the same frames back, the same ones skipped."""
    ref_fr = ref_milfh.SincgarsDataFramer(1200)
    coded = [ref_fr.frame_to_bits(f) for f in ref_fr.frame_data(bytes(range(200)))]
    flen = max(len(b) for b in coded)
    bits = np.concatenate([np.pad(b, (0, flen - len(b))) for b in coded]
                          + [np.random.default_rng(4).integers(0, 2, flen + 100)]).astype(np.int32)
    if flip_every:
        bits[::flip_every] ^= 1
    ref_frames = []
    for i in range(0, len(bits) - flen + 1, flen):
        try:
            ref_frames.append(ref_milfh.SincgarsDataFramer(1200).bits_to_frame(bits[i:i + flen]))
        except ValueError:
            continue
    before = viterbi.viterbi_forward.launches
    frames = milfh.sincgars_deframe(torch.from_numpy(bits), flen, 1200)
    assert viterbi.viterbi_forward.launches == before  # CPU tensors: the plain version
    assert [(f.sequence, f.payload, f.frame_type) for f in frames] == \
        [(f.sequence, f.payload, f.frame_type) for f in ref_frames]
    if flip_every != 41:
        assert b"".join(f.payload for f in frames) == bytes(range(200))
    assert milfh.sincgars_deframe(torch.from_numpy(bits[: flen - 1]), flen) == []


def test_sincgars_phy_end_to_end_like_reference():
    """tests/test_link16_sincgars.py:187: 'TACTICAL DATA' at 10 dB, on the
    reference's IQ and noise."""
    radio, ref_radio = milfh.Sincgars(device=CPU), ref_milfh.Sincgars()
    iq, flen = ref_milfh.sincgars_modulate_data(ref_radio, b"TACTICAL DATA", 1200)
    rx = np.asarray(ref_awgn(jax.random.key(4), iq, 10.0))
    got = milfh.sincgars_demodulate_data(radio, rx, flen, 1200)
    want = ref_milfh.sincgars_demodulate_data(ref_radio, rx, flen, 1200)
    assert [(f.sequence, f.payload) for f in got] == [(f.sequence, f.payload) for f in want]
    assert got[0].payload == b"TACTICAL DATA" and got[0].sequence == 0
