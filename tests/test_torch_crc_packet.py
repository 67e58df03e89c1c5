"""The port's CRCs and LoRa packet framing against the JAX package.

`fec.crc` must give the reference's checksums bit for bit for all seven
CRCs on the same batched bytes (the port's register is int64 where the
reference's is uint32), and `build_packet` and `parse_packet` must give the
reference's bytes and verdicts, corruption included. Card-only checks
are marked ``cuda``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.fec import crc as ref_crc
from r4w_tpu.waveforms import lora as ref_lora
from r4w_tpu.waveforms.lora import packet as ref_packet
from r4w_tpu_torch.fec import crc
from r4w_tpu_torch.waveforms import lora
from r4w_tpu_torch.waveforms.lora import packet

CPU = torch.device("cpu")
CHECK = b"123456789"  # the catalogue's check string


@pytest.mark.parametrize("name", sorted(crc.CRC_PARAMS))
def test_crc_matches_reference_on_batched_bytes(name):
    assert crc.CRC_PARAMS[name] == ref_crc.CRC_PARAMS[name]
    np.testing.assert_array_equal(crc._crc_table(name), ref_crc._crc_table(name))
    data = np.random.default_rng(len(name)).integers(0, 256, (3, 4, 37)).astype(np.int32)
    got = crc.crc_compute(torch.from_numpy(data), name)
    assert got.shape == (3, 4) and got.dtype == torch.int64 and got.device == CPU
    want = np.asarray(ref_crc.crc_compute(data, name)).astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool(crc.crc_check(torch.from_numpy(data), torch.from_numpy(want), name).all())
    one = np.frombuffer(CHECK, np.uint8).astype(np.int32)
    assert int(crc.crc_compute(one, name, device=CPU)) == int(ref_crc.crc_compute(one, name))


@pytest.mark.parametrize("name", sorted(crc.CRC_PARAMS))
def test_crc_host_path_equals_the_tensor_loop(name):
    """One byte sequence on the CPU takes the Python-integer path; it gives
    the tensor loop's checksum (a batch of one row) and the reference's."""
    rng = np.random.default_rng(len(name) + 7)
    for n in (0, 1, 9, 106, 255):
        data = rng.integers(0, 256, n).astype(np.int32)
        got = crc.crc_compute(torch.from_numpy(data), name)
        assert got.shape == () and got.dtype == torch.int64
        assert int(got) == int(crc.crc_compute(torch.from_numpy(data[None]), name)[0])
        if n:
            assert int(got) == int(np.asarray(ref_crc.crc_compute(data, name)))


def test_crc_known_answers_and_edges():
    check = np.frombuffer(CHECK, np.uint8).astype(np.int32)
    assert int(crc.crc_compute(check, "crc16-ccitt", device=CPU)) == 0x29B1
    assert int(crc.crc_compute(check, "crc32", device=CPU)) == 0xCBF43926
    assert not bool(crc.crc_check(check, 0x29B0, "crc16-ccitt", device=CPU))
    for name in crc.CRC_PARAMS:  # no bytes: init (reflected) ^ xorout
        empty = np.zeros((2, 0), np.int32)
        np.testing.assert_array_equal(crc.crc_compute(empty, name, device=CPU).numpy(),
                                      np.asarray(ref_crc.crc_compute(empty, name)))
    # values above a byte are masked to their low byte, as the reference does
    wide = np.array([0x1FF, 0x2A5, 7], np.int32)
    assert (int(crc.crc_compute(wide, "crc8", device=CPU))
            == int(ref_crc.crc_compute(wide, "crc8")))


def test_crc_reflect_out_branch(monkeypatch):
    """refin != refout (no catalogue CRC has it) reflects the register."""
    for module in (crc, ref_crc):
        monkeypatch.setitem(module.CRC_PARAMS, "crc16-mixed",
                            (16, 0x1021, 0x1D0F, False, True, 0x0000))
    data = np.random.default_rng(1).integers(0, 256, (5, 11)).astype(np.int32)
    np.testing.assert_array_equal(
        crc.crc_compute(data, "crc16-mixed", device=CPU).numpy(),
        np.asarray(ref_crc.crc_compute(data, "crc16-mixed")).astype(np.int64))


def test_fletcher16_matches_reference():
    data = np.random.default_rng(2).integers(0, 256, (4, 300)).astype(np.int32)
    got = crc.fletcher16(torch.from_numpy(data))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref_crc.fletcher16(data)).astype(np.int64))
    assert int(crc.fletcher16(np.frombuffer(b"abcde", np.uint8).astype(np.int32),
                              device=CPU)) == 0xC8F0


@pytest.mark.parametrize("payload,cr,crc_enabled", [
    (b"payload!", 2, True), (b"framed msg", 1, True), (b"", 1, True), (b"no crc", 4, False),
    (bytes(range(255)), 1, True)])
def test_packet_build_and_parse_match_reference(payload, cr, crc_enabled):
    got = packet.build_packet(payload, cr, crc_enabled, device=CPU)
    want = ref_packet.build_packet(payload, cr, crc_enabled)
    np.testing.assert_array_equal(got, want)
    assert packet.parse_packet(got, device=CPU) == ref_packet.parse_packet(want)
    assert packet.parse_packet(got, device=CPU) == (payload, True if crc_enabled else None)
    hdr = packet.PacketHeader.decode(got)
    assert hdr == packet.PacketHeader(len(payload), cr, crc_enabled)
    np.testing.assert_array_equal(hdr.encode(), ref_packet.PacketHeader.decode(want).encode())


@pytest.mark.parametrize("where,flip", [(5, 0xFF), (2, 0x01), (0, 0x02), (-1, 0x80), (-2, 0x01)])
def test_packet_corruption_matches_reference(where, flip):
    data = packet.build_packet(b"payload!", cr=2, device=CPU)
    bad = data.copy()
    bad[where] ^= flip
    got = packet.parse_packet(bad, device=CPU)
    assert got == ref_packet.parse_packet(bad)
    assert got[1] is not True


def test_packet_truncation_and_short_header():
    data = packet.build_packet(b"abc", device=CPU)
    for cut in (0, 2, 3, 5, len(data) - 1):
        assert packet.parse_packet(data[:cut], device=CPU) == ref_packet.parse_packet(data[:cut])
    assert packet.parse_packet(data[:-1], device=CPU) == (b"abc", False)


def test_packet_over_the_port_modem():
    params, rparams = lora.LoRaParams(sf=7), ref_lora.LoRaParams(sf=7)
    frame = packet.build_packet(b"framed msg", device=CPU)
    tx = lora.modulate(params, frame, include_preamble=False, device=CPU)
    np.testing.assert_array_equal(
        tx.numpy(), np.asarray(ref_lora.modulate(rparams, jnp.asarray(frame),
                                                 include_preamble=False)))
    result = lora.demodulate(params, tx)
    assert packet.parse_packet(result.payload.numpy(), device=CPU) == (b"framed msg", True)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(crc.CRC_PARAMS))
def test_crc_on_card_equals_cpu(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    data = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (64, 255)).astype(np.int32))
    got = crc.crc_compute(data.cuda(), name)
    assert got.is_cuda
    assert torch.equal(got.cpu(), crc.crc_compute(data, name))
