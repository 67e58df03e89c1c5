"""`ops.protocols` and `ops.packets` against the JAX package.

tests/test_protocols.py, the packet half of tests/test_scramblers_packets.py
and the protocol and packet cases of the known-answer files run on the port
through `torch_port_proxy` (the framers and parsers are the reference's
numpy, so their bytes are the reference's). Parity cases hold the
signal-facing functions against the reference on the same numpy inputs:
CTCSS tones equal and metrics within TOL (two float32 products of 38 tones
in another order), the POCSAG fields equal, the APT image equal byte for
byte, the burst masks equal and the floor within TOL. The trap tests:
`random_pdu` draws the reference's threefry bytes, an address past 21 bits
overflows as in the reference, and the APT image truncates to uint8 as the
reference's cast does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.ops import packets as ref_pk
from r4w_tpu.ops import protocols as ref_pr
from r4w_tpu_torch.channel import threefry
from r4w_tpu_torch.core import types
from r4w_tpu_torch.ops import packets as pk
from r4w_tpu_torch.ops import protocols as pr
from torch_port_proxy import check_parity, run_reference_test

TOL = 1e-5

PR = "r4w_tpu_torch.ops.protocols"
PK = "r4w_tpu_torch.ops.packets"
KA = {"r4w_tpu.ops.protocols": PR, "r4w_tpu.ops.packets": PK}

REFERENCE_TESTS = [
    *[("test_protocols", n, {}, {"pr": PR}, {}) for n in (
        "TestHdlcAx25.test_crc16_x25_vector", "TestHdlcAx25.test_bit_stuffing",
        "TestHdlcAx25.test_nrzi_roundtrip", "TestHdlcAx25.test_ax25_roundtrip",
        "TestHdlcAx25.test_ax25_fcs_rejects_corruption", "TestHdlcAx25.test_aprs",
        "TestSlip.test_escaping_known_answer", "TestSlip.test_multiframe_stream",
        "TestAis.test_sixbit_armor_roundtrip", "TestAis.test_position_report_roundtrip",
        "TestAis.test_checksum_rejects", "TestAcars.test_roundtrip",
        "TestAcars.test_parity_enforced", "TestAcars.test_odd_parity_property",
        "TestCtcss.test_tone_table", "TestCtcss.test_detects_generated_tone",
        "TestCtcss.test_no_tone_below_threshold")],
    *[("test_scramblers_packets", f"TestPackets.{n}", {}, {"pk": PK}, {}) for n in (
        "test_packet_roundtrip_and_errors", "test_header_payload_demux",
        "test_protocol_format_parse", "test_telemetry_roundtrip", "test_random_pdu",
        "test_ccsds_roundtrip", "test_dvb_s2_deframer", "test_zigbee_frame_roundtrip",
        "test_pocsag_roundtrip", "test_psk31_varicode_roundtrip", "test_noaa_apt_lines_shape",
        "test_meteor_burst_detect", "test_sigfox_roundtrip", "test_tagged_stream_utilities")],
    *[("test_known_answers_families", n, KA, {}, {}) for n in (
        "test_crc16_x25_check_value", "test_nmea_checksum_published_example",
        "test_slip_escaping_exact", "test_hdlc_stuffing_exact", "test_ccsds_asm_exact",
        "test_pocsag_sync_and_idle_words", "test_psk31_varicode_known_letters",
        "test_nrzi_encode_known_vector", "test_ccsds_frame_roundtrip_fields",
        "test_zigbee_mac_frame_roundtrip_and_fcs", "test_sigfox_frame_roundtrip",
        "test_ais_nmea_armoring_roundtrip", "test_dvb_s2_bbheader_layout")],
    ("test_known_answers", "TestCodingVectors.test_crc_x25_vector", KA, {}, {}),
    ("test_known_answers_r4f", "TestCtcss.test_tone_table_matches_eia", KA, {}, {}),
    *[("test_known_answers_r4f", "TestCtcss.test_detect_finds_injected_tone", KA, {},
       {"tone": t}) for t in (67.0, 100.0, 151.4, 245.3)],
    ("test_known_answers_r4o", "TestHeaderPayloadDemux.test_exact_split", KA, {}, {}),
    ("test_known_answers_r4q", "TestPacketCodec.test_roundtrip_exact_frame_layout_and_crc", KA,
     {}, {}),
    ("test_known_answers_r4r", "TestTelemetryFrame.test_layout_roundtrip_and_crc", KA, {}, {}),
    ("test_known_answers_r4t", "TestProtocolFormat.test_kv_and_json_roundtrip", KA, {}, {}),
]


@pytest.mark.parametrize("module,name,modules,swaps,params", REFERENCE_TESTS,
                         ids=[f"{t[0]}::{t[1]}{t[4] or ''}" for t in REFERENCE_TESTS])
def test_reference_test_on_port(monkeypatch, module, name, modules, swaps, params):
    run_reference_test(monkeypatch, module, name, modules, params=params, **swaps)


def test_reference_file_meta_on_port(monkeypatch, tmp_path):
    run_reference_test(monkeypatch, "test_scramblers_packets",
                       "TestPackets.test_file_meta_and_tagged_sink", params={"tmp_path": tmp_path},
                       pk=PK)


def _audio_windows(rng):
    """Three 1 s windows at 8 kHz: a 103.5 Hz tone in noise, noise alone,
    a 245.3 Hz tone under a voice-band tone."""
    fs, n = 8000.0, 8000
    t = np.arange(n) / fs
    return np.stack([
        0.15 * np.sin(2 * np.pi * 103.5 * t) + 0.3 * rng.standard_normal(n),
        rng.standard_normal(n),
        0.15 * np.sin(2 * np.pi * 245.3 * t) + np.sin(2 * np.pi * 900 * t)
        + 0.1 * rng.standard_normal(n)]).astype(np.float32)


def _pages():
    """Three batches (rows of 17 words): two pages and a batch of idles."""
    idle = np.full(17, ref_pk._POCSAG_IDLE, np.uint32)
    idle[0] = ref_pk._POCSAG_SYNC
    return np.stack([ref_pk.pocsag_encode_numeric(1234567, "911", 0),
                     ref_pk.pocsag_encode_numeric(2000001, "5550100", 3), idle]).astype(np.int64)


def _reference_pages(words):
    """The reference's fields of each batch (it decodes one), stacked."""
    rows = [ref_pk.pocsag_decode(np.asarray(w)) for w in words]
    return [np.stack([np.asarray(r[i]) for r in rows]) for i in range(4)]


def _apt(rng):
    fs = 11025.0
    t = np.arange(int(fs * 2)) / fs
    pattern = 0.5 + 0.5 * np.sign(np.sin(2 * np.pi * 4 * t))
    return ((pattern * np.sin(2 * np.pi * 2400 * t)) + 0.05 * rng.standard_normal(t.size)).astype(
        np.float32)


def _bursts(rng):
    x = 0.01 * (rng.standard_normal(8192) + 1j * rng.standard_normal(8192))
    x[2048:2560] += 1.0
    x[6000:6300] += 0.5
    return x.astype(np.complex64)


def _cases():
    r = np.random.default_rng(17)
    windows = _audio_windows(r)
    return [
        ("ctcss_detect", lambda a: pr.ctcss_detect(a, 8000.0),
         lambda a: ref_pr.ctcss_detect(a, 8000.0), (windows,), TOL),
        ("ctcss_detect_one_window", lambda a: pr.ctcss_detect(a[0], 8000.0, 5.0),
         lambda a: ref_pr.ctcss_detect(a[0], 8000.0, 5.0), (windows,), TOL),
        ("ctcss_generate", lambda: pr.ctcss_generate(156.7, 8000, 8000.0, device="cpu"),
         lambda: ref_pr.ctcss_generate(156.7, 8000, 8000.0), (), TOL),
        ("pocsag_decode", pk.pocsag_decode, _reference_pages, (_pages(),), 0),
        ("noaa_apt_lines", lambda a: pk.noaa_apt_lines(a, 11025.0),
         lambda a: ref_pk.noaa_apt_lines(a, 11025.0), (_apt(r),), 0),
        ("meteor_burst_detect", pk.meteor_burst_detect, ref_pk.meteor_burst_detect,
         (_bursts(r),), TOL),
        ("meteor_burst_detect_frame", lambda x: pk.meteor_burst_detect(x, 128, 6.0),
         lambda x: ref_pk.meteor_burst_detect(x, 128, 6.0), (_bursts(r)[:7000],), TOL),
    ]


CASES = _cases()


@pytest.mark.parametrize("name,port,want,args,tol", CASES, ids=[c[0] for c in CASES])
def test_parity(name, port, want, args, tol):
    check_parity(port, want, args, tol=tol, label=name)


def test_pocsag_decode_host_words(monkeypatch):
    """Host lists with the sync word past 2^31 decode as the reference's
    (on the default device, the CPU here)."""
    monkeypatch.setattr(types, "DEFAULT_DEVICE", torch.device("cpu"))
    words = ref_pk.pocsag_encode_numeric(1234568, "0425 1234", 2)
    got = pk.pocsag_decode([int(w) for w in words])
    want = ref_pk.pocsag_decode([int(w) for w in words])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), np.asarray(w))
    assert pk.pocsag_digits_to_str(got[2], got[3]) == "0425 1234"


@pytest.mark.parametrize("seed,lo,hi", [(0, 8, 16), (7, 8, 64), (123, 1, 255)])
def test_random_pdu_draws_reference_bytes(seed, lo, hi):
    """The threefry split and both randint draws are the reference's."""
    assert pk.random_pdu(threefry.key(seed), lo, hi) == ref_pk.random_pdu(
        jax.random.key(seed), lo, hi)


def test_pocsag_address_overflow_matches_reference():
    """Addresses are 21 bits; past 2,097,151 the address codeword leaves
    uint32 and both packages raise OverflowError."""
    with pytest.raises(OverflowError):
        ref_pk.pocsag_encode_numeric(7654321, "1")
    with pytest.raises(OverflowError):
        pk.pocsag_encode_numeric(7654321, "1")
    np.testing.assert_array_equal(pk.pocsag_encode_numeric(2097151, "12"),
                                  ref_pk.pocsag_encode_numeric(2097151, "12"))


def test_uint8_truncation_matches_reference_cast():
    """Values that land on an integer keep it; values a hair below drop
    to the integer under, as the reference's astype(uint8)."""
    v = np.float32([0.0, 0.49999997, 1.0, 127.5, 127.99999, 128.0, 254.99998, 255.0])
    np.testing.assert_array_equal(torch.from_numpy(v).to(torch.uint8).numpy(),
                                  np.asarray(jnp.asarray(v).astype(jnp.uint8)))
    # a raster whose peak pixel is the maximum: it scales to exactly 255.0
    fs = 11025.0
    n = int(fs)                      # one line: its brightest pixel is 255 on both sides
    audio = (np.sin(2 * np.pi * 2400 * np.arange(n) / fs)
             * (1.0 + 0.5 * np.cos(2 * np.pi * 3 * np.arange(n) / fs))).astype(np.float32)
    got = pk.noaa_apt_lines(torch.from_numpy(audio), fs).numpy()
    want = np.asarray(ref_pk.noaa_apt_lines(jnp.asarray(audio), fs))
    assert got.max() == 255 and want.max() == 255
    np.testing.assert_array_equal(got, want)


def test_ctcss_windows_are_rows():
    """A stack of windows in one call gives each window's own call."""
    windows = torch.from_numpy(_audio_windows(np.random.default_rng(5)))
    tone, metric = pr.ctcss_detect(windows.reshape(3, 1, -1), 8000.0)
    for i in range(3):
        t1, m1 = pr.ctcss_detect(windows[i], 8000.0)
        assert float(tone[i, 0]) == float(t1)
        np.testing.assert_allclose(float(metric[i, 0]), float(m1), rtol=TOL)
