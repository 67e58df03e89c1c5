"""The C API's port (`r4w_tpu_torch.native.capi` over byte copies of
``r4w_capi.cpp`` and ``r4w_capi.h``) against the port's own functions.

The cases of ``tests/test_capi.py`` with the JAX functions replaced by the
port's on the CPU: the C library re-implements the chirp phase law, the
PSK constellations and LoRa's whitening, Hamming code and interleaver, and
these tests pin the C output to the port's sample for sample and byte for
byte. Also: the sources are the reference's bytes, the library builds into
``build/r4w_tpu_torch/native/`` (not beside the source) under a name keyed
by the source and the flags, the wrappers take tensors, and
``examples/11_capi_demo.c`` compiles against the port's header and runs.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from r4w_tpu_torch import native
from r4w_tpu_torch.native import capi
from r4w_tpu_torch.waveforms import create_waveform
from r4w_tpu_torch.waveforms.lora import chirp, modem
from r4w_tpu_torch.waveforms.lora.params import LoRaParams

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
IQ_ATOL = 3e-6          # the reference test's: complex64 on the port's side


@pytest.fixture(scope="module")
def lib():
    """The built library; a failed build fails every test that needs it."""
    got = capi.get_lib()
    assert got is not None, capi.build_error()
    return got


def test_sources_are_the_references_bytes():
    for name in ("r4w_capi.cpp", "r4w_capi.h"):
        assert (ROOT / "r4w_tpu_torch" / "native" / name).read_bytes() == \
            (ROOT / "r4w_tpu" / "native" / name).read_bytes()


def test_library_builds_into_build_dir_keyed_by_source(lib):
    path = capi.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent.parts[-3:] == ("build", "r4w_tpu_torch", "native")
    assert capi.CXX_FLAGS == ("-O2", "-shared", "-fPIC")
    # keyed by the source's bytes and the flags
    assert path == native.library_path(capi.SOURCE, capi.CXX_FLAGS)
    assert path.name.startswith("libr4w_capi_") and path.suffix == ".so"
    assert native.library_path(capi.SOURCE, ("-O3",) + capi.CXX_FLAGS[1:]) != path
    assert not (ROOT / "r4w_tpu_torch" / "native" / "libr4w.so").exists()
    assert capi.available() and capi.build_error() is None


def test_version_and_abi(lib):
    assert lib.r4w_version().decode().count(".") == 2
    assert lib.r4w_abi_version() >= 1


def test_complex_helpers_match_numpy(lib):
    a = lib.r4w_complex_new(3.0, 4.0)
    assert lib.r4w_complex_magnitude(a) == pytest.approx(5.0)
    assert lib.r4w_complex_power(a) == pytest.approx(25.0)
    assert lib.r4w_complex_phase(a) == pytest.approx(np.angle(3 + 4j))
    b = lib.r4w_complex_from_polar(2.0, np.pi / 3)
    assert complex(b.re, b.im) == pytest.approx(2 * np.exp(1j * np.pi / 3))
    m = lib.r4w_complex_mul(a, b)
    assert complex(m.re, m.im) == pytest.approx((3 + 4j) * 2 * np.exp(1j * np.pi / 3))
    c = lib.r4w_complex_conj(a)
    assert (c.re, c.im) == (3.0, -4.0)
    s = lib.r4w_complex_add(a, b)
    assert complex(s.re, s.im) == pytest.approx((3 + 4j) + 2 * np.exp(1j * np.pi / 3))


@pytest.mark.parametrize("n", [64, 1024, 100, 37])  # pow2 + Bluestein
def test_fft_matches_torch(lib, n):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal(n) + 1j * rng.standard_normal(n))
    got = capi.fft_forward(x)
    np.testing.assert_allclose(got, torch.fft.fft(x).numpy(), rtol=1e-9, atol=1e-9)
    back = capi.fft_inverse(torch.from_numpy(got))
    np.testing.assert_allclose(back, x.numpy(), rtol=1e-9, atol=1e-9)


def test_fft_find_peak(lib):
    n = 256
    tone = np.exp(2j * np.pi * 37 * np.arange(n) / n)
    spec = capi.fft_forward(tone)
    bin_, mag, ph = ctypes.c_size_t(), ctypes.c_double(), ctypes.c_double()
    rc = lib.r4w_fft_find_peak(spec.ctypes.data_as(ctypes.POINTER(capi.Complex)), n,
                               ctypes.byref(bin_), ctypes.byref(mag), ctypes.byref(ph))
    assert rc == capi.OK and bin_.value == 37
    assert mag.value == pytest.approx(n, rel=1e-9)


def test_power_spectrum_db(lib):
    x = np.array([1 + 0j, 0 + 0j, 10 + 0j], np.complex128)
    out = np.zeros(3, np.float64)
    rc = lib.r4w_fft_power_spectrum_db(x.ctypes.data_as(ctypes.POINTER(capi.Complex)),
                                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), 3)
    assert rc == capi.OK
    assert out[0] == pytest.approx(0.0) and out[1] == -200.0 and out[2] == pytest.approx(20.0)


def test_chirp_matches_port_base_chirps(lib):
    params = LoRaParams(sf=7, bw_hz=125_000)
    c = capi.CChirp(7, 125_000, 1)
    assert c.samples_per_symbol == params.samples_per_symbol
    np.testing.assert_allclose(c.upchirp(), chirp.base_upchirp(params, CPU).numpy(), atol=2e-6)
    np.testing.assert_allclose(c.downchirp(), chirp.base_downchirp(params, CPU).numpy(),
                               atol=2e-6)


@pytest.mark.parametrize("sym", [0, 1, 42, 127])
def test_chirp_symbol_matches_port(lib, sym):
    params = LoRaParams(sf=7, bw_hz=125_000)
    want = chirp.symbol_chirps(params, torch.tensor([sym], dtype=torch.int32))[0].numpy()
    np.testing.assert_allclose(capi.CChirp(7, 125_000, 1).symbol(sym), want, atol=2e-6)


def test_ringbuffer_roundtrip(lib):
    rb = lib.r4w_ringbuffer_new(100)  # rounds up to 128
    try:
        assert lib.r4w_ringbuffer_capacity(rb) == 128
        assert lib.r4w_ringbuffer_is_empty(rb)
        assert lib.r4w_ringbuffer_push(rb, lib.r4w_complex_new(1.0, -2.0)) == capi.OK
        assert lib.r4w_ringbuffer_len(rb) == 1
        out = capi.Complex()
        assert lib.r4w_ringbuffer_pop(rb, ctypes.byref(out)) == capi.OK
        assert (out.re, out.im) == (1.0, -2.0)
        assert lib.r4w_ringbuffer_pop(rb, ctypes.byref(out)) == capi.ERR_EMPTY
        data = np.arange(200, dtype=np.float64).view(np.complex128)
        pushed = lib.r4w_ringbuffer_push_slice(
            rb, data.ctypes.data_as(ctypes.POINTER(capi.Complex)), data.size)
        assert pushed == 100 and lib.r4w_ringbuffer_len(rb) == 100
        got = np.zeros(100, np.complex128)
        popped = lib.r4w_ringbuffer_pop_slice(
            rb, got.ctypes.data_as(ctypes.POINTER(capi.Complex)), 100)
        assert popped == 100
        np.testing.assert_array_equal(got, data)
    finally:
        lib.r4w_ringbuffer_free(rb)


def test_ringbuffer_full(lib):
    rb = lib.r4w_ringbuffer_new(2)
    try:
        one = lib.r4w_complex_new(1.0, 0.0)
        assert lib.r4w_ringbuffer_push(rb, one) == capi.OK
        assert lib.r4w_ringbuffer_push(rb, one) == capi.OK
        assert lib.r4w_ringbuffer_is_full(rb)
        assert lib.r4w_ringbuffer_push(rb, one) == capi.ERR_FULL
    finally:
        lib.r4w_ringbuffer_free(rb)


def test_generate_tone_and_shift(lib):
    n, fs, f = 128, 1000.0, 100.0
    buf = np.zeros(n, np.complex128)
    p = buf.ctypes.data_as(ctypes.POINTER(capi.Complex))
    assert lib.r4w_generate_tone(f, fs, p, n) == capi.OK
    np.testing.assert_allclose(buf, np.exp(2j * np.pi * f * np.arange(n) / fs), atol=1e-12)
    assert lib.r4w_frequency_shift(p, n, -f, fs) == capi.OK
    np.testing.assert_allclose(buf, np.ones(n), atol=1e-9)


def test_add_awgn_snr(lib):
    n = 4096
    buf = np.ones(n, np.complex128)
    assert lib.r4w_add_awgn(buf.ctypes.data_as(ctypes.POINTER(capi.Complex)), n, 10.0) == capi.OK
    measured = 10 * np.log10(1.0 / np.mean(np.abs(buf - 1.0) ** 2))
    assert measured == pytest.approx(10.0, abs=1.0)


def test_bpsk_matches_port_modulate(lib):
    wf_p = create_waveform("BPSK", 8000.0, CPU)
    wf_c = capi.CWaveform.bpsk(8000.0, 1000.0)
    assert wf_c.samples_per_symbol == wf_p.samples_per_symbol()
    data = b"\xa5\x17\x00\xff"
    got = wf_c.modulate(data)
    np.testing.assert_allclose(got, wf_p.modulate(data).numpy(), atol=1e-6)
    assert wf_c.demodulate(got) == data


def test_qpsk_matches_port_modulate(lib):
    wf_p = create_waveform("QPSK", 8000.0, CPU)
    wf_c = capi.CWaveform.qpsk(8000.0, 1000.0)
    data = b"\x3c\x99\x42"
    got = wf_c.modulate(data)
    np.testing.assert_allclose(got, wf_p.modulate(data).numpy(), atol=1e-6)
    # the wrapper takes the port's tensor
    assert wf_c.demodulate(torch.from_numpy(got)) == data


def test_qpsk_demod_under_noise(lib):
    wf_c = capi.CWaveform.qpsk(8000.0, 1000.0)
    data = bytes(range(32))
    iq = wf_c.modulate(data)
    rng = np.random.default_rng(3)
    noisy = iq + 0.1 * (rng.standard_normal(iq.size) + 1j * rng.standard_normal(iq.size))
    assert wf_c.demodulate(noisy) == data


def test_lora_modulate_matches_port(lib):
    params = LoRaParams(sf=7, bw_hz=125_000)
    payload = torch.tensor([0x48, 0x69, 0x21, 0x00, 0x7f], dtype=torch.int32)
    want = modem.modulate(params, payload, include_preamble=True, device=CPU).numpy()
    got = capi.CWaveform.lora(7, 125_000, 125_000.0).modulate(payload)
    assert got.size == want.size
    np.testing.assert_allclose(got, want, atol=IQ_ATOL)


def test_lora_c_roundtrip_and_cross_demod(lib):
    """C-modulated payload decodes via C *and* via the port's demodulator."""
    params = LoRaParams(sf=7, bw_hz=125_000)
    payload = b"r4w-capi"
    wf_c = capi.CWaveform.lora(7, 125_000, 125_000.0)
    iq = wf_c.modulate(payload)
    n = params.samples_per_symbol
    body = iq[8 * n + 2 * n + 2 * n + n // 4:]   # 8 up + 2 sync + 2.25 down
    assert wf_c.demodulate(body)[: len(payload)] == payload
    res = modem.demodulate(params, torch.from_numpy(body.astype(np.complex64)))
    assert bytes(res.payload.numpy().astype(np.uint8).tolist())[: len(payload)] == payload


def test_lora_port_tx_c_rx(lib):
    """The port's modulated payload decodes through the C demodulator."""
    params = LoRaParams(sf=8, bw_hz=125_000)
    payload = torch.tensor(list(b"hello world"), dtype=torch.int32)
    body = modem.modulate(params, payload, include_preamble=False, device=CPU)
    got = capi.CWaveform.lora(8, 125_000, 125_000.0).demodulate(body)
    assert got[: payload.numel()] == b"hello world"


def test_waveform_metadata(lib):
    wf = capi.CWaveform.lora(9, 250_000, 500_000.0)  # oversample 2
    assert wf.name == "LoRa"
    assert wf.samples_per_symbol == (1 << 9) * 2
    assert lib.r4w_waveform_get_type(wf._h) == capi.WAVEFORM_LORA


def test_invalid_parameters_rejected(lib):
    assert not lib.r4w_waveform_lora_new(4, 125_000, 125_000.0)  # bad SF
    assert not lib.r4w_waveform_lora_new(7, 99_000, 99_000.0)  # bad BW
    assert not lib.r4w_waveform_lora_new(7, 125_000, 130_000.0)  # frac osf
    assert not lib.r4w_waveform_bpsk_new(-1.0, 100.0)
    assert not lib.r4w_chirp_new(13, 125_000, 1)
    assert not lib.r4w_ringbuffer_new(1)
    with pytest.raises(ValueError):
        capi.CChirp(13, 125_000, 1)


def test_c_example_compiles_and_runs(lib, tmp_path):
    """examples/11_capi_demo.c compiled against the port's header and linked
    to the port's library, run with no Python in the loop."""
    cc = shutil.which("gcc") or shutil.which("cc")
    assert cc is not None, "no C compiler"
    so = capi.library_path()
    exe = tmp_path / "capi_demo"
    subprocess.run([cc, "-O2", "-o", str(exe), str(ROOT / "examples" / "11_capi_demo.c"),
                    "-I", str(ROOT / "r4w_tpu_torch" / "native"), str(so), "-lm",
                    f"-Wl,-rpath,{so.parent}"],
                   check=True, capture_output=True, timeout=120)
    out = subprocess.run([str(exe)], capture_output=True, text=True, timeout=120,
                         env={**os.environ, "LD_LIBRARY_PATH": str(so.parent)})
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout
    assert 'demodulated: "hello from C"' in out.stdout


def test_wrappers_raise_when_the_library_did_not_build(monkeypatch):
    monkeypatch.setattr(capi, "get_lib", lambda: None)
    monkeypatch.setattr(capi, "_build_error", "g++ failed")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        capi.fft_forward(np.ones(4))
    with pytest.raises(RuntimeError, match="unavailable"):
        capi.CWaveform.qpsk(8000.0, 1000.0)
