"""ctypes loader + pythonic wrapper for the C API (r4w_capi.cpp).

The C library is the framework's embedded/host seam — the role of the
reference's r4w-ffi crate (crates/r4w-ffi/src/lib.rs): C callers get
complex helpers, FFT, chirp generation, an SPSC ring, and
BPSK/QPSK/LoRa modulate/demodulate without a Python runtime. End users
of the C API include `r4w_capi.h` and link the library directly.

The port's counterpart of ``r4w_tpu.native.capi``. ``r4w_capi.cpp`` and
``r4w_capi.h`` are byte copies of the reference's. The library is built
with the reference's flags (``g++ -O2 -shared -fPIC``) at first use in a
process into ``build/r4w_tpu_torch/native/`` (gitignored), under a name
keyed by a hash of the source, the flags and the host's CPU model, written
under a temporary name and moved into place (`native.build`), so a
concurrent build never loads a half-written library. `available()` and
`build_error()` keep the reference's meaning; a wrapper called when the
library did not build raises with the build's error. The wrappers take
tensors or numpy: a tensor is read to the host once at the boundary;
outputs are numpy, as the C library works on host memory.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np
import torch

from r4w_tpu_torch import native

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "r4w_capi.cpp"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")

_lib = None
_lock = threading.Lock()
_build_error: str | None = None

OK = 0
ERR_NULL = 1
ERR_SIZE = 2
ERR_FULL = 3
ERR_EMPTY = 4

WAVEFORM_BPSK = 0
WAVEFORM_QPSK = 1
WAVEFORM_LORA = 2


class Complex(ctypes.Structure):
    _fields_ = [("re", ctypes.c_double), ("im", ctypes.c_double)]


def library_path() -> Path:
    """Where this host's build of the C library lives."""
    return native.library_path(SOURCE, CXX_FLAGS)


def _sig(lib):
    c_sz, c_dbl = ctypes.c_size_t, ctypes.c_double
    p = ctypes.POINTER
    lib.r4w_version.restype = ctypes.c_char_p
    lib.r4w_abi_version.restype = ctypes.c_int
    lib.r4w_complex_new.restype = Complex
    lib.r4w_complex_new.argtypes = [c_dbl, c_dbl]
    lib.r4w_complex_from_polar.restype = Complex
    lib.r4w_complex_from_polar.argtypes = [c_dbl, c_dbl]
    for f in ("magnitude", "phase", "power"):
        fn = getattr(lib, f"r4w_complex_{f}")
        fn.restype = c_dbl
        fn.argtypes = [Complex]
    for f in ("conj",):
        fn = getattr(lib, f"r4w_complex_{f}")
        fn.restype = Complex
        fn.argtypes = [Complex]
    for f in ("mul", "add"):
        fn = getattr(lib, f"r4w_complex_{f}")
        fn.restype = Complex
        fn.argtypes = [Complex, Complex]
    # FFT
    lib.r4w_fft_new.restype = ctypes.c_void_p
    lib.r4w_fft_new.argtypes = [c_sz]
    lib.r4w_fft_free.argtypes = [ctypes.c_void_p]
    lib.r4w_fft_size.restype = c_sz
    lib.r4w_fft_size.argtypes = [ctypes.c_void_p]
    for f in ("forward", "inverse"):
        fn = getattr(lib, f"r4w_fft_{f}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, p(Complex), c_sz]
    lib.r4w_fft_find_peak.restype = ctypes.c_int
    lib.r4w_fft_find_peak.argtypes = [p(Complex), c_sz, p(c_sz),
                                      p(c_dbl), p(c_dbl)]
    lib.r4w_fft_power_spectrum_db.restype = ctypes.c_int
    lib.r4w_fft_power_spectrum_db.argtypes = [p(Complex), p(c_dbl), c_sz]
    # chirp
    lib.r4w_chirp_new.restype = ctypes.c_void_p
    lib.r4w_chirp_new.argtypes = [ctypes.c_uint8, ctypes.c_uint32, c_sz]
    lib.r4w_chirp_free.argtypes = [ctypes.c_void_p]
    lib.r4w_chirp_samples_per_symbol.restype = c_sz
    lib.r4w_chirp_samples_per_symbol.argtypes = [ctypes.c_void_p]
    lib.r4w_chirp_bandwidth.restype = c_dbl
    lib.r4w_chirp_bandwidth.argtypes = [ctypes.c_void_p]
    for f in ("generate_upchirp", "generate_downchirp"):
        fn = getattr(lib, f"r4w_chirp_{f}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, p(Complex), c_sz]
    lib.r4w_chirp_modulate_symbol.restype = ctypes.c_int
    lib.r4w_chirp_modulate_symbol.argtypes = [ctypes.c_void_p,
                                              ctypes.c_uint16,
                                              p(Complex), c_sz]
    # ring buffer
    lib.r4w_ringbuffer_new.restype = ctypes.c_void_p
    lib.r4w_ringbuffer_new.argtypes = [c_sz]
    lib.r4w_ringbuffer_free.argtypes = [ctypes.c_void_p]
    for f in ("capacity", "len"):
        fn = getattr(lib, f"r4w_ringbuffer_{f}")
        fn.restype = c_sz
        fn.argtypes = [ctypes.c_void_p]
    for f in ("is_empty", "is_full"):
        fn = getattr(lib, f"r4w_ringbuffer_{f}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p]
    lib.r4w_ringbuffer_push.restype = ctypes.c_int
    lib.r4w_ringbuffer_push.argtypes = [ctypes.c_void_p, Complex]
    lib.r4w_ringbuffer_pop.restype = ctypes.c_int
    lib.r4w_ringbuffer_pop.argtypes = [ctypes.c_void_p, p(Complex)]
    lib.r4w_ringbuffer_push_slice.restype = c_sz
    lib.r4w_ringbuffer_push_slice.argtypes = [ctypes.c_void_p,
                                              p(Complex), c_sz]
    lib.r4w_ringbuffer_pop_slice.restype = c_sz
    lib.r4w_ringbuffer_pop_slice.argtypes = [ctypes.c_void_p,
                                             p(Complex), c_sz]
    # signal utils
    lib.r4w_generate_tone.restype = ctypes.c_int
    lib.r4w_generate_tone.argtypes = [c_dbl, c_dbl, p(Complex), c_sz]
    lib.r4w_add_awgn.restype = ctypes.c_int
    lib.r4w_add_awgn.argtypes = [p(Complex), c_sz, c_dbl]
    lib.r4w_frequency_shift.restype = ctypes.c_int
    lib.r4w_frequency_shift.argtypes = [p(Complex), c_sz, c_dbl, c_dbl]
    # waveforms
    lib.r4w_waveform_bpsk_new.restype = ctypes.c_void_p
    lib.r4w_waveform_bpsk_new.argtypes = [c_dbl, c_dbl]
    lib.r4w_waveform_qpsk_new.restype = ctypes.c_void_p
    lib.r4w_waveform_qpsk_new.argtypes = [c_dbl, c_dbl]
    lib.r4w_waveform_lora_new.restype = ctypes.c_void_p
    lib.r4w_waveform_lora_new.argtypes = [ctypes.c_uint8,
                                          ctypes.c_uint32, c_dbl]
    lib.r4w_waveform_free.argtypes = [ctypes.c_void_p]
    lib.r4w_waveform_get_type.restype = ctypes.c_int
    lib.r4w_waveform_get_type.argtypes = [ctypes.c_void_p]
    lib.r4w_waveform_samples_per_symbol.restype = c_sz
    lib.r4w_waveform_samples_per_symbol.argtypes = [ctypes.c_void_p]
    lib.r4w_waveform_name.restype = ctypes.c_char_p
    lib.r4w_waveform_name.argtypes = [ctypes.c_void_p]
    lib.r4w_waveform_modulate_size.restype = c_sz
    lib.r4w_waveform_modulate_size.argtypes = [ctypes.c_void_p, c_sz]
    lib.r4w_waveform_modulate.restype = ctypes.c_int
    lib.r4w_waveform_modulate.argtypes = [
        ctypes.c_void_p, p(ctypes.c_uint8), c_sz, p(Complex), c_sz,
        p(c_sz)]
    lib.r4w_waveform_demodulate.restype = ctypes.c_int
    lib.r4w_waveform_demodulate.argtypes = [
        ctypes.c_void_p, p(Complex), c_sz, p(ctypes.c_uint8), c_sz,
        p(c_sz)]


def get_lib():
    """The loaded C library, or None with `build_error()` set."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(native.build(SOURCE, CXX_FLAGS)))
            _sig(lib)
        except (RuntimeError, OSError, AttributeError) as e:
            _build_error = str(e)
            return None
        _lib = lib
        return _lib


def _require():
    """The loaded C library; raises when it did not build."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"C library unavailable: {build_error()}")
    return lib


def available() -> bool:
    return get_lib() is not None


def build_error() -> str | None:
    return _build_error


# ---------------------------------------------------------------------
# numpy bridging helpers
# ---------------------------------------------------------------------


def _host(x) -> np.ndarray:
    """`x` as a numpy array: a tensor is read to the host once."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _as_c128(x) -> np.ndarray:
    """complex128 C-contiguous copy — layout-compatible with Complex[]."""
    return np.ascontiguousarray(_host(x), np.complex128).copy()


def _cbuf(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(Complex))


def fft_forward(x) -> np.ndarray:
    lib = _require()
    buf = _as_c128(x)
    h = lib.r4w_fft_new(buf.size)
    try:
        rc = lib.r4w_fft_forward(h, _cbuf(buf), buf.size)
        if rc != OK:
            raise RuntimeError(f"r4w_fft_forward rc={rc}")
    finally:
        lib.r4w_fft_free(h)
    return buf


def fft_inverse(x) -> np.ndarray:
    lib = _require()
    buf = _as_c128(x)
    h = lib.r4w_fft_new(buf.size)
    try:
        rc = lib.r4w_fft_inverse(h, _cbuf(buf), buf.size)
        if rc != OK:
            raise RuntimeError(f"r4w_fft_inverse rc={rc}")
    finally:
        lib.r4w_fft_free(h)
    return buf


class CChirp:
    """RAII wrapper over r4w_chirp_t."""

    def __init__(self, sf: int, bw_hz: int, oversample: int = 1):
        self._lib = _require()
        self._h = self._lib.r4w_chirp_new(sf, bw_hz, oversample)
        if not self._h:
            raise ValueError("invalid chirp parameters")

    @property
    def samples_per_symbol(self) -> int:
        return int(self._lib.r4w_chirp_samples_per_symbol(self._h))

    def _gen(self, fn_name: str, *args) -> np.ndarray:
        n = self.samples_per_symbol
        out = np.zeros(n, np.complex128)
        rc = getattr(self._lib, fn_name)(self._h, *args, _cbuf(out), n)
        if rc != OK:
            raise RuntimeError(f"{fn_name} rc={rc}")
        return out

    def upchirp(self) -> np.ndarray:
        return self._gen("r4w_chirp_generate_upchirp")

    def downchirp(self) -> np.ndarray:
        return self._gen("r4w_chirp_generate_downchirp")

    def symbol(self, sym: int) -> np.ndarray:
        return self._gen("r4w_chirp_modulate_symbol", sym)

    def close(self):
        if self._h:
            self._lib.r4w_chirp_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class CWaveform:
    """RAII wrapper over r4w_waveform_t."""

    def __init__(self, handle, lib):
        if not handle:
            raise ValueError("invalid waveform parameters")
        self._h = handle
        self._lib = lib

    @classmethod
    def bpsk(cls, sample_rate: float, symbol_rate: float) -> "CWaveform":
        lib = _require()
        return cls(lib.r4w_waveform_bpsk_new(sample_rate, symbol_rate),
                   lib)

    @classmethod
    def qpsk(cls, sample_rate: float, symbol_rate: float) -> "CWaveform":
        lib = _require()
        return cls(lib.r4w_waveform_qpsk_new(sample_rate, symbol_rate),
                   lib)

    @classmethod
    def lora(cls, sf: int, bw_hz: int, sample_rate: float) -> "CWaveform":
        lib = _require()
        return cls(lib.r4w_waveform_lora_new(sf, bw_hz, sample_rate),
                   lib)

    @property
    def name(self) -> str:
        return self._lib.r4w_waveform_name(self._h).decode()

    @property
    def samples_per_symbol(self) -> int:
        return int(self._lib.r4w_waveform_samples_per_symbol(self._h))

    def modulate(self, data) -> np.ndarray:
        """Payload bytes (bytes, or a tensor or array of byte values) -> IQ."""
        raw = (np.ascontiguousarray(_host(data), np.uint8)
               if isinstance(data, (torch.Tensor, np.ndarray)) else np.frombuffer(bytes(data),
                                                                                   np.uint8))
        cap = int(self._lib.r4w_waveform_modulate_size(self._h, raw.size))
        out = np.zeros(cap, np.complex128)
        written = ctypes.c_size_t(0)
        rc = self._lib.r4w_waveform_modulate(
            self._h, raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            raw.size, _cbuf(out), cap, ctypes.byref(written))
        if rc != OK:
            raise RuntimeError(f"r4w_waveform_modulate rc={rc}")
        return out[: written.value]

    def demodulate(self, samples) -> bytes:
        buf = _as_c128(samples)
        cap = max(buf.size, 64)
        out = np.zeros(cap, np.uint8)
        written = ctypes.c_size_t(0)
        rc = self._lib.r4w_waveform_demodulate(
            self._h, _cbuf(buf), buf.size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
            ctypes.byref(written))
        if rc != OK:
            raise RuntimeError(f"r4w_waveform_demodulate rc={rc}")
        return bytes(out[: written.value])

    def close(self):
        if self._h:
            self._lib.r4w_waveform_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
