"""ctypes bindings for the native iqcore runtime (``iqcore.cpp``).

PyTorch counterpart of ``r4w_tpu.native``: the interleaved-IQ format
conversions (i16, i8, u8), interleave and deinterleave, the lock-free SPSC
ring buffer and the threaded UDP IQ receiver. ``iqcore.cpp`` is a copy of
the reference's source. It is built with ``g++`` at first use in a process
into ``build/r4w_tpu_torch/native/`` at the repository root (gitignored),
under a name keyed by a hash of the source, the flags and the host's CPU
model (``-march=native`` code does not move between hosts), written under
a temporary name and moved into place with ``os.replace``, so concurrent
builders never load a half-written library.

Every conversion and the ring buffer keep the reference's numpy versions as
their plain versions, used when the library cannot be built
(`native_available()` says which path runs); the UDP receiver has no plain
version and raises instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from collections import deque
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "iqcore.cpp"
BUILD_DIR = _DIR.parents[1] / "build" / "r4w_tpu_torch" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")
ABI_VERSION = 1  # the oldest iqcore_abi_version() these bindings accept

_lib = None
_lock = threading.Lock()
_build_error: str | None = None
_F32P = ctypes.POINTER(ctypes.c_float)


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def library_path(source: Path = SOURCE, flags=CXX_FLAGS) -> Path:
    """Where the library built from `source` with `flags` on this host lives."""
    digest = hashlib.sha256(" ".join(flags).encode())
    digest.update(_cpu_model().encode())
    digest.update(source.read_bytes())
    return BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"


def build(source: Path = SOURCE, flags=CXX_FLAGS, include: Path | None = None) -> Path:
    """Compile `source` with g++ unless its library exists; returns its path.

    Raises with g++'s messages if the compile fails."""
    out = library_path(source, flags)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *flags, *(["-I", str(include)] if include else []), "-o", str(tmp),
           str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=180)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed with exit code {proc.returncode}: {' '.join(cmd)}\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> None:
    u64, i64 = ctypes.c_uint64, ctypes.c_int64
    lib.iqcore_abi_version.restype = ctypes.c_int
    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_create.argtypes = [u64]
    lib.ring_destroy.argtypes = [ctypes.c_void_p]
    lib.ring_write.restype = u64
    lib.ring_write.argtypes = [ctypes.c_void_p, _F32P, u64]
    lib.ring_read.restype = u64
    lib.ring_read.argtypes = [ctypes.c_void_p, _F32P, u64]
    lib.ring_available_read.restype = u64
    lib.ring_available_read.argtypes = [ctypes.c_void_p]
    lib.ring_available_write.restype = u64
    lib.ring_available_write.argtypes = [ctypes.c_void_p]
    i16p = ctypes.POINTER(ctypes.c_int16)
    i8p = ctypes.POINTER(ctypes.c_int8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32 = ctypes.c_float
    lib.iq_f32_to_i16.argtypes = [_F32P, i16p, i64, f32]
    lib.iq_i16_to_f32.argtypes = [i16p, _F32P, i64, f32]
    lib.iq_f32_to_i8.argtypes = [_F32P, i8p, i64, f32]
    lib.iq_i8_to_f32.argtypes = [i8p, _F32P, i64, f32]
    lib.iq_f32_to_u8.argtypes = [_F32P, u8p, i64, f32, f32]
    lib.iq_u8_to_f32.argtypes = [u8p, _F32P, i64, f32, f32]
    lib.iq_interleave.argtypes = [_F32P, _F32P, _F32P, i64]
    lib.iq_deinterleave.argtypes = [_F32P, _F32P, _F32P, i64]
    lib.udprx_create.restype = ctypes.c_void_p
    lib.udprx_create.argtypes = [ctypes.c_int, u64, ctypes.c_int, ctypes.c_int]
    lib.udprx_destroy.argtypes = [ctypes.c_void_p]
    lib.udprx_port.restype = ctypes.c_int
    lib.udprx_port.argtypes = [ctypes.c_void_p]
    lib.udprx_read.restype = u64
    lib.udprx_read.argtypes = [ctypes.c_void_p, _F32P, u64]
    for fn in ("udprx_available", "udprx_packets", "udprx_seq_gaps", "udprx_overruns"):
        getattr(lib, fn).restype = u64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]


def get_lib():
    """The loaded library, built on first use; None when it cannot be built
    (`build_error()` says why) and the plain versions run instead."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
        except (RuntimeError, OSError, AttributeError) as e:
            _build_error = str(e)
            return None
        if lib.iqcore_abi_version() < ABI_VERSION:
            _build_error = "abi mismatch"
            return None
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def build_error() -> str | None:
    return _build_error


# ---------------------------------------------------------------------
# Format conversion (native when built, the reference's numpy otherwise)
# ---------------------------------------------------------------------


def _as_f32(x) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def f32_to_i16(x, scale: float = 32767.0) -> np.ndarray:
    lib = get_lib()
    x = _as_f32(x)
    out = np.empty(x.size, np.int16)
    if lib is not None:
        lib.iq_f32_to_i16(_ptr(x, ctypes.c_float), _ptr(out, ctypes.c_int16), x.size, scale)
        return out
    return np.clip(np.round(x * scale), -32768, 32767).astype(np.int16)


def i16_to_f32(x, scale: float = 32767.0) -> np.ndarray:
    lib = get_lib()
    x = np.ascontiguousarray(x, np.int16)
    out = np.empty(x.size, np.float32)
    if lib is not None:
        lib.iq_i16_to_f32(_ptr(x, ctypes.c_int16), _ptr(out, ctypes.c_float), x.size,
                          1.0 / scale)
        return out
    return (x / scale).astype(np.float32)


def _round_away(v: np.ndarray) -> np.ndarray:
    """The library's rounding: half away from zero, in float32."""
    half = np.float32(0.5)
    return np.where(v >= 0, v + half, v - half)


def f32_to_i8(x, scale: float = 127.0) -> np.ndarray:
    lib = get_lib()
    x = _as_f32(x)
    out = np.empty(x.size, np.int8)
    if lib is not None:
        lib.iq_f32_to_i8(_ptr(x, ctypes.c_float), _ptr(out, ctypes.c_int8), x.size, scale)
        return out
    v = np.clip(x * np.float32(scale), np.float32(-128), np.float32(127))
    return np.trunc(_round_away(v)).astype(np.int8)


def i8_to_f32(x, scale: float = 127.0) -> np.ndarray:
    lib = get_lib()
    x = np.ascontiguousarray(x, np.int8)
    out = np.empty(x.size, np.float32)
    if lib is not None:
        lib.iq_i8_to_f32(_ptr(x, ctypes.c_int8), _ptr(out, ctypes.c_float), x.size, 1.0 / scale)
        return out
    return x.astype(np.float32) * np.float32(1.0 / scale)


def f32_to_u8(x, scale: float = 127.5, offset: float = 127.5) -> np.ndarray:
    lib = get_lib()
    x = _as_f32(x)
    out = np.empty(x.size, np.uint8)
    if lib is not None:
        lib.iq_f32_to_u8(_ptr(x, ctypes.c_float), _ptr(out, ctypes.c_uint8), x.size, scale,
                         offset)
        return out
    v = np.clip(x * np.float32(scale) + np.float32(offset), np.float32(0), np.float32(255))
    return np.trunc(v + np.float32(0.5)).astype(np.uint8)


def u8_to_f32(x, scale: float = 127.5, offset: float = 127.5) -> np.ndarray:
    lib = get_lib()
    x = np.ascontiguousarray(x, np.uint8)
    out = np.empty(x.size, np.float32)
    if lib is not None:
        lib.iq_u8_to_f32(_ptr(x, ctypes.c_uint8), _ptr(out, ctypes.c_float), x.size,
                         1.0 / scale, offset)
        return out
    return (x.astype(np.float32) - np.float32(offset)) * np.float32(1.0 / scale)


def interleave(re, im) -> np.ndarray:
    lib = get_lib()
    re, im = _as_f32(re), _as_f32(im)
    out = np.empty(re.size * 2, np.float32)
    if lib is not None:
        lib.iq_interleave(_ptr(re, ctypes.c_float), _ptr(im, ctypes.c_float),
                          _ptr(out, ctypes.c_float), re.size)
        return out
    out[0::2] = re
    out[1::2] = im
    return out


def deinterleave(x) -> tuple[np.ndarray, np.ndarray]:
    lib = get_lib()
    x = _as_f32(x)
    n = x.size // 2
    re = np.empty(n, np.float32)
    im = np.empty(n, np.float32)
    if lib is not None:
        lib.iq_deinterleave(_ptr(x, ctypes.c_float), _ptr(re, ctypes.c_float),
                            _ptr(im, ctypes.c_float), n)
        return re, im
    return x[0::2].copy(), x[1::2].copy()


# ---------------------------------------------------------------------
# Ring buffer (SPSC, rt/ringbuffer.rs role)
# ---------------------------------------------------------------------


class NativeRingBuffer:
    """Lock-free SPSC ring over float32 (2 floats per IQ sample); a deque of
    arrays when the library is unavailable."""

    def __init__(self, capacity_floats: int):
        self._lib = get_lib()
        self._native = self._lib is not None
        if self._native:
            self._h = self._lib.ring_create(capacity_floats)
            if not self._h:
                raise MemoryError("ring_create failed")
        else:
            self._q = deque()
            self._stored = 0
            self._cap = capacity_floats

    def write(self, arr) -> int:
        arr = _as_f32(arr)
        if self._native:
            return int(self._lib.ring_write(self._h, _ptr(arr, ctypes.c_float), arr.size))
        take = min(arr.size, self._cap - self._stored)
        if take:
            self._q.append(arr[:take].copy())
            self._stored += take
        return take

    def read(self, n: int) -> np.ndarray:
        if self._native:
            out = np.empty(n, np.float32)
            got = int(self._lib.ring_read(self._h, _ptr(out, ctypes.c_float), n))
            return out[:got]
        parts = []
        need = min(n, self._stored)
        while need > 0 and self._q:
            chunk = self._q.popleft()
            if chunk.size > need:
                parts.append(chunk[:need])
                self._q.appendleft(chunk[need:])
                self._stored -= need
                need = 0
            else:
                parts.append(chunk)
                self._stored -= chunk.size
                need -= chunk.size
        return np.concatenate(parts) if parts else np.zeros(0, np.float32)

    @property
    def readable(self) -> int:
        if self._native:
            return int(self._lib.ring_available_read(self._h))
        return self._stored

    @property
    def writable(self) -> int:
        if self._native:
            return int(self._lib.ring_available_write(self._h))
        return self._cap - self._stored

    def write_complex(self, x) -> int:
        x = np.asarray(x, np.complex64)
        return self.write(interleave(x.real, x.imag)) // 2

    def read_complex(self, n: int) -> np.ndarray:
        raw = self.read(2 * n)
        m = raw.size // 2
        re, im = deinterleave(raw[: 2 * m])
        return (re + 1j * im).astype(np.complex64)

    def __del__(self):
        if getattr(self, "_native", False) and getattr(self, "_h", None):
            try:
                self._lib.ring_destroy(self._h)
            except Exception:  # noqa: BLE001 - interpreter teardown
                pass


# ---------------------------------------------------------------------
# Native UDP IQ receiver (iqcore.cpp UdpRx): a C++ thread drains the
# socket into the lock-free ring; Python reads complex64 in bulk.
# ---------------------------------------------------------------------


class NativeUdpReceiver:
    """Threaded native UDP IQ receiver, bound to 127.0.0.1 unless
    `bind_any`. Wire format of `r4w_tpu_torch.net` ([seq u32 LE][f32 I/Q
    ...]). Raises RuntimeError when the library is unavailable."""

    def __init__(self, port: int = 0, ring_samples: int = 1 << 20, has_header: bool = True,
                 bind_any: bool = False):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(f"native UDP receiver unavailable: {build_error()}")
        self._lib = lib
        self._carry: float | None = None
        self._h = lib.udprx_create(int(port), int(ring_samples) * 2, 1 if has_header else 0,
                                   1 if bind_any else 0)
        if not self._h:
            raise RuntimeError(f"could not bind UDP port {port}")

    @property
    def port(self) -> int:
        return int(self._lib.udprx_port(self._h))

    @property
    def available_samples(self) -> int:
        return int(self._lib.udprx_available(self._h)) // 2

    def read(self, max_samples: int) -> np.ndarray:
        buf = np.empty(max_samples * 2 + 1, np.float32)
        off = 0
        if self._carry is not None:
            buf[0] = self._carry
            off = 1
            self._carry = None
        got = off + int(self._lib.udprx_read(self._h, _ptr(buf[off:], ctypes.c_float),
                                             max_samples * 2))
        if got & 1:
            # ring reads are float-granular; an odd count splits an I/Q
            # pair: carry the dangling I to the next read so the stream
            # never misaligns
            self._carry = float(buf[got - 1])
            got -= 1
        inter = buf[:got]
        return (inter[0::2] + 1j * inter[1::2]).astype(np.complex64)

    @property
    def stats(self) -> dict:
        return {"packets": int(self._lib.udprx_packets(self._h)),
                "seq_gaps": int(self._lib.udprx_seq_gaps(self._h)),
                "overrun_floats": int(self._lib.udprx_overruns(self._h))}

    def close(self):
        if self._h:
            self._lib.udprx_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover - belt and braces
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass
