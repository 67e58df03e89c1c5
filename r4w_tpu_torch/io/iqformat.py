"""IQ sample file formats (crates/r4w-core/src/io/format.rs re-design).

PyTorch counterpart of ``r4w_tpu.io.iqformat``: five interleaved formats
(io/format.rs:49): cf64, cf32, ci16, ci8, cu8, and their SigMF datatypes.
Files are read and written as numpy; a tensor on any device is read to
the host in one copy when it is encoded. The reference encodes ci16 in
its native library when that builds (``iq_f32_to_i16``: a float32
product, clamped, rounded half away from zero); the port computes those
bytes in numpy (`_f32_to_i16`), and the other formats as the reference's
numpy does.
"""

from __future__ import annotations

import numpy as np
import torch

# format name -> (numpy scalar dtype, scale for int formats, offset)
_FORMATS = {
    "cf64": (np.float64, 1.0, 0.0),
    "cf32": (np.float32, 1.0, 0.0),
    "ci16": (np.int16, 32767.0, 0.0),
    "ci8": (np.int8, 127.0, 0.0),
    "cu8": (np.uint8, 127.5, 127.5),  # RTL-SDR style
}

SIGMF_DATATYPES = {
    "cf64": "cf64_le",
    "cf32": "cf32_le",
    "ci16": "ci16_le",
    "ci8": "ci8",
    "cu8": "cu8",
}

_FROM_SIGMF = {v: k for k, v in SIGMF_DATATYPES.items()}


def list_formats() -> list[str]:
    return list(_FORMATS)


def bytes_per_sample(fmt: str) -> int:
    dt, _, _ = _FORMATS[fmt]
    return 2 * np.dtype(dt).itemsize


def from_sigmf_datatype(datatype: str) -> str:
    if datatype in _FROM_SIGMF:
        return _FROM_SIGMF[datatype]
    raise ValueError(f"unsupported SigMF datatype {datatype}")


def to_host(samples) -> np.ndarray:
    """`samples` as a numpy array: a tensor is copied to the host once."""
    if isinstance(samples, torch.Tensor):
        return samples.detach().cpu().numpy()
    return np.asarray(samples)


def encode_samples(samples, fmt: str = "cf32") -> bytes:
    """complex array or tensor -> interleaved bytes (io/format.rs:287)."""
    if fmt not in _FORMATS:
        raise ValueError(f"unknown IQ format {fmt}; know {list(_FORMATS)}")
    dt, scale, offset = _FORMATS[fmt]
    x = to_host(samples)
    if fmt == "ci16":
        inter = np.empty(x.size * 2, np.float32)
        inter[0::2] = np.real(x).reshape(-1)
        inter[1::2] = np.imag(x).reshape(-1)
        return _f32_to_i16(inter, scale).tobytes()
    inter = np.empty(x.size * 2, np.float64)
    inter[0::2] = np.real(x).reshape(-1)
    inter[1::2] = np.imag(x).reshape(-1)
    if fmt in ("cf64", "cf32"):
        return inter.astype(dt).tobytes()
    info = np.iinfo(dt)
    q = np.clip(np.round(inter * scale + offset), info.min, info.max)
    return q.astype(dt).tobytes()


def _f32_to_i16(x: np.ndarray, scale: float) -> np.ndarray:
    """The reference's native ``iq_f32_to_i16``: v = x·scale in float32,
    clamped to [-32768, 32767], then (int16)(v ± 0.5f)."""
    v = np.clip(x * np.float32(scale), np.float32(-32768.0), np.float32(32767.0))
    half = np.where(v >= 0, np.float32(0.5), np.float32(-0.5))
    return (v + half).astype(np.int16)


def decode_samples(raw: bytes, fmt: str = "cf32") -> np.ndarray:
    """interleaved bytes -> complex64 array (io/format.rs:137 read path)."""
    if fmt not in _FORMATS:
        raise ValueError(f"unknown IQ format {fmt}; know {list(_FORMATS)}")
    dt, scale, offset = _FORMATS[fmt]
    flat = np.frombuffer(raw, dtype=dt).astype(np.float64)
    if fmt not in ("cf64", "cf32"):
        flat = (flat - offset) / scale
    n = len(flat) // 2
    out = flat[: 2 * n : 2] + 1j * flat[1 : 2 * n : 2]
    return out.astype(np.complex64)


def write_iq_file(path: str, samples, fmt: str = "cf32"):
    with open(path, "wb") as f:
        f.write(encode_samples(samples, fmt))


def read_iq_file(path: str, fmt: str = "cf32",
                 max_samples: int | None = None) -> np.ndarray:
    with open(path, "rb") as f:
        raw = f.read(
            max_samples * bytes_per_sample(fmt) if max_samples else -1
        )
    return decode_samples(raw, fmt)


def convert_iq_file(src: str, dst: str, src_fmt: str, dst_fmt: str,
                    block_samples: int = 1 << 20):
    """Streaming format conversion (cmd_convert, r4w-cli main.rs:5073)."""
    bps = bytes_per_sample(src_fmt)
    with open(src, "rb") as fin, open(dst, "wb") as fout:
        while True:
            raw = fin.read(block_samples * bps)
            if not raw:
                break
            fout.write(encode_samples(decode_samples(raw, src_fmt), dst_fmt))
