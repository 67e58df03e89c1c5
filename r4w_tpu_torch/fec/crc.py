"""CRC checksums and Fletcher-16.

PyTorch counterpart of ``r4w_tpu.fec.crc``: table-driven CRCs over byte
arrays, one table gather a byte, batched over any leading axes. The
reference holds the register in uint32 under a scan; torch's uint32 lacks
most bitwise and shift operations, so the register here is int64, masked
to the CRC's width after every step, and the scan is a loop over byte
positions of a (..., N) tensor. Checksums come back as int64 values below
2^32. Functions follow the device of a tensor input; other inputs go to
`resolve_device(device)`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from r4w_tpu_torch.core.types import to_tensor

# name: (width, poly, init, refin, refout, xorout)
CRC_PARAMS = {
    "crc8": (8, 0x07, 0x00, False, False, 0x00),
    "crc8-maxim": (8, 0x31, 0x00, True, True, 0x00),
    "crc16-ccitt": (16, 0x1021, 0xFFFF, False, False, 0x0000),
    "crc16-ibm": (16, 0x8005, 0x0000, True, True, 0x0000),
    "crc16-lora": (16, 0x1021, 0x0000, False, False, 0x0000),
    "crc24-adsb": (24, 0xFFF409, 0x000000, False, False, 0x000000),
    "crc32": (32, 0x04C11DB7, 0xFFFFFFFF, True, True, 0xFFFFFFFF),
}


def _reflect(v: int, bits: int) -> int:
    r = 0
    for i in range(bits):
        if v & (1 << i):
            r |= 1 << (bits - 1 - i)
    return r


@functools.lru_cache(maxsize=None)
def _crc_table(name: str) -> np.ndarray:
    width, poly, _, refin, _, _ = CRC_PARAMS[name]
    table = np.zeros(256, np.uint32)
    for byte in range(256):
        b = _reflect(byte, 8) if refin else byte
        reg = b << (width - 8)
        mask = (1 << width) - 1
        for _ in range(8):
            if reg & (1 << (width - 1)):
                reg = ((reg << 1) ^ poly) & mask
            else:
                reg = (reg << 1) & mask
        table[byte] = _reflect(reg, width) if refin else reg
    return table


@functools.lru_cache(maxsize=None)
def _table(name: str, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_crc_table(name).astype(np.int64)).to(device)


@functools.lru_cache(maxsize=None)
def _table_list(name: str) -> tuple[int, ...]:
    return tuple(int(v) for v in _crc_table(name))


def _crc_host(values: list[int], name: str) -> int:
    """The table-driven CRC of one byte sequence in Python integers: the
    same register steps as the tensor loop below."""
    width, _, init, refin, refout, xorout = CRC_PARAMS[name]
    table, mask = _table_list(name), (1 << width) - 1
    reg = _reflect(init, width) if refin else init
    for byte in values:
        byte &= 0xFF
        if refin:
            reg = ((reg >> 8) ^ table[(reg ^ byte) & 0xFF]) & mask
        else:
            reg = ((reg << 8) & mask) ^ table[((reg >> (width - 8)) ^ byte) & 0xFF]
    if refin != refout:
        reg = _reflect(reg, width)
    return reg ^ xorout


def crc_compute(data_bytes, name: str = "crc16-ccitt", device=None) -> torch.Tensor:
    """CRC over (..., N) byte arrays -> (...,) int64 checksums. One byte
    sequence on the CPU (wire bytes on the host) is checksummed in Python
    integers, which costs microseconds where a loop of tensor steps costs
    milliseconds; the result is the same."""
    width, _, init, refin, refout, xorout = CRC_PARAMS[name]
    data = to_tensor(data_bytes, device=device).to(torch.int64) & 0xFF
    if data.dim() == 1 and data.device.type == "cpu":
        return torch.tensor(_crc_host(data.tolist(), name), dtype=torch.int64)
    table = _table(name, data.device)
    mask = (1 << width) - 1
    reg = torch.full(data.shape[:-1], _reflect(init, width) if refin else init,
                     dtype=torch.int64, device=data.device)
    for i in range(data.shape[-1]):
        byte = data[..., i]
        if refin:
            reg = ((reg >> 8) ^ table[(reg ^ byte) & 0xFF]) & mask
        else:
            reg = ((reg << 8) & mask) ^ table[((reg >> (width - 8)) ^ byte) & 0xFF]
    if refin != refout:
        # bit-reflect the register (rare combinations)
        out = torch.zeros_like(reg)
        for i in range(width):
            out = out | (((reg >> i) & 1) << (width - 1 - i))
        reg = out
    return reg ^ xorout


def crc_check(data_bytes, checksum, name: str = "crc16-ccitt", device=None) -> torch.Tensor:
    crc = crc_compute(data_bytes, name, device)
    return crc == to_tensor(checksum, torch.int64, crc.device)


def fletcher16(data_bytes, device=None) -> torch.Tensor:
    """Fletcher-16 checksum over (..., N) bytes -> (...,) int64."""
    data = to_tensor(data_bytes, device=device).to(torch.int64) & 0xFF
    s1 = torch.zeros(data.shape[:-1], dtype=torch.int64, device=data.device)
    s2 = torch.zeros_like(s1)
    for i in range(data.shape[-1]):
        s1 = (s1 + data[..., i]) % 255
        s2 = (s2 + s1) % 255
    return (s2 << 8) | s1
