"""Bit-level coding ops: Gray code, LoRa Hamming FEC, whitening, interleaving.

PyTorch counterpart of ``r4w_tpu.ops.coding``. The lookup tables are
built by the same numpy code, cached per device, and read with gathers.
Integer reductions pass ``dtype=torch.int32`` because ``torch.sum`` of an
int32 tensor otherwise returns int64, and the interleaver is a masked
sum of shifted bits because CUDA has no integer matrix product.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from r4w_tpu_torch.core.types import SYMBOL_DTYPE, resolve_device, to_tensor


def _int(x) -> torch.Tensor:
    return to_tensor(x, SYMBOL_DTYPE)


def _arange(start: int, end: int, step: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(start, end, step, dtype=SYMBOL_DTYPE, device=like.device)


# --------------------------------------------------------------------------
# Gray code: g = n ^ (n >> 1)
# --------------------------------------------------------------------------


def gray_encode(x) -> torch.Tensor:
    x = _int(x)
    return x ^ (x >> 1)


def gray_decode(g) -> torch.Tensor:
    """Inverse Gray: repeated xor-shift (log2(16-bit) = 4 steps)."""
    g = _int(g)
    g = g ^ (g >> 8)
    g = g ^ (g >> 4)
    g = g ^ (g >> 2)
    g = g ^ (g >> 1)
    return g


# --------------------------------------------------------------------------
# LoRa Hamming(4, 4+cr) FEC. Parity rows generate the parity bits placed
# above the 4 data bits; data bit i is (data >> (3-i)) & 1.
# --------------------------------------------------------------------------

_PARITY_ROWS = {
    1: [[1, 1, 1, 1]],
    2: [[1, 0, 1, 1], [0, 1, 1, 1]],
    3: [[1, 0, 1, 1], [1, 1, 1, 0], [0, 1, 1, 1]],
    4: [[1, 0, 1, 1], [1, 1, 1, 0], [1, 1, 0, 1], [0, 1, 1, 1]],
}


@functools.lru_cache(maxsize=None)
def _hamming_tables(cr: int) -> tuple[np.ndarray, np.ndarray]:
    """(encode LUT [16] -> codeword, decode LUT [2^(4+cr)] -> nibble)."""
    rows = _PARITY_ROWS[cr]
    enc = np.zeros(16, np.int32)
    for data in range(16):
        bits = [(data >> (3 - i)) & 1 for i in range(4)]
        cw = data & 0x0F
        for i, row in enumerate(rows):
            p = sum(r & d for r, d in zip(row, bits)) & 1
            cw |= p << (4 + i)
        enc[data] = cw

    # Decode by minimum distance to the 16 valid codewords: CR4/7 and
    # CR4/8 have minimum distance 3, so they correct one bit. This departs
    # on purpose from the Rust original's syndrome rule, which corrects
    # nothing; the two agree on clean input.
    t = 1 if cr in (3, 4) else 0
    size = 1 << (4 + cr)
    dec = np.zeros(size, np.int32)
    for w in range(size):
        dists = np.array([bin(w ^ int(c)).count("1") for c in enc])
        best = int(np.argmin(dists))
        dec[w] = best if dists[best] <= t else (w & 0x0F)
    return enc, dec


@functools.lru_cache(maxsize=None)
def _hamming_luts(cr: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """`_hamming_tables` as read-only tensors on `device`."""
    enc, dec = _hamming_tables(cr)
    return torch.from_numpy(enc).to(device), torch.from_numpy(dec).to(device)


def hamming_encode(nibbles, cr: int) -> torch.Tensor:
    """Encode 4-bit nibbles to (4+cr)-bit codewords. cr in 1..4."""
    nib = _int(nibbles)
    enc, _ = _hamming_luts(cr, nib.device)
    return torch.take(enc, (nib & 0xF).long())


def hamming_decode(codewords, cr: int) -> torch.Tensor:
    """Decode (4+cr)-bit codewords to nibbles, correcting 1-bit errors at CR4/7-4/8."""
    cw = _int(codewords)
    _, dec = _hamming_luts(cr, cw.device)
    return torch.take(dec, (cw & ((1 << (4 + cr)) - 1)).long())


# --------------------------------------------------------------------------
# LoRa whitening: 8-bit LFSR, state << 1 | parity(state & 0x3A), output is
# the old MSB, XOR'd bytewise with the data. The sequence depends only on
# the position, so it is a table.
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _whitening_sequence(n_bytes: int) -> np.ndarray:
    state = 0xFF
    out = np.zeros(n_bytes, np.int32)
    for b in range(n_bytes):
        byte = 0
        for i in range(8):
            fb = bin(state & 0x3A).count("1") & 1
            msb = (state >> 7) & 1
            state = ((state << 1) | fb) & 0xFF
            byte |= msb << (7 - i)
        out[b] = byte
    return out


@functools.lru_cache(maxsize=None)
def _whitening_table(n_bytes: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_whitening_sequence(n_bytes)).to(device)


def whitening_sequence(n_bytes: int, device=None) -> torch.Tensor:
    """First n_bytes of the LoRa whitening PRBS (as int32 bytes)."""
    return _whitening_table(n_bytes, resolve_device(device)).clone()


def whiten(data) -> torch.Tensor:
    """XOR data bytes with the whitening sequence (self-inverse)."""
    data = _int(data)
    return data ^ _whitening_table(int(data.shape[-1]), data.device)


dewhiten = whiten


# --------------------------------------------------------------------------
# LoRa diagonal interleaver
# sf codewords of (4+cr) bits  <->  (4+cr) symbols of sf bits
#   symbols[(i+j) % n_bits] bit i = codeword[i] bit j
# --------------------------------------------------------------------------


def interleave(codewords, sf: int, cr: int) -> torch.Tensor:
    """Interleave blocks of sf codewords -> n_bits symbols.

    codewords: (..., sf) int32. Returns (..., 4+cr) int32 symbols.
    Symbol k gathers bit (k - i) mod n_bits of codeword i at position i;
    those bits sit at distinct positions, so their sum is their OR.
    """
    n_bits = 4 + cr
    cw = _int(codewords)
    i = _arange(0, sf, 1, cw)[:, None]  # codeword index / bit position in symbol
    k = _arange(0, n_bits, 1, cw)[None, :]  # target symbol
    j = (k - i) % n_bits  # (sf, n_bits): codeword bit that lands in symbol k
    bits = (cw[..., :, None] >> j) & 1  # (..., sf, n_bits)
    return (bits << i).sum(dim=-2, dtype=SYMBOL_DTYPE)


def deinterleave(symbols, sf: int, cr: int) -> torch.Tensor:
    """Inverse of `interleave`: (..., 4+cr) symbols -> (..., sf) codewords."""
    n_bits = 4 + cr
    syms = _int(symbols)
    i = _arange(0, sf, 1, syms)[:, None]
    j = _arange(0, n_bits, 1, syms)[None, :]
    sym_idx = (i + j) % n_bits  # (sf, n_bits), always in range
    gathered = syms.index_select(-1, sym_idx.reshape(-1)).reshape(
        *syms.shape[:-1], sf, n_bits)
    bits = (gathered >> i) & 1
    return (bits << j).sum(dim=-1, dtype=SYMBOL_DTYPE)


# --------------------------------------------------------------------------
# Byte/nibble/bit packing helpers
# --------------------------------------------------------------------------


def bytes_to_nibbles(data) -> torch.Tensor:
    """(..., n) bytes -> (..., 2n) nibbles, high nibble first."""
    data = _int(data)
    hi = (data >> 4) & 0xF
    lo = data & 0xF
    return torch.stack([hi, lo], dim=-1).reshape(*data.shape[:-1], -1)


def nibbles_to_bytes(nibbles) -> torch.Tensor:
    """(..., 2n) nibbles -> (..., n) bytes."""
    nib = _int(nibbles)
    pairs = nib.reshape(*nib.shape[:-1], -1, 2)
    return (pairs[..., 0] << 4) | (pairs[..., 1] & 0x0F)


def bytes_to_bits(data) -> torch.Tensor:
    """(..., n) bytes -> (..., 8n) bits, MSB first."""
    data = _int(data)
    bits = (data[..., None] >> _arange(7, -1, -1, data)) & 1
    return bits.reshape(*data.shape[:-1], -1)


def bits_to_bytes(bits) -> torch.Tensor:
    """(..., 8n) bits -> (..., n) bytes, MSB first."""
    bits = _int(bits)
    b = bits.reshape(*bits.shape[:-1], -1, 8)
    return (b << _arange(7, -1, -1, bits)).sum(dim=-1, dtype=SYMBOL_DTYPE)


def bits_to_symbols(bits, bits_per_symbol: int) -> torch.Tensor:
    """Group bits (MSB first) into symbols of `bits_per_symbol` bits."""
    bits = _int(bits)
    b = bits.reshape(*bits.shape[:-1], -1, bits_per_symbol)
    shifts = _arange(bits_per_symbol - 1, -1, -1, bits)
    return (b << shifts).sum(dim=-1, dtype=SYMBOL_DTYPE)


def symbols_to_bits(symbols, bits_per_symbol: int) -> torch.Tensor:
    """Unpack symbols into bits, MSB first."""
    s = _int(symbols)
    bits = (s[..., None] >> _arange(bits_per_symbol - 1, -1, -1, s)) & 1
    return bits.reshape(*s.shape[:-1], -1)
