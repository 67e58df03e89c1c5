"""Plain LoRa PHY reference: the benchmark's yardstick for `correct`.

Written from the LoRa PHY's description in plain numpy and PyTorch, with no
hand kernel, cache or batching trick: whitening, Hamming 4/(4+CR), the
diagonal interleaver, Gray mapping, chirp synthesis, AWGN at a measured
signal power, the dechirp DFT with its argmax, the decode and the bit errors.
It imports nothing of the program under test; the harness hands it the same
payloads, SNRs, noise and captured IQ that it hands the program, and it works
out everything else again.

`Precision` says in what type the tensors that a receiver keeps in device
memory are held: float32 throughout (the configurations' stated precision),
or rounded to bfloat16 at each such tensor (the transmitted and received IQ,
the dechirped rows, the power), which is the control that `correct` must
refuse.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

IQ = torch.complex64
REAL = torch.float32
INT = torch.int32

# Parity rows of LoRa's Hamming code: parity bit i of a nibble d3 d2 d1 d0
# (data bit m is (nibble >> (3 - m)) & 1) is the XOR of the data bits a row marks.
PARITY_ROWS = {
    1: [[1, 1, 1, 1]],
    2: [[1, 0, 1, 1], [0, 1, 1, 1]],
    3: [[1, 0, 1, 1], [1, 1, 1, 0], [0, 1, 1, 1]],
    4: [[1, 0, 1, 1], [1, 1, 1, 0], [1, 1, 0, 1], [0, 1, 1, 1]],
}


@dataclasses.dataclass(frozen=True)
class Phy:
    """The PHY settings the reference needs: spreading factor, bandwidth and
    coding rate 4/(4+cr), at one sample a chip."""

    sf: int
    bw_hz: int
    cr: int

    @property
    def chips(self) -> int:
        return 1 << self.sf

    def n_symbols(self, n_bytes: int) -> int:
        """Payload symbols of an n-byte payload: whole interleaver blocks of
        sf codewords, one codeword a nibble, 4 + cr symbols a block."""
        return -(-2 * n_bytes // self.sf) * (4 + self.cr)


def phy_of(config: dict) -> Phy:
    return Phy(sf=int(config["sf"]), bw_hz=int(config["bw_hz"]), cr=int(config["cr"]))


# --------------------------------------------------------------------------
# Tables, built in numpy
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def whitening_np(n_bytes: int) -> np.ndarray:
    """LoRa's whitening bytes: an 8-bit LFSR from 0xFF, next state
    (s << 1) | parity(s & 0x3A), each output bit the state's old MSB,
    eight bits a byte, MSB first."""
    state, out = 0xFF, np.zeros(n_bytes, np.int64)
    for b in range(n_bytes):
        byte = 0
        for i in range(8):
            msb = (state >> 7) & 1
            state = ((state << 1) | (bin(state & 0x3A).count("1") & 1)) & 0xFF
            byte |= msb << (7 - i)
        out[b] = byte
    return out


@functools.lru_cache(maxsize=None)
def hamming_np(cr: int) -> tuple[np.ndarray, np.ndarray]:
    """(codeword of each nibble, nibble of each received word). A word
    decodes to the nearest codeword's nibble where that is at most t bits
    away (t = 1 at CR 4/7 and 4/8, whose distance is 3; t = 0 below), else
    to its own low four bits."""
    enc = np.zeros(16, np.int64)
    for d in range(16):
        bits = [(d >> (3 - m)) & 1 for m in range(4)]
        word = d
        for i, row in enumerate(PARITY_ROWS[cr]):
            word |= (sum(r * b for r, b in zip(row, bits)) & 1) << (4 + i)
        enc[d] = word
    t = 1 if cr >= 3 else 0
    dec = np.zeros(1 << (4 + cr), np.int64)
    for w in range(dec.size):
        dist = [bin(w ^ int(c)).count("1") for c in enc]
        best = int(np.argmin(dist))
        dec[w] = best if dist[best] <= t else w & 0xF
    return enc, dec


@functools.lru_cache(maxsize=None)
def upchirp_np(sf: int, bw_hz: int) -> np.ndarray:
    """The base upchirp at one sample a chip, in float64: frequency from
    -bw/2 rising at bw²/K per second over the symbol, phase 0 at t = 0."""
    k = 1 << sf
    t = np.arange(k, dtype=np.float64) / bw_hz
    rate = bw_hz * bw_hz / k
    return np.exp(2j * np.pi * (-bw_hz / 2.0 * t + rate / 2.0 * t * t))


@functools.lru_cache(maxsize=None)
def _device_tables(phy: Phy, n_bytes: int, device: torch.device):
    up = upchirp_np(phy.sf, phy.bw_hz)
    k = phy.chips
    # symbol s is the base upchirp started s chips later, wrapping around
    bank = up[(np.arange(k)[None, :] + np.arange(k)[:, None]) % k]
    enc, dec = hamming_np(phy.cr)
    return {
        "bank": torch.from_numpy(bank.astype(np.complex64)).to(device),
        "down": torch.from_numpy(np.conj(up).astype(np.complex64)).to(device),
        "white": torch.from_numpy(whitening_np(n_bytes)).to(device),
        "enc": torch.from_numpy(enc).to(device),
        "dec": torch.from_numpy(dec).to(device),
    }


def tables(phy: Phy, n_bytes: int, device) -> dict:
    return _device_tables(phy, n_bytes, torch.device(device))


# --------------------------------------------------------------------------
# Encode and modulate
# --------------------------------------------------------------------------


def _interleave_index(phy: Phy):
    """(i, j, k): codeword i's bit j sits in symbol k = (i + j) mod (4 + cr),
    at bit position i of that symbol."""
    n_bits = 4 + phy.cr
    i = np.arange(phy.sf)[:, None]
    j = np.arange(n_bits)[None, :]
    return i, j, (i + j) % n_bits


def encode(phy: Phy, payload: torch.Tensor) -> torch.Tensor:
    """(..., n) payload bytes -> (..., S) symbols: whiten, split into
    nibbles high first, Hamming-encode, pad to blocks of sf codewords,
    interleave each block into 4 + cr symbols, Gray-map."""
    n = payload.shape[-1]
    t = tables(phy, n, payload.device)
    data = payload.long() ^ t["white"]
    nib = torch.stack([(data >> 4) & 0xF, data & 0xF], dim=-1).reshape(*data.shape[:-1], -1)
    cw = t["enc"][nib]
    n_blocks = -(-cw.shape[-1] // phy.sf)
    cw = torch.nn.functional.pad(cw, (0, n_blocks * phy.sf - cw.shape[-1]))
    cw = cw.reshape(*cw.shape[:-1], n_blocks, phy.sf)
    n_bits = 4 + phy.cr
    sym = torch.zeros(*cw.shape[:-1], n_bits, dtype=torch.int64, device=cw.device)
    i_idx, j_idx, k_idx = _interleave_index(phy)
    for i in range(phy.sf):
        for j in range(n_bits):
            k = int(k_idx[i, j])
            sym[..., k] |= ((cw[..., i] >> j) & 1) << i
    gray = sym ^ (sym >> 1)
    return gray.reshape(*gray.shape[:-2], -1)


def modulate(phy: Phy, payload: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    """(..., n) payload bytes -> (..., S·K) complex64 payload chirps."""
    sym = encode(phy, payload)
    chirps = tables(phy, payload.shape[-1], payload.device)["bank"][sym]
    return round_iq(chirps.reshape(*sym.shape[:-1], -1), precision)


# --------------------------------------------------------------------------
# Channel
# --------------------------------------------------------------------------


def complex_noise(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Unit variance per component: real and imaginary parts as the last axis
    of one float32 draw of `shape` + (2,)."""
    return torch.view_as_complex(torch.randn((*shape, 2), generator=generator,
                                             dtype=REAL, device=device))


def awgn(tx: torch.Tensor, snr_db: torch.Tensor, noise: torch.Tensor,
         precision: str = "float32") -> torch.Tensor:
    """tx + noise·σ with σ² = P / (2·10^(snr/10)) per component, P the mean of
    |tx|² over the last axis; `snr_db` broadcasts against tx's leading axes."""
    power = torch.mean(tx.real.square() + tx.imag.square(), dim=-1, keepdim=True)
    lin = torch.pow(10.0, snr_db.to(REAL) / 10.0)[..., None]
    sigma = torch.sqrt(power / lin / 2.0)
    return round_iq(tx + noise * sigma, precision)


# --------------------------------------------------------------------------
# Demodulate and decode
# --------------------------------------------------------------------------


def round_iq(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float32":
        return x
    if precision != "bfloat16":
        raise ValueError(f"unknown precision {precision!r}")
    parts = torch.view_as_real(x).to(torch.bfloat16).to(REAL)
    return torch.view_as_complex(parts.contiguous())


def power(phy: Phy, rx: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    """(..., S·K) received IQ -> (..., S, K) |DFT(x·conj(upchirp))|² in float32."""
    k = phy.chips
    rows = rx.reshape(*rx.shape[:-1], -1, k)
    down = tables(phy, 1, rx.device)["down"]
    mixed = round_iq(round_iq(rows, precision) * round_iq(down, precision), precision)
    spec = torch.fft.fft(mixed, dim=-1)
    p = spec.real.square() + spec.imag.square()
    return p if precision == "float32" else p.to(torch.bfloat16).to(REAL)


def decode(phy: Phy, symbols: torch.Tensor, n_bytes: int) -> torch.Tensor:
    """(..., S) symbols -> (..., n_bytes) payload bytes: Gray inverse,
    deinterleave, Hamming-decode, pair nibbles, dewhiten."""
    g = symbols.long()
    for shift in (8, 4, 2, 1):
        g = g ^ (g >> shift)
    n_bits = 4 + phy.cr
    blocks = g.reshape(*g.shape[:-1], -1, n_bits)
    cw = torch.zeros(*blocks.shape[:-1], phy.sf, dtype=torch.int64, device=g.device)
    _, _, k_idx = _interleave_index(phy)
    for i in range(phy.sf):
        for j in range(n_bits):
            cw[..., i] |= ((blocks[..., int(k_idx[i, j])] >> i) & 1) << j
    t = tables(phy, n_bytes, g.device)
    nib = t["dec"][cw].reshape(*cw.shape[:-2], -1)[..., : 2 * n_bytes]
    data = (nib[..., 0::2] << 4) | nib[..., 1::2]
    return data ^ t["white"]


def bit_errors(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bits that differ between two (..., n) byte tensors, per leading index."""
    x = (a.long() ^ b.long()) & 0xFF
    count = torch.zeros_like(x)
    for bit in range(8):
        count += (x >> bit) & 1
    return count.sum(dim=-1)


def demodulate(phy: Phy, rx: torch.Tensor, n_bytes: int, precision: str = "float32"):
    """(..., S·K) IQ -> (symbols (..., S), payload bytes (..., n_bytes))."""
    sym = torch.argmax(power(phy, rx, precision), dim=-1)
    return sym, decode(phy, sym, n_bytes)


def near_ties(p: torch.Tensor, rel: float) -> torch.Tensor:
    """(..., S, K) power -> (..., S) bools: rows whose two largest bins lie
    within `rel` of the largest, where rounding can swap the decision."""
    top = torch.topk(p, 2, dim=-1).values
    return (top[..., 0] - top[..., 1]) <= rel * top[..., 0]


def symbol_gap(p: torch.Tensor, symbols: torch.Tensor) -> torch.Tensor:
    """(..., S, K) reference power and (..., S) decisions -> (..., S) how far
    each decision's power lies below the row's largest, as a share of it."""
    best = p.amax(dim=-1)
    chosen = torch.gather(p, -1, symbols.long()[..., None].clamp(0, p.shape[-1] - 1))[..., 0]
    bad = (symbols.long() < 0) | (symbols.long() >= p.shape[-1])
    return torch.where(bad, torch.ones_like(best), (best - chosen) / best)
