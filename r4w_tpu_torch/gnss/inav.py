"""Galileo E1B I/NAV page coding (Galileo OS SIS ICD §4.3.5).

The reference generates the E1B data component but never decodes it
(crates/r4w-core/src/waveform/gnss/boc.rs:23-142 CBOC E1B/E1C,
satellite_emitter.rs:284-293 data overlay); this module implements the
full I/NAV nominal-page pipeline in both directions (VERDICT r4 #5):

Encode (transmit side, used by the scenario overlay):
  1 s page PART = 120 bits (even: e/o flag + type + 112 data + 6 tail;
  odd: e/o + type + 16 data + 40 OSNMA + 22 SAR + 2 spare + 24 CRC +
  8 SSP + 6 tail) → rate-1/2 K=7 convolutional code (G1 = 171o,
  G2 = 133o with the SECOND branch inverted, per ICD §4.1.4) →
  30-column × 8-row block interleaver (written rows, read columns) →
  10-symbol sync pattern 0101100000 prepended = 250 symbols.
  A nominal page = even part then odd part (2 s, 500 symbols); the
  CRC-24Q spans the 196 content bits (114 even + 82 odd-before-CRC).

Decode (receiver side): sync search at either polarity → de-interleave
→ branch-2 un-invert → soft Viterbi (fec.convolutional) → field split
→ CRC-24Q check.

PyTorch counterpart of ``r4w_tpu.gnss.inav``: the functions that do not
reach the FEC are copies of the reference's. The encoder runs the
port's `conv_encode` on the host. The decoder runs the port's soft
`viterbi_decode` on a device (the CUDA card unless named, where it
launches the forward and traceback kernels), one lane per page part:
`decode_stream` decodes every complete part of a stream in one batched
call, and its pages equal the reference's page for page.
"""

from __future__ import annotations

import numpy as np
import torch

from r4w_tpu_torch.core.types import resolve_device
from r4w_tpu_torch.fec.convolutional import conv_encode, viterbi_decode

SYNC = np.array([0, 1, 0, 1, 1, 0, 0, 0, 0, 0], np.int32)
PAGE_SYMS = 250           # per 1 s part, incl. sync
PART_BITS = 120           # info bits per part incl. 6-bit tail
CRC_POLY = 0x1864CFB      # CRC-24Q (Qualcomm), MSB-first, init 0


def crc24q(bits) -> int:
    """Bitwise CRC-24Q over a 0/1 bit array (MSB-first)."""
    reg = 0
    for b in np.asarray(bits, np.int64):
        reg = ((reg << 1) | int(b)) & 0x1FFFFFF
        if reg & 0x1000000:
            reg ^= CRC_POLY
    for _ in range(24):
        reg = (reg << 1) & 0x1FFFFFF
        if reg & 0x1000000:
            reg ^= CRC_POLY
    return reg & 0xFFFFFF


def _int_bits(v: int, n: int) -> np.ndarray:
    return np.array([(v >> (n - 1 - i)) & 1 for i in range(n)],
                    np.int32)


def _conv_encode_part(info114: np.ndarray) -> np.ndarray:
    """Rate-1/2 K=7 FEC with the G2 branch inverted (ICD §4.1.4.2).
    conv_encode(terminate=True) appends the part's 6-bit tail itself:
    114 info bits → 120 encoder inputs → 240 symbols (c1, c2). The
    bits are host numpy, so the encoder runs on a CPU tensor."""
    coded = conv_encode(
        torch.from_numpy(np.asarray(info114, np.int32)), constraint=7,
        polys=(0o171, 0o133), terminate=True).numpy().reshape(-1, 2).copy()
    coded[:, 1] ^= 1
    return coded.reshape(-1)


def _interleave(sym240: np.ndarray) -> np.ndarray:
    """30 columns × 8 rows, written row-wise, read column-wise."""
    return np.asarray(sym240, np.int32).reshape(8, 30).T.reshape(-1)


def _deinterleave(sym240: np.ndarray) -> np.ndarray:
    return np.asarray(sym240).reshape(30, 8).T.reshape(-1)


def encode_page(data112: np.ndarray, data16: np.ndarray,
                osnma: int = 0, sar: int = 0, ssp: int = 0
                ) -> np.ndarray:
    """One nominal page (even + odd part) → 500 symbols (0/1).

    data112 / data16 are the word's data bits split per the ICD page
    layout; the CRC is computed here over the 196 content bits."""
    d1 = np.asarray(data112, np.int32)
    d2 = np.asarray(data16, np.int32)
    assert d1.shape == (112,) and d2.shape == (16,)
    even_info = np.concatenate([[0, 0], d1])                 # 114
    odd_pre = np.concatenate([[1, 0], d2, _int_bits(osnma, 40),
                              _int_bits(sar, 22), [0, 0]])   # 82
    crc = crc24q(np.concatenate([even_info, odd_pre]))
    even = even_info                                         # 114
    odd = np.concatenate([odd_pre, _int_bits(crc, 24),
                          _int_bits(ssp, 8)])                # 114
    parts = []
    for part in (even, odd):
        parts.append(np.concatenate([
            SYNC, _interleave(_conv_encode_part(part))]))
    return np.concatenate(parts)


def pages_to_symbols_pm(pages: list[np.ndarray]) -> np.ndarray:
    """±1 symbol stream from encoded pages (0 → +1, the scenario
    overlay convention nav = 1 − 2·sym)."""
    return 1.0 - 2.0 * np.concatenate(pages).astype(np.float32)


def sync_search(soft_syms: np.ndarray) -> tuple[int, int]:
    """(offset, polarity) of the page-part grid in a soft ±1 symbol
    stream: correlate the 10-symbol sync at every offset, fold mod
    250, pick the (offset, ±1) with the largest summed response."""
    s = np.asarray(soft_syms, np.float64)
    pat = 1.0 - 2.0 * SYNC
    n = len(s) - len(pat) + 1
    if n <= 0:
        return 0, 1
    win = np.lib.stride_tricks.sliding_window_view(s, len(pat))
    corr = win @ pat
    folded = np.zeros(PAGE_SYMS)
    for k in range(n):
        folded[k % PAGE_SYMS] += corr[k]
    off = int(np.argmax(np.abs(folded)))
    pol = 1 if folded[off] >= 0 else -1
    return off, pol


def decoder_input(soft: np.ndarray) -> np.ndarray:
    """(n, 240) float32 decoder input of n parts' (n, 240) soft symbols:
    deinterleaved, the G2 branch un-inverted, in float32 as the
    reference's JAX decoder takes its float64 input."""
    de = np.stack([_deinterleave(p) for p in np.asarray(soft, np.float64)])
    de = de.reshape(len(de), -1, 2)
    de[:, :, 1] = -de[:, :, 1]  # un-invert the G2 branch in the soft domain
    return de.reshape(len(de), -1).astype(np.float32)


def decode_parts(soft: np.ndarray, device=None) -> np.ndarray:
    """(n, 114) decoded info bits of n parts' (n, 240) soft symbols (±1,
    +1 = bit 0) in one batched Viterbi decode on `device` (default: the
    CUDA card), one lane a part."""
    rx = torch.from_numpy(decoder_input(soft)).to(resolve_device(device))
    dec = viterbi_decode(rx, constraint=7, polys=(0o171, 0o133), terminated=True, soft=True)
    return dec.cpu().numpy().astype(np.int32)


def decode_part(soft240: np.ndarray, device=None) -> np.ndarray:
    """114 decoded info bits from one part's 240 soft symbols (±1,
    +1 = bit 0; the 6 tail bits are consumed by the terminated
    trellis)."""
    return decode_parts(np.asarray(soft240, np.float64)[None], device)[0]


def _page_fields(even: np.ndarray, odd: np.ndarray) -> dict:
    """The field dict of one page from its parts' decoded bits."""
    even_info, odd_pre = even, odd[:82]
    crc_rx = 0
    for b in odd[82:106]:
        crc_rx = (crc_rx << 1) | int(b)
    crc_ok = (crc24q(np.concatenate([even_info, odd_pre])) == crc_rx
              and even[0] == 0 and odd[0] == 1)
    return {"data112": even[2:114], "data16": odd[2:18],
            "even_odd": (int(even[0]), int(odd[0])),
            "crc_ok": bool(crc_ok)}


def decode_page(soft500: np.ndarray, device=None) -> dict:
    """Decode one nominal page (two 250-symbol parts WITHOUT their
    sync prefixes stripped — this strips them). Returns the field
    dict incl. crc_ok."""
    s = np.asarray(soft500, np.float64)
    even, odd = decode_parts(np.stack([s[10:250], s[260:500]]), device)
    return _page_fields(even, odd)


def decode_stream(soft_syms: np.ndarray, device=None) -> list[dict]:
    """Find the part grid in a soft ±1 stream and decode every
    complete nominal page (even part followed by odd part). Each page
    dict carries `sym_index` — the stream index of the page's FIRST
    symbol (its even part's first sync symbol), the anchor the word-5
    GST TOW refers to (tools/galileo_pvt.py transmit times).

    Every complete part on the grid is decoded in one batched call on
    `device` (default: the CUDA card); the reference's walk over the
    grid then reads the decoded parts, so the pages are the ones that
    decoding each page in turn gives."""
    s = np.asarray(soft_syms, np.float64)
    off, pol = sync_search(s)
    s = pol * s
    n_parts = max(0, (len(s) - off) // PAGE_SYMS)
    if n_parts < 2:
        return []
    grid = s[off:off + n_parts * PAGE_SYMS].reshape(n_parts, PAGE_SYMS)
    parts = decode_parts(grid[:, len(SYNC):], device)
    pages = []
    j = 0
    while j + 2 <= n_parts:
        page = _page_fields(parts[j], parts[j + 1])
        if page["even_odd"] != (0, 1):
            j += 1  # grid hit an odd part first: slip one part
            continue
        page["sym_index"] = off + j * PAGE_SYMS
        pages.append(page)
        j += 2
    return pages


def transmit_time_at_block(m_star: int, page_sym_index: int,
                           tow_page: float, code_phase_at,
                           code_length: float,
                           t_epoch_s: float = 4092 / 1.023e6) -> float:
    """Transmit time (GST seconds-of-week) of the signal at the START
    of tracked block m_star, from a decoded word-5 TOW — the full
    pseudorange observable with no supplied integer milliseconds
    (the Galileo analogue of nav_message.transmit_time_at_block;
    E1B is simpler: one symbol per 4 ms code epoch, so block index IS
    symbol index and there is no bit-edge search).

    page_sym_index: block index of the first symbol of the page whose
    word 5 carried tow_page (decode_stream's `sym_index`).
    code_phase_at(m): tracked replica code phase (code_length units)
    at the start of block m."""
    frac0 = float(code_phase_at(page_sym_index)) / code_length
    delta = frac0 if frac0 <= 0.5 else frac0 - 1.0
    t_est = tow_page + (delta + (m_star - page_sym_index)) * t_epoch_s
    frac_star = float(code_phase_at(m_star)) / code_length
    n_ep = round(t_est / t_epoch_s - frac_star)
    return (n_ep + frac_star) * t_epoch_s
