"""Scramblers, whiteners and the generic FEC table.

PyTorch counterpart of ``r4w_tpu.ops.scramblers`` (scrambler.rs,
additive_scrambler.rs, pn_scrambler.rs, linear_congruential_whitener.rs,
glfsr_source.rs, gold_code_generator.rs,
cyclic_redundancy_check_parallel.rs, fec_generic_api.rs,
aes_stream_cipher.rs, covert_timing_encoder.rs).

Keystreams that do not depend on the data (the additive scrambler's LFSR,
the LCG whitener, the Galois LFSR) are numpy copies of the reference's
host loops, bit for bit, applied on the device with one XOR. The
multiplicative descrambler takes its register from the received bits, so
it is feed-forward: its feedback is the XOR of the received stream
shifted by each tap. The multiplicative scrambler feeds its output back;
it stays a step loop over the bits, as the reference's ``lax.scan`` is,
with the register an int64 tensor and the parity an XOR fold (torch has no
population count). Registers of 32 bits or more take the reference's
arbitrary-width host loop (`_pn_host`). The FEC table runs on the port's
``fec.block`` and ``fec.convolutional``; the convolutional codec decodes on
both Viterbi kernels on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from r4w_tpu_torch.core.types import resolve_device, to_tensor
from r4w_tpu_torch.ops import spreading as _spreading

# ------------------------------------------------------- scramblers


def _bits(bits) -> torch.Tensor:
    return to_tensor(bits, torch.int32)


def additive_scramble(bits, taps: int, seed: int, nbits: int) -> torch.Tensor:
    """Additive (synchronous) scrambler (additive_scrambler.rs):
    XOR with a free-running LFSR keystream. Self-inverse."""
    b = _bits(bits)
    ks = _spreading.lfsr_bits(nbits, taps, seed, int(b.shape[0]))
    return b ^ torch.from_numpy(ks.astype(np.int32)).to(b.device)


def _pn_host(bits, taps: int, seed: int, nbits: int, feed_output: bool) -> torch.Tensor:
    """Bit-serial loop for registers wider than a 32-bit word, with an
    arbitrary-width Python-int state (host-side, 1-D)."""
    device = bits.device if isinstance(bits, torch.Tensor) else resolve_device()
    if isinstance(bits, torch.Tensor):
        bits = bits.cpu().numpy()
    b = np.asarray(bits).astype(np.int64).reshape(-1)
    mask = (1 << nbits) - 1
    state = seed & mask
    out = np.zeros_like(b)
    for i in range(b.shape[0]):
        fb = bin(state & taps).count("1") & 1
        out[i] = b[i] ^ fb
        state = ((state << 1) | int(out[i] if feed_output else b[i])) & mask
    return torch.from_numpy(out.astype(np.int32)).to(device)


def _parity(x: torch.Tensor) -> torch.Tensor:
    """Parity of the low 32 bits of each int64 element, by XOR folds."""
    for shift in (16, 8, 4, 2, 1):
        x = x ^ (x >> shift)
    return x & 1


def _pn_scan(bits, taps: int, seed: int, nbits: int, feed_output: bool) -> torch.Tensor:
    """The multiplicative (de)scrambler along the last axis, leading axes a
    batch. Register bit j (LSB first) holds the bit that entered j + 1
    steps ago, the seed's bits before the first."""
    if nbits <= 0:
        raise ValueError(f"nbits must be positive, got {nbits}")
    if nbits >= 32:
        return _pn_host(bits, taps, seed, nbits, feed_output)
    b = _bits(bits)
    mask, seed = (1 << nbits) - 1, seed & ((1 << nbits) - 1)
    n = b.shape[-1]
    if not feed_output:
        # the register's bits are the received stream's: e[k] = b[k], and
        # e[-1-q] = seed bit q before it
        seed_bits = torch.tensor([(seed >> q) & 1 for q in range(nbits - 1, -1, -1)],
                                 dtype=torch.int32, device=b.device)
        e = torch.cat([seed_bits.expand(b.shape[:-1] + (nbits,)), b], dim=-1)
        fb = torch.zeros_like(b)
        for j in range(nbits):
            if (taps >> j) & 1:  # register bit j at step i is e[i - 1 - j]
                fb = fb ^ e[..., nbits - 1 - j: nbits - 1 - j + n]
        return b ^ fb
    state = torch.full(b.shape[:-1], seed, dtype=torch.int64, device=b.device)
    b64 = b.to(torch.int64)
    outs = []
    for i in range(n):
        out = b64[..., i] ^ _parity(state & taps)
        state = ((state << 1) | out) & mask
        outs.append(out)
    if not outs:
        return b.clone()
    return torch.stack(outs, dim=-1).to(torch.int32)


def pn_scramble(bits, taps: int, seed: int, nbits: int) -> torch.Tensor:
    """Multiplicative (self-synchronizing) scrambler (pn_scrambler.rs):
    out = in XOR parity(state&taps); the OUTPUT bit is shifted into the
    state, so the descrambler resynchronizes from the line stream."""
    return _pn_scan(bits, taps, seed, nbits, feed_output=True)


def pn_descramble(bits, taps: int, seed: int, nbits: int) -> torch.Tensor:
    """Inverse of pn_scramble — state is fed from the RECEIVED bits."""
    return _pn_scan(bits, taps, seed, nbits, feed_output=False)


@functools.lru_cache(maxsize=None)
def _lcg_keystream(n: int, seed: int) -> np.ndarray:
    state = int(seed)
    a, c, mask = 1664525, 1013904223, (1 << 64) - 1
    ks = np.zeros(n, np.int32)
    for i in range(n):
        state = (a * state + c) & mask
        ks[i] = (state >> 24) & 0xFF
    return ks


def lcg_whiten(data_bytes, seed: int = 0x12345678) -> torch.Tensor:
    """XOR bytes with a linear-congruential keystream
    (linear_congruential_whitener.rs). Self-inverse. LCG: Numerical
    Recipes constants, top byte used; the keystream is built on the host
    once per length and seed."""
    d = to_tensor(data_bytes, torch.int32)
    return d ^ torch.from_numpy(_lcg_keystream(int(d.shape[-1]), int(seed))).to(d.device)


@functools.lru_cache(maxsize=None)
def _glfsr_bits(taps: int, seed: int, nbits: int, n: int) -> np.ndarray:
    mask = (1 << nbits) - 1
    state = seed & mask
    out = np.zeros(n, np.int64)
    for i in range(n):
        out[i] = state & 1
        state >>= 1
        if out[i]:
            state ^= taps
        state &= mask
    return out.astype(np.int32)


def glfsr_source(taps: int, seed: int, nbits: int, n: int, device=None) -> torch.Tensor:
    """Galois-configuration LFSR bit source (glfsr_source.rs), built on the
    host, on `device` (default the card)."""
    return torch.from_numpy(_glfsr_bits(int(taps), int(seed), int(nbits), int(n))).to(
        resolve_device(device))


def gold_code_generator(degree: int, index: int, n: int | None = None,
                        device=None) -> torch.Tensor:
    """Named alias of the Gold-code family generator
    (gold_code_generator.rs → spreading.gold_code), tiled to `n` chips."""
    code = torch.from_numpy(_spreading.gold_code(degree, index)).to(resolve_device(device))
    if n is not None:
        code = code.repeat(-(-n // code.shape[0]))[:n]
    return code


# ---------------------------------------------------------- CRC batch


@functools.lru_cache(maxsize=None)
def _x25_table() -> np.ndarray:
    table = np.zeros(256, np.int64)
    for byte in range(256):
        crc = byte
        for _ in range(8):
            crc = (crc >> 1) ^ 0x8408 if crc & 1 else crc >> 1
        table[byte] = crc
    return table.astype(np.int32)


def crc16_parallel(frames) -> torch.Tensor:
    """CRC-16/X.25 over a BATCH of equal-length byte frames in one
    vectorized table walk (cyclic_redundancy_check_parallel.rs): the byte
    loop is over frame LENGTH, every frame advances in lockstep."""
    f = to_tensor(frames, torch.int32)  # (B, L)
    tab = torch.from_numpy(_x25_table()).to(f.device)
    crc = torch.full((f.shape[0],), 0xFFFF, dtype=torch.int32, device=f.device)
    for i in range(f.shape[1]):
        crc = (crc >> 8) ^ tab[((crc ^ f[:, i]) & 0xFF).long()]
    return crc ^ 0xFFFF


# ------------------------------------------------------ generic FEC API


_FEC_CODECS = {}


def _lazy_codecs():
    if _FEC_CODECS:
        return _FEC_CODECS
    from r4w_tpu_torch.fec import block, convolutional

    def conv_enc(bits, **kw):
        return convolutional.conv_encode(bits)

    def conv_dec(bits, **kw):
        return convolutional.viterbi_decode(bits)

    _FEC_CODECS.update({
        "repetition": (lambda b, r=3, **kw: block.repetition_encode(b, r),
                       lambda b, r=3, **kw: block.repetition_decode(b, r)),
        "golay": (lambda b, **kw: block.golay_encode(b),
                  lambda b, **kw: block.golay_decode(b)[0]),
        "convolutional": (conv_enc, conv_dec),
    })
    return _FEC_CODECS


def fec_encode(name: str, bits, **kw) -> torch.Tensor:
    """Unified encoder dispatch (fec_generic_api.rs)."""
    try:
        enc, _ = _lazy_codecs()[name]
    except KeyError:
        raise ValueError(f"unknown FEC '{name}'") from None
    return enc(_bits(bits), **kw)


def fec_decode(name: str, bits, **kw) -> torch.Tensor:
    try:
        _, dec = _lazy_codecs()[name]
    except KeyError:
        raise ValueError(f"unknown FEC '{name}'") from None
    return dec(_bits(bits), **kw)


def fec_list() -> list[str]:
    return sorted(_lazy_codecs())


# ------------------------------------------------------- stream cipher


def aes_ctr_keystream_xor(data: bytes, key: bytes, nonce: bytes) -> bytes:
    """AES-256-CTR stream cipher (aes_stream_cipher.rs). Encrypt ==
    decrypt. Needs the ``cryptography`` package, imported on call."""
    from cryptography.hazmat.primitives.ciphers import (
        Cipher, algorithms, modes)
    if len(nonce) != 16:
        nonce = bytes(nonce) + b"\x00" * (16 - len(nonce))
    enc = Cipher(algorithms.AES(bytes(key)), modes.CTR(nonce)).encryptor()
    return enc.update(bytes(data)) + enc.finalize()


# --------------------------------------------------- covert timing code


def covert_timing_encode(bits, base_interval: int, delta: int) -> torch.Tensor:
    """Encode bits into inter-event timing (covert_timing_encoder.rs):
    bit 0 → gap of base_interval, bit 1 → base_interval + delta.
    Returns event indices."""
    gaps = base_interval + delta * _bits(bits)
    return torch.cumsum(gaps, dim=-1, dtype=torch.int32)


def covert_timing_decode(events, base_interval: int, delta: int) -> torch.Tensor:
    ev = to_tensor(events, torch.int32)
    gaps = torch.cat([ev[..., :1], torch.diff(ev, dim=-1)], dim=-1)
    return (gaps > base_interval + delta // 2).to(torch.int32)


BLOCKS = {
    "additive_scrambler": ("additive_scramble", "fec",
                           "synchronous LFSR scrambler "
                           "(additive_scrambler.rs)",
                           ("taps", "seed", "nbits")),
    "pn_scrambler": ("pn_scramble", "fec",
                     "self-synchronizing scrambler (pn_scrambler.rs)",
                     ("taps", "seed", "nbits")),
    "pn_descrambler": ("pn_descramble", "fec",
                       "self-synchronizing descrambler "
                       "(pn_scrambler.rs)", ("taps", "seed", "nbits")),
    "lcg_whitener": ("lcg_whiten", "fec",
                     "LCG byte whitener "
                     "(linear_congruential_whitener.rs)", ("seed",)),
    "glfsr_source": ("glfsr_source", "source",
                     "Galois LFSR source (glfsr_source.rs)",
                     ("taps", "seed", "nbits")),
    "gold_code_generator": ("gold_code_generator", "source",
                            "Gold family (gold_code_generator.rs)",
                            ("degree", "index")),
    "crc_parallel": ("crc16_parallel", "fec",
                     "batched CRC-16/X.25 "
                     "(cyclic_redundancy_check_parallel.rs)"),
    "fec_generic_api": ("fec_encode", "fec",
                        "unified FEC dispatch (fec_generic_api.rs)",
                        ("name",)),
    "aes_stream_cipher": ("aes_ctr_keystream_xor", "fec",
                          "AES-256-CTR stream cipher "
                          "(aes_stream_cipher.rs)", ("key", "nonce")),
    "covert_timing_encoder": ("covert_timing_encode", "modulator",
                              "bits -> event timing "
                              "(covert_timing_encoder.rs)",
                              ("base_interval", "delta")),
}
