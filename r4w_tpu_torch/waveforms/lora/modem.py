"""LoRa modulator/demodulator as batch functions on tensors.

PyTorch counterpart of ``r4w_tpu.waveforms.lora.modem``. TX is whitening →
Hamming → diagonal interleave → Gray → chirp-bank gather; RX is dechirp →
DFT power → argmax → Gray⁻¹ → deinterleave → Hamming⁻¹ → dewhiten. Every
function takes leading batch dimensions where the JAX package used
``vmap``. On a CUDA tensor the dechirp and DFT power always run in the
Hopper kernel (`kernels.dechirp`), for every SF and oversample. The
chain's layer boundaries are spans (`observe.spans`): `loopback_ber`,
`modulate`, `demodulate` and its two steps, and `channel.awgn`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from r4w_tpu_torch.channel import awgn
from r4w_tpu_torch.core.types import (DEFAULT_DEVICE, IQ_DTYPE, REAL_DTYPE, SYMBOL_DTYPE,
                                      resolve_device, to_tensor)
from r4w_tpu_torch.kernels.dechirp import dechirp_power_dispatch
from r4w_tpu_torch.observe.spans import traced
from r4w_tpu_torch.ops import coding
from r4w_tpu_torch.waveforms.lora import chirp as chirp_mod
from r4w_tpu_torch.waveforms.lora.params import LoRaParams


class LoRaDemodResult(NamedTuple):
    payload: torch.Tensor  # (..., n_bytes) int32 recovered bytes (incl. block pad)
    symbols: torch.Tensor  # (..., S) int32 raw DFT-peak symbols
    snr_db: torch.Tensor  # (..., S) f32 per-symbol peak/avg SNR estimate
    magnitude: torch.Tensor  # (..., S) f32 peak magnitudes


# --------------------------------------------------------------------------
# Encode path
# --------------------------------------------------------------------------


def encode_symbols(params: LoRaParams, payload) -> torch.Tensor:
    """bytes -> LoRa symbols.

    payload: (..., n_bytes) int32. Returns (..., S) int32 symbols where
    S = ceil(2*n_bytes / sf) * (4+cr).
    """
    sf, cr = params.sf, params.cr
    whitened = coding.whiten(payload)
    nibbles = coding.bytes_to_nibbles(whitened)
    codewords = coding.hamming_encode(nibbles, cr)
    # pad to whole interleaver blocks of sf codewords
    n_cw = codewords.shape[-1]
    n_blocks = -(-n_cw // sf)
    pad = n_blocks * sf - n_cw
    if pad:
        codewords = F.pad(codewords, (0, pad))
    blocks = codewords.reshape(*codewords.shape[:-1], n_blocks, sf)
    interleaved = coding.interleave(blocks, sf, cr)  # (..., n_blocks, 4+cr)
    symbols = coding.gray_encode(interleaved)
    return symbols.reshape(*symbols.shape[:-2], -1)


@traced("lora.modulate",
        lambda iq, params, *_, **__: {"symbols": iq.numel() // params.samples_per_symbol})
def modulate(params: LoRaParams, payload, include_preamble: bool = True,
             device=DEFAULT_DEVICE) -> torch.Tensor:
    """Full LoRa TX chain: payload bytes -> IQ.

    payload: (..., n_bytes) int32, moved to `device`. Returns
    (..., n_samples) complex64 on `device`.
    """
    payload = torch.as_tensor(payload, device=resolve_device(device)).to(SYMBOL_DTYPE)
    chirps = chirp_mod.symbol_chirps(params, encode_symbols(params, payload))
    body = chirps.reshape(*chirps.shape[:-2], -1)
    if not include_preamble:
        return body
    pre = chirp_mod.preamble(params, body.device)
    return torch.cat([pre.expand(*body.shape[:-1], -1), body], dim=-1)


# --------------------------------------------------------------------------
# Decode path
# --------------------------------------------------------------------------


@traced("lora.demodulate_symbols",
        lambda out, params, *_: {"rows": out[0].numel(), "k": params.chips_per_symbol})
def demodulate_symbols(params: LoRaParams, samples):
    """Batched dechirp-DFT-argmax.

    samples: (..., S*N) or (..., S, N) complex64 payload-aligned IQ.
    Returns (symbols (..., S) int32, snr_db f32, magnitude f32).
    Every leading dimension is flattened into rows of K chips. At
    oversample > 1 the samples and the downchirp are decimated before the
    product, which equals the JAX package's (x·d)[::osf] element for element.
    """
    n = params.samples_per_symbol
    k = params.chips_per_symbol
    samples = to_tensor(samples, IQ_DTYPE)
    if samples.shape[-1] != n:
        s = samples.shape[-1] // n
        samples = samples[..., : s * n].reshape(*samples.shape[:-1], s, n)
    down = chirp_mod.base_downchirp(params, samples.device)
    if params.oversample > 1:
        samples = samples[..., :: params.oversample]
        down = down[:: params.oversample]
    lead = samples.shape[:-1]
    power = dechirp_power_dispatch(samples.reshape(-1, k), down)  # (rows, K)
    symbols = torch.argmax(power, dim=-1).to(SYMBOL_DTYPE)
    peak_power = torch.amax(power, dim=-1)
    avg_power = torch.mean(power, dim=-1)
    snr_db = 10.0 * torch.log10(peak_power / torch.clamp_min(avg_power, 1e-30))
    return (symbols.reshape(lead), snr_db.to(REAL_DTYPE).reshape(lead),
            torch.sqrt(peak_power).to(REAL_DTYPE).reshape(lead))


@traced("lora.decode_symbols", lambda _, params, symbols: {"symbols": math.prod(symbols.shape)})
def decode_symbols(params: LoRaParams, symbols) -> torch.Tensor:
    """symbols -> payload bytes.

    symbols: (..., S) int32 with S a multiple of (4+cr).
    Returns (..., n_bytes) int32 including interleaver-block padding bytes.
    """
    sf, cr = params.sf, params.cr
    n_bits = 4 + cr
    gray_decoded = coding.gray_decode(symbols)
    n_blocks = gray_decoded.shape[-1] // n_bits
    blocks = gray_decoded[..., : n_blocks * n_bits].reshape(
        *gray_decoded.shape[:-1], n_blocks, n_bits)
    codewords = coding.deinterleave(blocks, sf, cr)  # (..., n_blocks, sf)
    nibbles = coding.hamming_decode(codewords, cr).reshape(*codewords.shape[:-2], -1)
    # drop odd trailing nibble (bytes need pairs)
    n_nib = nibbles.shape[-1] - (nibbles.shape[-1] % 2)
    payload = coding.nibbles_to_bytes(nibbles[..., :n_nib])
    return coding.dewhiten(payload)


@traced("lora.demodulate", lambda res, *_: {"frames": math.prod(res.symbols.shape[:-1])})
def demodulate(params: LoRaParams, samples) -> LoRaDemodResult:
    """Full RX chain on payload-aligned samples."""
    symbols, snr_db, mag = demodulate_symbols(params, samples)
    payload = decode_symbols(params, symbols)
    return LoRaDemodResult(payload=payload, symbols=symbols, snr_db=snr_db,
                           magnitude=mag)


def _loopback_counts(ber, params, payload, *_, **__) -> dict:
    """A sweep call's packets (BERs) and the samples they were sent in."""
    n_bytes = np.shape(payload)[-1]
    return {"packets": ber.numel(), "samples": ber.numel() * params.samples_per_symbol
            * params.n_payload_symbols(n_bytes)}


@traced("lora.loopback_ber", _loopback_counts)
def loopback_ber(params: LoRaParams, payload, snr_db, *,
                 generator: torch.Generator | None = None,
                 noise: torch.Tensor | None = None) -> torch.Tensor:
    """modulate → AWGN → demodulate → bit error rate.

    The payload's leading dimensions and `snr_db`'s shape broadcast into
    one batch, run as one call: a (lanes, SNRs) grid of SNRs with one
    payload is a Monte-Carlo sweep. Returns the BER per batch element.
    Pass exactly one of `generator` and `noise` (see `channel.awgn`).
    """
    payload = to_tensor(payload, SYMBOL_DTYPE)
    tx = modulate(params, payload, include_preamble=False, device=payload.device)
    snr = torch.as_tensor(snr_db, dtype=REAL_DTYPE, device=tx.device)
    batch = torch.broadcast_shapes(tx.shape[:-1], snr.shape)
    rx = awgn(tx.expand(*batch, tx.shape[-1]), snr[..., None], generator=generator,
              noise=noise)
    result = demodulate(params, rx)
    n = payload.shape[-1]
    tx_bits = coding.bytes_to_bits(payload)
    rx_bits = coding.bytes_to_bits(result.payload[..., :n])
    return torch.mean((tx_bits != rx_bits).to(REAL_DTYPE), dim=-1)
