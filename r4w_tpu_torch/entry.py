"""Entry points of the port's paths: the LoRa loopback and the Viterbi decode.

`entry(device)` is the counterpart of ``__graft_entry__.entry``: one LoRa
SF7 forward step, modulate → AWGN → dechirp-DFT-argmax demodulate → BER.
`lora_sweep(device, seed)` is the counterpart of ``bench.py``'s
``bench_lora_sweep``: the SF7-SF12 Monte-Carlo BER grid at its full size,
timed on the card with CUDA events. `viterbi_bench(device, seed)` is the
counterpart of ``bench.py``'s ``bench_viterbi``: a K=7 rate-1/2 soft
decode of 4096 frames of 2048 bits, timed the same way. Every entry point
runs on the CUDA card unless the caller names another device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from r4w_tpu_torch.core.types import DEFAULT_DEVICE, REAL_DTYPE, SYMBOL_DTYPE
from r4w_tpu_torch.fec.convolutional import conv_encode, viterbi_decode_mxu
from r4w_tpu_torch.parallel import ber_sweep
from r4w_tpu_torch.waveforms import lora

SWEEP_SNRS_DB = tuple(float(s) for s in np.arange(-26.0, -2.0, 2.0))  # 12 points
SWEEP_SFS = tuple(range(7, 13))
SWEEP_PAYLOAD_BYTES = 16
BER_TARGET = 0.01
VITERBI_LANES, VITERBI_INFO_BITS = 4096, 2048  # frames × info bits per frame


def entry(device=DEFAULT_DEVICE):
    """(forward, example_args) for one LoRa SF7 loopback step on `device`."""
    device = torch.device(device)
    params = lora.LoRaParams(sf=7)

    def forward(payload, snr_db, generator):
        return lora.loopback_ber(params, payload, snr_db, generator=generator)

    payload = torch.arange(16, dtype=SYMBOL_DTYPE, device=device) % 256
    snr_db = torch.tensor(0.0, dtype=REAL_DTYPE, device=device)
    generator = torch.Generator(device=device).manual_seed(0)
    return forward, (payload, snr_db, generator)


def sweep_lanes(sf: int) -> int:
    """Monte-Carlo lanes per SNR point: 512 at SF7, halving per SF, at least 4."""
    return max(4, 512 >> (sf - 7))


def waterfall_snr_db(snrs_db, ber) -> float | None:
    """First SNR whose BER is below `BER_TARGET`, or None."""
    below = np.asarray(ber) < BER_TARGET
    return float(np.asarray(snrs_db)[int(np.argmax(below))]) if below.any() else None


def lora_sweep(device=DEFAULT_DEVICE, seed: int = 0) -> dict:
    """SF7-SF12 Monte-Carlo BER sweep on a CUDA device.

    For each SF: `sweep_lanes(sf)` lanes × 12 SNRs of a 16-byte payload,
    one warm-up run, then one run timed with CUDA events. Returns
    ``compute_s`` (seconds of the timed run), ``ber`` (mean BER per SNR)
    and ``waterfall_snr_db`` (first SNR with BER < 1%), each keyed "sf<n>".
    """
    device = torch.device(device)
    _require_cuda("lora_sweep", device)
    result = {"compute_s": {}, "ber": {}, "waterfall_snr_db": {}}
    for sf in SWEEP_SFS:
        params = lora.LoRaParams(sf=sf)
        payload = (torch.arange(SWEEP_PAYLOAD_BYTES, dtype=SYMBOL_DTYPE, device=device)
                   % params.chips_per_symbol)
        run = functools.partial(ber_sweep, functools.partial(lora.loopback_ber, params),
                                payload, SWEEP_SNRS_DB, n_lanes=sweep_lanes(sf),
                                seed=seed + sf)
        run()  # warm-up: builds the kernel and the cached tables
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ber = run()
        end.record()
        end.synchronize()
        ber = ber.cpu().numpy()
        key = f"sf{sf}"
        result["compute_s"][key] = start.elapsed_time(end) / 1e3
        result["ber"][key] = ber.tolist()
        result["waterfall_snr_db"][key] = waterfall_snr_db(SWEEP_SNRS_DB, ber)
    return result


def _require_cuda(name: str, device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"{name} times with CUDA events and needs a CUDA device, got {device}")


def viterbi_bench(device=DEFAULT_DEVICE, seed: int = 6) -> dict:
    """K=7 rate-1/2 soft Viterbi decode of 4096 frames × 2048 info bits.

    Random bits from `np.random.default_rng(seed)`, encoded with flush bits
    on the card, soft values 1 - 2·coded; one warm-up decode, then one
    decode timed with CUDA events. Raises unless the decoded bits equal
    the input bits. Returns ``info_mbps`` (decoded information Mbit/s),
    ``compute_s`` (seconds of the timed decode) and the shapes.
    """
    device = torch.device(device)
    _require_cuda("viterbi_bench", device)
    rng = np.random.default_rng(seed)
    bits = torch.from_numpy(
        rng.integers(0, 2, (VITERBI_LANES, VITERBI_INFO_BITS)).astype(np.int32)).to(device)
    soft = (1.0 - 2.0 * conv_encode(bits)).to(REAL_DTYPE)
    viterbi_decode_mxu(soft, soft=True)  # warm-up: builds the kernels
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    decoded = viterbi_decode_mxu(soft, soft=True)
    end.record()
    end.synchronize()
    if not torch.equal(decoded, bits):
        errors = int((decoded != bits).sum())
        raise AssertionError(f"viterbi_bench decoded {errors} bits wrong on clean input")
    compute_s = start.elapsed_time(end) / 1e3
    return {"info_mbps": VITERBI_LANES * VITERBI_INFO_BITS / compute_s / 1e6,
            "compute_s": compute_s, "lanes": VITERBI_LANES, "info_bits": VITERBI_INFO_BITS,
            "steps": soft.shape[-1] // 2}
