"""Entry points of the port's main path: the LoRa loopback.

`entry(device)` is the counterpart of ``__graft_entry__.entry``: one LoRa
SF7 forward step, modulate → AWGN → dechirp-DFT-argmax demodulate → BER.
`lora_sweep(device, seed)` is the counterpart of ``bench.py``'s
``bench_lora_sweep``: the SF7-SF12 Monte-Carlo BER grid at its full size,
timed on the card with CUDA events.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from r4w_tpu_torch.core.types import REAL_DTYPE, SYMBOL_DTYPE
from r4w_tpu_torch.parallel import ber_sweep
from r4w_tpu_torch.waveforms import lora

SWEEP_SNRS_DB = tuple(float(s) for s in np.arange(-26.0, -2.0, 2.0))  # 12 points
SWEEP_SFS = tuple(range(7, 13))
SWEEP_PAYLOAD_BYTES = 16
BER_TARGET = 0.01


def entry(device):
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


def lora_sweep(device, seed: int = 0) -> dict:
    """SF7-SF12 Monte-Carlo BER sweep on a CUDA device.

    For each SF: `sweep_lanes(sf)` lanes × 12 SNRs of a 16-byte payload,
    one warm-up run, then one run timed with CUDA events. Returns
    ``compute_s`` (seconds of the timed run), ``ber`` (mean BER per SNR)
    and ``waterfall_snr_db`` (first SNR with BER < 1%), each keyed "sf<n>".
    """
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"lora_sweep times with CUDA events and needs a CUDA device, "
                         f"got {device}")
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
