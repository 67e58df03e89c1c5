"""Where the device time goes, per cell of the port's paths, on one CUDA card.

``python -m r4w_tpu_torch.profiling`` runs one warm call of each cell under
``torch.profiler`` with CPU and CUDA activity and prints one JSON line per
cell: the card's name and power limit, the device busy time (the union of
the device events' intervals), the span from the first device event's
start to the last one's end, the idle share of that span, the number of
device events, and device milliseconds per event name (cut to its first
96 characters), largest first.

Cells: the LoRa Monte-Carlo sweep at SF7 and at SF12 (one ``ber_sweep``
call at ``entry.lora_sweep``'s shape), the decode bench (one
``viterbi_decode_mxu`` at ``entry.viterbi_bench``'s 4096 × 2048 shape),
the DDC bench (one ``digital_down_convert`` at ``entry.ddc_bench``'s
64 × 2^20 shape), the GPS tracking cell (``gnss.gps_pvt_fix.l1ca_receiver``
on 1.001 s of the decoded gate's six-satellite capture at 4.092 MS/s: one
acquisition over 12 ms, then six channels × 1000 one-ms blocks; the
capture is made on the card before the cell and is not in its time) and
the E1B tracking cell (``gnss.galileo_pvt.closed_pass``, the Galileo
gate's closed Costas pass over the first 1.008 s of its six-satellite
capture at 5.115 MS/s: six channels × about 250 four-ms blocks of 20,460
samples, seeded by one run of ``e1b_receiver`` on the same capture before
the cell) and the composed receiver gate (`entry.composed_receiver_gate`
at the reference's 1,024 bits: the step loops of PFB timing recovery,
MLSE and the DFE). It needs a CUDA card; it has no CPU path.
"""

from __future__ import annotations

import functools
import json
import subprocess
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from r4w_tpu_torch.entry import (DDC_CENTER_HZ, DDC_DECIMATION, DDC_RATE_HZ, SWEEP_PAYLOAD_BYTES,
                                 SWEEP_SNRS_DB, VITERBI_INFO_BITS, VITERBI_LANES,
                                 composed_receiver_gate, ddc_signal, sweep_lanes)
from r4w_tpu_torch.fec.convolutional import conv_encode, viterbi_decode_mxu
from r4w_tpu_torch.gnss import galileo_pvt as gal
from r4w_tpu_torch.gnss import gps_pvt_fix as gps
from r4w_tpu_torch.gnss.scenario import GnssScenario
from r4w_tpu_torch.ops.stream_math import digital_down_convert
from r4w_tpu_torch.parallel import ber_sweep
from r4w_tpu_torch.waveforms import lora

TOP_EVENTS = 8
NAME_CHARS = 96  # device event names are cut to this length
MEMORY_EVENTS = ("[memory]", "[OutOfMemory]")  # allocator records, not device work
GPS_CELL_SECONDS = 1.001  # 1000 tracking blocks after the latest channel's window start
GAL_CELL_SECONDS = 1.008  # 250 E1B blocks after the latest channel's code epoch


def breakdown(fn, warm: bool = True) -> dict:
    """Device time of one call of `fn`, after one warm-up call unless the
    caller has just made one (`warm=False`)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the raw device events, not prof.events(): building those event trees
    # takes minutes at a step loop's hundreds of thousands of launches
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA and not e.is_hidden_event()
              and e.name() not in MEMORY_EVENTS]
    if not events:
        raise RuntimeError("the profiler recorded no device events")
    spans = sorted((e.start_ns() / 1e3, e.end_ns() / 1e3) for e in events)
    busy_us, end_us = 0.0, spans[0][0]
    for start, stop in spans:
        busy_us += max(0.0, stop - max(start, end_us))
        end_us = max(end_us, stop)
    span_us = end_us - spans[0][0]
    by_name = defaultdict(float)
    for e in events:
        by_name[e.name()[:NAME_CHARS]] += e.duration_ns() / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP_EVENTS]
    return {"busy_ms": busy_us / 1e3, "span_ms": span_us / 1e3,
            "idle_share": 1.0 - busy_us / span_us if span_us else 0.0,
            "device_events": len(events), "top_ms": dict(top)}


def cells(device: torch.device) -> dict:
    """The cells, each a no-argument call on `device`."""
    runs = {}
    for sf in (7, 12):
        params = lora.LoRaParams(sf=sf)
        payload = (torch.arange(SWEEP_PAYLOAD_BYTES, dtype=torch.int32, device=device)
                   % params.chips_per_symbol)
        runs[f"lora_sweep_sf{sf}"] = functools.partial(
            ber_sweep, functools.partial(lora.loopback_ber, params), payload, SWEEP_SNRS_DB,
            n_lanes=sweep_lanes(sf), seed=sf)
    bits = np.random.default_rng(6).integers(0, 2, (VITERBI_LANES, VITERBI_INFO_BITS))
    soft = 1.0 - 2.0 * conv_encode(torch.from_numpy(bits.astype(np.int32)).to(device)).float()
    runs["viterbi_bench"] = functools.partial(viterbi_decode_mxu, soft, soft=True)
    runs["ddc_bench"] = functools.partial(digital_down_convert, ddc_signal(device), DDC_CENTER_HZ,
                                          DDC_RATE_HZ, DDC_DECIMATION)
    cfg, _, _ = gps.decoded_scenario(GPS_CELL_SECONDS)
    rx = GnssScenario(cfg, device=device).generate_device()
    runs["gps_tracking"] = functools.partial(gps.l1ca_receiver, rx,
                                             [s.prn for s in cfg.satellites])
    runs["e1b_tracking"] = e1b_tracking_cell(device)
    runs["receiver_gate"] = functools.partial(composed_receiver_gate, device)
    return runs


def e1b_tracking_cell(device: torch.device):
    """The Galileo gate's closed pass over its first GAL_CELL_SECONDS, as a
    no-argument call; the capture and the seeds (acquisition, Doppler
    refine and code sweep of `e1b_receiver`) are made before it."""
    cfg, _ = gal.galileo_scenario(GAL_CELL_SECONDS)
    prns = [s.prn for s in cfg.satellites]
    rx = GnssScenario(cfg, device=device).generate_device()
    seeds = gal.e1b_receiver(rx, prns)
    code_t = torch.from_numpy(np.stack(gal.e1b_codes(prns)).astype(np.float32)).to(device)
    return functools.partial(gal.closed_pass, rx, code_t, seeds["istart"], seeds["phase_ref"],
                             seeds["dop_ref"])


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    for name, fn in cells(torch.device("cuda")).items():
        print(json.dumps({"cell": name, "card": card, **breakdown(fn)}), flush=True)


if __name__ == "__main__":
    main()
