#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's main path on one CUDA card.

Builds the Hopper kernel from this checkout, holds it against its plain
PyTorch version for SF5-SF12, then drives the LoRa loopback through the
port's public entry points: the quick start, ``entry()``'s forward step
and the full SF7-SF12 Monte-Carlo sweep, and shows that this path
launched the kernel. Each phase prints one line; a failed phase raises,
and the exit code is then non-zero. The second-to-last line is the
kernel table as JSON, the last line the device record.

Run from the repository root, with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card (Hopper, for sm_90a) and nvcc; it has no CPU path.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

from r4w_tpu_torch import create_waveform
from r4w_tpu_torch.channel import awgn
from r4w_tpu_torch.entry import (SWEEP_PAYLOAD_BYTES, SWEEP_SNRS_DB, entry, lora_sweep,
                                 sweep_lanes)
from r4w_tpu_torch.kernels import _build
from r4w_tpu_torch.kernels.dechirp import dechirp_power, dechirp_power_cuda
from r4w_tpu_torch.waveforms import lora
from r4w_tpu_torch.waveforms.lora import chirp

REL_TOL = 1e-4  # max|kernel - plain| / max(plain), the JAX package's own bar
WATERFALL_BARS_DB = {"sf7": -8.0, "sf8": -12.0, "sf9": -14.0, "sf10": -16.0,
                     "sf11": -20.0, "sf12": -22.0}
WATERFALL_SLACK_DB = 2.0  # one step of the sweep's SNR grid
TIMED_LAUNCHES = 10


def phase(name: str, message: str) -> None:
    print(f"[{name}] {message}", flush=True)


def cuda_ms(fn, iters: int = TIMED_LAUNCHES) -> float:
    """Mean device milliseconds of `fn` over `iters` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got, ref) -> tuple[float, float]:
    """(max|got - ref|, that over max(ref))."""
    abs_err = float(torch.max(torch.abs(got - ref)))
    return abs_err, abs_err / float(torch.max(ref))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    phase("1 device", f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
          f"card(s), torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. Build and load the kernel (set-up time).
    t0 = time.perf_counter()
    path, log = _build.ensure_built()
    _build.load_library()
    usage = [line.split(":", 1)[1].strip() for line in log.splitlines()
             if "Used" in line and "registers" in line]
    phase("2 build", f"{path.name} in {time.perf_counter() - t0:.2f} s; ptxas: "
          f"{'; '.join(usage) or 'already built'}")

    # 3. Kernel against the plain version: SF5-SF12, then the sweep's shapes.
    worst_rel = 0.0
    for sf in range(5, 13):
        params = lora.LoRaParams(sf=sf)
        k = params.chips_per_symbol
        down = chirp.base_downchirp(params, dev)
        gen = torch.Generator(device=dev).manual_seed(sf)
        noise = torch.complex(torch.randn(64, k, generator=gen, device=dev),
                              torch.randn(64, k, generator=gen, device=dev))
        syms = torch.randint(0, k, (64,), generator=gen, device=dev, dtype=torch.int32)
        clean = chirp.symbol_chirps(params, syms)
        for label, x in (("noise", noise), ("chirps", clean)):
            got, ref = dechirp_power_cuda(x, down), dechirp_power(x, down)
            torch.cuda.synchronize()
            _, rel = rel_err(got, ref)
            worst_rel = max(worst_rel, rel)
            if not rel < REL_TOL:
                raise AssertionError(f"SF{sf} {label}: max|Δ|/max(ref) {rel:.3g} >= {REL_TOL}")
        if not (torch.equal(got.argmax(-1).int(), syms)
                and torch.equal(ref.argmax(-1).int(), syms)):
            raise AssertionError(f"SF{sf}: argmax differs on clean chirps")
    phase("3 kernel", f"SF5-SF12 match the plain version: worst max|Δ|/max(ref) "
          f"{worst_rel:.3g} < {REL_TOL}, argmax identical on clean chirps")

    timings = {}
    for sf in (7, 12):
        params = lora.LoRaParams(sf=sf)
        k = params.chips_per_symbol
        rows = (sweep_lanes(sf) * len(SWEEP_SNRS_DB)
                * params.n_payload_symbols(SWEEP_PAYLOAD_BYTES))
        down = chirp.base_downchirp(params, dev)
        gen = torch.Generator(device=dev).manual_seed(100 + sf)
        x = torch.complex(torch.randn(rows, k, generator=gen, device=dev),
                          torch.randn(rows, k, generator=gen, device=dev))
        got, ref = dechirp_power_cuda(x, down), dechirp_power(x, down)
        abs_err, rel = rel_err(got, ref)
        if not rel < REL_TOL:
            raise AssertionError(f"SF{sf} sweep shape: max|Δ|/max(ref) {rel:.3g} >= {REL_TOL}")
        del got, ref
        # plain, kernel, kernel, plain: one card, one call, taken in turns
        plain = [cuda_ms(lambda: dechirp_power(x, down))]
        kern = [cuda_ms(lambda: dechirp_power_cuda(x, down)) for _ in range(2)]
        plain.append(cuda_ms(lambda: dechirp_power(x, down)))
        timings[sf] = {"rows": rows, "k": k, "abs_err": abs_err, "rel_err": rel,
                       "ms": sum(kern) / 2, "plain_ms": sum(plain) / 2}
        phase("3 timing", f"SF{sf} sweep shape ({rows}, {k}): kernel "
              f"{kern[0]:.4f}/{kern[1]:.4f} ms, plain cuFFT path {plain[0]:.4f}/"
              f"{plain[1]:.4f} ms per call (mean of {TIMED_LAUNCHES}); max|Δ| "
              f"{abs_err:.4g}, /max(ref) {rel:.3g}")
        del x

    # The main path starts here: only its launches count.
    dechirp_power.launches = 0

    # 4. Quick start on CUDA tensors, checked against the CPU's plain path.
    wf = create_waveform("LoRa-SF7", 125_000.0, device=dev)
    tx = wf.modulate(b"hello")
    rx = awgn(tx, -2.0, generator=torch.Generator(device=dev).manual_seed(0))
    res = wf.demodulate(rx)
    decoded = bytes(res.bits[:5].cpu().numpy().astype("uint8"))
    if not tx.is_cuda or decoded != b"hello":
        raise AssertionError(f"quick start decoded {decoded!r} on {tx.device}")
    cpu_res = create_waveform("LoRa-SF7", 125_000.0).demodulate(rx.cpu())
    if not torch.equal(res.symbols.cpu(), cpu_res.symbols):
        raise AssertionError("quick start: CUDA symbols differ from the CPU plain path")
    phase("4 quick start", f"decoded {decoded!r} at -2 dB on {tx.device}; "
          f"{res.symbols.numel()} symbols equal the CPU plain path; "
          f"SNR estimate {res.snr_estimate:.2f} dB")

    # 5. entry()'s forward step.
    forward, args = entry(dev)
    ber = forward(*args)
    if ber.shape != () or not ber.is_cuda or float(ber) != 0.0:
        raise AssertionError(f"entry forward: BER {ber} at 0 dB, expected 0.0")
    phase("5 entry", f"LoRa SF7 loopback at 0 dB on {ber.device}: BER {float(ber)}")

    # 6. The full SF7-SF12 Monte-Carlo sweep.
    sweep = lora_sweep(dev, seed=0)
    for key, bar in WATERFALL_BARS_DB.items():
        ber_curve = sweep["ber"][key]
        got = sweep["waterfall_snr_db"][key]
        if len(ber_curve) != len(SWEEP_SNRS_DB) or not all(0.0 <= b <= 1.0 for b in ber_curve):
            raise AssertionError(f"{key}: malformed BER curve {ber_curve}")
        if got is None or abs(got - bar) > WATERFALL_SLACK_DB:
            raise AssertionError(f"{key}: waterfall {got} dB, bar {bar} ± "
                                 f"{WATERFALL_SLACK_DB} dB; BER {ber_curve}")
    phase("6 sweep", "compute_s " + ", ".join(
        f"{key} {s:.6f}" for key, s in sweep["compute_s"].items())
        + f" (total {sum(sweep['compute_s'].values()):.6f}); waterfall dB "
        + json.dumps(sweep["waterfall_snr_db"]))

    # 7. The main path went through the kernel.
    launches = dechirp_power.launches
    if launches <= 0:
        raise AssertionError("the main path never launched the dechirp_power kernel")
    phase("7 launches", f"dechirp_power kernel launched {launches} times in phases 4-6")

    t7 = timings[7]
    print(json.dumps({"kernels": [{
        "name": "dechirp_power",
        "route": "cuda",
        "source": "r4w_tpu_torch/csrc/dechirp_power.cu",
        "replaces": "r4w_tpu/kernels/pallas_kernels.py:90",
        "launches": launches,
        "max_abs_err": t7["abs_err"],
        "ms": t7["ms"],
        "plain_ms": t7["plain_ms"],
        "shape": [t7["rows"], t7["k"]],
        "max_rel_err": max(t["rel_err"] for t in timings.values()),
        "ms_sf12": timings[12]["ms"],
        "plain_ms_sf12": timings[12]["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
