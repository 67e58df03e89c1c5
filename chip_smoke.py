#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's paths on one CUDA card.

Builds every Hopper kernel from this checkout (one nvcc per source, run in
parallel) and holds each against its plain PyTorch version. Then it drives
two paths through the port's public entry points and shows that each
launched its kernels: the LoRa loopback (the quick start, ``entry()``'s
forward step and the full SF7-SF12 Monte-Carlo sweep; dechirp-power
kernel) and the K=7 soft Viterbi decode (the full-size decode bench and
MIL-STD-188-110 round trips with autobaud; forward-ACS and traceback
kernels). Each phase prints one line; a failed phase raises, and the exit
code is then non-zero. The second-to-last line is the kernel table as
JSON, the last line the device record.

Run from the repository root, with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card (Hopper, for sm_90a) and nvcc; it has no CPU path.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import time

import torch

from r4w_tpu_torch import create_waveform
from r4w_tpu_torch.channel import awgn
from r4w_tpu_torch.entry import (SWEEP_PAYLOAD_BYTES, SWEEP_SNRS_DB, VITERBI_INFO_BITS,
                                 VITERBI_LANES, entry, lora_sweep, sweep_lanes, viterbi_bench)
from r4w_tpu_torch.fec import convolutional
from r4w_tpu_torch.kernels import _build, viterbi
from r4w_tpu_torch.kernels.dechirp import dechirp_power, dechirp_power_cuda
from r4w_tpu_torch.waveforms import lora
from r4w_tpu_torch.waveforms.lora import chirp

REL_TOL = 1e-4  # max|kernel - plain| / max(plain), the JAX package's own bar
WATERFALL_BARS_DB = {"sf7": -8.0, "sf8": -12.0, "sf9": -14.0, "sf10": -16.0,
                     "sf11": -20.0, "sf12": -22.0}
WATERFALL_SLACK_DB = 2.0  # one step of the sweep's SNR grid
TIMED_LAUNCHES = 10
PLAIN_VITERBI_CALLS = 1  # the plain forward is a 2054-step loop of small launches
# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, FP32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
VITERBI_CODES = {5: (0o23, 0o35), 7: (0o171, 0o133)}
MIL_DATA = bytes([0xA7, 0x1B, 0x3C, 0xD2, 0x55, 0x00, 0xFF, 0x42])  # tests/test_hf_modems.py:23
MIL_CASES = ((2400, 14.0), (1200, 8.0), (600, 5.0), (75, -4.0))  # rate bps, SNR dB


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


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least milliseconds the card could take, what bounds it): the larger of
    the bytes over the HBM rate and the operations over the FP32 peak."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def zero_launch_counts() -> None:
    dechirp_power.launches = 0
    viterbi.viterbi_forward.launches = 0
    viterbi.viterbi_traceback.launches = 0


def noisy_branch_metrics(lanes: int, steps: int, constraint: int, seed: int):
    """(steps, 4, lanes) branch metrics of 1 - 2·coded + 0.4·N(0, 1), made on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_info = steps - (constraint - 1)
    bits = torch.randint(0, 2, (lanes, n_info), generator=gen, device="cuda",
                         dtype=torch.int32)
    coded = convolutional.conv_encode(bits, constraint, VITERBI_CODES[constraint])
    soft = 1.0 - 2.0 * coded.float() + 0.4 * torch.randn(coded.shape, generator=gen,
                                                         device="cuda")
    return convolutional._branch_metrics(soft.reshape(lanes, steps, 2))


def check_viterbi(bm: torch.Tensor, constraint: int) -> dict:
    """Both kernels against their plain versions on `bm`, with torch.equal."""
    polys = VITERBI_CODES[constraint]
    dec, final = viterbi.viterbi_forward_cuda(bm, constraint, polys)
    want_dec, want_final = viterbi.viterbi_forward(bm, constraint, polys)
    start = torch.argmax(want_final, dim=0).to(torch.int32)
    bits = [viterbi.viterbi_traceback_cuda(want_dec, constraint, polys, s) for s in (None, start)]
    want_bits = [viterbi.viterbi_traceback(want_dec, constraint, polys, s) for s in (None, start)]
    torch.cuda.synchronize()
    label = f"K={constraint} (T, L)=({bm.shape[0]}, {bm.shape[2]})"
    if not (torch.equal(dec, want_dec) and torch.equal(final, want_final)):
        raise AssertionError(f"{label}: viterbi_forward kernel differs from the plain version")
    if not all(torch.equal(a, b) for a, b in zip(bits, want_bits)):
        raise AssertionError(f"{label}: viterbi_traceback kernel differs from the plain version")
    return {"forward_abs_err": float(torch.max(torch.abs(final - want_final))),
            "traceback_abs_err": max(float(torch.max(torch.abs(a - b)))
                                     for a, b in zip(bits, want_bits))}


def check_viterbi_kernels() -> dict:
    """Phase 8: both Viterbi kernels equal their plain versions bit for bit,
    for K = 5 and 7 at small shapes (one lane, as MIL-STD-188-110 decodes,
    a ragged block, several blocks) and at the decode bench's shape, where
    they are also timed beside the plain versions. Returns the kernel-table
    entries of both kernels (times, bounds and errors at the bench shape)."""
    cases = 0
    for constraint in VITERBI_CODES:
        for lanes in (1, 3, 130, 2100):
            for steps in (constraint + 1, 255, 512):
                check_viterbi(noisy_branch_metrics(lanes, steps, constraint, seed=steps * lanes),
                              constraint)
                cases += 1
    phase("8 viterbi", f"{cases} cases, K=5 and 7, lanes 1/3/130/2100, T K+1/255/512: "
          f"decisions, final metrics and bits equal the plain versions (torch.equal)")

    constraint, polys = 7, VITERBI_CODES[7]
    steps, lanes = VITERBI_INFO_BITS + constraint - 1, VITERBI_LANES
    bm = noisy_branch_metrics(lanes, steps, constraint, seed=6)
    errs = check_viterbi(bm, constraint)
    dec, _ = viterbi.viterbi_forward_cuda(bm, constraint, polys)
    forward = {"plain": viterbi.viterbi_forward, "kernel": viterbi.viterbi_forward_cuda}
    traceback = {"plain": viterbi.viterbi_traceback, "kernel": viterbi.viterbi_traceback_cuda}
    times = {}
    for name, fns, arg in (("viterbi_forward", forward, bm), ("viterbi_traceback", traceback, dec)):
        def run(kind, fns=fns, arg=arg):
            return cuda_ms(lambda: fns[kind](arg, constraint, polys),
                           PLAIN_VITERBI_CALLS if kind == "plain" else TIMED_LAUNCHES)
        # plain, kernel, kernel, plain: one card, one call, taken in turns
        plain = [run("plain")]
        kern = [run("kernel"), run("kernel")]
        plain.append(run("plain"))
        times[name] = (kern, plain)
    torch.cuda.synchronize()

    groups = dec.shape[1]
    states = 1 << (constraint - 1)
    n_codes = bm.shape[1]
    fwd_bound = bound(4 * (steps * n_codes * lanes + steps * groups * lanes + states * lanes),
                      3 * states * steps * lanes)  # 2 adds + 1 compare per target state
    tb_bound = bound(4 * 2 * steps * lanes,  # one decision word read, one bit written
                     5 * steps * lanes)
    table = {}
    for name, (b_ms, b_by), err, shape in (
            ("viterbi_forward", fwd_bound, errs["forward_abs_err"], [steps, n_codes, lanes]),
            ("viterbi_traceback", tb_bound, errs["traceback_abs_err"], [steps, groups, lanes])):
        kern, plain = times[name]
        table[name] = {"max_abs_err": err, "ms": sum(kern) / 2, "plain_ms": sum(plain) / 2,
                       "bound_ms": b_ms, "bound_by": b_by, "shape": shape}
        phase("8 timing", f"{name} at {tuple(shape)}: kernel {kern[0]:.4f}/{kern[1]:.4f} ms "
              f"(mean of {TIMED_LAUNCHES}), plain {plain[0]:.4f}/{plain[1]:.4f} ms (mean of "
              f"{PLAIN_VITERBI_CALLS}); bound {b_ms:.4f} ms by {b_by}, "
              f"{100 * b_ms / table[name]['ms']:.2f}% of it; max|Δ| {err}")
    return table


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

    # 2. Build and load every kernel, one nvcc per source in parallel (set-up time).
    t0 = time.perf_counter()
    built = _build.ensure_built()
    for name in built:
        _build.load_library(name)
    for name, (path, log) in built.items():
        usage = sorted({line.split(":", 1)[1].strip() for line in log.splitlines()
                        if "Used" in line and "registers" in line})
        phase("2 build", f"{path.name}; ptxas: {'; '.join(usage) or 'already built'}")
    phase("2 build", f"{len(built)} libraries in {time.perf_counter() - t0:.2f} s")

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

    # The LoRa path starts here: only its launches count.
    zero_launch_counts()

    # 4. Quick start on CUDA tensors, checked against the CPU's plain path.
    wf = create_waveform("LoRa-SF7", 125_000.0, device=dev)
    tx = wf.modulate(b"hello")
    rx = awgn(tx, -2.0, generator=torch.Generator(device=dev).manual_seed(0))
    res = wf.demodulate(rx)
    decoded = bytes(res.bits[:5].cpu().numpy().astype("uint8"))
    if not tx.is_cuda or decoded != b"hello":
        raise AssertionError(f"quick start decoded {decoded!r} on {tx.device}")
    cpu_res = create_waveform("LoRa-SF7", 125_000.0, device="cpu").demodulate(rx.cpu())
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

    # 7. The LoRa path went through the kernel.
    launches = dechirp_power.launches
    if launches <= 0:
        raise AssertionError("the main path never launched the dechirp_power kernel")
    phase("7 launches", f"dechirp_power kernel launched {launches} times in phases 4-6")

    viterbi_timing = check_viterbi_kernels()

    # The Viterbi path starts here: only its launches count.
    zero_launch_counts()

    # 9. The decode bench at its full size.
    bench = viterbi_bench(dev)
    phase("9 decode bench", f"{bench['lanes']} frames × {bench['info_bits']} bits, T "
          f"{bench['steps']}: all decoded bits equal the input; info_mbps "
          f"{bench['info_mbps']:.3f}, compute_s {bench['compute_s']:.6f}")

    # 10. MIL-STD-188-110 round trips on the card, autobaud, checked against the CPU path.
    wf = create_waveform("MIL-STD-188-110")
    for rate, snr in MIL_CASES:
        tx = dataclasses.replace(wf, rate=rate, interleave="short").modulate(MIL_DATA)
        rx = awgn(tx, snr, generator=torch.Generator(device=dev).manual_seed(7))
        res = wf.demodulate(rx)
        got = bytes(res.bits[: len(MIL_DATA)].cpu().numpy().astype("uint8"))
        cpu = dataclasses.replace(wf, device=torch.device("cpu")).demodulate(rx.cpu())
        if not (tx.is_cuda and res.bits.is_cuda):
            raise AssertionError(f"MIL-STD-188-110 {rate} bps ran on {tx.device}")
        if (got, res.metadata) != (MIL_DATA, {"rate": rate, "interleave": "short"}):
            raise AssertionError(f"MIL-STD-188-110 {rate} bps at {snr} dB: {got!r}, "
                                 f"{res.metadata}")
        if not torch.equal(res.bits[: len(MIL_DATA)].cpu(), cpu.bits[: len(MIL_DATA)]):
            raise AssertionError(f"MIL-STD-188-110 {rate} bps: CUDA payload differs from the "
                                 f"CPU path")
        phase("10 MIL-STD-188-110", f"{rate} bps at {snr} dB on {tx.device}: autobaud "
              f"{res.metadata}, payload {got.hex()} equals the input and the CPU path")

    # 11. The Viterbi path went through both kernels.
    fwd, tb = viterbi.viterbi_forward.launches, viterbi.viterbi_traceback.launches
    if fwd <= 0 or tb <= 0:
        raise AssertionError(f"the Viterbi path launched forward {fwd}, traceback {tb} times")
    phase("11 launches", f"viterbi_forward kernel launched {fwd} times, viterbi_traceback "
          f"{tb} times in phases 9-10")

    def dechirp_bound(t):  # complex64 rows in, float32 power out; FFT flops
        k = t["k"]
        return bound(t["rows"] * k * (8 + 4) + 8 * k, t["rows"] * k * (5 * math.log2(k) + 9))

    t7 = timings[7]
    bound7, by7 = dechirp_bound(t7)
    kernels = [{
        "name": "dechirp_power",
        "route": "cuda",
        "source": "r4w_tpu_torch/csrc/dechirp_power.cu",
        "replaces": "r4w_tpu/kernels/pallas_kernels.py:90",
        "launches": launches,
        "max_abs_err": t7["abs_err"],
        "ms": t7["ms"],
        "plain_ms": t7["plain_ms"],
        "bound_ms": bound7,
        "bound_by": by7,
        "library_ms": None,
        "shape": [t7["rows"], t7["k"]],
        "max_rel_err": max(t["rel_err"] for t in timings.values()),
        "ms_sf12": timings[12]["ms"],
        "plain_ms_sf12": timings[12]["plain_ms"],
        "bound_ms_sf12": dechirp_bound(timings[12])[0],
    }]
    for name, line, count in (("viterbi_forward", 403, fwd), ("viterbi_traceback", 479, tb)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "r4w_tpu_torch/csrc/viterbi.cu",
            "replaces": f"r4w_tpu/kernels/pallas_kernels.py:{line}",
            "launches": count,
            **viterbi_timing[name],
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
