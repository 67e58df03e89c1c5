"""The navigation, biomedical, infrastructure, timing and waveform-spec
slice's two gates: a frequency-hopping 16-QAM link with digital
predistortion streamed over TCP at full width, and the slice's blocks
card against CPU.

`hopping_link_gate(device, hops)` runs the link that a tactical VHF
hopper, an ISM-band telemetry hopper or a GNU-Radio-style flowgraph
between an SDR's host and a processing host runs, made of the port's
functions only. The scene is synthesised from seed 0 (`hop_scene`: the
bits, the DPD training burst and the noise in numpy):

1. Modulation from a declarative spec: the 16-QAM spec (QAM16_SPEC, equal
   to specs/qam16.yaml) builds its waveform (`waveform_spec`): 2,000
   symbols/s, 8 samples a symbol at 16 kS/s, 76 symbols (304 bits) a dwell,
   each sample repeated UPSAMPLE = 128 times to the 2.048 MS/s capture rate.
2. Hop control: `hop_pattern_lfsr(64, hops)` over 64 channels 25 kHz apart
   centred on DC (`hop_frequencies(pattern, −787.5 kHz, 25 kHz)`), and
   `FrequencyHoppingController(pattern, 77,824, 4,096)`: a hop every
   81,920 samples (40 ms), its last 4,096 samples the guard, silent while
   the synthesiser retunes.
3. Transmitter (`transmit`): drive 0.75 of the unit-power constellation;
   `dpd_learn_polynomial(order=7)` once on 2^16 complex Gaussian samples
   (std 0.5625 a part) through the PA; `dpd_apply` on every dwell;
   `rotator_apply` to +f of the dwell's channel from phase 0, the dwells
   grouped by channel (one NCO launch a channel); `rapp_pa(1, 2)`.
4. Channel: complex AWGN at Es/N0 = 30 dB (the noise variance a complex
   sample P·(2.048e6/2000)/10³, P the PA output's mean power over the
   dwells), and a copy at 20 dB for the BER report, from the same unit
   noise.
5. Stream (`stream_link`): a sender thread sends the 30 dB capture hop by
   hop through `TcpSink` to a `TcpSource` on 127.0.0.1 (port 0); the
   receiver `recv`s each hop onto the device and records it with its hop,
   channel and `SampleClock` timestamp in an `IndexedRecorder` file.
6. De-hop (`receive_block`), a block of BLOCK_HOPS hops (1 s) at a time
   as the block completes: the guard samples (`ctl.in_guard`) dropped,
   `rotator_apply` by −f of the channel from phase 0 (grouped by channel),
   one `decimating_fir(design_lowpass(63, 51.2 kHz, 2.048 MS/s), ·, 16)`
   launch and one `decimating_fir(design_lowpass(63, 6.4 kHz, 128 kS/s),
   ·, 8)` launch over the block's rows, to 16 kS/s.
7. Demodulate: the two filters delay the 16 kS/s stream by GROUP_DELAY =
   31/128 + 31/8 = 4.117 samples, so symbol s spans [8s + 4.117,
   8s + 12.117) there and is read from the window of 8 samples starting at
   8s + WINDOW_START, WINDOW_START = 5 = ⌈GROUP_DELAY⌉: the first window
   that lies inside its symbol (at 4 the window's first sample sits 0.117
   samples before the symbol's start, in the symbol before; over the first
   50 hops at 30 dB the smallest decision margin is 0.29 at 5, 0.19 at 4,
   and at 3 the bits fail). The
   last symbol's window would end 5 samples past the dwell's filtered end,
   so SCORED_SYMBOLS = 75 of the 76 are scored and the last is dropped. Each dwell's windows are
   scaled to unit mean power (the PA's gain is not one) and decided by the
   spec waveform's `linear_demodulate_symbols`; `indices_to_bits` gives the
   bits.

`hopping_bars` holds the result to the scene's truth; `hopping_agreement`
holds a card run against a CPU run on the same capture. `infra_blocks_gate`
runs every `BLOCKS` entry of navigation, biomedical and infra_fills, every
alias of `alias_blocks`, and the public classes and functions of timing and
waveform_spec on their JAX tests' inputs on `device` and on the CPU.
"""

from __future__ import annotations

import math
import os
import tempfile
import threading
import time

import numpy as np
import torch

from r4w_tpu_torch import timing
from r4w_tpu_torch import waveform_spec as ws
from r4w_tpu_torch.core.types import DEFAULT_DEVICE, IQ_DTYPE, resolve_device
from r4w_tpu_torch.dispatch_gates import DEVICE, _text
from r4w_tpu_torch.modem_gates import _Stages, _launched, _on, _synchronize, compare, launch_counts
from r4w_tpu_torch.ops import biomedical as bio
from r4w_tpu_torch.ops import filters
from r4w_tpu_torch.ops import infra_fills as inf
from r4w_tpu_torch.ops import navigation as nav
from r4w_tpu_torch.ops.impairments import rapp_pa
from r4w_tpu_torch.waveforms import linear_mod as lm

# The 16-QAM spec, yaml.safe_load of specs/qam16.yaml (the card's machine
# has no PyYAML; tests/test_torch_timing_spec.py holds the two equal).
QAM16_SPEC = {
    "waveform": {
        "name": "16-QAM",
        "full_name": "16-point Quadrature Amplitude Modulation",
        "version": "1.0.0",
        "description": "4x4 Gray-coded square grid, 4 bits/symbol.",
        "classification": {"type": "digital", "category": "narrowband"},
    },
    "modulation": {
        "domain": "amplitude-phase",
        "scheme": "QAM",
        "order": 16,
        "bits_per_symbol": 4,
        "constellation": {
            "type": "qam",
            "points": [[-0.9487, -0.9487], [-0.9487, -0.3162], [-0.9487, 0.9487],
                       [-0.9487, 0.3162], [-0.3162, -0.9487], [-0.3162, -0.3162],
                       [-0.3162, 0.9487], [-0.3162, 0.3162], [0.9487, -0.9487],
                       [0.9487, -0.3162], [0.9487, 0.9487], [0.9487, 0.3162],
                       [0.3162, -0.9487], [0.3162, -0.3162], [0.3162, 0.9487],
                       [0.3162, 0.3162]],
            "gray_coded": True,
        },
    },
    "timing": {"symbol_rate": 2000.0, "sample_rate": 16000.0, "samples_per_symbol": 8},
}

CAPTURE_RATE_HZ = 2.048e6
N_CHANNELS = 64
BASE_HZ, SPACING_HZ = -787.5e3, 25e3      # channel c at −787.5 kHz + c·25 kHz; none at DC
HOPS = 250                                # 10.0 s
BLOCK_HOPS = 25                           # the receiver's block, 1 s
DWELL, GUARD = 77_824, 4_096
PERIOD = DWELL + GUARD                    # 81,920 samples, 40 ms
SYMBOL_RATE_HZ, SPEC_RATE_HZ, SPS = 2000.0, 16e3, 8
UPSAMPLE = int(CAPTURE_RATE_HZ / SPEC_RATE_HZ)            # 128
SYMBOLS = DWELL // (SPS * UPSAMPLE)                       # 76 a dwell
BITS_PER_SYMBOL = 4
BITS = SYMBOLS * BITS_PER_SYMBOL                          # 304 a dwell
DRIVE = 0.75
DPD_ORDER, DPD_TRAIN = 7, 1 << 16
DPD_STD = 0.75 * DRIVE                    # a part of the training burst
PA_SATURATION, PA_SMOOTHNESS = 1.0, 2.0
ESN0_DB, BER_ESN0_DB = 30.0, 20.0
SAMPLES_PER_SYMBOL = CAPTURE_RATE_HZ / SYMBOL_RATE_HZ     # 1024: Es = P·1024
DDC_TAPS, DDC_CUTOFF_HZ, DDC_DECIMATION = 63, 51.2e3, 16
SYM_TAPS, SYM_CUTOFF_HZ, SYM_DECIMATION = 63, 6.4e3, 8
GROUP_DELAY = ((DDC_TAPS - 1) / 2 / DDC_DECIMATION + (SYM_TAPS - 1) / 2) / SYM_DECIMATION
WINDOW_START = math.ceil(GROUP_DELAY)   # 5
SCORED_SYMBOLS = SYMBOLS - 1              # the last symbol's window runs past the dwell
SCORED_BITS = SCORED_SYMBOLS * BITS_PER_SYMBOL
RECORD_CHECKS = 8                         # hops read back besides the first and the last
# bars
DPD_GAIN_DB = 8.0                         # transmit EVM with DPD at least this much better
VISITED_CHANNELS = {HOPS: 63}             # channels the LFSR pattern visits in HOPS hops
# card against CPU
# The DPD fit's float32 normal equations (condition ~2·10⁴) part by ~3e-4 between the
# card's and the CPU's summation orders; the PA output follows by ~1e-5 of its peak.
COEF_TOL = 1e-3        # max|card − CPU| / max|CPU| of the DPD coefficients
TX_TOL = 1e-4          # of the PA output
SYMBOL_TOL = 1e-4      # the 16 kS/s windows, relative to their peak
EVM_TOL_DB = 0.2
MARGIN = 1e-4          # a decision counts where its two nearest points differ by more


def spec() -> ws.WaveformSpec:
    """The 16-QAM spec from QAM16_SPEC."""
    return ws.WaveformSpec._from_dict(QAM16_SPEC)


def hop_scene(hops: int = HOPS, seed: int = 0) -> dict:
    """The scene in numpy from `seed`: the hop pattern, the bits (hops,
    BITS), the DPD training burst (DPD_TRAIN,) and unit-variance complex
    noise (hops, PERIOD), each from its own stream of the seed, so the first
    hops of a longer scene are a shorter scene's."""
    train_ss, bits_ss, noise_ss = np.random.SeedSequence(seed).spawn(3)
    r = np.random.default_rng(train_ss)
    train = (DPD_STD * (r.standard_normal(DPD_TRAIN) + 1j * r.standard_normal(DPD_TRAIN))
             ).astype(np.complex64)
    bits = np.random.default_rng(bits_ss).integers(0, 2, (hops, BITS)).astype(np.int32)
    noise = np.random.default_rng(noise_ss).standard_normal((hops, PERIOD, 2), np.float32)
    noise = (noise * np.float32(1 / math.sqrt(2))).view(np.complex64)[..., 0]
    pattern = inf.hop_pattern_lfsr(N_CHANNELS, hops, device="cpu").numpy()
    return {"hops": hops, "pattern": pattern, "bits": bits, "train": train, "noise": noise}


def channel_increment(channel: int) -> float:
    """Radians a sample of channel `channel`'s carrier (float64; the NCO
    rounds it to float32)."""
    return 2.0 * math.pi * (BASE_HZ + channel * SPACING_HZ) / CAPTURE_RATE_HZ


def _groups(channels: np.ndarray):
    """(perm, inverse, [(channel, start, stop)]): the order that puts the
    rows of each channel together, its inverse, and each channel's slice of
    the permuted rows."""
    perm = np.argsort(channels, kind="stable")
    inverse = np.argsort(perm, kind="stable")
    ordered = channels[perm]
    cuts = np.flatnonzero(np.diff(ordered)) + 1
    starts = np.concatenate([[0], cuts])
    stops = np.concatenate([cuts, [len(ordered)]])
    return perm, inverse, [(int(ordered[a]), int(a), int(b)) for a, b in zip(starts, stops)]


def rotate_by_channel(x: torch.Tensor, channels: np.ndarray, sign: float) -> torch.Tensor:
    """Each row of x (rows, n) rotated by sign·(its channel's increment)
    from phase 0: the rows of a channel as one `rotator_apply` (one NCO
    launch a channel)."""
    perm, inverse, groups = _groups(channels)
    dev = x.device
    ordered = x.index_select(0, torch.from_numpy(perm).to(dev))
    out = torch.empty_like(ordered)
    for c, a, b in groups:
        out[a:b] = inf.rotator_apply(ordered[a:b], sign * channel_increment(c))
    return out.index_select(0, torch.from_numpy(inverse).to(dev))


def transmit_evm_db(out: torch.Tensor, ideal: torch.Tensor) -> torch.Tensor:
    """EVM of `out` against `ideal` after the best complex gain (as
    tests/test_infra_fills.py aligns it), in dB of the ideal's power, as a
    0-dim float64 tensor (the sums in complex128)."""
    o, x = out.reshape(-1).to(torch.complex128), ideal.reshape(-1).to(torch.complex128)
    gg = torch.vdot(o, x) / torch.vdot(o, o)
    err = torch.mean(torch.abs(gg * o - x) ** 2)
    return 10.0 * torch.log10(err / torch.mean(torch.abs(x) ** 2))


def transmit(scene: dict, device, wf=None) -> dict:
    """The transmitter on `device`: the spec waveform's symbols at drive
    DRIVE, repeated to the capture rate, predistorted, mixed to each dwell's
    channel and through the PA; the guard silent. Returns the capture before
    noise (hops, PERIOD), the PA output's mean power over the dwells, the
    DPD coefficients and gain, and the transmit EVM with and without DPD
    (the PA is memoryless and amplitude-only, so it commutes with the mix
    and the EVM is taken at baseband), each a tensor on `device`."""
    dev = resolve_device(device)
    wf = wf or spec().build_waveform(dev)
    hops = scene["hops"]
    sym16 = wf.modulate(scene["bits"].reshape(-1)).reshape(hops, SYMBOLS * SPS)
    x = DRIVE * sym16.repeat_interleave(UPSAMPLE, dim=-1)
    train = torch.from_numpy(scene["train"]).to(dev)
    coef, gain = inf.dpd_learn_polynomial(train, rapp_pa(train, PA_SATURATION, PA_SMOOTHNESS),
                                          order=DPD_ORDER)
    pre = inf.dpd_apply(x, coef)
    evm = {"without": transmit_evm_db(rapp_pa(x, PA_SATURATION, PA_SMOOTHNESS), x),
           "with": transmit_evm_db(rapp_pa(pre, PA_SATURATION, PA_SMOOTHNESS), x)}
    pa = rapp_pa(rotate_by_channel(pre, scene["pattern"], 1.0), PA_SATURATION, PA_SMOOTHNESS)
    tx = torch.zeros((hops, PERIOD), dtype=IQ_DTYPE, device=dev)
    tx[:, :DWELL] = pa
    power = torch.mean(pa.real ** 2 + pa.imag ** 2)
    return {"tx": tx, "power": power, "coef": coef, "gain": gain, "evm_db": evm}


def add_noise(tx: torch.Tensor, noise: torch.Tensor, power: torch.Tensor,
              esn0_db: float) -> torch.Tensor:
    """tx + unit complex noise scaled to Es/N0 = esn0_db, Es = power ·
    SAMPLES_PER_SYMBOL."""
    sigma = torch.sqrt(power * (SAMPLES_PER_SYMBOL / 10.0 ** (esn0_db / 10.0)))
    return tx + sigma.to(tx.real.dtype) * noise


def design_taps(device) -> tuple:
    """The de-hopper's two lowpass filters as float32 tensors on `device`."""
    lp1 = filters.design_lowpass(DDC_TAPS, DDC_CUTOFF_HZ, CAPTURE_RATE_HZ)
    lp2 = filters.design_lowpass(SYM_TAPS, SYM_CUTOFF_HZ, CAPTURE_RATE_HZ / DDC_DECIMATION)
    return torch.from_numpy(lp1).to(device), torch.from_numpy(lp2).to(device)


def receive_block(rows: torch.Tensor, first_hop: int, ctl, constellation: torch.Tensor,
                  taps: tuple) -> dict:
    """De-hop, filter and demodulate the hops first_hop.. of rows (k,
    PERIOD): the 16 kS/s stream (k, SYMBOLS·SPS), the scored windows scaled
    to unit power, their means, the decisions (k, SCORED_SYMBOLS), the bits
    (k, SCORED_BITS) and the spec's SNR estimate per dwell."""
    k = rows.shape[0]
    hops = np.arange(first_hop, first_hop + k)
    guard = ctl.in_guard(np.arange(first_hop * PERIOD, (first_hop + 1) * PERIOD)).cpu().numpy()
    keep = torch.from_numpy(np.flatnonzero(~guard)).to(rows.device)
    channels = ctl.channel_at(hops * PERIOD).cpu().numpy()
    dwell = rows.index_select(-1, keep)
    base = rotate_by_channel(dwell, channels, -1.0)
    y1, _ = filters.decimating_fir(taps[0], base, DDC_DECIMATION)
    y2, _ = filters.decimating_fir(taps[1], y1, SYM_DECIMATION)
    win = y2[:, WINDOW_START:WINDOW_START + SCORED_SYMBOLS * SPS]
    scaled = win / torch.sqrt(torch.mean(win.real ** 2 + win.imag ** 2, dim=-1, keepdim=True))
    idx, _, snr = lm.linear_demodulate_symbols(scaled, constellation, SPS)
    means = torch.mean(scaled.reshape(k, SCORED_SYMBOLS, SPS), dim=-1)
    order = torch.arange(constellation.shape[0], device=rows.device)
    bits = lm.indices_to_bits(idx, order, BITS_PER_SYMBOL)
    return {"symbols": y2, "means": means, "idx": idx, "bits": bits, "snr_db": snr}


def _join(blocks: list) -> dict:
    return {k: torch.cat([b[k] for b in blocks]) for k in blocks[0]}


def receive(capture: torch.Tensor, ctl, constellation: torch.Tensor, taps: tuple) -> dict:
    """`receive_block` over the card-resident capture (hops, PERIOD), a
    block of BLOCK_HOPS at a time."""
    return _join([receive_block(capture[h:h + BLOCK_HOPS], h, ctl, constellation, taps)
                  for h in range(0, capture.shape[0], BLOCK_HOPS)])


def _sender(port: int, host_capture: np.ndarray, errors: list) -> None:
    try:
        sink = inf.TcpSink("127.0.0.1", port)
        for row in host_capture:
            sink.send(row)
        sink.close()
    except Exception as exc:  # noqa: BLE001 - reported by the receiver
        errors.append(repr(exc))


def stream_link(capture: torch.Tensor, ctl, constellation: torch.Tensor, taps: tuple,
                path: str) -> dict:
    """The capture (hops, PERIOD) on its device sent hop by hop from the
    host over loopback TCP, received onto the device, recorded with its hop,
    channel and timestamp into an `IndexedRecorder` at `path`, and received
    a block at a time as each block completes. Returns the receiver's
    outputs, the recorder, each hop's timestamp, the hops that differ from
    what was sent, the stream's seconds and the sender's errors."""
    dev = capture.device
    hops = capture.shape[0]
    host = capture.cpu().numpy()
    src = inf.TcpSource(0)
    errors: list = []
    thread = threading.Thread(target=_sender, args=(src.port, host, errors), daemon=True)
    t0 = time.perf_counter()
    thread.start()
    src.accept()
    rec = inf.IndexedRecorder(path)
    clock = timing.SampleClock(CAPTURE_RATE_HZ)
    stamps, blocks, pending = [], [], []
    differs = torch.zeros((), dtype=torch.int64, device=dev)
    try:
        for h in range(hops):
            hop = src.recv(device=dev)
            differs = differs + torch.any(hop.view(torch.int32) != capture[h].view(torch.int32))
            ts = clock.timestamp()
            rec.record(hop, hop=h, channel=int(ctl.pattern[h % len(ctl.pattern)]),
                       secs=ts.secs, picos=ts.picos)
            stamps.append(ts)
            clock.advance(PERIOD)
            pending.append(hop)
            if len(pending) == BLOCK_HOPS or h == hops - 1:
                first = h + 1 - len(pending)
                blocks.append(receive_block(torch.stack(pending), first, ctl, constellation,
                                            taps))
                pending = []
    finally:
        thread.join(timeout=60)
        src.close()
    _synchronize(dev)
    seconds = time.perf_counter() - t0
    return {"out": _join(blocks), "recorder": rec, "stamps": stamps,
            "hops_differing": int(differs), "seconds": seconds,
            "mb_per_s": hops * PERIOD * 8 / 1e6 / seconds, "sender_errors": errors}


def hopping_link_chain(scene: dict, device, path: str) -> dict:
    """The scene through the link on `device`: transmit, channel, stream
    and receive at ESN0_DB, and receive the BER_ESN0_DB copy from the
    device. Returns every stage's outputs, stage ms and launches."""
    dev = resolve_device(device)
    stages = _Stages(dev)
    wf = spec().build_waveform(dev)
    constellation = wf.constellation_points()
    taps = design_taps(dev)
    ctl = inf.FrequencyHoppingController(scene["pattern"], DWELL, GUARD, device="cpu")
    counts = {"start": launch_counts()}
    stages.mark("start")
    tx = transmit(scene, dev, wf)
    stages.mark("transmit")
    counts["transmit"] = launch_counts()
    noise = torch.from_numpy(scene["noise"]).to(dev)
    capture = add_noise(tx["tx"], noise, tx["power"], ESN0_DB)
    low = add_noise(tx["tx"], noise, tx["power"], BER_ESN0_DB)
    del noise
    stages.mark("channel")
    link = stream_link(capture, ctl, constellation, taps, path)
    stages.mark("stream_receive")
    counts["stream_receive"] = launch_counts()
    ber = receive(low, ctl, constellation, taps)
    stages.mark("receive_20db")
    counts["receive_20db"] = launch_counts()
    keys = list(counts)
    launches = {k: {n: counts[k][n] - counts[p][n] for n in counts[k]}
                for p, k in zip(keys, keys[1:])}
    return {"tx": tx, "capture": capture, "low": low, "link": link, "ber_out": ber,
            "ctl": ctl, "stage_ms": stages.ms(), "launches": launches}


def _evm(tx: dict) -> dict:
    return {k: float(v) for k, v in tx["evm_db"].items()}


def hopping_bars(run: dict, scene: dict) -> dict:
    """The link held to the scene's truth."""
    hops, ctl, link = scene["hops"], run["ctl"], run["link"]
    pattern = scene["pattern"]
    sent = scene["bits"][:, :SCORED_BITS]
    got = link["out"]["bits"].cpu().numpy()
    low = run["ber_out"]["bits"].cpu().numpy()
    b = {"messages": hops - link["hops_differing"] if not link["sender_errors"] else 0,
         "sender_errors": link["sender_errors"]}
    b["link_ok"] = b["messages"] == hops and not link["sender_errors"]
    starts = np.arange(hops) * PERIOD
    b["channel_at_ok"] = bool(np.array_equal(ctl.channel_at(starts).numpy(), pattern))
    guard = ctl.in_guard(np.arange(hops * PERIOD)).numpy().reshape(hops, PERIOD)
    b["in_guard_ok"] = bool((~guard[:, :DWELL]).all() and guard[:, DWELL:].all())
    b["boundaries_ok"] = bool(np.array_equal(ctl.hop_boundaries(hops * PERIOD).numpy(), starts))
    b["visited"] = int(len(np.unique(pattern)))
    b["visited_ok"] = b["visited"] == VISITED_CHANNELS.get(hops, b["visited"])
    rec = link["recorder"]
    b["find_ok"] = all(rec.find(channel=c) == np.flatnonzero(pattern == c).tolist()
                       for c in range(N_CHANNELS))
    pick = np.random.default_rng(0).choice(hops, size=min(RECORD_CHECKS, hops), replace=False)
    host = run["capture"].cpu().numpy()
    b["read_ok"] = all(np.array_equal(rec.read(int(i), device="cpu")[0].numpy().view(np.int32),
                                      host[int(i)].view(np.int32))
                       for i in sorted({0, hops - 1, *pick.tolist()}))
    b["file_bytes"] = os.path.getsize(rec.path)
    b["file_ok"] = b["file_bytes"] == hops * PERIOD * 8
    b["time_ok"] = all(ts == timing.Timestamp.from_samples(h * PERIOD, CAPTURE_RATE_HZ)
                       and ts.secs * timing.Timestamp.PICOS_PER_SEC + ts.picos
                       == h * 40_000_000_000
                       and rec.index[h][2]["secs"] == ts.secs
                       and rec.index[h][2]["picos"] == ts.picos
                       for h, ts in enumerate(link["stamps"]))
    evm = _evm(run["tx"])
    b["evm_db"] = evm
    b["dpd_gain_db"] = evm["without"] - evm["with"]
    b["dpd_ok"] = b["dpd_gain_db"] >= DPD_GAIN_DB
    b["bit_errors"] = int(np.sum(got != sent))
    b["bits_scored"] = int(sent.size)
    b["snr_db"] = [float(v) for v in (link["out"]["snr_db"].min(), link["out"]["snr_db"].max())]
    b["bit_errors_20db"] = int(np.sum(low != sent))
    b["ber_20db"] = b["bit_errors_20db"] / sent.size
    b["ok"] = bool(b["link_ok"] and b["channel_at_ok"] and b["in_guard_ok"]
                   and b["boundaries_ok"] and b["visited_ok"] and b["find_ok"] and b["read_ok"]
                   and b["file_ok"] and b["time_ok"] and b["dpd_ok"] and b["bit_errors"] == 0)
    return b


def hopping_link_gate(device=DEFAULT_DEVICE, hops: int = HOPS) -> dict:
    """The scene (`hop_scene(hops)`) through the link on `device`. Returns
    ``ok`` (the bars), the bars, the stage times, the launches of each
    hand-written kernel by stage, the seconds end to end (upload of the
    scene to the last bits; the numpy scene not counted), the TCP stream's
    MB/s, the chain's outputs and the scene."""
    device = resolve_device(device)
    scene = hop_scene(hops)
    before = launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        _synchronize(device)
        t0 = time.perf_counter()
        run = hopping_link_chain(scene, device, os.path.join(tmp, "hops.iq"))
        _synchronize(device)
        seconds = time.perf_counter() - t0
        bars = hopping_bars(run, scene)
    return {"ok": bars["ok"], "bars": bars, "stage_ms": run["stage_ms"],
            "launches": _launched(before), "launches_by_stage": run["launches"],
            "seconds": seconds, "stream_s": run["link"]["seconds"],
            "stream_mb_per_s": run["link"]["mb_per_s"], "run": run, "scene": scene,
            "samples": hops * PERIOD, "device": str(device)}


def decisive_mask(means: torch.Tensor, constellation: torch.Tensor) -> torch.Tensor:
    """True where a window mean's two nearest constellation points differ
    in distance by more than MARGIN."""
    d = torch.sort(torch.abs(means[..., None] - constellation), dim=-1).values
    return d[..., 1] - d[..., 0] > MARGIN


def hopping_agreement(card: dict, cpu_tx: dict, cpu_link: dict, cpu_low: dict,
                      scene: dict) -> dict:
    """A card run of the link against CPU runs on the same scene and
    capture: the CPU's transmitter on the scene (PA output within TX_TOL,
    DPD coefficients within COEF_TOL, transmit EVM within EVM_TOL_DB), the
    CPU's stream and receiver on the card's 30 dB capture (bits, channels,
    records and timestamps equal, the 16 kS/s windows within SYMBOL_TOL),
    and on its 20 dB copy (decisions equal wherever both margins exceed
    MARGIN)."""
    run = card["run"]
    const = torch.from_numpy(spec().constellation)
    res = {"tx_rel": compare(run["tx"]["tx"], cpu_tx["tx"]),
           "coef_rel": compare(run["tx"]["coef"], cpu_tx["coef"])}
    ev_card, ev_cpu = _evm(run["tx"]), _evm(cpu_tx)
    res["evm_delta_db"] = max(abs(ev_card[k] - ev_cpu[k]) for k in ev_card)
    a, b = run["link"], cpu_link
    res["bits_equal"] = bool(torch.equal(a["out"]["bits"].cpu(), b["out"]["bits"]))
    res["records_equal"] = a["recorder"].index == b["recorder"].index
    res["stamps_equal"] = a["stamps"] == b["stamps"]
    res["channels_equal"] = bool(np.array_equal(
        run["ctl"].channel_at(np.arange(scene["hops"]) * PERIOD).numpy(),
        b["ctl"].channel_at(np.arange(scene["hops"]) * PERIOD).numpy()))
    res["symbols_rel"] = compare(a["out"]["symbols"], b["out"]["symbols"])
    lo_a, lo_b = run["ber_out"], cpu_low
    both = (decisive_mask(lo_a["means"].cpu(), const) & decisive_mask(lo_b["means"], const))
    res["decisive_20db"] = int(both.sum())
    res["decisions_20db_equal"] = bool(torch.equal(lo_a["idx"].cpu()[both], lo_b["idx"][both]))
    res["ok"] = bool(res["tx_rel"] <= TX_TOL and res["coef_rel"] <= COEF_TOL
                     and res["evm_delta_db"] <= EVM_TOL_DB and res["bits_equal"]
                     and res["records_equal"] and res["stamps_equal"] and res["channels_equal"]
                     and res["symbols_rel"] <= SYMBOL_TOL and res["decisions_20db_equal"])
    return res


def cpu_runs(card: dict, path: str) -> tuple:
    """The CPU's transmitter on the card run's scene, and the CPU's stream,
    record and receive of the card's 30 dB capture and its receiver on the
    20 dB copy (for `hopping_agreement`)."""
    cpu = torch.device("cpu")
    scene, run = card["scene"], card["run"]
    tx = transmit(scene, cpu)
    const = torch.from_numpy(spec().constellation)
    taps = design_taps(cpu)
    ctl = inf.FrequencyHoppingController(scene["pattern"], DWELL, GUARD, device="cpu")
    link = stream_link(run["capture"].cpu(), ctl, const, taps, path)
    link["ctl"] = ctl
    low = receive(run["low"].cpu(), ctl, const, taps)
    return tx, link, low


# ------------------------------------------------------------ blocks gate

BLOCKS_TOL = 1e-5          # max|card − CPU| / max|CPU|: sums, FFTs and products in another order
BLOCKS_LOOP_TOL = 1e-4     # the navigation recursions (thousands of steps of float32 updates)
# The DPD fit's float32 normal equations on the reference test's burst (std 0.45 a part, deeper
# into compression than the link's): the card's and the CPU's summation orders part by 3.5e-3
# in the coefficients (an H100 chip run; 3.2e-4 on the link's own burst).
BLOCKS_DPD_TOL = 1e-2
# The particle filter: the card's float32 exp and float64 cumulative sums part from the CPU's
# by ulps, and an ulp at a resampling edge moves a resampled index, after which the two
# ensembles are different samples of one posterior: the tracks agree to Monte-Carlo noise
# (tests/test_torch_navigation_biomedical.py measures the reference's own).
BLOCKS_PF_TOL = 2e-2


def _stamp(t: timing.Timestamp) -> torch.Tensor:
    return torch.tensor([t.secs, t.picos], dtype=torch.int64)


def _timing_cases():
    """Timestamp, SampleClock and HardwareClock as tests/test_timing_sandbox.py
    drives them (host integers and floats, equal on both runs)."""
    def timestamp():
        a, b = timing.Timestamp.from_seconds(1.5), timing.Timestamp.from_seconds(0.75)
        t = timing.Timestamp(0, 0)
        step = timing.Timestamp.from_seconds(1e-6)
        for _ in range(1000):
            t = t + step
        return [_stamp(a + b), _stamp(a - b), _stamp(t),
                _stamp(timing.Timestamp.from_samples(48_000_000, 48e6)),
                _stamp(timing.Timestamp.from_samples(249 * PERIOD, CAPTURE_RATE_HZ))]

    def sample_clock():
        c = timing.SampleClock(1e6)
        c.advance(500_000)
        return [torch.tensor([c.samples, c.samples_until(timing.Timestamp.from_seconds(0.75))]),
                _stamp(c.timestamp()), torch.tensor(c.elapsed_seconds())]

    def hardware_clock():
        c = timing.HardwareClock(1e6, drift_ppm=10.0, jitter_ps=5.0, seed=1)
        c.advance(10_000_000)
        return torch.tensor([c.true_time(), c.apparent_time(), c.offset()], dtype=torch.float64)

    def wall_clock():
        c = timing.WallClock(scale=100.0)
        c.pause()
        frozen = c.now()
        return torch.tensor([c.now() == frozen, c.scale == 100.0])

    none = ((), {})
    return [("timing.Timestamp", timestamp, none, 0),
            ("timing.SampleClock", sample_clock, none, 0),
            ("timing.HardwareClock", hardware_clock, none, 0),
            ("timing.WallClock", wall_clock, none, 0)]


def _spec_cases(tmp: str):
    """The spec from QAM16_SPEC: its fields, its constellation against the
    factory's 16-QAM, and its waveform's round trip on the device."""
    from r4w_tpu_torch.waveforms import create_waveform

    def fields():
        s = spec()
        return [torch.from_numpy(s.constellation), torch.tensor(
            [s.order, s.bits_per_symbol, s.samples_per_symbol, s.gray_coded, s.differential]),
            torch.tensor([s.symbol_rate, s.sample_rate, s.rolloff]), _text(s.name)]

    def check(device):
        ok, err = spec().check_constellation(create_waveform("16-QAM", 16e3, device))
        return [torch.tensor(ok), torch.tensor(err)]

    def round_trip(device):
        wf = spec().build_waveform(device)
        tx = wf.modulate(b"\x5a\xc3\x0f")
        res = wf.demodulate(tx + 0.05 * torch.ones_like(tx))
        return [tx, wf.constellation_points(), res.bits, res.symbols,
                torch.tensor(res.snr_estimate)]

    def spec_dir():
        # PyYAML may be absent (the card's machine): every spec is then skipped
        return _text(sorted(ws.load_spec_dir(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "specs"))))

    on = ((), {"device": DEVICE})
    return [("waveform_spec.WaveformSpec", fields, ((), {}), 0),
            ("waveform_spec.WaveformSpec.check_constellation", check, on, BLOCKS_TOL),
            ("waveform_spec.WaveformSpec.build_waveform", round_trip, on, BLOCKS_TOL),
            ("waveform_spec.load_spec_dir", spec_dir, ((), {}), 0)]


def _ecg_rows(fs: float = 250.0, n_s: float = 20.0, seed: int = 0) -> np.ndarray:
    """tests/test_bio_nav_instruments.py's synthetic ECG (gaussian R spikes
    at 72 bpm on a noisy baseline), and a second row at 60 bpm."""
    rows = []
    for bpm in (72.0, 60.0):
        rng = np.random.default_rng(seed)
        n = int(fs * n_s)
        x = 0.02 * rng.standard_normal(n)
        t = 0.3
        while t * fs < n - 50:
            k = int(t * fs)
            x[k - 5:k + 6] += np.exp(-0.5 * ((np.arange(-5, 6)) / 1.5) ** 2)
            t += 60.0 / bpm
        rows.append(x)
    return np.stack(rows).astype(np.float32)


def _nav_cases():
    """navigation's BLOCKS entries on tests/test_bio_nav_instruments.py's and
    tests/test_known_answers_r4c.py's inputs; the recursions on two rows."""
    from scipy.spatial.transform import Rotation
    ltol = BLOCKS_LOOP_TOL
    dt = 0.01
    g_body = Rotation.from_euler("x", -0.3).apply([0.0, 0.0, 9.81])
    r = np.random.default_rng(54)
    gyro = np.stack([np.zeros((3000, 3)), 0.3 * r.standard_normal((3000, 3))]).astype(np.float32)
    accel = np.stack([np.tile(g_body, (3000, 1)), np.tile(g_body, (3000, 1))
                      + r.standard_normal((3000, 3))]).astype(np.float32)
    accel_sd = np.stack([np.tile([2.0, 0.0, 9.81], (500, 1)), np.tile([2.0, 0.0, 9.81], (500, 1))
                         + r.standard_normal((500, 3))]).astype(np.float32)
    gyro_sd = np.stack([np.zeros((500, 3)), 0.2 * r.standard_normal((500, 3))]).astype(np.float32)
    rng = np.random.default_rng(12)
    z = (0.5 * np.arange(200) + 2.0 * rng.standard_normal(200)).astype(np.float32)
    a = np.asarray([[0.95, 0.1], [0.0, 0.9]], np.float32)
    b = np.asarray([[0.0], [1.0]], np.float32)
    c = np.asarray([1.0, 0.0], np.float32)
    lg = np.asarray([0.4, 0.3], np.float32)
    y = np.stack([np.linspace(0, 3, 120), np.sin(np.arange(120) / 9.0)]).astype(np.float32)
    u = (0.1 * np.ones((2, 120, 1))).astype(np.float32)
    q = r.standard_normal(4)
    q = (q / np.linalg.norm(q)).astype(np.float32)
    return [
        ("navigation.quaternion_attitude_tracker",
         lambda g, a_: nav.attitude_track_mahony(g, a_, dt, kp=2.0), ((gyro, accel), {}), ltol),
        ("navigation.inertial_nav_processor", lambda a_, g: nav.strapdown_integrate(a_, g, dt),
         ((accel_sd, gyro_sd), {}), ltol),
        ("navigation.imu_aided_tracking", lambda p, v, f: nav.imu_aided_update(p, v, f, 0.25),
         ((np.float32([10, 0, 0]), np.float32([1, 2, 3]), np.float32([20, 0, 0])), {}),
         BLOCKS_TOL),
        ("navigation.magnetometer_vector_rotator", nav.magnetometer_rotate,
         ((np.float32([1.0, 0.0, 0.5]), q), {}), BLOCKS_TOL),
        ("navigation.particle_filter_tracker",
         lambda zz: nav.particle_filter_track(zz, (0, 0)), ((z,), {}), BLOCKS_PF_TOL),
        ("navigation.digital_twin_state_observer",
         lambda yy, uu: nav.luenberger_observe(yy, a, b, c, lg, uu), ((y, u), {}), ltol),
        ("navigation.spatio_temporal_fusion", nav.spatio_temporal_fuse,
         ((np.float32([[1.0, 2.0], [3.0, 4.0]]), np.float32([1.0, 4.0])), {}), BLOCKS_TOL),
    ]


def _bio_cases():
    """biomedical's BLOCKS entries on tests/test_bio_nav_instruments.py's
    and tests/test_known_answers_r4l.py's inputs."""
    tol = BLOCKS_TOL
    fs = 250.0
    ecg = _ecg_rows(fs)
    t = np.arange(2500) / fs
    mains = np.stack([np.sin(2 * np.pi * 1.2 * t) + 0.5 * np.sin(2 * np.pi * 50 * t),
                      np.sin(2 * np.pi * 0.9 * t) + 0.3 * np.cos(2 * np.pi * 50 * t)]
                     ).astype(np.float32)
    alpha = np.sin(2 * np.pi * 10 * np.arange(5000) / fs).astype(np.float32)
    x = np.zeros(20000)
    x[500:20000:1500] = 2.0
    x[1100:20000:1700] = 0.8
    r = np.random.default_rng(2)
    rest = (0.05 * r.standard_normal((2, 1000))).astype(np.float32)
    fist = r.standard_normal((2, 1000)).astype(np.float32)
    emg = np.stack([r.standard_normal(8000), 0.5 * r.standard_normal(8000)]).astype(np.float32)
    sfs = 22050.0
    st = np.arange(int(sfs)) / sfs
    call = ((np.sin(2 * np.pi * 4 * st) > 0.5) * np.sin(2 * np.pi * 3000 * st)).astype(np.float32)
    rhythms = {"normal": [int(k * fs * 60 / 72) for k in range(20)],
               "brady": [int(k * fs * 60 / 40) for k in range(10)],
               "tachy": [int(k * fs * 60 / 150) for k in range(30)],
               "irregular": (np.cumsum(np.random.default_rng(1).uniform(0.4, 1.4, 20))
                             * fs).astype(int)}

    def qrs(e):
        peaks, valid = bio.qrs_detect(e, fs)
        return [peaks, valid, bio.heart_rate_series(peaks[0][valid[0]], fs)]

    def rhythm(device):
        return [_text(bio.arrhythmia_classify(torch.tensor(np.asarray(v), device=device), fs))
                for v in rhythms.values()]

    def gesture(a_, b_):
        fr, ff = bio.emg_gesture_features(a_, 2000.0), bio.emg_gesture_features(b_, 2000.0)
        return [fr, ff, _text(bio.gesture_classify_nn(bio.emg_gesture_features(
            0.9 * b_, 2000.0), {"rest": fr, "fist": ff}))]

    return [
        ("biomedical.ecg_qrs_detector", qrs, ((ecg,), {}), 0),
        ("biomedical.ecg_arrhythmia_classifier", rhythm, ((), {"device": DEVICE}), 0),
        ("biomedical.biomedical_signal_processor", lambda e: bio.ecg_clean(e, fs),
         ((mains,), {}), tol),
        # the bands as one array: a band's leakage is held against the tone's power
        ("biomedical.eeg_band_powers", lambda e: torch.stack(list(bio.eeg_band_powers(
            e, fs).values())), ((alpha,), {}), tol),
        ("biomedical.eeg_bci", lambda a_, b_: bio.bci_alpha_blocking(a_, b_, fs),
         ((alpha, 0.1 * alpha), {}), tol),
        ("biomedical.emg_decomposition",
         lambda e: bio.emg_decompose_mu(e, 2000.0, n_units=2, threshold_sigma=3.0),
         ((x.astype(np.float32),), {}), 0),
        ("biomedical.emg_gesture_decoder", gesture, ((rest, fist), {}), tol),
        ("biomedical.bioacoustic_species_classifier", lambda a_: bio.species_features(a_, sfs),
         ((call,), {}), tol),
        ("biomedical.emg_envelope", lambda e: bio.emg_envelope(e, 2000.0), ((emg,), {}), tol),
    ]


def _infra_cases(tmp: str):
    """infra_fills' BLOCKS entries and aliases on tests/test_infra_fills.py's
    and the known-answer files' inputs (r4n, r4p); the host I/O on
    loopback sockets and files under `tmp`."""
    tol = BLOCKS_TOL
    r = np.random.default_rng(55)
    data = (np.arange(16) + 1j * np.arange(16)).astype(np.complex64)
    iq = (r.standard_normal((3, 4096)) + 1j * r.standard_normal((3, 4096))).astype(np.complex64)
    fs = 8000.0
    t = np.arange(8000) / fs
    speech = np.sin(2 * np.pi * 400 * t)
    speech[:1500] = 0.0
    mics = np.stack([speech + 0.5 * r.standard_normal(8000),
                     np.roll(speech, 2) + 0.5 * r.standard_normal(8000)]).astype(np.float32)
    pa_x = (0.45 * (r.standard_normal(8000) + 1j * r.standard_normal(8000))).astype(np.complex64)

    def files(x, device):
        p = os.path.join(tmp, f"x_{device.type}.iq")
        n = inf.file_sink(p, x)
        return [torch.tensor(n), inf.file_source(p, device=device),
                inf.file_source(p, count=4, offset_items=2, device=device)]

    def fds(x, device):
        rd, wr = os.pipe()
        n = inf.fd_sink(wr, x)
        os.close(wr)
        back = inf.fd_source(rd, x.shape[0], device=device)
        os.close(rd)
        return [torch.tensor(n), back]

    def tcp(x, device):
        src = inf.TcpSource(0)
        got = {}
        th = threading.Thread(target=lambda: (src.accept(), got.setdefault(
            "rx", src.recv(device=device))))
        th.start()
        sink = inf.TcpSink("127.0.0.1", src.port)
        sink.send(x)
        th.join(timeout=10)
        sink.close()
        src.close()
        return got["rx"]

    def pdu():
        send, recv, close = inf.socket_pdu_pair()
        send(b"hello pdu")
        out = recv()
        close()
        return _text(out.decode())

    def control(x):
        ctl = inf.StreamControl()
        out = [ctl.process(x)]
        ctl.pause()
        out.append(ctl.process(x))
        ctl.single_step()
        out += [ctl.process(x), ctl.process(x)]
        ctl.resume()
        return out + [ctl.process(x)]

    def recorder(a_, b_, device):
        rec = inf.IndexedRecorder(os.path.join(tmp, f"rec_{device.type}.iq"))
        rec.record(a_, freq=100e6)
        rec.record(b_, freq=200e6)
        back, meta = rec.read(1, device=device)
        return [back, torch.tensor(meta["freq"]), torch.tensor(rec.find(freq=100e6))]

    def controller(device):
        ctl = inf.FrequencyHoppingController([3, 7, 1], 100, guard_samples=10, device=device)
        return [ctl.channel_at(np.array([0, 110, 330])), ctl.in_guard(np.array([105, 50])),
                ctl.hop_boundaries(300)]

    def dpd(x):
        y = rapp_pa(x, 1.0, 2.0)
        coef, g = inf.dpd_learn_polynomial(x, y, order=7)
        return [coef, g, rapp_pa(inf.dpd_apply(x, coef), 1.0, 2.0)]

    aliases = inf.alias_blocks()

    def alias(name):
        def run(device):
            obj = aliases[name][0](sample_rate=1e6, device=device)
            items = obj if isinstance(obj, tuple) else (obj,)
            return _text(" ".join(getattr(o, "__qualname__", type(o).__name__) for o in items)
                         + " " + aliases[name][1] + " " + aliases[name][2])
        return run

    one = ((data,), {"device": DEVICE})
    return [
        ("infra_fills.file_sink", files, one, 0),
        ("infra_fills.file_source", files, one, 0),
        ("infra_fills.fd_sink", fds, one, 0),
        ("infra_fills.fd_source", fds, one, 0),
        ("infra_fills.tcp_sink", tcp, ((iq[0],), {"device": DEVICE}), 0),
        ("infra_fills.tcp_source", tcp, ((iq[1],), {"device": DEVICE}), 0),
        ("infra_fills.socket_pdu", pdu, ((), {}), 0),
        ("infra_fills.stream_control", control, ((np.arange(4, dtype=np.int32),), {}), 0),
        ("infra_fills.signal_recorder_indexed", recorder,
         ((np.arange(8).astype(np.complex64), (np.arange(4) + 5j).astype(np.complex64)),
          {"device": DEVICE}), 0),
        ("infra_fills.frequency_hopper", lambda device: inf.hop_pattern_lfsr(
            50, 500, device=device), ((), {"device": DEVICE}), 0),
        ("infra_fills.frequency_hopping", lambda p: inf.hop_frequencies(p, 900e6, 25e3),
         ((np.int32([3, 17, 49, 0]),), {}), 0),
        ("infra_fills.frequency_hopping_controller", controller, ((), {"device": DEVICE}), 0),
        ("infra_fills.speech_enhancement_beamforming",
         lambda m: inf.speech_enhance_beamform(m, [0, -2], fs), ((mics,), {}), tol),
        ("infra_fills.dpd_learn", dpd, ((pa_x,), {}), BLOCKS_DPD_TOL),
        ("infra_fills.dpd_apply", lambda x: inf.dpd_apply(x, np.complex64(
            [0.96, -0.39, 0.61])), ((iq,), {}), tol),
        ("infra_fills.simd_cmul", inf.cmul, ((iq[0], iq[1]), {}), tol),
        ("infra_fills.simd_cmac", inf.cmac, ((iq[2], iq[0], iq[1]), {}), tol),
        ("infra_fills.rotator", lambda x: inf.rotator_apply(x, 0.013, 0.4), ((iq,), {}), tol),
        *[(f"infra_fills.alias.{n}", alias(n), ((), {"device": DEVICE}), 0) for n in aliases],
    ]


def _public(module) -> list[str]:
    import inspect
    return [n for n, v in vars(module).items() if not n.startswith("_")
            and (inspect.isfunction(v) or inspect.isclass(v)) and v.__module__ == module.__name__]


def blocks_names() -> list[str]:
    """Every `BLOCKS` entry of navigation, biomedical and infra_fills as
    module.entry, every alias of `alias_blocks` as infra_fills.alias.name,
    and the public classes and functions of timing and waveform_spec as
    module.name."""
    return ([f"{m.__name__.rsplit('.', 1)[-1]}.{k}" for m in (nav, bio, inf) for k in m.BLOCKS]
            + [f"infra_fills.alias.{n}" for n in inf.alias_blocks()]
            + [f"{m.__name__.rsplit('.', 1)[-1]}.{n}" for m in (timing, ws) for n in _public(m)])


def _cases(tmp: str) -> list:
    return _timing_cases() + _spec_cases(tmp) + _nav_cases() + _bio_cases() + _infra_cases(tmp)


def infra_blocks_gate(device=DEFAULT_DEVICE) -> dict:
    """Every case of `_cases` on `device` and on the CPU (the worst
    difference a case, inf for differing decisions; each held to its
    tolerance). Returns ``ok``, ``worst`` by case, ``failed``, ``missing``,
    the worst case by name, the DPD coefficients' card-against-CPU
    difference, and the launches of each hand-written kernel."""
    device = resolve_device(device)
    cpu = torch.device("cpu")
    worst, failed, results = {}, [], {}
    before = launch_counts()
    with tempfile.TemporaryDirectory() as tmpdir:
        for name, fn, (args, kwargs), tol in _cases(tmpdir):
            got, want = (fn(*_on(list(args), d), **{k: d if v is DEVICE else v
                                                     for k, v in kwargs.items()})
                         for d in (device, cpu))
            results[name] = (got, want)
            worst[name] = compare(got, want)
            if not worst[name] <= tol:
                failed.append(name)
    missing = sorted(set(blocks_names()) - set(worst))
    top = max(worst, key=lambda k: worst[k])
    got, want = results["infra_fills.dpd_learn"]
    return {"ok": not failed and not missing, "worst": worst, "failed": failed,
            "missing": missing, "worst_case": (top, worst[top]),
            "dpd_coef_rel": compare(got[0], want[0]), "launches": _launched(before),
            "device": str(device)}
