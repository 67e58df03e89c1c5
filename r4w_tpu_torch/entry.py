"""Entry points of the port's paths: the LoRa loopback and the Viterbi decode.

`entry(device)` is the counterpart of ``__graft_entry__.entry``: one LoRa
SF7 forward step, modulate → AWGN → dechirp-DFT-argmax demodulate → BER.
`lora_sweep(device, seed)` is the counterpart of ``bench.py``'s
``bench_lora_sweep``: the SF7-SF12 Monte-Carlo BER grid at its full size,
timed on the card with CUDA events. `viterbi_bench(device, seed)` is the
counterpart of ``bench.py``'s ``bench_viterbi``: a K=7 rate-1/2 soft
decode of 4096 frames of 2048 bits, timed the same way. `ddc_bench(device,
seed)` is the digital down-converter at a capture size users run: 64
streams of 2^20 samples at an LTE-20 rate, mixed, lowpassed and decimated
by 8. `gps_pvt_fix(device)` is the counterpart of ``bench.py``'s
``bench_gps_pvt_fix``: the GPS L1 C/A receiver from a 24.3 s six-satellite
capture to a position fix. `pcps_bench(device)` is the counterpart of
``bench.py``'s ``bench_pcps``: the PCPS correlation grid of 8 PRNs × 41
Doppler bins × 2046 code phases, in correlations per second.
`galileo_pvt(device)` is the counterpart of ``tools/galileo_pvt.py``: the
Galileo E1B receiver from an 11.2 s six-satellite capture to a position
fix, its I/NAV pages decoded by the Viterbi kernels. `dual_pvt(device)` is
the counterpart of ``bench.py``'s ``bench_dual_pvt``: GPS L1 C/A and
Galileo E1B receivers on one 24.3 s ten-satellite capture, to a joint fix
with an inter-system bias. `glonass_track(device)` is the counterpart of
``bench.py``'s ``bench_glonass_track``: six GLONASS L1OF FDMA channels
mixed down exactly, acquired and tracked over 4 s. `ber_gate(device)` is
the counterpart of ``r4w_tpu.ber.main``: the BER-vs-theory gate of every
linear scheme and noncoherent BFSK at 1,000,000 bits a point.
`lora_packet_roundtrip(sf, device)` frames a payload with header and
CRC, modulates it with its preamble behind a noise gap (and an optional
CFO), finds it with the preamble search, demodulates and checks it.
`pcps_gcorr_bench(device)` is the counterpart of ``bench.py``'s
``bench_pcps_gcorr``: a 50-slot C/A bank × 41 Doppler bins × 1023 lags
through 4096-point transforms, 1024 chained iterations, in correlations
per second. `device_sweep(device)` is the counterpart of ``bench.py``'s
``bench_device_sweep`` and ``tools/device_sweep.py``: every factory
waveform through modulate -> host -> demodulate. `fleet_noisy_gate(device)`
is the counterpart of ``tests/test_fleet_noisy.py``: every factory name
through AWGN at its own SNR, digital names bit-exact, the analog, radar and
beacon names held to their functional bars. `sincgars_data_roundtrip(device)`
frames a file-sized payload for SINCGARS data mode, codes it, hops it over
the air through AWGN and back, its frames decoded as lanes of one Viterbi
call. `channel_bench(device)` is the counterpart of ``bench.py``'s
``bench_channel`` (its threefry half): AWGN at 20 dB applied 16,384 times
to 2^18 samples, in samples per second. `fading_gate(device)` puts OFDM,
LoRa-SF7, DSSS and BFSK through the TDL fading channels, and QPSK through a
static 2-ray channel with the LS channel estimate and the frequency-domain
equaliser (`two_ray_fde_case`), on the reference's own threefry draws, as
the JAX package's fading tests do.
`coded_link_gate(device)` runs the JAX FEC tests' own inputs (LDPC,
turbo, polar, convolutional, TCM, DVB-S2X short frames, LT with erasures,
MAP into a soft chain) through the port's codecs, each to its test's bar.
`dvb_s2x_bench(device)` decodes a batch of 128 DVB-S2X normal frames at
rate 1/2. `composed_receiver_gate(device, n_bits)` is the counterpart of
``tests/test_e2e_receiver.py``: the reference's composed QPSK link (K=7
code, interleaver, RRC shaping, AWGN, matched filter, PFB timing
recovery, 4th-power phase, soft Viterbi over every timing and phase
hypothesis as lanes of one decode), PN channel sounding into MLSE over a
3-tap ISI channel, MAP decoding into a soft chain and MLSE against a DFE
on a spectral null; at the reference's 1,024 bits, or at a 1,500-byte
packet's 12,000. `fm_broadcast_gate(device)` receives one minute of a
stereo station with RDS through the reference's broadcast chain, and
`modem_family_gate(device)` runs the modem family card against CPU; both
live in `modem_gates` and are re-exported here. `spectrum_monitor_gate(device,
rows)` watches one second of a 30.72 MS/s capture for four bursty FM
emitters (spectrum sensing, four down-converters, burst gate, squelch,
envelope and peak hold), and `dsp_blocks_gate(device)` runs the stream and
detection blocks card against CPU; both live in `monitor_gates` and are
re-exported here. `array_radar_gate(device, cpis)` runs a 16-element
digital-array pulse-Doppler radar at a full CPI (16 × 128 × 4096):
jammer-nulling MVDR beams, MTI, matched filter, Doppler, 2-D CFAR, MUSIC
and the tracker; `array_blocks_gate(device)` runs the radar, array and
propagation blocks card against CPU; both live in `radar_gates` and are
re-exported here. `spectrum_access_gate(device, rows)` runs a
dynamic-spectrum-access node's sensing cycle over a 20 MHz band at 30.72
MS/s (occupancy, duty cycles, waterfall, down-converted idle channels,
cyclic features, classification, leases, excision and the transmitter's
self-check), and `sensing_blocks_gate(device)` runs the spectrum-analysis,
cognitive, instrument and sensing blocks card against CPU; both live in
`cognitive_gates` and are re-exported here. `dispatch_monitor_gate(device)`
runs a narrowband-FM dispatch monitor over 8.0 s of a 2.4 MS/s capture
(eight 12.5 kHz channels: squelch, CTCSS tones, a DTMF ANI, POCSAG pages,
voice cleaning and pitch), and `protocol_blocks_gate(device)` runs the
packet, protocol, ADS-B, audio and applied blocks card against CPU; both
live in `dispatch_gates` and are re-exported here. `hopping_link_gate(device,
hops)` runs a frequency-hopping 16-QAM link with digital predistortion over
10 s at 2.048 MS/s (250 hops of 64 channels: the spec-built waveform, DPD,
the hop synthesiser, AWGN, a loopback TCP sample link, the indexed
recorder with timestamps, de-hopping, two decimating filters and the
demodulator), and `infra_blocks_gate(device)` runs the navigation,
biomedical, infrastructure, timing and waveform-spec blocks card against
CPU; both live in `hop_gates` and are re-exported here.
`e1c_pilot_gate(device)` is the counterpart of ``tools/e1c_tracking.py``'s
8-SV gate: Galileo E1C pilots at C/N0 34 dB-Hz acquired and handed to
overlay-wiped pilot loops over 200 ms, then E1B I/NAV pages decoded off the
pilot loops over 4.35 s (`gnss.e1c_tracking`, re-exported here).
`rf_scene_gate(device)` runs one second of a 30.72 MS/s multi-emitter RF
scene through the loopback SDR into a triggered SigMF capture and its
replay, with stream tags, metrics and configuration (`scene_gates`,
re-exported here). `mesh_lora_gate(device)` floods a 16-node Meshtastic
``LongFast`` mesh over the LoRa PHY (SF11, 250 kHz), every round's frames
modulated, put through AWGN at their links' SNRs and demodulated as one
batch on the card (`mesh_gates`, re-exported here). `registry_survey(device)`
runs every block of the 523-block registry through the block-graph
pipeline with its schema's defaults (`registry_survey`, re-exported here).
`dryrun_multichip(n, device)` runs the five sharded patterns of
``__graft_entry__.dryrun_multichip`` over n ranks of `device`, one process a
rank (`parallel.dryrun`, re-exported here).
Every entry point runs on the CUDA card unless the caller names another
device.
"""

from __future__ import annotations

import functools
import math
import time

import numpy as np
import torch

from r4w_tpu_torch import ber
from r4w_tpu_torch.channel import ChannelConfig, apply_channel, awgn, threefry
from r4w_tpu_torch.core.types import (DEFAULT_DEVICE, IQ_DTYPE, REAL_DTYPE, SYMBOL_DTYPE,
                                      resolve_device)
from r4w_tpu_torch.fec import dvb_s2x, fountain, ldpc, polar, tcm, turbo
from r4w_tpu_torch.fec.convolutional import (conv_encode, map_decode, viterbi_decode,
                                             viterbi_decode_mxu)
from r4w_tpu_torch.fec.interleave import block_deinterleave, block_interleave
from r4w_tpu_torch.gnss import acquisition, dual_pvt as dual, galileo_pvt as gal
from r4w_tpu_torch.gnss import glonass_track as glo, gps_pvt_fix as gps, prn
from r4w_tpu_torch.kernels import viterbi
from r4w_tpu_torch.modem_gates import fm_broadcast_gate, modem_family_gate  # noqa: F401
from r4w_tpu_torch.monitor_gates import dsp_blocks_gate, spectrum_monitor_gate  # noqa: F401
from r4w_tpu_torch.radar_gates import array_blocks_gate, array_radar_gate  # noqa: F401
from r4w_tpu_torch.cognitive_gates import sensing_blocks_gate, spectrum_access_gate  # noqa: F401
from r4w_tpu_torch.dispatch_gates import dispatch_monitor_gate, protocol_blocks_gate  # noqa: F401
from r4w_tpu_torch.hop_gates import hopping_link_gate, infra_blocks_gate  # noqa: F401
from r4w_tpu_torch.gnss.e1c_tracking import e1c_pilot_gate  # noqa: F401
from r4w_tpu_torch.scene_gates import rf_scene_gate  # noqa: F401
from r4w_tpu_torch.remote_gates import block_graph_gate, remote_lab_gate  # noqa: F401
from r4w_tpu_torch.mesh_gates import mesh_lora_gate  # noqa: F401
from r4w_tpu_torch.registry_survey import registry_survey  # noqa: F401
from r4w_tpu_torch.ops import equalizers, measure, pulse, resample
from r4w_tpu_torch.ops.filters import fir_filter
from r4w_tpu_torch.ops.modem import soft_demap_llr
from r4w_tpu_torch.ops.spreading import m_sequence
from r4w_tpu_torch.ops.stream_math import digital_down_convert
from r4w_tpu_torch.ops.sync import _integer_pow
from r4w_tpu_torch.core.hostio import cis
from r4w_tpu_torch.parallel import ber_sweep
from r4w_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: F401
from r4w_tpu_torch.waveforms import create_waveform, list_waveforms, lora
from r4w_tpu_torch.waveforms import milfh_waveforms as milfh
from r4w_tpu_torch.waveforms.iot_waveforms import SPEED_OF_LIGHT
from r4w_tpu_torch.waveforms.lora import packet, sync

SWEEP_SNRS_DB = tuple(float(s) for s in np.arange(-26.0, -2.0, 2.0))  # 12 points
SWEEP_SFS = tuple(range(7, 13))
SWEEP_PAYLOAD_BYTES = 16
BER_TARGET = 0.01
VITERBI_LANES, VITERBI_INFO_BITS = 4096, 2048  # frames × info bits per frame
DDC_STREAMS, DDC_SAMPLES = 64, 1 << 20        # streams × complex64 samples per stream
DDC_RATE_HZ = 30.72e6                          # the LTE-20 sample rate
DDC_CENTER_HZ, DDC_DECIMATION = 7.68e6, 8
DDC_TONE_OFFSET_HZ = 120e3                     # the wanted signal, off the channel centre
DDC_INTERFERER_OFFSET_HZ = -5e6                # an equal-power neighbour, 5 MHz away
DDC_NOISE_STD = 0.1                            # per component
DDC_EDGE = 64                                  # output samples skipped at each end
DDC_AMPLITUDE_TOL = 0.02
DDC_REJECTION_DB = 50.0
PCPS_PRNS, PCPS_RATE_HZ = 8, 2_046_000.0       # 8 C/A codes at 2 samples a chip
PCPS_CONFIG = acquisition.PcpsConfig(doppler_max_hz=5000.0, doppler_step_hz=250.0,
                                     coherent_periods=2)
PCPS_CALLS = 16                                # chained calls timed together
PACKET_PAYLOAD_BYTES = 255                     # the largest the header's length byte describes
PACKET_GAP_SAMPLES = 777                       # noise before the preamble
PACKET_GAP_STD = 0.05                          # per component
GCORR_RATE_HZ, GCORR_LAGS = 1.023e6, 1023      # one C/A period at one sample a chip
GCORR_SLOTS, GCORR_DOPPLER_BINS = 50, 41       # PRN 1 + p mod 32; ±5 kHz at 250 Hz
GCORR_DOPPLER_STEP_HZ, GCORR_NFFT = 250.0, 4096
GCORR_ITERS = 1024                             # chained iterations timed together
SWEEP_RATE_HZ, SWEEP_MESSAGE = 48_000.0, b"device-sweep"  # tools/device_sweep.py:21-22
# tests/test_fleet_noisy.py:17-51: the payload, each digital name's SNR in dB and
# sample rate (None: the factory's default), the names held to functional bars
NOISY_DATA = bytes([0xA7, 0x1B, 0x3C, 0xD2])
DIGITAL_SNR: dict[str, tuple[float, float | None]] = {
    "OOK": (0.0, None), "ASK": (8.0, None), "4-ASK": (18.0, None), "BFSK": (12.0, None),
    "4-FSK": (18.0, None), "PPM": (0.0, None), "ADS-B": (8.0, 8_000_000.0),
    "BPSK": (-6.0, None), "QPSK": (-6.0, None), "8-PSK": (0.0, None), "16-QAM": (0.0, None),
    "64-QAM": (8.0, None), "256-QAM": (10.0, None), "OFDM": (12.0, None),
    "DSSS": (-8.0, None), "DSSS-QPSK": (-8.0, None), "Zigbee": (-2.0, None),
    "UWB": (-6.0, None), "ALE": (-5.0, None), "3G-ALE": (-5.0, None),
    "STANAG-4285": (0.0, None), "MIL-STD-188-110": (0.0, None), "P25": (12.0, None),
    "P25-Phase2": (5.0, None), "TETRA": (5.0, None), "TETRA-DMO": (5.0, None),
    "DMR": (12.0, None), "DMR-Tier3": (12.0, None), "DMR-Direct": (12.0, None),
    "FHSS": (5.0, None), "FHSS-AntiJam": (5.0, None), "SINCGARS": (5.0, None),
    "HAVEQUICK": (8.0, None), "Link-16": (-6.0, None), "LoRa": (-8.0, None),
    "LoRa-SF7": (-8.0, None), "LoRa-SF12": (-8.0, None), "GPS-L1CA": (-6.0, None),
    "GPS-L5": (-6.0, None), "GLONASS-L1OF": (-6.0, None), "Galileo-E1": (-6.0, None),
}
FUNCTIONAL = frozenset({"CW", "AM-Broadcast", "FM-Broadcast", "NBFM", "FMCW", "ELT-121.5",
                        "EPIRB-121.5", "PLB-121.5", "Beacon-243"})
CW_SNR_DB, CW_FREQ_TOL_HZ = 10.0, 10.0                     # tests/test_fleet_noisy.py:80-84
ANALOG_BARS = {"AM-Broadcast": (30.0, 6.0), "FM-Broadcast": (30.0, 4.0),
               "NBFM": (35.0, 10.0)}                       # name: (SNR dB, mean |err| bar)
FMCW_RATE_HZ, FMCW_RANGE_M, FMCW_SNR_DB = 1_000_000.0, 1500.0, 0.0
BEACON_SNR_DB = 10.0
CHANNEL_SAMPLES, CHANNEL_ITERS = 1 << 18, 16384  # bench.py:645's shape
CHANNEL_SNR_DB = 20.0
# tests/test_waveform_fleet.py:103-116 and tests/test_fleet_fading.py:20-33:
# (waveform, sample rate, model, TDL profile, SNR dB, Doppler Hz, payload, key)
FADING_CASES = (
    ("OFDM", 1_000_000.0, "tdl_awgn", "EPA", 25.0, 5.0, NOISY_DATA, 11),
    ("OFDM", 1_000_000.0, "freq_selective", "EVA", 25.0, 5.0, NOISY_DATA, 11),
    ("LoRa-SF7", 125_000.0, "tdl_awgn", "EPA", 15.0, 2.0, b"\xa5\x3c", 3),
    ("DSSS", 1_000_000.0, "tdl_awgn", "EPA", 18.0, 2.0, b"\xa5\x3c", 3),
    ("BFSK", 250_000.0, "tdl_awgn", "EPA", 22.0, 2.0, b"\xa5\x3c", 3),
)
# tests/test_fleet_fading.py:36-75: QPSK at 1 MS/s behind a 16-byte known
# preamble (numpy seed 0) through a static 2-ray channel (a full-symbol echo
# of 0.9 at 8 samples) and AWGN at 25 dB on key 9; an 8-tap LS estimate on
# the preamble's first 2,048 samples, its taps over 0.05 equalised in the
# frequency domain at n_fft 4096
TWO_RAY_FDE_CASE = ("QPSK", 1_000_000.0, 8, 0.9, 25.0, b"\xa5\x3c" * 4, 9)
TWO_RAY_LABEL = "QPSK static 2-ray FDE"
TWO_RAY_PILOT, TWO_RAY_TAPS, TWO_RAY_TAP_MIN, TWO_RAY_NFFT = 2048, 8, 0.05, 4096
# tests/test_named_blocks.py:44-56: (rate, Eb/N0 dB), short frames, 40 iterations
DVB_GATE_POINTS = (("1/4", 2.0), ("1/2", 3.0), ("3/4", 4.0), ("9/10", 6.5))
DVB_GATE_ITERS = 40
DVB_BENCH_FRAMES, DVB_BENCH_RATE, DVB_BENCH_EBN0_DB = 128, "1/2", 3.0
TCM_GATE_BITS, TCM_GATE_EBN0_DB = 100_000, 5.0  # tests/test_fec.py:270
# tests/test_e2e_receiver.py: 1,024 info bits at 4 samples a symbol through
# AWGN at 14 dB on jax.random.key(1); the ISI and spectral-null links on
# 4,000 and 6,000 symbols (numpy seeds 9 and 13)
RECEIVER_INFO_BITS, RECEIVER_SPS, RECEIVER_SNR_DB, RECEIVER_KEY = 1024, 4, 14.0, 1
RECEIVER_ISI_SYMBOLS, RECEIVER_NULL_SYMBOLS = 4000, 6000
RECEIVER_OFFSETS = 64       # the reference's timing search: offsets below 64 that fit
RECEIVER_DFE_SKIP = 4000    # DFE decisions before this are its convergence, not scored
PACKET_INFO_BITS = 12_000   # one 1,500-byte packet, the Ethernet MTU
QPSK_POINTS = np.exp(1j * (np.pi / 4.0 + 2.0 * np.pi * np.arange(4) / 4)).astype(np.complex64)


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


def ddc_signal(device=DEFAULT_DEVICE, seed: int = 0, streams: int = DDC_STREAMS,
               samples: int = DDC_SAMPLES) -> torch.Tensor:
    """(streams, samples) complex64 at `DDC_RATE_HZ`, made on `device`.

    Each stream holds a unit tone at centre + 120 kHz and an equal-power
    interferer at centre - 5 MHz, each with a random start phase, plus
    complex Gaussian noise of std 0.1 per component, all drawn from a
    `torch.Generator` seeded with `seed`.
    """
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    n = torch.arange(samples, dtype=torch.float64, device=device)
    x = torch.complex(torch.randn((streams, samples), generator=gen, device=device),
                      torch.randn((streams, samples), generator=gen, device=device))
    x *= DDC_NOISE_STD
    for offset in (DDC_TONE_OFFSET_HZ, DDC_INTERFERER_OFFSET_HZ):
        cycles = torch.remainder((DDC_CENTER_HZ + offset) / DDC_RATE_HZ * n, 1.0)
        start = 2.0 * math.pi * torch.rand((streams, 1), generator=gen, device=device,
                                           dtype=torch.float64)
        x += torch.polar(torch.ones_like(cycles), 2.0 * math.pi * cycles + start).to(IQ_DTYPE)
    return x


def _tone_amplitude(y: torch.Tensor, freq_hz: float, sample_rate: float) -> torch.Tensor:
    """|mean(y · e^{-j2πf·m/fs})| per row, in float64."""
    m = torch.arange(y.shape[-1], dtype=torch.float64, device=y.device)
    ref = torch.polar(torch.ones_like(m),
                      -2.0 * math.pi * torch.remainder(freq_hz / sample_rate * m, 1.0))
    return torch.abs(torch.mean(y.to(torch.complex128) * ref, dim=-1))


def ddc_check(y: torch.Tensor) -> dict:
    """Hold a DDC output of `ddc_signal` to its bars; raise if any stream fails.

    The tone must come back at amplitude 1 ± 0.02 (64 output samples
    skipped at each end), its spectral peak must be the bin nearest
    +120 kHz, and the interferer, measured as the output correlated with
    its own aliased frequency, must be at least 50 dB below the tone.
    """
    rate = DDC_RATE_HZ / DDC_DECIMATION
    alias = (DDC_INTERFERER_OFFSET_HZ + rate / 2) % rate - rate / 2
    seg = y[..., DDC_EDGE:y.shape[-1] - DDC_EDGE]
    tone = _tone_amplitude(seg, DDC_TONE_OFFSET_HZ, rate)
    interferer = _tone_amplitude(seg, alias, rate)
    rejection_db = 20.0 * torch.log10(tone / interferer)
    want_bin = round(DDC_TONE_OFFSET_HZ / rate * y.shape[-1]) % y.shape[-1]
    peak_bin = torch.argmax(torch.abs(torch.fft.fft(y, dim=-1)), dim=-1)
    result = {"tone_amplitude": [float(tone.min()), float(tone.max())],
              "rejection_db": float(rejection_db.min()),
              "peak_bin": want_bin}
    if float(torch.max(torch.abs(tone - 1.0))) > DDC_AMPLITUDE_TOL:
        raise AssertionError(f"DDC tone amplitude outside 1 ± {DDC_AMPLITUDE_TOL}: {result}")
    if not bool(torch.all(peak_bin == want_bin)):
        raise AssertionError(f"DDC spectral peak not at bin {want_bin}: "
                             f"{sorted(set(peak_bin.tolist()))}")
    if result["rejection_db"] < DDC_REJECTION_DB:
        raise AssertionError(f"DDC interferer rejection below {DDC_REJECTION_DB} dB: {result}")
    return result


def ddc_bench(device=DEFAULT_DEVICE, seed: int = 0) -> dict:
    """Digital down-conversion of 64 streams × 2^20 complex64 samples.

    The input (`ddc_signal`, 512 MiB) sits at 30.72 MS/s; the DDC mixes
    7.68 MHz to baseband and decimates by 8 through its default 63-tap
    lowpass, giving 64 × 2^17 samples (64 MiB). One warm-up call, then one
    call timed with CUDA events; raises unless every stream passes
    `ddc_check`. Returns ``msps`` (input Msamples/s), ``compute_s``
    (seconds of the timed call), the checks' numbers and the shapes.
    """
    device = torch.device(device)
    _require_cuda("ddc_bench", device)
    x = ddc_signal(device, seed)

    def run():
        return digital_down_convert(x, DDC_CENTER_HZ, DDC_RATE_HZ, DDC_DECIMATION)

    run()  # warm-up: builds the kernels
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    y = run()
    end.record()
    end.synchronize()
    compute_s = start.elapsed_time(end) / 1e3
    checks = ddc_check(y)
    return {"msps": x.numel() / compute_s / 1e6, "compute_s": compute_s, **checks,
            "streams": x.shape[0], "samples": x.shape[1], "decimation": DDC_DECIMATION,
            "out_samples": y.shape[-1]}


def gps_pvt_fix(device=DEFAULT_DEVICE, duration_s: float = 24.3, cn0_dbhz: float = 48.0) -> dict:
    """The GPS L1 C/A decoded-ephemeris gate on `device`.

    Six satellites at `cn0_dbhz` with LNAV (SF4 filler, then SF1-3) at
    4.092 MS/s for `duration_s`: scenario on the device, acquisition over a
    12 ms slice, six tracking channels over the whole capture, LNAV decode
    and the position and velocity solve on the host. Returns the receiver's
    dict: ``value`` (position error, m), ``pass``, ``acquired``,
    ``decoded``, ``velocity``, ``per_sv`` records, and ``gen_s``,
    ``acquire_s`` and ``track_s``, wall times that each end in a device
    synchronisation.
    """
    return gps.main_decoded(duration_s, cn0_dbhz, device=device)


def galileo_pvt(device=DEFAULT_DEVICE, cn0_dbhz: float = 48.0,
                duration_s: float = gal.DURATION_S) -> dict:
    """The Galileo E1B decoded-ephemeris gate on `device`.

    Six satellites at `cn0_dbhz` with I/NAV (a filler part, then the pages
    of words 1-5) at 5.115 MS/s for `duration_s`: scenario on the device,
    acquisition over 12 epochs with a 4-sub-phase CBOC bank, an open-loop
    Doppler refine and code sweep, six Costas channels over the whole
    capture, the I/NAV pages of each channel decoded in one batched
    Viterbi call on the device, words, ephemeris and the position solve
    on the host. Returns the receiver's dict: ``value`` (position error,
    m), ``pass``, ``acquired``, ``decoded``, ``per_sv`` records, and
    ``gen_s``, ``acquire_s``, ``track_s`` and ``decode_s``, wall times
    that each end in a device synchronisation.
    """
    return gal.main(cn0_dbhz, device=device, duration_s=duration_s)


def dual_pvt(device=DEFAULT_DEVICE, cn0_dbhz: float = 48.0,
             duration_s: float = dual.DURATION_S) -> dict:
    """The joint GPS + Galileo gate on `device`.

    Five GPS L1 C/A and five Galileo E1B satellites in one capture at
    5.115 MS/s for `duration_s`; both receivers on the same samples, LNAV
    and I/NAV decoded, then the joint fix (one clock state per system),
    the GPS-only and Galileo-only fixes, the velocity and a truth-position
    control. Returns ``value`` (joint error, m), ``pass``, ``decoded``,
    ``joint`` (with ``isb_m``), ``gps_only``, ``galileo_only``,
    ``velocity``, ``per_sv`` and the stage times.
    """
    return dual.main(cn0_dbhz, duration_s, device=device)


def glonass_track(device=DEFAULT_DEVICE, cn0_dbhz: float = 45.0,
                  duration_s: float = glo.DURATION_S) -> dict:
    """The GLONASS L1OF FDMA gate on `device`.

    Six satellites on channels k = −3…+2 at 6.132 MS/s for `duration_s`:
    the exact integer-phase mixdown to a (6, N) baseband bank, PCPS per
    channel with the shared m-sequence, six Costas channels in one
    tracking call, then per channel the lock, Doppler error and 20 ms bit
    match. Returns ``value`` (channels OK), ``pass``, ``per_ch`` and the
    stage times.
    """
    return glo.main(cn0_dbhz, duration_s, device=device)


def pcps_inputs(device=DEFAULT_DEVICE, seed: int = 7):
    """(x, codes) of `pcps_bench`: 4092 complex64 samples of unit-variance
    noise per component from `np.random.default_rng(seed)` and the C/A codes
    of PRN 1-8 at 2 samples a chip, (8, 2046) float32, on `device`."""
    device = torch.device(device)
    codes = np.stack([np.repeat(prn.gps_ca_code(p + 1), 2).astype(np.float32)
                      for p in range(PCPS_PRNS)])
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(4092) + 1j * rng.standard_normal(4092)).astype(np.complex64)
    return torch.from_numpy(x).to(device), torch.from_numpy(codes).to(device)


def pcps_bench(device=DEFAULT_DEVICE, seed: int = 7) -> dict:
    """PCPS correlator throughput through `acquisition.pcps_grid`.

    8 PRNs × 41 Doppler bins (±5 kHz, 250 Hz steps) × 2046 code phases,
    two code periods summed non-coherently. One warm-up call, then
    `PCPS_CALLS` back-to-back calls timed with CUDA events. Returns
    ``mcorr_per_s`` (PRNs × Doppler bins × phases per second, in
    millions), ``ms_per_call`` and the grid's shape.
    """
    device = torch.device(device)
    _require_cuda("pcps_bench", device)
    x, codes = pcps_inputs(device, seed)
    grid = acquisition.pcps_grid(x, codes, PCPS_RATE_HZ, PCPS_CONFIG)  # warm-up
    if not bool(torch.isfinite(grid).all()):
        raise AssertionError("pcps_bench: the grid is not finite")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(PCPS_CALLS):
        acquisition.pcps_grid(x, codes, PCPS_RATE_HZ, PCPS_CONFIG)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / PCPS_CALLS
    cells = grid.numel()
    return {"mcorr_per_s": cells / ms / 1e3, "ms_per_call": ms, "shape": list(grid.shape),
            "calls": PCPS_CALLS}


def ber_gate(device=DEFAULT_DEVICE, n_bits: int = 1_000_000, seed: int = 0) -> dict:
    """The BER-vs-theory acceptance gate on `device`.

    `ber.DEFAULT_GATE_POINTS` (BPSK, QPSK, 8PSK, 16- and 64-QAM and
    noncoherent BFSK at two or three Eb/N0 points each), `n_bits` bits a
    point. Returns ``results`` (every `ber.BerGateResult`),
    ``worst_deviation`` (the largest |measured − theory| / theory) and
    ``pass`` (worst deviation under 10%).
    """
    results = ber.ber_acceptance_report(ber.DEFAULT_GATE_POINTS, n_bits, seed, device)
    worst = max(r.deviation for r in results)
    return {"results": results, "worst_deviation": worst, "pass": worst < 0.10}


def packet_capture(params: lora.LoRaParams, payload: bytes, cfo_hz: float = 0.0,
                   seed: int = 0, device=DEFAULT_DEVICE) -> torch.Tensor:
    """1-D complex64 capture on `device`: `PACKET_GAP_SAMPLES` of noise of std
    `PACKET_GAP_STD` a component (from `np.random.default_rng(seed)`), then
    the packet of `payload` (header, payload, CRC-16) modulated with its
    preamble, all turned by `cfo_hz`."""
    device = torch.device(device)
    frame = packet.build_packet(payload, device=device)
    tx = lora.modulate(params, frame, include_preamble=True, device=device)
    rng = np.random.default_rng(seed)
    gap = PACKET_GAP_STD * (rng.standard_normal(PACKET_GAP_SAMPLES)
                            + 1j * rng.standard_normal(PACKET_GAP_SAMPLES))
    rx = torch.cat([torch.from_numpy(gap.astype(np.complex64)).to(device), tx])
    if cfo_hz:
        t = torch.arange(rx.shape[-1], dtype=torch.float64, device=device) / params.sample_rate
        turn = torch.polar(torch.ones_like(t), 2.0 * math.pi * cfo_hz * t)
        rx = (rx.to(torch.complex128) * turn).to(IQ_DTYPE)
    return rx


def lora_packet_roundtrip(sf: int = 7, cfo_hz: float = 0.0, seed: int = 0,
                          device=DEFAULT_DEVICE) -> dict:
    """One LoRa packet through a capture and back, on `device`.

    `PACKET_PAYLOAD_BYTES` random bytes from `np.random.default_rng(seed)`
    are framed by `packet.build_packet`, modulated with their preamble
    behind a noise gap (`packet_capture`), found and CFO-corrected by
    `sync.synchronize`, demodulated and parsed. Returns ``sent``,
    ``payload`` (b'' when nothing is found), ``crc_ok``, ``detected``,
    ``frame_start``, ``gap``, ``cfo_hz`` (the estimate), ``cfo_true_hz``
    and ``samples``.
    """
    device = torch.device(device)
    params = lora.LoRaParams(sf=sf)
    payload = np.random.default_rng(seed).integers(0, 256, PACKET_PAYLOAD_BYTES,
                                                   dtype=np.uint8).tobytes()
    rx = packet_capture(params, payload, cfo_hz, seed, device)
    aligned, res = sync.synchronize(params, rx)
    got, crc_ok = b"", None
    if aligned is not None:
        out = lora.demodulate(params, aligned)
        got, crc_ok = packet.parse_packet(out.payload.cpu().numpy(), device=device)
    return {"sent": payload, "payload": got, "crc_ok": crc_ok, "detected": bool(res.detected),
            "frame_start": int(res.frame_start), "gap": PACKET_GAP_SAMPLES,
            "cfo_hz": float(res.cfo_hz), "cfo_true_hz": cfo_hz, "samples": rx.shape[-1]}


def gcorr_inputs(device=DEFAULT_DEVICE, seed: int = 0):
    """(x, carriers, code_fft) of `pcps_gcorr_bench` on `device`: two C/A
    periods of unit-variance noise a component from
    `np.random.default_rng(seed)` (2046,) complex64; the Doppler wipe-offs
    e^{-j2π·f·t} (41, 2046), float32 phase; the conjugate 4096-point
    transforms of the 50-slot bank of C/A codes, PRN 1 + p mod 32 (50, 4096)."""
    device = torch.device(device)
    n = 2 * GCORR_LAGS
    rng = np.random.default_rng(seed)
    re = rng.standard_normal((n,), dtype=np.float32)
    im = rng.standard_normal((n,), dtype=np.float32)
    x = torch.complex(torch.from_numpy(re), torch.from_numpy(im)).to(device)
    dops = (torch.arange(GCORR_DOPPLER_BINS, dtype=REAL_DTYPE, device=device)
            * GCORR_DOPPLER_STEP_HZ - GCORR_DOPPLER_BINS // 2 * GCORR_DOPPLER_STEP_HZ)
    t = (torch.arange(n, dtype=REAL_DTYPE, device=device)
         / torch.full((), GCORR_RATE_HZ, dtype=REAL_DTYPE, device=device))
    ang = -2.0 * math.pi * dops[:, None] * t[None, :]
    carriers = torch.complex(torch.cos(ang), torch.sin(ang))
    codes = np.stack([prn.gps_ca_code(1 + p % 32) for p in range(GCORR_SLOTS)]).astype(np.float32)
    code_fft = torch.conj(torch.fft.fft(torch.from_numpy(codes).to(device).to(IQ_DTYPE),
                                        GCORR_NFFT, dim=-1)).resolve_conj()
    return x, carriers, code_fft


def gcorr_step(x: torch.Tensor, carriers: torch.Tensor, code_fft: torch.Tensor):
    """One iteration of `pcps_gcorr_bench`: the (50, 41, 1023) correlation
    power of `x` against every code and Doppler bin, and the next `x`,
    x·(1 + 1e-12·peak), which chains the iterations on the surface."""
    mf = torch.fft.fft(x[None, :] * carriers, GCORR_NFFT, dim=-1)
    surf = torch.fft.ifft(mf[None] * code_fft[:, None, :], dim=-1)[..., :GCORR_LAGS]
    power = surf.real ** 2 + surf.imag ** 2
    return x * (1.0 + 1e-12 * torch.amax(power)), power


def pcps_gcorr_bench(device=DEFAULT_DEVICE, iters: int = GCORR_ITERS, seed: int = 0) -> dict:
    """Big-grid PCPS throughput: a 50-slot C/A bank (the 32 distinct codes,
    18 repeated) × 41 Doppler bins × 1023 lags, 4096-point transforms.

    One warm-up iteration, then `iters` iterations chained through x, issued
    from a Python loop of cuFFT calls with no host synchronisation inside
    and timed with CUDA events. Returns ``gcorr_per_s`` (slots × bins × lags
    × iters per second, in billions), ``compute_s``, ``ms_per_iter``,
    ``energy`` (Σ|x|² at the end, finite) and the grid's shape.
    """
    device = torch.device(device)
    _require_cuda("pcps_gcorr_bench", device)
    x, carriers, code_fft = gcorr_inputs(device, seed)
    gcorr_step(x, carriers, code_fft)  # warm-up: plans the transforms
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        x, _ = gcorr_step(x, carriers, code_fft)
    end.record()
    end.synchronize()
    compute_s = start.elapsed_time(end) / 1e3
    energy = float(torch.sum(x.real ** 2 + x.imag ** 2))
    if not math.isfinite(energy):
        raise AssertionError(f"pcps_gcorr_bench: x is not finite after {iters} iterations")
    cells = GCORR_SLOTS * GCORR_DOPPLER_BINS * GCORR_LAGS * iters
    return {"gcorr_per_s": cells / compute_s / 1e9, "compute_s": compute_s,
            "ms_per_iter": 1e3 * compute_s / iters, "energy": energy, "iters": iters,
            "shape": [GCORR_SLOTS, GCORR_DOPPLER_BINS, GCORR_LAGS], "nfft": GCORR_NFFT}


# --------------------------------------------------------------------------
# The waveform fleet
# --------------------------------------------------------------------------


def sweep_round(name: str, device=DEFAULT_DEVICE):
    """One waveform through `tools/device_sweep.py`'s probe on `device`:
    `create_waveform(name, 48 kHz)`, modulate `SWEEP_MESSAGE`, copy the IQ
    to host numpy, back to the device, demodulate. Returns (host IQ, the
    `DemodResult`)."""
    device = resolve_device(device)
    wf = create_waveform(name, SWEEP_RATE_HZ, device)
    iq = wf.modulate(SWEEP_MESSAGE).cpu().numpy()
    return iq, wf.demodulate(torch.from_numpy(iq).to(device))


def device_sweep(device=DEFAULT_DEVICE) -> dict:
    """Every factory waveform through `sweep_round` on `device`, in
    `list_waveforms()` order. A name whose round raises is recorded in
    ``failures`` (name and exception) and the sweep goes on, as the
    reference's does.

    Returns ``ok``, ``attempted``, ``total``, ``failures``, and per name
    ``samples`` (the IQ length), ``warm_ms`` (a second round, host clock
    to a device synchronisation) and, for the names that carry data,
    ``bytes_back`` (whether the first bytes equal `SWEEP_MESSAGE`)."""
    device = resolve_device(device)
    names = list_waveforms()
    out = {"ok": 0, "attempted": 0, "total": len(names), "failures": [], "samples": {},
           "warm_ms": {}, "bytes_back": {}, "device": str(device)}
    for name in names:
        out["attempted"] += 1
        try:
            iq, res = sweep_round(name, device)
            _synchronize(device)
            t0 = time.perf_counter()
            sweep_round(name, device)
            _synchronize(device)
            out["warm_ms"][name] = (time.perf_counter() - t0) * 1e3
        except Exception as exc:  # recorded in the result, as bench_device_sweep does
            out["failures"].append(f"{name}: {type(exc).__name__}: {exc}")
            continue
        out["ok"] += 1
        out["samples"][name] = int(iq.shape[-1])
        if create_waveform(name, SWEEP_RATE_HZ, device).info().carries_data:
            got = res.bits[: len(SWEEP_MESSAGE)].cpu().numpy().astype(np.uint8).tobytes()
            out["bytes_back"][name] = got == SWEEP_MESSAGE
    return out


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reference_awgn(samples: torch.Tensor, snr_db: float, seed: int) -> torch.Tensor:
    """`awgn` with the noise the reference's ``awgn(jax.random.key(seed),
    ...)`` draws for samples of this shape (`channel.threefry`, on the
    host), on the samples' device."""
    return awgn(samples, snr_db, key=threefry.key(seed))


def analog_error(got: np.ndarray, ref: np.ndarray) -> float:
    """Mean |got - ref| of demodulated audio bytes at the best of the
    reference's alignments (0-1 samples off `got`, 0-2 off `ref`: slack for
    filter group-delay transients)."""
    got, ref = got.astype(np.float64), ref.astype(np.float64)
    best = np.inf
    for goff in range(2):
        for roff in range(3):
            n = min(len(got) - goff, len(ref) - roff)
            if n >= 2:
                best = min(best, float(np.mean(np.abs(got[goff:goff + n] - ref[roff:roff + n]))))
    return best


def fmcw_echo(wf, tx: torch.Tensor, range_m: float) -> torch.Tensor:
    """`tx` delayed by the round trip to a target at `range_m`, in whole
    samples, the head filled with zeros."""
    delay = int(round(2 * range_m / SPEED_OF_LIGHT * wf.common.sample_rate))
    return torch.cat([torch.zeros(delay, dtype=tx.dtype, device=tx.device),
                      tx[: tx.shape[-1] - delay]])


def fleet_noisy_gate(device=DEFAULT_DEVICE, seed: int = 3) -> dict:
    """Every factory name through AWGN on `device`, the noise of each case
    the reference's own draw for ``jax.random.key(seed)`` (`reference_awgn`):
    the reference's matrix passes on key 3 alone for some names (3G-ALE,
    P25 and NBFM decode on 45-75% of other draws at their SNRs, in either
    package), so the port is held to the reference's gate on the
    reference's noise.

    Digital names (`DIGITAL_SNR`) must return `NOISY_DATA` bit-exact at
    their SNR and rate; CW's frequency within 10 Hz of 1000 Hz at 10 dB;
    AM, FM and NBFM's audio bytes within their mean-|err| bars; FMCW's
    range of a 1500 m echo at 0 dB within two range bins; each beacon must
    detect its sweep at 10 dB. Returns per-name ``results`` (a dict with
    ``ok`` and the measured value), ``failures``, ``covered`` (the matrix
    covers `list_waveforms()` exactly) and ``ok``."""
    device = resolve_device(device)
    results = {}
    for name, (snr, rate) in DIGITAL_SNR.items():
        wf = create_waveform(name, rate, device) if rate else create_waveform(name, device=device)
        rx = reference_awgn(wf.modulate(NOISY_DATA), snr, seed)
        got = wf.demodulate(rx).bits[: len(NOISY_DATA)].cpu().numpy().astype(np.uint8).tobytes()
        results[name] = {"ok": got == NOISY_DATA, "snr_db": snr, "bytes": got.hex()}

    wf = create_waveform("CW", device=device)
    freq = wf.demodulate(reference_awgn(wf.modulate(b""), CW_SNR_DB, seed)).metadata["frequency"]
    results["CW"] = {"ok": abs(freq - 1000.0) < CW_FREQ_TOL_HZ, "frequency_hz": freq}

    for name, (snr, bar) in ANALOG_BARS.items():
        wf = create_waveform(name, device=device)
        rx = reference_awgn(wf.modulate(NOISY_DATA), snr, seed)
        err = analog_error(wf.demodulate(rx).bits.cpu().numpy(),
                           np.frombuffer(NOISY_DATA, np.uint8))
        results[name] = {"ok": err < bar, "mean_abs_err": err, "bar": bar}

    wf = create_waveform("FMCW", FMCW_RATE_HZ, device)
    echo = reference_awgn(fmcw_echo(wf, wf.modulate(), FMCW_RANGE_M), FMCW_SNR_DB, seed)
    range_m = wf.estimate_range(echo)
    bin_m = SPEED_OF_LIGHT / (2 * wf.sweep_bandwidth)
    results["FMCW"] = {"ok": abs(range_m - FMCW_RANGE_M) < 2 * bin_m, "range_m": range_m,
                       "range_bin_m": bin_m}

    for name in ("ELT-121.5", "EPIRB-121.5", "PLB-121.5", "Beacon-243"):
        wf = create_waveform(name, device=device)
        md = wf.demodulate(reference_awgn(wf.modulate(NOISY_DATA), BEACON_SNR_DB,
                                          seed)).metadata
        results[name] = {"ok": (md["sweep_detected"] == 1.0
                                and md["audio_freq_max"] > md["audio_freq_min"]), **md}

    covered = set(DIGITAL_SNR) | FUNCTIONAL == set(list_waveforms()) == set(results)
    failures = sorted(name for name, r in results.items() if not r["ok"])
    return {"ok": covered and not failures, "covered": covered, "failures": failures,
            "results": results, "device": str(device)}


def noisy_pass_rates(device=DEFAULT_DEVICE, seeds=range(40)) -> dict:
    """How far above its threshold each SNR of the noisy matrix sits: for
    every digital name (`DIGITAL_SNR`) and analog name (`ANALOG_BARS`), the
    share of `seeds` on which a fresh `torch.Generator(device).manual_seed(s)`
    draw passes the name's bar at its SNR. A measurement, not a gate."""
    device = resolve_device(device)
    cases = {name: (snr, rate, None) for name, (snr, rate) in DIGITAL_SNR.items()}
    cases.update({name: (snr, None, bar) for name, (snr, bar) in ANALOG_BARS.items()})
    rates = {}
    for name, (snr, rate, bar) in cases.items():
        wf = create_waveform(name, rate, device) if rate else create_waveform(name, device=device)
        tx = wf.modulate(NOISY_DATA)
        passed = 0
        for seed in seeds:
            rx = awgn(tx, snr, generator=torch.Generator(device=device).manual_seed(seed))
            got = wf.demodulate(rx).bits.cpu().numpy()
            if bar is None:
                passed += got[: len(NOISY_DATA)].astype(np.uint8).tobytes() == NOISY_DATA
            else:
                passed += analog_error(got, np.frombuffer(NOISY_DATA, np.uint8)) < bar
        rates[name] = passed / len(seeds)
    return rates


def sincgars_data_roundtrip(device=DEFAULT_DEVICE, n_bytes: int = 2048, mode_bps: int = 1200,
                            snr_db: float = 10.0, seed: int = 4) -> dict:
    """A file transfer over SINCGARS data mode on `device`.

    `n_bytes` random bytes from `np.random.default_rng(seed)` are framed
    (`SincgarsDataFramer`, FEC on: 71-byte payloads at 1200 bps), coded,
    hopped through the SINCGARS PHY, put through AWGN at `snr_db` (a
    `torch.Generator(device).manual_seed(seed)` draw), demodulated and
    deframed, every frame a lane of one Viterbi decode. Returns
    ``frames`` (sent), ``crc_ok`` (frames back with their CRC good),
    ``sequences``, ``payload_equal``, ``samples``, ``frame_bits``,
    ``decode_s`` (demodulate and deframe, host clock to the frames on the
    host) and ``launches`` (Viterbi kernel launches in the decode)."""
    device = resolve_device(device)
    data = np.random.default_rng(seed).integers(0, 256, n_bytes, dtype=np.uint8).tobytes()
    radio = create_waveform("SINCGARS", device=device)
    iq, frame_bits = milfh.sincgars_modulate_data(radio, data, mode_bps)
    rx = awgn(iq, snr_db, generator=torch.Generator(device=device).manual_seed(seed))
    _synchronize(device)
    before = (viterbi.viterbi_forward.launches, viterbi.viterbi_traceback.launches)
    t0 = time.perf_counter()
    frames = milfh.sincgars_demodulate_data(radio, rx, frame_bits, mode_bps)
    decode_s = time.perf_counter() - t0
    sent = -(-n_bytes // milfh.SincgarsDataFramer(mode_bps).max_payload_size())
    return {"frames": sent, "crc_ok": len(frames), "sequences": [f.sequence for f in frames],
            "payload_equal": b"".join(f.payload for f in frames) == data,
            "samples": int(iq.shape[-1]), "frame_bits": frame_bits, "decode_s": decode_s,
            "launches": {"viterbi_forward": viterbi.viterbi_forward.launches - before[0],
                         "viterbi_traceback": viterbi.viterbi_traceback.launches - before[1]},
            "device": str(device)}


def channel_bench(device=DEFAULT_DEVICE, seed: int = 8, iters: int = CHANNEL_ITERS) -> dict:
    """AWGN apply throughput: ``bench.py``'s ``bench_channel`` on the card.

    2^18 complex64 samples from `np.random.default_rng(seed)` go through
    `iters` chained applications of `awgn(·, 20 dB)` on Philox, each
    times 1/√1.01 to undo the 1% power the noise adds, timed with CUDA
    events after a short warm-up. Returns ``msamples_per_s``,
    ``compute_s``, the shape and the final mean power (which must stay
    finite and near the input's). ``bench.py`` also times a hardware-RNG
    key of JAX's; that variant has no counterpart here."""
    device = torch.device(device)
    _require_cuda("channel_bench", device)
    rng = np.random.default_rng(seed)
    re = rng.standard_normal(CHANNEL_SAMPLES, dtype=np.float32)
    im = rng.standard_normal(CHANNEL_SAMPLES, dtype=np.float32)
    v0 = torch.complex(torch.from_numpy(re), torch.from_numpy(im)).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    scale = float(np.float32(1.0 / np.sqrt(1.01)))

    def run(v, n):
        for _ in range(n):
            v = awgn(v, CHANNEL_SNR_DB, generator=gen) * scale
        return torch.mean(v.real ** 2 + v.imag ** 2)

    run(v0, 16)  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    power = run(v0, iters)
    end.record()
    end.synchronize()
    compute_s = start.elapsed_time(end) / 1e3
    return {"msamples_per_s": CHANNEL_SAMPLES * iters / compute_s / 1e6,
            "compute_s": compute_s, "samples": CHANNEL_SAMPLES, "iters": iters,
            "mean_power": float(power), "device": str(device)}


def fading_case(case, device=DEFAULT_DEVICE, generator: torch.Generator | None = None) -> dict:
    """One `FADING_CASES` row on `device`: modulate its payload, apply its
    channel (the reference's threefry draws for the row's key, or
    `generator`'s), demodulate. Returns ``ok`` (the payload back) and the
    bytes."""
    name, rate, model, profile, snr, doppler, data, key = case
    wf = create_waveform(name, rate, device)
    cfg = ChannelConfig(model=model, snr_db=snr, sample_rate=rate, doppler_hz=doppler,
                        tdl_profile=profile)
    tx = wf.modulate(data)
    rx = (apply_channel(tx, cfg, generator=generator) if generator is not None
          else apply_channel(tx, cfg, key=threefry.key(key)))
    got = wf.demodulate(rx).bits[: len(data)].cpu().numpy().astype(np.uint8).tobytes()
    return {"ok": got == data, "bytes": got.hex()}


def two_ray_fde_case(device=DEFAULT_DEVICE, generator: torch.Generator | None = None) -> dict:
    """`TWO_RAY_FDE_CASE` on `device` (tests/test_fleet_fading.py:36-75): a
    QPSK burst behind a known preamble through a static 2-ray channel and
    AWGN (the reference's key-9 draws, or `generator`'s), the channel
    estimated by `propagation.ls_channel_estimate` on the preamble and
    equalised by `propagation.sparse_multipath_equalize`. Returns ``ok``
    (the payload back and the estimate's 2-ray structure: main tap within
    0.1 of 1, an echo over 0.7), the bytes, the taps and the estimate."""
    from r4w_tpu_torch.channel import multipath_2ray
    from r4w_tpu_torch.ops import propagation

    name, rate, delay, amplitude, snr, data, key = TWO_RAY_FDE_CASE
    device = resolve_device(device)
    wf = create_waveform(name, rate, device)
    # the reference's bytes() of an int64 array: each draw then 7 zero bytes
    preamble = bytes(np.random.default_rng(0).integers(0, 256, 16))
    tx_pre = wf.modulate(preamble)
    tx = torch.cat([tx_pre, wf.modulate(data)])
    rx = multipath_2ray(tx, delay, amplitude)
    rx = (awgn(rx, snr, generator=generator) if generator is not None
          else awgn(rx, snr, key=threefry.key(key)))
    h = propagation.ls_channel_estimate(tx_pre[:TWO_RAY_PILOT], rx[:TWO_RAY_PILOT],
                                        n_taps=TWO_RAY_TAPS)
    h_host = h.cpu().numpy()
    taps = [(i, complex(h_host[i])) for i in range(TWO_RAY_TAPS)
            if abs(h_host[i]) > TWO_RAY_TAP_MIN]
    pad = (-rx.shape[0]) % TWO_RAY_NFFT
    rx_p = torch.cat([rx, torch.zeros(pad, dtype=rx.dtype, device=device)])
    eq = propagation.sparse_multipath_equalize(rx_p, taps, n_fft=TWO_RAY_NFFT)
    got = (wf.demodulate(eq[tx_pre.shape[0]:]).bits[: len(data)].cpu().numpy()
           .astype(np.uint8).tobytes())
    structure = abs(abs(h_host[0]) - 1.0) < 0.1 and float(np.max(np.abs(h_host[1:]))) > 0.7
    return {"ok": got == data and structure, "bytes": got.hex(), "taps": taps, "estimate": h_host}


def fading_gate(device=DEFAULT_DEVICE, seeds=range(20)) -> dict:
    """OFDM, LoRa-SF7, DSSS and BFSK through TDL fading on `device`
    (`FADING_CASES`: OFDM through ``tdl_awgn`` EPA and ``freq_selective``
    EVA at 1 MS/s, 25 dB, 5 Hz Doppler, key 11; the others through EPA at
    2 Hz, key 3), and QPSK through a static 2-ray channel with the LS
    estimate and the frequency-domain equaliser (`two_ray_fde_case`), each
    on the reference's own draws for its key: the payload must come back.
    Then, as information and not a gate, the share of fresh Philox draws
    (``torch.Generator(device).manual_seed(s)`` for `seeds`) on which each
    case decodes. Returns ``ok``, per-case ``results`` and ``pass_rates``,
    keyed "name model" (`TWO_RAY_LABEL` for the 2-ray case)."""
    device = resolve_device(device)
    runs = [(f"{case[0]} {case[2]} {case[3]}", functools.partial(fading_case, case))
            for case in FADING_CASES] + [(TWO_RAY_LABEL, two_ray_fde_case)]
    results, rates = {}, {}
    for label, run in runs:
        results[label] = run(device)
        passed = sum(run(device, torch.Generator(device=device).manual_seed(s))["ok"]
                     for s in seeds)
        rates[label] = passed / len(seeds)
    return {"ok": all(r["ok"] for r in results.values()), "results": results,
            "pass_rates": rates, "device": str(device)}


def _bpsk(bits: torch.Tensor, rng: np.random.Generator, sigma: float) -> np.ndarray:
    """(1 - 2·bits) + N(0, sigma²) on the host in float64, the JAX tests' channel."""
    b = bits.cpu().numpy()
    return (1 - 2.0 * b) + rng.normal(0, sigma, b.shape)


def _ldpc_case(device) -> dict:
    """tests/test_fec.py:133: the (96, 3, 6) code, 4 frames at 2 dB."""
    code = ldpc.ldpc_code(ldpc.make_regular_ldpc(96, 3, 6), device)
    rng = np.random.default_rng(6)
    u = rng.integers(0, 2, (4, code.k))
    c = ldpc.ldpc_encode(torch.from_numpy(u).to(device), code)
    sigma = np.sqrt(1 / (2 * 10 ** (2.0 / 10)))
    llr = torch.from_numpy((2 * _bpsk(c, rng, sigma) / sigma ** 2).astype(np.float32)).to(device)
    hard, ok = ldpc.ldpc_decode(llr, code)
    data = ldpc.ldpc_extract_data(hard, code).cpu().numpy()
    return {"ok": bool(ok.all()) and np.array_equal(data, u), "decisions": hard.cpu().numpy(),
            "frames_ok": int(ok.sum())}


def _turbo_case(device) -> dict:
    """tests/test_fec.py:148: N = 128 at 0 dB, 6 iterations."""
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2, 128)
    sys_, p1, p2, pi = turbo.turbo_encode(torch.from_numpy(bits).to(device))
    sigma = np.sqrt(1 / (2 * 10 ** (0.0 / 10)))
    llrs = [2 * _bpsk(x, rng, sigma) / sigma ** 2 for x in (sys_, p1, p2)]
    raw = int(((llrs[0] < 0).astype(int) != bits).sum())
    hard, _ = turbo.turbo_decode(*[torch.from_numpy(x.astype(np.float32)).to(device)
                                   for x in llrs], pi)
    errors = int((hard.cpu().numpy() != bits).sum())
    return {"ok": raw > 0 and errors == 0, "decisions": hard.cpu().numpy(), "raw_errors": raw,
            "errors": errors}


def _polar_case(device) -> dict:
    """tests/test_fec.py:163: (128, 64), clean and at 6 dB."""
    n, k = 128, 64
    rng = np.random.default_rng(8)
    bits = rng.integers(0, 2, k)
    cw = polar.polar_encode(torch.from_numpy(bits).to(device), n, k)
    clean = polar.polar_decode((1.0 - 2.0 * cw.cpu().numpy()) * 10.0, n, k)
    sigma = np.sqrt(1 / (2 * 10 ** (6.0 / 10)))
    noisy = polar.polar_decode(2 * _bpsk(cw, rng, sigma) / sigma ** 2, n, k)
    errors = int((noisy != bits).sum())
    return {"ok": np.array_equal(clean, bits) and errors == 0, "decisions": noisy,
            "codeword": cw.cpu().numpy(), "errors": errors}


def _conv_case(device) -> dict:
    """tests/test_fec.py:195: K=7 rate 1/2, 2000 bits at 3 dB, coded BER
    below uncoded BPSK's."""
    rng = np.random.default_rng(9)
    n_bits, ebn0_db = 2000, 3.0
    bits = rng.integers(0, 2, n_bits)
    coded = conv_encode(torch.from_numpy(bits).to(device))
    sigma_c = np.sqrt(1 / (2 * 10 ** ((ebn0_db - 3.0) / 10)))
    noisy = torch.from_numpy(_bpsk(coded, rng, sigma_c).astype(np.float32)).to(device)
    dec = viterbi_decode(noisy, soft=True).cpu().numpy()
    coded_ber = float((dec != bits).mean())
    sigma_u = np.sqrt(1 / (2 * 10 ** (ebn0_db / 10)))
    rx_u = (1 - 2.0 * bits) + rng.normal(0, sigma_u, n_bits)
    uncoded_ber = float(((rx_u < 0).astype(int) != bits).mean())
    return {"ok": coded_ber < uncoded_ber, "decisions": dec, "coded_ber": coded_ber,
            "uncoded_ber": uncoded_ber}


def _tcm_case(device, n_bits: int = TCM_GATE_BITS) -> dict:
    """tests/test_fec.py:270: TCM below half uncoded QPSK's BER at 5 dB,
    QPSK above 1e-3, over `n_bits` bits (seed 2); with the received
    symbols and TCM's decisions."""
    run = tcm.tcm_coding_gain_run(TCM_GATE_EBN0_DB, n_bits, seed=2, device=device)
    tcm_ber, qpsk_ber = run["tcm_ber"], run["qpsk_ber"]
    return {"ok": tcm_ber < 0.5 * qpsk_ber and qpsk_ber > 1e-3, "decisions": run["decisions"],
            "symbols": run["rx"].cpu().numpy(), "tcm_ber": tcm_ber, "qpsk_ber": qpsk_ber,
            "bits": n_bits}


def _dvb_short_cases(device) -> dict:
    """tests/test_named_blocks.py:44-56 on their module's ``RNG =
    np.random.default_rng(42)``, replayed in the file's order (its parity
    test draws one 2/3 frame first): a short frame a rate, decoded in 40
    iterations, parity ok and equal to the bits sent."""
    rng = np.random.default_rng(42)
    rng.integers(0, 2, dvb_s2x.info_bits("2/3", "short"))
    out = {}
    for rate, ebn0 in DVB_GATE_POINTS:
        u = rng.integers(0, 2, dvb_s2x.info_bits(rate, "short")).astype(np.int32)
        c = dvb_s2x.encode(torch.from_numpy(u).to(device), rate, "short")
        esn0 = 10 ** (ebn0 / 10) * dvb_s2x.CODE_RATES[rate]
        y = _bpsk(c, rng, np.sqrt(1 / (2 * esn0)))
        hard, ok = dvb_s2x.decode(torch.from_numpy((4 * esn0 * y).astype(np.float32)).to(device),
                                  rate, "short", iters=DVB_GATE_ITERS)
        hard = hard.cpu().numpy()
        out[f"dvb_s2x {rate}"] = {"ok": bool(ok) and np.array_equal(hard, u), "decisions": hard,
                                  "ebn0_db": ebn0}
    return out


def _lt_cases(device) -> dict:
    """tests/test_fountain_wavelet.py:21-44: k = 32 of n = 48 with all
    symbols, and k = 24 of n = 48 with a third of them erased."""
    out = {}
    for label, seed, k, n, width, lt_seed, kept in (("lt overhead", 0, 32, 48, 64, 5, None),
                                                    ("lt erasures", 1, 24, 48, 16, 9, 36)):
        rng = np.random.default_rng(seed)
        data = rng.integers(0, 2, (k, width)).astype(np.uint8)
        enc = fountain.lt_encode(torch.from_numpy(data).to(device), n, seed=lt_seed)
        g = fountain.lt_generator(k, n, seed=lt_seed)
        keep = rng.permutation(n)[:kept] if kept else np.arange(n)
        dec, ok = fountain.lt_decode(enc.cpu().numpy()[keep], g[keep], k)
        out[label] = {"ok": bool(ok) and np.array_equal(dec, data), "decisions": dec}
    return out


def _map_case(device) -> dict:
    """tests/test_e2e_receiver.py:139: MAP LLRs of a repetition-then-K=7
    chain, soft-combined, no worse than hard combining and below 5% errors."""
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2, 256).astype(np.int32)
    rep = np.repeat(bits, 2)
    coded = conv_encode(torch.from_numpy(rep).to(device)).cpu().numpy()
    soft = (1.0 - 2.0 * coded).astype(np.float32)
    soft += 0.8 * rng.standard_normal(len(soft)).astype(np.float32)
    llr, hard_inner = map_decode(torch.from_numpy(soft).to(device))
    llr = llr.cpu().numpy()[: len(rep)]
    soft_dec = (llr.reshape(-1, 2).sum(1) < 0).astype(np.int32)
    hard_dec = hard_inner.cpu().numpy()[: len(rep)].reshape(-1, 2)[:, 0]
    err_soft, err_hard = int((soft_dec != bits).sum()), int((hard_dec != bits).sum())
    return {"ok": err_soft <= err_hard and err_soft < 0.05 * len(bits), "decisions": soft_dec,
            "llr": llr, "errors_soft": err_soft, "errors_hard": err_hard}


def coded_link_gate(device=DEFAULT_DEVICE, tcm_bits: int = TCM_GATE_BITS) -> dict:
    """The JAX FEC tests' own inputs (their numpy seeds) through the port's
    codecs on `device`, each to its test's bar: LDPC (96, 3, 6) at 2 dB,
    turbo N = 128 at 0 dB, polar (128, 64), the convolutional coded-BER
    gate, TCM's gain at 5 dB over `tcm_bits` bits (the test's 100,000 by
    default), DVB-S2X short frames at four rates, LT with and without
    erasures, and MAP decoding into a soft chain. The host makes each
    test's noise from the codewords, as the tests do. Returns ``ok`` and
    per-case ``results`` (``ok``, the decisions, the case's numbers)."""
    device = resolve_device(device)
    results = {"ldpc": _ldpc_case(device), "turbo": _turbo_case(device),
               "polar": _polar_case(device), "conv": _conv_case(device),
               "tcm": _tcm_case(device, tcm_bits), **_dvb_short_cases(device),
               **_lt_cases(device), "map": _map_case(device)}
    return {"ok": all(r["ok"] for r in results.values()), "results": results,
            "device": str(device)}


def dvb_s2x_frames(device=DEFAULT_DEVICE, frames: int = DVB_BENCH_FRAMES,
                   rate: str = DVB_BENCH_RATE, ebn0_db: float = DVB_BENCH_EBN0_DB,
                   seed: int = 0):
    """(bits (frames, k) int32, channel LLRs (frames, 64,800) float32) of
    normal frames on `device`: Philox bits from `seed`, BPSK through AWGN
    at `ebn0_db`, LLR = 4·Es/N0·y."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    k = dvb_s2x.info_bits(rate, "normal")
    bits = torch.randint(0, 2, (frames, k), generator=gen, device=device, dtype=SYMBOL_DTYPE)
    c = dvb_s2x.encode(bits, rate, "normal")
    esn0 = 10 ** (ebn0_db / 10) * dvb_s2x.CODE_RATES[rate]
    noise = torch.randn(c.shape, generator=gen, device=device, dtype=REAL_DTYPE)
    y = (1.0 - 2.0 * c.to(REAL_DTYPE)) + noise * float(np.sqrt(1 / (2 * esn0)))
    return bits, y * float(4 * esn0)


def dvb_s2x_bench(device=DEFAULT_DEVICE, frames: int = DVB_BENCH_FRAMES,
                  iters: int = DVB_GATE_ITERS, seed: int = 0) -> dict:
    """A batch of `frames` DVB-S2X normal frames (64,800 coded bits, rate
    1/2) at 3.0 dB Eb/N0 decoded in one call of `iters` min-sum iterations
    on the card (messages (frames, 32,400, 15) float32), timed with CUDA
    events after a one-frame warm-up that builds the layout. Returns
    ``info_mbps`` (information bits decoded per second), ``compute_s``,
    ``frames``, ``frames_ok`` (parity ok and equal to the bits sent) and
    ``ok`` (every frame)."""
    device = torch.device(device)
    _require_cuda("dvb_s2x_bench", device)
    bits, llr = dvb_s2x_frames(device, frames, seed=seed)
    dvb_s2x.decode(llr[:1], DVB_BENCH_RATE, "normal", iters=1)  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    hard, ok = dvb_s2x.decode(llr, DVB_BENCH_RATE, "normal", iters=iters)
    end.record()
    end.synchronize()
    compute_s = start.elapsed_time(end) / 1e3
    good = ok & torch.all(hard == bits, dim=-1)
    frames_ok = int(good.sum())
    return {"info_mbps": bits.numel() / compute_s / 1e6, "compute_s": compute_s,
            "frames": frames, "frames_ok": frames_ok, "ok": frames_ok == frames,
            "info_bits": bits.shape[-1], "iters": iters, "device": str(device)}


def _receiver_symbols(n_coded: int) -> int:
    """QPSK symbols of `n_coded` coded bits padded to whole 8×16 interleaver blocks."""
    return (n_coded + 127) // 128 * 128 // 2


def _qpsk_link(bits: np.ndarray, device: torch.device) -> dict:
    """tests/test_e2e_receiver.py:28-100: bits -> K=7 conv -> 8×16 interleave
    -> QPSK/RRC (sps 4, β 0.35, 33 taps) -> AWGN at 14 dB on the reference's
    key-1 draw -> matched filter -> PFB clock sync -> 4th-power phase and
    energy normalisation -> every (offset, rotation) hypothesis the
    reference's search tries, offset-major, decoded as the lanes of ONE
    soft Viterbi call; the first whose bits equal the payload is the answer."""
    sps = RECEIVER_SPS
    qpsk = torch.from_numpy(QPSK_POINTS).to(device)
    coded = conv_encode(torch.from_numpy(bits).to(device))
    n_coded = coded.shape[-1]
    inter = block_interleave(torch.nn.functional.pad(coded, (0, (-n_coded) % 128)), 8, 16)
    pairs = inter.reshape(-1, 2)
    syms = qpsk[(pairs[:, 0] * 2 + pairs[:, 1]).long()]
    # tail symbols flush the shaping, matched and PFB filter delays
    all_syms = torch.cat([syms, qpsk[torch.zeros(32, dtype=torch.long, device=device)]])
    up = torch.zeros(all_syms.shape[0] * sps, dtype=IQ_DTYPE, device=device)
    up[::sps] = all_syms
    taps = pulse.root_raised_cosine_taps(sps, 8, 0.35)
    shaped, _ = fir_filter(taps, up)
    rx = awgn(shaped, RECEIVER_SNR_DB, key=threefry.key(RECEIVER_KEY))

    t0 = time.perf_counter()
    mf, _ = fir_filter(taps, rx)
    _synchronize(device)
    t1 = time.perf_counter()
    rec, _ = resample.pfb_clock_sync(mf, sps, rrc_beta=0.35)
    _synchronize(device)
    t2 = time.perf_counter()
    # data-free phase recovery (QPSK 4th power), then unit energy
    ph4 = torch.angle(torch.mean(_integer_pow(rec[40:], 4)))
    rec = rec * cis(-(ph4 + math.pi) / 4)
    rec = rec / torch.sqrt(torch.mean(torch.abs(rec) ** 2))
    need = _receiver_symbols(n_coded)
    n_off = min(RECEIVER_OFFSETS, rec.shape[0] - need + 1)
    cand = rec.unfold(0, need, 1)[:n_off]  # (offsets, need)
    rot = cis(-math.pi / 2 * torch.arange(4, dtype=REAL_DTYPE, device=device))
    z = (cand[:, None, :] * rot[None, :, None]).reshape(n_off * 4, need)
    soft = torch.tanh(soft_demap_llr(z, qpsk) / 2).reshape(n_off * 4, -1)
    deint = block_deinterleave(soft, 8, 16)[:, :n_coded]
    dec = viterbi_decode(deint, terminated=True, soft=True)[:, : len(bits)]
    match = torch.all(dec == torch.from_numpy(bits).to(device), dim=-1).cpu().numpy()
    t3 = time.perf_counter()
    first = int(np.argmax(match)) if match.any() else None
    return {"ok": first is not None, "offset": None if first is None else first // 4,
            "rotation": None if first is None else first % 4,
            "bits": None if first is None else dec[first].cpu().numpy(),
            "decoding": np.flatnonzero(match), "hypotheses": n_off * 4,
            "viterbi_steps": n_coded // 2, "symbols": int(rec.shape[0]),
            "seconds": {"matched_filter": t1 - t0, "pfb_clock_sync": t2 - t1,
                        "search": t3 - t2}}


def _isi_channel(n_sym: int, device: torch.device) -> dict:
    """tests/test_e2e_receiver.py:102-136: a two-period m-sequence(8) probe,
    then QPSK through the 3-tap channel h_true with numpy noise σ 0.06;
    `channel_sound` on the second period, MLSE with the first three
    estimated taps, and the naive slicer."""
    rng = np.random.default_rng(9)
    idx = rng.integers(0, 4, n_sym)
    syms = QPSK_POINTS[idx]
    h_true = np.asarray([1.0, 0.55 * np.exp(1j * 0.5), 0.28 * np.exp(-1j * 1.1)], np.complex64)
    probe = m_sequence(8).astype(np.complex64)  # 255 chips
    frame = np.concatenate([np.tile(probe, 2), syms])
    rx = np.convolve(frame, h_true)[: len(frame)]
    rx += 0.06 * (rng.standard_normal(len(rx)) + 1j * rng.standard_normal(len(rx)))
    cir = measure.channel_sound(torch.from_numpy(rx[255:510].astype(np.complex64)).to(device),
                                torch.from_numpy(probe).to(device), n_taps=8).cpu().numpy()
    data = rx[510:510 + n_sym].astype(np.complex64)
    _synchronize(device)
    t0 = time.perf_counter()
    dec = equalizers.mlse_equalize(torch.from_numpy(data).to(device), cir[:3],
                                   QPSK_POINTS).cpu().numpy()
    secs = time.perf_counter() - t0
    naive = np.argmin(np.abs(data[:, None] - QPSK_POINTS), axis=1)
    return {"cir": cir, "tap_err": float(np.abs(cir[:3] - h_true).max()),
            "ghost": float(np.abs(cir[3:]).max()), "ser_mlse": float(np.mean(dec != idx)),
            "ser_naive": float(np.mean(naive != idx)), "decisions": dec, "mlse_s": secs}


def _spectral_null(n_sym: int, device: torch.device) -> dict:
    """tests/test_e2e_receiver.py:163-186: QPSK through [0.71, 0, 0.7] with
    numpy noise σ 0.07; MLSE, and a DFE (9 forward, 4 feedback taps, μ
    0.005, its default BPSK slicer, as the reference calls it) scored
    after its first RECEIVER_DFE_SKIP outputs."""
    rng = np.random.default_rng(13)
    idx = rng.integers(0, 4, n_sym)
    s = QPSK_POINTS[idx]
    h = np.asarray([0.71, 0.0, 0.7], np.complex64)  # deep in-band null
    y = np.convolve(s, h)[: len(s)].astype(np.complex64)
    y += 0.07 * (rng.standard_normal(len(y))
                 + 1j * rng.standard_normal(len(y))).astype(np.complex64)
    y_t = torch.from_numpy(y).to(device)
    _synchronize(device)
    t0 = time.perf_counter()
    mlse = equalizers.mlse_equalize(y_t, h, QPSK_POINTS).cpu().numpy()
    t1 = time.perf_counter()
    ydfe = equalizers.dfe_equalize(y_t, n_ff=9, n_fb=4, mu=0.005).y.cpu().numpy()
    t2 = time.perf_counter()
    dfe_idx = np.argmin(np.abs(ydfe[RECEIVER_DFE_SKIP:, None] - QPSK_POINTS), axis=1)
    return {"ser_mlse": float(np.mean(mlse != idx)),
            "ser_dfe": float(np.mean(dfe_idx != idx[RECEIVER_DFE_SKIP:])),
            "decisions": mlse, "dfe_decisions": dfe_idx, "dfe_y": ydfe,
            "mlse_s": t1 - t0, "dfe_s": t2 - t1}


def composed_receiver_gate(device=DEFAULT_DEVICE, n_bits: int = RECEIVER_INFO_BITS) -> dict:
    """The four tests of ``tests/test_e2e_receiver.py`` on the port.

    At the reference's `n_bits` (1,024) the ISI and spectral-null links run
    on its 4,000 and 6,000 symbols and every bar of its tests is checked:
    some timing and phase hypothesis decodes the payload; the sounded taps
    within 0.08 with no ghost tap over 0.05, MLSE SER 0 where the naive
    slicer's is above 0.03; MAP soft combining no worse than hard and
    under 5% errors; MLSE SER below 0.002 and below the DFE's. At any other
    size (PACKET_INFO_BITS for the 1,500-byte packet) both links run on the
    packet's QPSK symbol count, and the gate's bar is the first test's (the
    payload decoded); the other numbers are reported, not held to bars the
    reference never ran at that size. Returns ``ok``, per-case results
    with their decisions, and host seconds of the step loops.
    """
    device = resolve_device(device)
    reference = n_bits == RECEIVER_INFO_BITS
    t0 = time.perf_counter()
    bits = np.random.default_rng(7).integers(0, 2, n_bits).astype(np.int32)
    link = _qpsk_link(bits, device)
    link["ok"] = link["ok"] and np.array_equal(link["bits"], bits)
    n_sym = _receiver_symbols(2 * (n_bits + 6))
    isi = _isi_channel(RECEIVER_ISI_SYMBOLS if reference else n_sym, device)
    soft = _map_case(device)
    null = _spectral_null(RECEIVER_NULL_SYMBOLS if reference else n_sym, device)
    if reference:
        isi["ok"] = (isi["tap_err"] < 0.08 and isi["ghost"] < 0.05 and isi["ser_mlse"] == 0.0
                     and isi["ser_naive"] > 0.03)
        null["ok"] = null["ser_mlse"] < 0.002 and null["ser_mlse"] < null["ser_dfe"]
        ok = link["ok"] and isi["ok"] and soft["ok"] and null["ok"]
    else:
        ok = link["ok"]
    _synchronize(device)
    total = time.perf_counter() - t0
    loops = {"pfb_clock_sync": link["seconds"]["pfb_clock_sync"],
             "mlse": isi["mlse_s"] + null["mlse_s"], "dfe": null["dfe_s"]}
    return {"ok": ok, "n_bits": n_bits, "reference_size": reference,
            "cases": {"qpsk_link": link, "isi_mlse": isi, "map_soft": soft,
                      "mlse_vs_dfe": null},
            "seconds": {"total": total, **loops,
                        "share": {k: v / total for k, v in loops.items()}},
            "device": str(device)}
