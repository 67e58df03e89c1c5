#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's paths on one CUDA card.

Builds every Hopper kernel from this checkout (one nvcc per source, run in
parallel), counts local-memory instructions in their SASS, and holds each
against its plain PyTorch version. Then it drives
three paths through the port's public entry points and shows that each
launched its kernels: the LoRa loopback (the quick start, ``entry()``'s
forward step and the full SF7-SF12 Monte-Carlo sweep; dechirp-power
kernel), the K=7 soft Viterbi decode (the full-size decode bench and
MIL-STD-188-110 round trips with autobaud; forward-ACS and traceback
kernels) and the digital down-converter (the full-size DDC bench, a
DUC -> DDC round trip, a streamed frequency-translating FIR and a
rational resampler; FIR-decimate and NCO kernels). Phase 16 holds the
card's results of functions no path runs (the FIR family's other users,
vco, puncturing, windows) against the port's own CPU results. Then the GPS
L1 C/A receiver, a path with no hand-written kernel: phase 17 runs
``gps_pvt_fix()`` at the full size of the JAX package's gate (six
satellites, 24.3 s at 4.092 MS/s on the card) and fails unless the gate
passes; phase 18 holds the card's PCPS grid, acquisition, tracking,
scenario composite and code-phase fix against the port's CPU results;
phase 19 times ``pcps_bench()`` and the GNSS paths per call beside
their launch counts. Then the Galileo E1B receiver, the joint GPS + Galileo
receiver and GLONASS L1OF FDMA tracking, each at its gate's full size with
the counts set to 0 before it: phase 20 ``galileo_pvt()`` (six SVs, 11.2 s
at 5.115 MS/s) and phase 21 ``dual_pvt()`` (5 + 5 SVs, 24.3 s at 5.115
MS/s), whose I/NAV page parts go through both Viterbi kernels, one launch
each per channel; phase 22 ``glonass_track()`` (six FDMA channels, 4 s at
6.132 MS/s), which launches no hand-written kernel; phase 23 holds the
Viterbi kernels at the I/NAV shape (T = 120, the gates' lane counts) bit
for bit against their plain versions and times them, and holds the
card's I/NAV decode, E1B acquisition and closed tracking and GLONASS
mixdown against the port's CPU results. Then the link round trips, each
with the counts set to 0 before it and read after: phase 24
``lora_packet_roundtrip()`` at SF7-SF12 (255-byte payloads with header and
CRC behind a noise gap, one with a 400 Hz CFO, and noise alone), whose
preamble search and demodulation both launch the dechirp kernel, timed
at the search's window shapes; phase 25 ``ber_gate()`` at 1,000,000 bits
a point (every point within 10% of theory), the waveform-level BPSK check
and the six PSK/QAM waveforms (no hand-written kernel); phase 26 STANAG
4285 at every mode, long interleave and four AWGN points, and HARQ, whose
one-lane decodes launch both Viterbi kernels, timed at STANAG's T; phase
27 ``pcps_gcorr_bench()`` in Gcorr/s; phase 28 the CRCs, the sync windows
and decisions and the linear demodulator on the card against the port's
CPU results. Then the waveform fleet, each path with the counts set to 0
before it and read after: phase 29 ``device_sweep()`` (all 50 factory
names through modulate -> host -> demodulate at 48 kHz: 50/50, the bytes
back for the reference's 40 names, each name's decisions equal to the
port's CPU demodulation of the same host IQ, per-name warm times, the
dechirp and Viterbi launches of the LoRa, MIL-STD-188-110 and STANAG
names); phase 30 ``fleet_noisy_gate()`` (every name through AWGN on the
reference's own noise: digital names bit-exact, the CW, analog, FMCW and
beacon bars); phase 31 ``sincgars_data_roundtrip()`` (2,048 bytes in 29
coded frames over the SINCGARS hop PHY at 10 dB: 29/29 with their CRC,
one launch of each Viterbi kernel, both kernels bit for bit against their
plain versions at the decode's bm (638, 4, 29) and timed there). Then the
channel models and the FEC codecs: phase 32 holds every channel and
impairment function on the card against the port's CPU result on the
same threefry draws and runs ``channel_bench()`` (AWGN at 20 dB, 16,384
times over 2^18 samples) in Msamples/s; phase 33 ``fading_gate()`` (OFDM
through TDL EPA and EVA, LoRa-SF7, DSSS and BFSK through EPA, on the
reference's draws: every payload back; the dechirp kernel launched by the
LoRa case; QPSK through a static 2-ray channel with the LS estimate and
the frequency-domain equaliser), then its pass rates under fresh Philox
draws; phase 34
``coded_link_gate()`` (the JAX FEC tests' inputs: LDPC, turbo, polar,
convolutional, TCM at 100,000 bits, DVB-S2X short frames, LT, MAP: every
bar, decisions equal to the CPU's, each Viterbi kernel launched twice,
by the convolutional gate and TCM), the launches and time of one BCJR,
turbo, MAP, LDPC, DVB-S2X and TCM decode; phase 35 ``dvb_s2x_bench()``
(128 normal frames at rate 1/2, 3.0 dB, 40 iterations: every frame
decoded) in information Mbit/s. Then synchronisation, equalisation and
AGC: phase 36 holds every function of the slice's eight modules (pulse
shaping, the filter recursions, measurement, resampling, sync, sync2,
equalizers, AGC) on the card against the port's CPU result on the same
numpy-made inputs (2^14 samples; the loops at their reference tests'
sizes: pfb_clock_sync, MLSE, the DFE and the integer loops equal, floats
within the stated tolerances) and prints each loop's launches and host
time a step; phase 37 runs ``composed_receiver_gate()``, the reference's
composed QPSK receiver, at its 1,024 bits and at a 1,500-byte packet
(every bar, every decision equal to a CPU run of the gate, fir_decimate
launched twice and each Viterbi kernel once a gate, the timing and phase
hypotheses as the lanes of one decode), with one gate under the
profiler; phase 38 holds the three kernels against their plain versions
at the gate's shapes (FIR (1, 48,256) K = 33; Viterbi bm (12,006, 4, 88))
and times them. Then the modem family: phase 39 runs
``modem_family_gate()`` (every function of the rest of modem, mapping,
events, scramblers, the RAKE receiver, exotic_modems and the emphasis
filters on its JAX test's inputs, card against CPU; the FEC table's
convolutional codec on a 1,500-byte packet, each Viterbi kernel launched
once; an LTE 20 MHz uplink subframe through SC-FDMA) and times both
Viterbi kernels at the packet's bm (12,006, 4, 1); phase 40 runs
``fm_broadcast_gate()``, a broadcast FM stereo + RDS receiver, at 1 s and
at one minute of a station (14.4 M IQ samples at 240 kS/s), each with the
counts set to 0 just before it and read just after (every bar;
fir_decimate 9 and first_order_iir 1 launches at both lengths), holds a
2 s station's card results against a CPU run, and profiles one warm
chain; phase 41 holds the recursion kernel's linear kind bit for bit
against its plain step loop (at the FM path's (1, 14.4 M) too), times it
at (1, 2^15), (1, 14.4 M) and (2, 14.4 M) beside its bytes bound and its
serial floor (the bare chain, timed on the card by ``chain_probe``), and
times the FIR at (1, 14.4 M) float32 for K = 301, 201 and 101 beside its
plain version, cuDNN's conv1d and its bound. Then the stream and detection
slice: phase 42 runs ``dsp_blocks_gate()`` (every function of stream_math,
filters2, stream_blocks, detect, adaptive and kalman on its JAX test's
inputs, card against CPU, and each recursion kind at (4, 2^20) bit for
bit); phase 43 runs ``spectrum_monitor_gate()``, a wideband spectrum
monitor on 32 blocks of 2^20 samples at 30.72 MS/s (spectrum sensing, four
down-converters, the burst gate, squelch, envelope and peak hold), with
the counts set to 0 just before it and read just after (every bar;
nco_mix 4, fir_decimate 4 and first_order_iir 3 launches, one a kind),
holds a 2-block capture's card results against a CPU run, profiles one
warm chain and times the NCO and FIR kernels at the monitor's shapes;
phase 44 holds each recursion kind bit for bit against its plain version
at (4, 2^20), (1, 2^15), complex (8, 4096) and, for the two linear forms,
(1, 14.4 M), and times each beside its bare chain, its bytes bound and
its plain loop. Then radar, arrays and propagation: phase 45 runs
``array_blocks_gate()`` (every function of core.linalg, radar,
radar_sonar, radar_adv, beamforming, mimo, propagation and ew on its JAX
test's inputs, card against CPU, the SVD and eigenvectors by their
phase-free invariants; ``cfar_1d``'s window sums launch the FIR kernel)
and times the FIR at that window (64 rows of 4096 cells, K = 21) beside
its plain version, conv1d and its bound; phase 46 runs
``array_radar_gate()``, a 16-element digital-array pulse-Doppler radar at
a full CPI (16 × 128 × 4096) over 5 CPIs with the counts set to 0 just
before it and read just after (every bar: each target at its planted bins
in every CPI and strongest in the beam nearest its sine, at most 25 false
detections a CPI, MVDR at least 15 dB under the conventional beam away
from the jammer, five confirmed tracks within 7.5 m from the second CPI;
no hand-written kernel launched), holds the last CPI's card run against a
CPU run (CFAR masks equal but at counted ties, clusters equal, weights,
maps and MUSIC angles within tolerance) and profiles one warm CPI; phase
47 the static 2-ray case of phase 33's fading gate (QPSK through a 2-ray
channel, the LS estimate and the frequency-domain equaliser: every byte
back) on the card against a CPU run. Then spectrum analysis, cognitive
radio, instruments and sensing: phase 48 runs ``sensing_blocks_gate()``
(every BLOCKS entry of spectral2, cognitive, instruments and sensing and
both analysis classes on their JAX tests' inputs, card against CPU, the
worst case by name); phase 49 runs ``spectrum_access_gate()``, a
dynamic-spectrum-access node's sensing cycle over 32 blocks of 2^20
samples at 30.72 MS/s (occupancy and duty cycles, the engine, the
waterfall, the idle channels down-converted by 16 and their cyclic
features, classification, leases, excision, the transmitter's
self-check), with the counts set to 0 just before it and read just after
(every bar; nco_mix one launch and fir_decimate one launch a channel, and
fir_decimate two for the self-check's shaping and matched filter), holds
the full-size waterfall stage (2^25 values) and the first 4 blocks' card
run and the self-check against CPU runs, times
the cycle warm and profiles it; phase 50 holds the NCO and FIR kernels
against their plain versions at the gate's DDC shape ((32, 2^20) c64,
K = 63, f = 16) and times them beside conv1d and their bounds. Then
packets, protocols, ADS-B, audio and the applied voice tools: phase 51 runs
``protocol_blocks_gate()`` (every BLOCKS entry of packets and audio and
every public function of protocols, applied and adsb on their JAX tests'
inputs, card against CPU, the worst case by name); phase 52 runs
``dispatch_monitor_gate()``, a narrowband-FM dispatch monitor over 8.0 s of
a 2.4 MS/s capture in 20 rows (eight channels down-converted by 10 and
joined across the rows, selected and demodulated to 8 kHz audio, squelched,
CTCSS tones, the DTMF ANI, four POCSAG pages, voice cleaning and pitch),
with the counts set to 0 just before it and read just after (every bar;
nco_mix 8, fir_decimate 11, first_order_iir 1 launches), times the chain
warm, profiles it and holds a CPU run of the whole capture against the
card's; phase 53 holds the NCO at the capture rows, the FIR at the
monitor's four shapes (and its voice batch) and the recursion's ema kind
at the squelch's (8, 192,000) against their plain versions and times them
beside conv1d, their bounds and the recursion's serial floor. Then navigation,
biomedical, the infrastructure fills, timing and waveform specs: phase 54
runs ``infra_blocks_gate()`` (every BLOCKS entry of navigation, biomedical
and infra_fills, every alias of ``alias_blocks``, and the public classes and
functions of timing and waveform_spec on their JAX tests' inputs, card
against CPU, the worst case by name) and holds the DPD fit on the link's
training burst card against CPU; phase 55 runs
``hopping_link_gate()``, a frequency-hopping 16-QAM link with digital
predistortion over 10.0 s at 2.048 MS/s (250 hops of 64 channels: the
spec-built waveform, DPD, the hop synthesiser's rotator, the Rapp PA, AWGN
at 30 and 20 dB, a loopback TCP sample link, the indexed recorder with
sample-clock timestamps, de-hopping and two decimating FIRs a block of 25
hops, the demodulator), with the counts set to 0 just before it and read
just after (every bar; nco_mix one launch a channel in the transmitter and
one a channel of each block in each receiver, fir_decimate two a block),
runs it warm, profiles its device part and holds CPU runs of the same scene
and captures against the card's; phase 56 holds the NCO through
``rotator_apply``'s ω path at (8, 77,824) and the FIR at the de-hopper's
(25, 77,824) K = 63 f = 16 and (25, 4,864) K = 63 f = 8 against their plain
versions and times them beside conv1d and their bounds. Then the Galileo
E1C pilot chain and the host layer's data plane: phase 57 runs
``e1c_pilot_gate()`` (eight E1C SVs at 34 dB-Hz and two absent controls over
50 code periods at 5 MS/s: acquisition, the CS25 joint searches, the code
sweeps, the wiped pilot pass; then E1B I/NAV pages decoded off the pilot
loops over 4.35 s), with the counts set to 0 just before it and read just
after (every bar: 8/8 acquired, 0/2 false alarms, 8/8 tracked, the E1B
pass with every CRC-ok page's data equal to the truth; each Viterbi kernel
one launch an SV), phase 58 runs it again from a fresh capture (warm),
phase 59 profiles its pilot stage, phase 60 holds the CPU's acquisition of
the card's capture, the CPU's pilot stage and the CPU's I/NAV decode of the
card's symbols against the card's; phase 61 runs ``rf_scene_gate()`` (one
second at 30.72 MS/s in blocks of 2^20: five emitters around a moving
receiver, the loopback simulator's AWGN, the attenuator, a triggered
SigMF capture and its replay, stream tags and PDUs, a BFSK payload decoded,
metrics over HTTP, config), with the counts set to 0 just before it and
read just after (every bar; fir_decimate 2 launches), warm, one warm chain
under the profiler, the FIR at the decode's two shapes against its plain
version (timed beside conv1d and its bound), and the whole scene on the CPU
against the card's; phase 62 holds both Viterbi kernels at
an SV's I/NAV parts against their plain versions bit for bit and times
them. Then the block registry, the block-graph pipeline and the remote-lab
host layer: phase 63 builds the native iqcore runtime (g++) from the
checkout and checks its conversions against their plain versions; phase 64
runs ``remote_lab_gate()`` (an agent on 127.0.0.1 streams a 255-byte
LoRa-SF7 packet over UDP into the native receiver, bit for bit and decoded
on the card equal to the CPU's decode; then the reference's 5 s
``BenchmarkReceiver.run`` on an unpaced stream, at least 1.0 Msps
demodulated), with the counts set to 0 just before it and read just after
(the dechirp kernel once a batch), and profiles ten warm batches; phase 65 runs
``block_graph_gate()`` (the pipeline wizard's graph at a full LoRa packet:
dechirp, first_order_iir and fir_decimate each launched), warm, profiled,
and its report against a CPU run's; phase 66 resolves the 523 registry
blocks on the card with every schema, paints `hopping_link_gate`'s link as a
``SampleSchedule`` (250 hops, 20.48 M samples) card against CPU, holds
``TorchAccelerator`` at 2^20 against ``SimulatedAccelerator`` and builds,
loads and round-trips the example C-ABI plugin; phase 67 holds the three
kernels against their plain versions at the shapes these two gates give
them and times them beside cuFFT's transform and conv1d. Then the LoRa
mesh, the C API, the sandbox and the figures: phase 68 runs every registry
block and the pipeline's demodulator through ``run_pipeline`` with its
schema's defaults on the card (the counts set to 0 just before it and read
just after) and on the CPU, the erring blocks and their causes equal and
every other block's shape, dtype and power (0.01 dB) equal; phase 69 runs
``mesh_lora_gate()`` (16 Meshtastic nodes on a 4 × 4 grid, LongFast SF11 at
250 kHz, texts, ACKs, a position, a telemetry and a traceroute flooding
over the LoRa PHY, each round's frames modulated, put through AWGN at their
links' SNRs and demodulated as one batch) with the counts set to 0 just
before it and read just after (every bar; dechirp once a round), warm, and
its busiest round under the profiler; phase 70 runs the gate on the CPU
against the card's (every delivery, status and inbox) and times dechirp at
the busiest round's SF11 shape against its plain version and cuFFT; phase
71 builds the C API from the checkout's byte copies and holds its
modulators, demodulators, FFT and chirps against the port's on the card
and runs ``examples/11_capi_demo.c``; phase 72 runs the sandbox's levels
under this CUDA process (a child that touches the card errs within its
timeout, the parent's card still launches); phase 73 holds the figures'
spectrum and waterfall data card against CPU. Then the front ends and the
multi-device layer: phase 74 runs ``dryrun_multichip(1)``'s five sharded
patterns in a process of their own under NCCL on the card and under gloo
on the CPU (results equal), and ``parallel.ber_sweep`` over an NCCL mesh of
one card at the LoRa sweep's SF7 size, equal to the unsharded sweep;
phase 75 serves the explorer on 127.0.0.1 on the card (the catalog, PR
20's block graph through /api/pipeline, the sky view, the live stream's
waterfall, an agent's TX into it, and the demo round of LoRa-SF12 over the
nine channel models, each against the CPU); phase 76 runs the CLI's
commands in-process at a 255-byte LoRa payload and ``python -m
r4w_tpu_torch simulate`` once, every printed line against the CPU's. The
CPU runs that phases 37, 61, 68, 70 and 74-76 hold the card against are
computed in one spawned process of their own (`CpuReferences`), started
with the script and stopped when phase 76 has read them. Each phase prints
at least one line; a failed phase raises,
and the exit code is then non-zero. The second-to-last line is the kernel
table as JSON, the last line the device record.

Run from the repository root, with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card (Hopper, for sm_90a) and nvcc; it has no CPU path.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import importlib.util
import io
import json
import math
import multiprocessing as mp
import re
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.request
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from r4w_tpu_torch import arq, ber, create_waveform
from r4w_tpu_torch import channel as chan
from r4w_tpu_torch.channel import awgn, threefry
from r4w_tpu_torch.core import windows
from r4w_tpu_torch.core.hostio import cis
from r4w_tpu_torch.entry import (DDC_CENTER_HZ, DDC_DECIMATION, DDC_RATE_HZ, DDC_SAMPLES,
                                 DDC_STREAMS, PACKET_GAP_SAMPLES, PCPS_CONFIG, PCPS_RATE_HZ,
                                 SWEEP_PAYLOAD_BYTES, SWEEP_RATE_HZ, SWEEP_SNRS_DB,
                                 VITERBI_INFO_BITS, VITERBI_LANES, ber_gate, channel_bench,
                                 coded_link_gate, ddc_bench, ddc_signal, device_sweep,
                                 dual_pvt, dvb_s2x_bench, dvb_s2x_frames, entry, fading_gate,
                                 fleet_noisy_gate, galileo_pvt, gcorr_inputs, gcorr_step,
                                 glonass_track, gps_pvt_fix, lora_packet_roundtrip, lora_sweep,
                                 noisy_pass_rates, packet_capture, pcps_bench, pcps_gcorr_bench,
                                 pcps_inputs, sincgars_data_roundtrip, sweep_lanes, sweep_round,
                                 TCM_GATE_BITS, viterbi_bench, composed_receiver_gate,
                                 PACKET_INFO_BITS, QPSK_POINTS, RECEIVER_INFO_BITS, RECEIVER_SPS,
                                 TWO_RAY_LABEL, array_blocks_gate, array_radar_gate,
                                 two_ray_fde_case)
from r4w_tpu_torch.fec import convolutional, crc, dvb_s2x, ldpc, tcm, turbo
from r4w_tpu_torch.gnss import acquisition, inav, scenario, tracking
from r4w_tpu_torch.gnss import dual_pvt as dual
from r4w_tpu_torch.gnss import galileo_pvt as gal
from r4w_tpu_torch.gnss import glonass_track as glo
from r4w_tpu_torch.gnss import gps_pvt_fix as gps
from r4w_tpu_torch.gnss.ephemeris import circular_ephemeris_for_position
from r4w_tpu_torch.gnss import prn as gnss_prn
from r4w_tpu_torch.kernels import _build, fir, nco, recurrence, viterbi
from r4w_tpu_torch.kernels.dechirp import dechirp_power, dechirp_power_cuda, launch_plan
from r4w_tpu_torch.ops import agc as agc_ops
from r4w_tpu_torch.ops import sync as ops_sync
from r4w_tpu_torch.ops import (equalizers, filters, filters2, impairments, measure, pulse, resample,
                               spreading, stream_math, sync2)
from r4w_tpu_torch.modem_gates import (FAMILY_DFT_TOL, FAMILY_PHASE_TOL, FAMILY_TOL,
                                       FM_FIR_LAUNCHES, FM_RATE_HZ, FM_RECURSION_LAUNCHES,
                                       FM_SECONDS, FM_SEPARATION_DB, LTE_CP,
                                       LTE_FFT, LTE_SC, LTE_SYMBOLS, fm_broadcast_chain,
                                       fm_broadcast_gate, modem_family_gate)
from r4w_tpu_torch.modem_gates import PACKET_BYTES as FAMILY_PACKET_BYTES
from r4w_tpu_torch.modem_gates import launch_counts as fm_counts
from r4w_tpu_torch.monitor_gates import (MONITOR_BLOCK, MONITOR_DECIMATION, MONITOR_RATE_HZ,
                                         MONITOR_RECURSIONS, MONITOR_ROWS, RECURSION_COEFS,
                                         RECURSION_SHAPE, dsp_blocks_gate,
                                         monitor_agreement, spectrum_monitor_chain,
                                         spectrum_monitor_gate)
from r4w_tpu_torch.profiling import breakdown
from r4w_tpu_torch import cognitive_gates, dispatch_gates, hop_gates, radar_gates, scene_gates
from r4w_tpu_torch import config as r4w_config
from r4w_tpu_torch.observe import MetricsRegistry
from r4w_tpu_torch.entry import e1c_pilot_gate, rf_scene_gate
from r4w_tpu_torch.gnss import e1c_common, e1c_tracking
from r4w_tpu_torch.waveforms import linear_mod, list_waveforms, lora
from r4w_tpu_torch.waveforms import milfh_waveforms as milfh
from r4w_tpu_torch.waveforms import stanag4285 as stanag
from r4w_tpu_torch.waveforms.lora import chirp, sync
from r4w_tpu_torch.waveforms.lora import modem as lora_modem
from r4w_tpu_torch import accel as r4w_accel
from r4w_tpu_torch import native as r4w_native
from r4w_tpu_torch import remote_gates
from r4w_tpu_torch.benchmark import WaveformRunner
from r4w_tpu_torch.pipeline import run_pipeline
from r4w_tpu_torch.registry import PluginManager, default_registry
from r4w_tpu_torch.waveforms import base as waveform_base
from r4w_tpu_torch import entry as entry_module
from r4w_tpu_torch import mesh, mesh_gates, sandbox, viz
from r4w_tpu_torch.mesh_gates import GATE, mesh_lora_gate
from r4w_tpu_torch.native import capi
from r4w_tpu_torch.registry_survey import POWER_TOL_DB as SURVEY_POWER_TOL_DB
from r4w_tpu_torch.registry_survey import compare_surveys, registry_survey
from r4w_tpu_torch import explorer, frontend_gates, parallel
from r4w_tpu_torch.analysis import Waterfall
from r4w_tpu_torch.parallel.dryrun import COMPOSITE_REL_TOL, dryrun_multichip

REL_TOL = 1e-4  # max|kernel - plain| / max(plain), the JAX package's own bar
CAPI_IQ_ATOL = 3e-6       # tests/test_capi.py: the C modulators against complex64 IQ
CAPI_FFT_REL = 1e-9       # tests/test_capi.py: the C FFT, complex128 on both sides
CAPI_CHIRP_ATOL = 2e-6    # tests/test_capi.py: the C chirps against complex64 chirps
SANDBOX_TIMEOUT_S = 60
SANDBOX_MEMORY_MB = 256   # tests/test_timing_sandbox.py's L3 limit
VIZ_DB_TOL = 1e-4
WATERFALL_BARS_DB = {"sf7": -8.0, "sf8": -12.0, "sf9": -14.0, "sf10": -16.0,
                     "sf11": -20.0, "sf12": -22.0}
WATERFALL_SLACK_DB = 2.0  # one step of the sweep's SNR grid
TIMED_LAUNCHES = 10
SLEEP_CYCLES = 50_000_000  # ~25 ms at the H100's clock: the host enqueues behind it
PLAIN_VITERBI_CALLS = 1  # the plain forward is a 2054-step loop of small launches
# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, FP32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
VITERBI_CODES = {5: (0o23, 0o35), 7: (0o171, 0o133)}
# every constraint the forward kernel takes at R = 2, K = 7 at R = 3, and two codes
# whose generators do not all tap both ends of the register
VITERBI_ALL_CODES = ((3, (0o7, 0o5)), (4, (0o17, 0o13)), (5, (0o23, 0o35)), (6, (0o53, 0o75)),
                     (7, (0o171, 0o133)), (8, (0o247, 0o371)), (7, (0o133, 0o171, 0o165)),
                     (4, (0o16, 0o13)), (7, (0o170, 0o133)))
VITERBI_ALL_LANES = (1, 3, 33, 130, 2100, 4096)
VITERBI_RAGGED_STEPS = (37, 300)  # not multiples of any staging chunk (32 or 16 steps)
# kernels whose every template instance must be in the SASS with no LDL/STL:
# the traceback's, one per state count; the FIR's, one per sample type
SASS_GUARDS = {"viterbi": ("viterbi_traceback_kernel",
                           viterbi.MAX_CONSTRAINT - viterbi.MIN_CONSTRAINT + 1),
               "fir_decimate": ("fir_decimate_kernel", 2)}
MIL_STEPS = 1440  # one lane's trellis at 2400 bps, short interleave: MIL-STD-188-110's plan
DECHIRP_RAGGED_ROWS_SF7 = 100_003
MIL_DATA = bytes([0xA7, 0x1B, 0x3C, 0xD2, 0x55, 0x00, 0xFF, 0x42])  # tests/test_hf_modems.py:23
MIL_CASES = ((2400, 14.0), (1200, 8.0), (600, 5.0), (75, -4.0))  # rate bps, SNR dB
FIR_REL_TOL = 1e-5  # max|kernel - plain| / max|plain|: FP32 sums in the same tap order
NCO_REL_TOL = 1e-5  # max|kernel - plain| / (gain · max|x|): the same float32 phase
DDC_REL_TOL = 1e-4  # max|path - plain path| / max|plain path|
DDC_TAPS = 63       # the DDC's default lowpass
FIR_TAPS = (1, 4, 31, 63, 512, 1025)
FIR_FACTORS = (1, 2, 4, 8)
FIR_SWEEP_TAPS = (1, 16, 32, 63, 127)  # phase 12's time-against-taps line
NCO_CASES = ((30.72e6 / 4, 30.72e6), (-30.72e6 / 4, 30.72e6), (30.72e6 / 8, 30.72e6),
             (-30.72e6 / 8, 30.72e6), (2500.0, 1e6))  # freq Hz, sample rate Hz
# (rows, n): long rows; then row counts that are not a multiple of the kernel's
# row tile (nco.ROW_TILE), with even n (column pairs) and odd n (one column a thread)
NCO_SHAPES = ((2, 1 << 20), (3, 4097), (1, 1 << 16), (17, 1 << 16), (17, 4097))
ROUND_TRIP_SAMPLES = 1 << 17  # baseband samples per stream, ×8 up and back down
COVERAGE_SHAPE = (8, 1 << 14)  # phase 16's FIR inputs
VCO_SAMPLES = 1 << 20
VCO_FREQ_REL_TOL = 1e-3  # tests/test_detect_streammath.py:200, the tone's measured frequency
# vco's phase against an exact sum of its float32 steps, at VCO_SAMPLES, in float32
# ulps of the largest phase: a parallel float32 scan's rounding (about 20 on the card)
VCO_PHASE_ULPS = 128
MIX_TOL = 1e-4           # max|card - CPU| / max|CPU|, tests/test_torch_filters.py:34
PUNCTURE_PATTERNS = ([1, 1, 0, 1], [1, 0], [1, 1, 1, 0, 0, 1])  # tests/test_torch_conv.py
WINDOW_KINDS = ("rect", "hann", "hamming", "blackman", "blackmanharris", "bartlett", "flattop",
                "kaiser", "gaussian")
ROUND_TRIP_TONE_HZ = 120e3
XLATING_BLOCKS = 4
# GNSS: the gate (tools/gps_pvt_fix.py's) and the tolerances of the CPU tests
GPS_MAX_ERROR_M, GPS_MAX_SPEED_MPS = 50.0, 1.0
PVT_TOL_M = 0.01                      # code-phase fix, card vs CPU on one capture
TRACK_FS, TRACK_BLOCKS, TRACK_CN0_DBHZ = 2.046e6, 300, 48.0
# PRN, Doppler Hz, code phase at sample 0 (chips), as tests/test_torch_gnss_tracking.py
TRACK_CHANNELS = ((7, 800.0, 0.3), (12, -1500.0, 0.6), (21, 2400.0, 0.5))
TRACK_SEED_ERR_CHIPS, TRACK_SEED_ERR_HZ = 0.05, -10.0
TRACK_TOLS = {"code_phase": 1e-3, "carrier_freq": 0.1, "dll_disc": 1e-3, "pll_disc": 1e-3,
              "cn0_dbhz": 0.05}  # absolute; prompts and E/L within 1e-3 of max|prompt|
PROMPT_REL_TOL = 1e-3
COMPOSITE_TOL = 1e-5                  # max|Δ| / max|CPU|, tests/test_torch_gnss_scenario.py
COMPOSITE_SAMPLES = 1 << 16
GNSS_TIMED_BLOCKS = 1000              # tracking blocks in phase 19's per-step timing
GNSS_BLOCK_SAMPLES = 1 << 22          # the capture's generate_device block
# Galileo E1B, the joint gate and GLONASS: the gates' bars (tools/galileo_pvt.py:330,
# tools/dual_pvt.py:292, the GPS gate's speed bar; GLONASS's are in its verdicts)
GAL_MAX_ERROR_M = 60.0
DUAL_MAX_ERROR_M, DUAL_MAX_SPEED_MPS = 60.0, 1.0
E1B_TIMED_BLOCKS = 250                # E1B tracking blocks in phase 19's per-step timing
E1B_CHECK_BLOCKS = 300                # closed E1B blocks held card against CPU in phase 23
E1B_CHECK_SECONDS = (E1B_CHECK_BLOCKS + 2) * 4092 / 1.023e6
# absolute; prompts and E/L within PROMPT_REL_TOL of max|prompt|. The E1B code phase
# is in subchips of a 49,104-subchip code, where a float32 block update steps by
# 0.0039 (tests/test_torch_gnss_galileo.py)
E1B_TRACK_TOLS = {"code_phase": 0.05, "carrier_freq": 0.1, "dll_disc": 1e-3, "pll_disc": 1e-3,
                  "cn0_dbhz": 0.05}
GLONASS_MIX_TOL = 1e-5                # max|card - CPU| / max|CPU|, float32 phase on both
MIXDOWN_SAMPLES = 1 << 20
# The link round trips (phases 24-28): the reference's bars
PACKET_SFS = tuple(range(7, 13))
PACKET_CFO_HZ = 400.0                 # tests/test_kernels_sync_arq.py:92, within one bin
NOISE_SAMPLES = 6000                  # tests/test_kernels_sync_arq.py:104
BER_GATE_MAX_DEV = 0.10               # docs/PERFORMANCE.md, "<10% deviation from theory"
WAVEFORM_BER = ("BPSK", -16.0, 256, 24)  # tests/test_ber_theory.py:56-68: within 25%
WAVEFORM_BER_MAX_DEV = 0.25
LINEAR_NAMES = ("BPSK", "QPSK", "8-PSK", "16-QAM", "64-QAM", "256-QAM")
STANAG_BYTES = 256
STANAG_AWGN = ((2400, 14.0), (1200, 8.0), (600, 5.0), (75, -2.0))  # tests/test_hf_modems.py:95
HARQ_TRIALS, HARQ_NOISE_STD = 6, 0.95  # tests/test_kernels_sync_arq.py:157-167
# The waveform fleet (phases 29-31)
FLEET_SIZE = 50
# names whose bytes the reference's probe does not get back at 48 kHz
SWEEP_NO_BYTES = {"CW", "ADS-B", "AM-Broadcast", "FM-Broadcast", "NBFM", "FMCW", "ELT-121.5",
                  "EPIRB-121.5", "PLB-121.5", "Beacon-243"}
# analog bytes truncate float32 audio that lands within an ulp of an integer:
# card and CPU may truncate one code apart (tests/torch_fleet_parity.py)
ANALOG_NAMES, ANALOG_CODE_TOL = ("AM-Broadcast", "FM-Broadcast", "NBFM"), 1
SINCGARS_FRAMES, SINCGARS_FRAME_BITS = 29, 1276  # 2,048 bytes at 1200 bps, 71-byte payloads
# The channel models and FEC codecs (phases 32-35)
# max|card - CPU| / max|CPU| on the same threefry draws: the card's float32
# cos/sin/exp/erfc and its parallel cumulative sum (phase noise) part by ulps
CHANNEL_CARD_TOL = 1e-5
CHANNEL_CHECK_SHAPE = (4, 1 << 16)
# the Viterbi launches of coded_link_gate(): the convolutional gate's decode and TCM's
CODED_GATE_VITERBI = 2
CARD = "cuda"              # the device type phase 36 requires of the card's results
SLICE_SAMPLES = 1 << 14    # phase 36's feed-forward inputs
SLICE_CARD_TOL = 1e-5      # max|card - CPU| / max|CPU|: sums, FFTs and FIR taps in another order
SLICE_CUMSUM_TOL = 2e-5    # differences of float32 cumulative sums (Schmidl-Cox)
SLICE_LOOP_TOL = 1e-4      # the recursions, tests/test_torch_resample_sync.py's LOOP_TOL
SLICE_RLS_TOL = 5e-5       # RLS, tests/test_torch_equalizers_agc.py's RLS_TOL
LOOP_PROFILE_STEPS = (64, 192)  # a recursion's launches a step: the slope between these
# max|card - CPU| / max|CPU| of the 2-ray LS estimate: float32 normal equations of an
# oversampled burst (condition ~10^4), whose products sum in another order on the card
TWO_RAY_ESTIMATE_TOL = 1e-3
FIXED_STEP_LOOPS = {"sync2.delay_lock_loop"}  # 64 steps whatever the input
RECURSION_KERNEL_LOOPS = {"filters.single_pole_iir", "filters.dc_blocker"}  # one launch a call
RECEIVER_FIR_LAUNCHES = 2  # the gate's shaping filter and matched filter
RECEIVER_HYPOTHESES = 88   # offsets 0-21 × 4 rotations, lanes of one Viterbi decode
FM_CARD_SECONDS = 2.0      # phase 40's station for the card against the CPU
FM_CARD_TOL = 1e-4         # max|card - CPU| / max|CPU| of L, R, mono audio and the multiplex
FM_FIR_TAPS = (301, 201, 101)  # the FM path's analytic bandpass and RDS lowpass, stereo lowpass, mono
CLOCK_READ_CALLS = 24      # queued recursion calls at the FM row while nvidia-smi reads the clock
# The stream and detection slice (phases 42-44)
MONITOR_CARD_ROWS = 2      # phase 43's capture for the card against the CPU
MONITOR_LAUNCHES = {"nco_mix": 4, "fir_decimate": 4, "first_order_iir": 3}
CHAIN_PROBE_STEPS = 1 << 24
ACCESS_SELF_CHECK_FIRS = 2  # the self-check burst's shaping and matched filter
DISPATCH_LAUNCHES = {"nco_mix": 8, "fir_decimate": 11, "first_order_iir": 1}
HOP_NCO_ROWS = 8           # phase 56's rotator rows, the most dwells of one channel in a block
# The E1C pilot chain and the RF scene (phases 57-62): card against CPU. The pilot
# stage's open-loop prompts are float32 sums over 20,000 samples whose order
# differs between the card and the CPU (tests/test_torch_e1c_tracking.py holds the
# CPU against JAX with the same tolerances)
E1C_LOCK_TOL, E1C_CN0_TOL_DB, E1C_DOP_TOL_HZ, E1C_JUMP_TOL = 0.005, 0.5, 0.05, 0.01
SCENE_IQ_TOL = 1e-5        # max|card - CPU| / max|CPU| of the capture: cos/sin and sums an ulp apart
ACCEL_SAMPLES = 1 << 20    # phase 66's accelerator inputs
ACCEL_TAPS = 64
ACCEL_REL_TOL = 1e-3       # max|card - sim| / max|sim|, tests/test_infra_fills.py:167-185
REGISTRY_COUNTS = {"filter": 47, "resampler": 10, "sync": 33, "channel": 12, "measurement": 119,
                   "source": 19, "radar": 42, "math": 97, "modulator": 80, "sink": 19, "fec": 14,
                   "gnss": 6, "demodulator": 25}  # the reference's default_registry()
GRAPH_LAUNCHES = ("dechirp_power", "first_order_iir", "fir_decimate")  # rx, flt, dec
MULTI_SWEEP_SEED = 74       # phase 74's sharded and unsharded sweeps
DRYRUN_PEAK_REL_TOL = 1e-5  # PCPS peaks card against CPU: float32 FFT sums in another order
STREAM_FS, STREAM_FFT, STREAM_REPS = 250_000.0, 256, 32   # phase 75's live stream
STREAM_WAIT_S = 30.0
STREAM_ROW_TOL_DB = 0.1 + 1e-4  # the rows are rounded to 0.1 dB on both sides
PYTHON_M_TIMEOUT_S = 300
PROFILED_BATCHES = 10      # phase 64's warm batches under the profiler: one records no events
RECURSION_STANDS_FOR = ["r4w_tpu/ops/filters.py:225", "r4w_tpu/ops/filters.py:243",
                        "r4w_tpu/ops/filters2.py:365", "r4w_tpu/ops/filters2.py:413",
                        "r4w_tpu/ops/filters2.py:454", "r4w_tpu/ops/stream_blocks.py:53",
                        "r4w_tpu/ops/stream_blocks.py:72", "r4w_tpu/ops/stream_blocks.py:104",
                        "r4w_tpu/ops/stream_blocks.py:206", "r4w_tpu/ops/adaptive.py:159"]


_STARTED = time.perf_counter()


def phase(name: str, message: str) -> None:
    """One line of a phase, with the seconds since the script started."""
    print(f"[{name}] ({time.perf_counter() - _STARTED:.1f} s) {message}", flush=True)


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


def queued_ms(fn, iters: int = TIMED_LAUNCHES) -> float:
    """Mean device milliseconds of `fn` over `iters` calls enqueued while the
    stream sleeps (`torch.cuda._sleep`), so that the kernels run back to back
    whatever the host's launch rate; `fn` must not synchronise."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn) -> float:
    """Milliseconds of one call of `fn` on the host's clock (a CPU path)."""
    t0 = time.perf_counter()
    fn()
    return 1e3 * (time.perf_counter() - t0)


def rel_err(got, ref) -> tuple[float, float]:
    """(max|got - ref|, that over max|ref|)."""
    abs_err = float(torch.max(torch.abs(got - ref)))
    return abs_err, abs_err / float(torch.max(torch.abs(ref)))


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least milliseconds the card could take, what bounds it): the larger of
    the bytes over the HBM rate and the operations over the FP32 peak."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def local_memory_ops(library: Path) -> dict[str, int]:
    """LDL/STL (local-memory) instructions per kernel of a built library, from
    ``cuobjdump -sass``, by the kernel's mangled name."""
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(library)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = 0
        elif name is not None and re.search(r"\b(LDL|STL)\b", line):
            counts[name] += 1
    return counts


def zero_launch_counts() -> None:
    dechirp_power.launches = 0
    viterbi.viterbi_forward.launches = 0
    viterbi.viterbi_traceback.launches = 0
    fir.fir_decimate.launches = 0
    nco.nco_mix.launches = 0
    recurrence.reset_launches()


def randn_iq(shape, gen: torch.Generator) -> torch.Tensor:
    return torch.complex(torch.randn(shape, generator=gen, device=gen.device),
                         torch.randn(shape, generator=gen, device=gen.device))


def in_turns(plain, kernel, timer=cuda_ms) -> tuple[list[float], list[float]]:
    """(kernel ms ×2, plain ms ×2), taken plain, kernel, kernel, plain on one card
    by `timer` (back to back, or `queued_ms`)."""
    p = [timer(plain)]
    k = [timer(kernel), timer(kernel)]
    p.append(timer(plain))
    return k, p


def plain_decimating_fir(taps: torch.Tensor, x: torch.Tensor, factor: int) -> torch.Tensor:
    """`filters.decimating_fir` from zero state with the dispatcher bypassed."""
    return fir.fir_decimate(x, taps.flip(0), factor, zero_state=True)


def fir_bound(rows: int, n: int, k: int, factor: int) -> tuple[float, str]:
    """Complex64 rows in, kept outputs out; 2 FMAs (4 flops) per tap and output."""
    n_out = fir.n_outputs(n, k, factor)
    return bound(8 * rows * n + 4 * k + 8 * rows * n_out, 4 * rows * n_out * k)


def check_fir_kernel(dev: torch.device) -> dict:
    """Phase 12: the FIR-decimate kernel against its plain version over real
    and complex input, 1 and 64 rows, every factor and tap count of the
    grid and N = 997, 4096+13 and K-1; then with the state as a second
    pointer (given, null for zeros, and a view 8 bytes off 16-byte
    alignment) at N = 997 and N < K-1; then timed beside the plain version
    and the cuDNN conv1d yardstick at the DDC's shape (f = 8) and the dense
    shape (f = 1), with the DDC's own two-pointer call; then real input at
    both factors, and 1-127 taps beside one copy of x, at that shape.
    Returns the kernel-table entry."""
    gen = torch.Generator(device=dev).manual_seed(12)

    def samples(shape, complex_):
        return randn_iq(shape, gen) if complex_ else torch.randn(shape, generator=gen, device=dev)

    def check(label, got, want):
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"fir_decimate {label}: {got.shape} {got.dtype} vs {want.shape}")
        if not want.numel():
            return 0.0
        _, rel = rel_err(got, want)
        if not rel < FIR_REL_TOL:
            raise AssertionError(f"fir_decimate {label}: max|Δ|/max|ref| {rel:.3g}")
        return rel

    cases, worst = 0, 0.0
    for complex_ in (False, True):
        for rows in (1, 64):
            for k in FIR_TAPS:
                taps = torch.randn(k, generator=gen, device=dev)
                for n in sorted({997, 4096 + 13, max(k - 1, 1)}):
                    x = samples((rows, n), complex_)
                    for factor in FIR_FACTORS:
                        got = fir.fir_decimate_cuda(x, taps, factor)
                        want = fir.fir_decimate(x, taps, factor)
                        torch.cuda.synchronize()
                        cases += 1
                        worst = max(worst, check(f"{'complex' if complex_ else 'real'} {rows}x{n} "
                                                 f"K={k} f={factor}", got, want))
    phase("12 fir kernel", f"{cases} cases (real/complex, rows 1/64, K {FIR_TAPS}, f "
          f"{FIR_FACTORS}, N 997/4109/K-1) match the plain version: worst "
          f"max|Δ|/max|ref| {worst:.3g} < {FIR_REL_TOL}")

    cases, worst, rows = 0, 0.0, 3
    for complex_ in (False, True):
        for k in FIR_TAPS:
            taps = torch.randn(k, generator=gen, device=dev)
            for n in sorted({997, max((k - 1) // 2, 1)}):
                x = samples((rows, n), complex_)
                off = 8 // x.element_size()  # 8 bytes, in samples
                flat = samples((rows * (k - 1) + off,), complex_)
                shifted = flat[off:].view(rows, k - 1)
                if k > 1 and shifted.data_ptr() % 16 != 8:
                    raise AssertionError(f"the offset state sits at {shifted.data_ptr() % 16} B")
                for kind, state in (("state", flat[:-off].view(rows, k - 1)), ("zeros", None),
                                    ("8 B off", shifted)):
                    for factor in FIR_FACTORS:
                        got = fir.fir_decimate_cuda(x, taps, factor, state,
                                                    zero_state=state is None)
                        want = fir.fir_decimate(x, taps, factor, state, zero_state=state is None)
                        torch.cuda.synchronize()
                        cases += 1
                        worst = max(worst, check(f"{kind} {'complex' if complex_ else 'real'} "
                                                 f"{rows}x{n} K={k} f={factor}", got, want))
    phase("12 fir state", f"{cases} cases with the state beside x (given, null for zeros, 8 B "
          f"off 16-byte alignment; real/complex, K {FIR_TAPS}, f {FIR_FACTORS}, N 997 and "
          f"N < K-1) match the plain version's concatenation: worst max|Δ|/max|ref| "
          f"{worst:.3g} < {FIR_REL_TOL}")

    rows, n = DDC_STREAMS, DDC_SAMPLES + DDC_TAPS - 1
    taps = torch.from_numpy(filters.design_lowpass(
        DDC_TAPS, DDC_RATE_HZ / (2.5 * DDC_DECIMATION), DDC_RATE_HZ)).to(dev)
    x = randn_iq((rows, n), gen)
    # the DDC's own call reads the same stream as a 62-sample state beside a 2^20 block
    state, block = x[:, :DDC_TAPS - 1].contiguous(), x[:, DDC_TAPS - 1:].contiguous()
    entry_row = {}
    for factor, key in ((DDC_DECIMATION, ""), (1, "_dense")):
        got = fir.fir_decimate_cuda(x, taps, factor)
        want = fir.fir_decimate(x, taps, factor)
        abs_err, rel = rel_err(got, want)
        if not rel < FIR_REL_TOL:
            raise AssertionError(f"fir_decimate at ({rows}, {n}) f={factor}: {rel:.3g}")
        if not torch.equal(fir.fir_decimate_cuda(block, taps, factor, state), got):
            raise AssertionError(f"fir_decimate f={factor}: state beside the block differs from "
                                 f"the concatenated stream")
        del got, want
        kern, plain = in_turns(lambda: fir.fir_decimate(x, taps, factor),
                               lambda: fir.fir_decimate_cuda(x, taps, factor))
        two_pointer = cuda_ms(lambda: fir.fir_decimate_cuda(block, taps, factor, state))
        # the yardstick: cuDNN conv1d in full FP32 on the (rows, 2, n) real and
        # imaginary planes with the taps repeated, groups=2; the layout copy untimed
        planes = torch.view_as_real(x).permute(0, 2, 1).contiguous()
        weight = taps.view(1, 1, -1).repeat(2, 1, 1)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            lib_out = F.conv1d(planes, weight, stride=factor, groups=2)
            library = cuda_ms(lambda: F.conv1d(planes, weight, stride=factor, groups=2))
        got = fir.fir_decimate_cuda(x, taps, factor)
        _, lib_rel = rel_err(torch.view_as_complex(lib_out.permute(0, 2, 1).contiguous()), got)
        if not lib_rel < FIR_REL_TOL:
            raise AssertionError(f"the conv1d yardstick computes another function: {lib_rel:.3g}")
        del planes, lib_out, got
        b_ms, b_by = fir_bound(rows, n, DDC_TAPS, factor)
        ms = sum(kern) / 2
        entry_row.update({f"ms{key}": ms, f"plain_ms{key}": sum(plain) / 2,
                          f"bound_ms{key}": b_ms, f"library_ms{key}": library,
                          f"ms_two_pointer{key}": two_pointer})
        if not key:
            entry_row.update({"max_abs_err": abs_err, "bound_by": b_by,
                              "shape": [rows, n, DDC_TAPS, factor]})
        else:
            entry_row["bound_by_dense"] = b_by
        phase("12 timing", f"fir_decimate complex ({rows}, {n}) K={DDC_TAPS} f={factor}: "
              f"kernel {kern[0]:.4f}/{kern[1]:.4f} ms, plain {plain[0]:.4f}/{plain[1]:.4f} ms, "
              f"conv1d (cuDNN, FP32, 2 planes, groups=2, max|Δ|/max|y| {lib_rel:.3g}) "
              f"{library:.4f} ms (mean of "
              f"{TIMED_LAUNCHES}); bound {b_ms:.4f} ms by {b_by}, {100 * b_ms / ms:.2f}% of it; "
              f"max|Δ| {abs_err:.4g}")
        phase("12 timing", f"fir_decimate f={factor}: the DDC's call, a ({rows}, {DDC_TAPS - 1}) "
              f"state beside a ({rows}, {DDC_SAMPLES}) block (equal bit for bit), "
              f"{two_pointer:.4f} ms")
    del state, block

    # real float32 input at the same shape: half the bytes, the same FMAs
    xr = torch.randn((rows, n), generator=gen, device=dev)
    for factor, key in ((DDC_DECIMATION, ""), (1, "_dense")):
        _, rel = rel_err(fir.fir_decimate_cuda(xr, taps, factor), fir.fir_decimate(xr, taps, factor))
        if not rel < FIR_REL_TOL:
            raise AssertionError(f"fir_decimate real ({rows}, {n}) f={factor}: {rel:.3g}")
        entry_row[f"ms_real{key}"] = cuda_ms(lambda: fir.fir_decimate_cuda(xr, taps, factor))
        phase("12 real", f"fir_decimate float32 ({rows}, {n}) K={DDC_TAPS} f={factor}: "
              f"{entry_row[f'ms_real{key}']:.4f} ms (mean of {TIMED_LAUNCHES}), max|Δ|/max|ref| "
              f"{rel:.3g} < {FIR_REL_TOL}")
    del xr

    # where the time goes: the kernel from 1 to 127 taps beside one copy of x,
    # which moves the bytes the kernel must at f = 1
    y = torch.empty_like(x)
    copy = cuda_ms(lambda: y.copy_(x))
    del y
    entry_row["ms_copy"] = copy
    for factor in (DDC_DECIMATION, 1):
        by_k = {}
        for k in FIR_SWEEP_TAPS:
            taps_k = torch.randn(k, generator=gen, device=dev)
            by_k[k] = cuda_ms(lambda: fir.fir_decimate_cuda(x, taps_k, factor))
        entry_row[f"ms_by_k_f{factor}"] = {str(k): t for k, t in by_k.items()}
        phase("12 taps", f"fir_decimate ({rows}, {n}) f={factor}: " + ", ".join(
            f"K={k} {t:.4f}" for k, t in by_k.items()) + f" ms; x.copy_ {copy:.4f} ms")
    return entry_row


def check_nco_kernel(dev: torch.device) -> dict:
    """Phase 13: the NCO kernel against its plain version at ±fs/4, ±fs/8 and
    2500 Hz at 1 MHz, gain 1 and 2, φ₀ 0 and 1, up to 2^20 samples a row
    (the phase-rounding trap shows only at large indices), at row counts
    that are not a multiple of the row tile (1, 3, 17) and odd n, each also
    as a view 8 bytes off 16-byte alignment; then timed at (64, 2^20).
    Returns the kernel-table entry."""
    gen = torch.Generator(device=dev).manual_seed(13)
    cases, worst, bitwise = 0, 0.0, 0
    for rows, n in NCO_SHAPES:
        flat = randn_iq((rows * n + 1,), gen)
        for view, x in (("aligned", flat[:-1].view(rows, n)), ("8 B off", flat[1:].view(rows, n))):
            scale = float(x.abs().max())
            for freq, rate in NCO_CASES:
                for gain in (1.0, 2.0):
                    for phase0 in (0.0, 1.0):
                        got = nco.nco_mix_cuda(x, freq, rate, phase0, gain)
                        want = nco.nco_mix(x, freq, rate, phase0, gain)
                        rel = float((got - want).abs().max()) / (gain * scale)
                        cases += 1
                        bitwise += bool(torch.equal(got, want))
                        worst = max(worst, rel)
                        if not rel <= NCO_REL_TOL:
                            raise AssertionError(
                                f"nco_mix ({rows}, {n}) {view} f={freq} fs={rate} gain={gain} "
                                f"φ0={phase0}: max|Δ|/(gain·max|x|) {rel:.3g}")
    phase("13 nco kernel", f"{cases} cases (±fs/4, ±fs/8, 2500 Hz at 1 MHz; gain 1/2; φ0 0/1; "
          f"(rows, n) {' '.join(f'({r}, {n})' for r, n in NCO_SHAPES)}, aligned and 8 B off) "
          f"match the plain version: worst max|Δ|/(gain·max|x|) {worst:.3g} <= {NCO_REL_TOL}; "
          f"{bitwise} of them bit for bit")

    x = randn_iq((DDC_STREAMS, DDC_SAMPLES), gen)
    freq = -DDC_CENTER_HZ
    got = nco.nco_mix_cuda(x, freq, DDC_RATE_HZ)
    abs_err = float((got - nco.nco_mix(x, freq, DDC_RATE_HZ)).abs().max())
    del got
    kern, plain = in_turns(lambda: nco.nco_mix(x, freq, DDC_RATE_HZ),
                           lambda: nco.nco_mix_cuda(x, freq, DDC_RATE_HZ))
    b_ms, b_by = bound(16 * x.numel(), 0)  # 8 bytes in, 8 out per sample
    ms = sum(kern) / 2
    phase("13 timing", f"nco_mix at {tuple(x.shape)}, f={freq}: kernel {kern[0]:.4f}/"
          f"{kern[1]:.4f} ms, plain {plain[0]:.4f}/{plain[1]:.4f} ms (mean of "
          f"{TIMED_LAUNCHES}); bound {b_ms:.4f} ms by {b_by}, {100 * b_ms / ms:.2f}% of it; "
          f"max|Δ| {abs_err:.4g}")
    return {"max_abs_err": abs_err, "ms": ms, "plain_ms": sum(plain) / 2, "bound_ms": b_ms,
            "bound_by": b_by, "shape": list(x.shape)}


def check_dechirp_ragged(dev: torch.device) -> None:
    """Phase 3, ragged blocks: at every SF, row counts that are not a multiple of
    the kernel's rows per block (1, 3, 5 and 5·rows-per-block + 3 rows, and
    100,003 at SF7), held to the same bars as the full blocks."""
    worst, cases = 0.0, []
    for sf in range(5, 13):
        params = lora.LoRaParams(sf=sf)
        k = params.chips_per_symbol
        down = chirp.base_downchirp(params, dev)
        gen = torch.Generator(device=dev).manual_seed(200 + sf)
        per_block = launch_plan(k).rows_per_block
        counts = {1, 3, 5, 5 * per_block + 3} | ({DECHIRP_RAGGED_ROWS_SF7} if sf == 7 else set())
        for rows in sorted(counts):
            syms = torch.randint(0, k, (rows,), generator=gen, device=dev, dtype=torch.int32)
            clean = chirp.symbol_chirps(params, syms)
            for label, x in (("chirps", clean), ("noise", randn_iq((rows, k), gen))):
                got, ref = dechirp_power_cuda(x, down), dechirp_power(x, down)
                torch.cuda.synchronize()
                _, rel = rel_err(got, ref)
                worst = max(worst, rel)
                if not rel < REL_TOL:
                    raise AssertionError(f"SF{sf} {rows} {label} rows: max|Δ|/max(ref) {rel:.3g}")
                if label == "chirps" and not torch.equal(got.argmax(-1).int(), syms):
                    raise AssertionError(f"SF{sf} {rows} rows: argmax differs on clean chirps")
        cases.append(f"SF{sf} {'/'.join(map(str, sorted(counts)))}")
    phase("3 kernel", f"ragged blocks ({'; '.join(cases)} rows) match the plain version: worst "
          f"max|Δ|/max(ref) {worst:.3g} < {REL_TOL}, argmax equal to the sent symbols")


def drive_ddc_path(dev: torch.device) -> None:
    """Phase 14: the DDC path through the port's entry points."""
    bench = ddc_bench(dev)
    phase("14 ddc bench", f"{bench['streams']} streams × {bench['samples']} samples at "
          f"{DDC_RATE_HZ / 1e6} MS/s, /{bench['decimation']}: tone amplitude "
          f"{bench['tone_amplitude']}, interferer >= {bench['rejection_db']:.2f} dB down, peak "
          f"at bin {bench['peak_bin']}; msps {bench['msps']:.3f}, compute_s "
          f"{bench['compute_s']:.6f}")

    x = ddc_signal(dev)
    y = stream_math.digital_down_convert(x, DDC_CENTER_HZ, DDC_RATE_HZ, DDC_DECIMATION)
    taps = torch.from_numpy(filters.design_lowpass(
        DDC_TAPS, DDC_RATE_HZ / (2.5 * DDC_DECIMATION), DDC_RATE_HZ)).to(dev)
    want = plain_decimating_fir(taps, nco.nco_mix(x, -DDC_CENTER_HZ, DDC_RATE_HZ),
                                DDC_DECIMATION)
    _, rel = rel_err(y, want)
    if not rel < DDC_REL_TOL:
        raise AssertionError(f"DDC path differs from the plain path: {rel:.3g}")
    del x, y, want
    phase("14 ddc path", f"digital_down_convert equals the plain path on the bench signal: "
          f"max|Δ|/max|ref| {rel:.3g} < {DDC_REL_TOL}")

    gen = torch.Generator(device=dev).manual_seed(14)
    rate_in = DDC_RATE_HZ / DDC_DECIMATION
    m = torch.arange(ROUND_TRIP_SAMPLES, dtype=torch.float64, device=dev)
    start = 2.0 * math.pi * torch.rand((DDC_STREAMS, 1), generator=gen, device=dev,
                                       dtype=torch.float64)
    base = torch.polar(torch.ones_like(m), 2.0 * math.pi * ROUND_TRIP_TONE_HZ / rate_in * m
                       + start).to(torch.complex64)
    up = filters2.digital_up_converter(base, DDC_DECIMATION, DDC_CENTER_HZ, DDC_RATE_HZ)
    down = stream_math.digital_down_convert(up, DDC_CENTER_HZ, DDC_RATE_HZ, DDC_DECIMATION)
    seg = slice(64, ROUND_TRIP_SAMPLES - 64)
    amp = torch.abs(torch.mean(down[:, seg].to(torch.complex128) * base[:, seg].conj(), dim=-1))
    if not (down.shape == base.shape and float((amp - 1.0).abs().max()) < 0.02):
        raise AssertionError(f"DUC -> DDC round trip: {tuple(down.shape)}, amplitude "
                             f"{float(amp.min())}..{float(amp.max())}")
    phase("14 round trip", f"DUC ×{DDC_DECIMATION} to {DDC_CENTER_HZ / 1e6} MHz and DDC back, "
          f"{tuple(base.shape)}: tone amplitude {float(amp.min()):.6f}..{float(amp.max()):.6f}")
    del up, down

    fs = 1e6
    center = -fs / (32 * math.pi)  # a phase step of exactly 1/16 rad: block phases are exact
    x = randn_iq((DDC_STREAMS, XLATING_BLOCKS << 16), gen)
    xtaps = filters.design_lowpass(DDC_TAPS, 50e3, fs)
    whole, _, _ = filters.freq_xlating_fir(xtaps, x, center, fs)
    parts, state, ph = [], None, 0.0
    for block in x.chunk(XLATING_BLOCKS, dim=-1):
        y, state, ph = filters.freq_xlating_fir(xtaps, block, center, fs, state, ph)
        parts.append(y)
    _, rel = rel_err(torch.cat(parts, dim=-1), whole)
    if not rel < FIR_REL_TOL:
        raise AssertionError(f"freq_xlating_fir in {XLATING_BLOCKS} blocks: {rel:.3g}")
    phase("14 freq_xlating_fir", f"{XLATING_BLOCKS} blocks with carried state and phase equal "
          f"one shot at {tuple(x.shape)}: max|Δ|/max|ref| {rel:.3g}")

    x = x[:, : 1 << 16].contiguous()
    y = resample.rational_resample(x, 3, 2)
    rtaps = torch.from_numpy(filters.design_lowpass(128, 0.5 / 3, 1.0)).to(dev)
    want = plain_decimating_fir(rtaps, filters._zero_stuff(x, 3), 2)
    _, rel = rel_err(y, want)
    if not (y.is_cuda and y.shape == (DDC_STREAMS, 3 << 15) and rel < FIR_REL_TOL):
        raise AssertionError(f"rational_resample 3/2: {tuple(y.shape)} on {y.device}, {rel:.3g}")
    phase("14 rational_resample", f"3/2 on {tuple(x.shape)} -> {tuple(y.shape)} on the card, "
          f"max|Δ|/max|plain| {rel:.3g}")


def check_card_against_cpu(dev: torch.device) -> None:
    """Phase 16: functions that no path above runs, on the card against the
    port's own CPU results on the same input: the FIR family's other users
    within FIR_REL_TOL, vco's tone frequency at 2^20 samples within the
    reference test's 1e-3, its phase there within VCO_PHASE_ULPS of an exact
    sum and its samples at 4096 within MIX_TOL, puncture, depuncture and
    make_window bit for bit."""
    gen = torch.Generator().manual_seed(16)
    x = torch.complex(torch.randn(COVERAGE_SHAPE, generator=gen),
                      torch.randn(COVERAGE_SHAPE, generator=gen))
    xr = torch.randn(COVERAGE_SHAPE, generator=gen)
    taps = filters.design_lowpass(31, 0.1, 1.0)
    cases = (("interpolating_fir", lambda v: (filters.interpolating_fir(taps, v, 4),), x),
             ("polyphase_interpolate", lambda v: (resample.polyphase_interpolate(v, taps, 3),), x),
             ("halfband_decimate", lambda v: (resample.halfband_decimate(v),), x),
             ("moving_average", lambda v: filters.moving_average(v, 16), xr),
             ("moving_rms", lambda v: (filters.moving_rms(v, 8),), x))
    worst = 0.0
    for name, fn, arg in cases:
        for got, want in zip(fn(arg.to(dev)), fn(arg)):
            if not (got.is_cuda and got.shape == want.shape and got.dtype == want.dtype):
                raise AssertionError(f"{name}: {got.shape} {got.dtype} on {got.device}, CPU "
                                     f"{want.shape} {want.dtype}")
            _, rel = rel_err(got.cpu(), want)
            worst = max(worst, rel)
            if not rel < FIR_REL_TOL:
                raise AssertionError(f"{name}: card vs CPU max|Δ|/max|CPU| {rel:.3g}")
    phase("16 card vs cpu", f"{', '.join(c[0] for c in cases)} on {tuple(x.shape)} equal the "
          f"CPU's results: worst max|Δ|/max|CPU| {worst:.3g} < {FIR_REL_TOL}")

    fs, sens = 100e3, 2000.0  # tests/test_detect_streammath.py:194-200: 0.5 units -> 1 kHz
    freqs = {}
    for where in ("cpu", dev):
        y = stream_math.vco(torch.full((VCO_SAMPLES,), 0.5, device=where), sens, fs)
        step = torch.angle(y[1:] * y[:-1].conj()).double().mean()
        freqs[str(torch.device(where).type)] = float(step) * fs / (2 * math.pi)
    card, cpu = freqs["cuda"], freqs["cpu"]
    if not (abs(card - cpu) <= VCO_FREQ_REL_TOL * cpu
            and abs(card - 1e3) <= VCO_FREQ_REL_TOL * 1e3):
        raise AssertionError(f"vco tone at {VCO_SAMPLES} samples: card {card} Hz, CPU {cpu} Hz")
    ctrl = torch.rand((2, VCO_SAMPLES), generator=gen) * 2.0 - 1.0
    # the port's own float32 steps, summed exactly
    exact = torch.cumsum((2.0 * math.pi * sens * ctrl / fs).double(), dim=-1)
    phase_err = {}
    for where in ("cpu", dev):
        y = stream_math.vco(ctrl.to(where), sens, fs).cpu()
        phase_err[str(torch.device(where).type)] = float(
            torch.angle(y.to(torch.complex128) * torch.polar(torch.ones_like(exact), -exact))
            .abs().max())
    ulp = float(torch.finfo(torch.float32).eps) * float(exact.abs().max())
    if not max(phase_err.values()) <= VCO_PHASE_ULPS * ulp:
        raise AssertionError(f"vco phase at {VCO_SAMPLES} samples drifts {phase_err} rad from "
                             f"its exact sum, beyond {VCO_PHASE_ULPS} float32 ulps ({ulp:.3g} rad)")
    short = ctrl[:, :4096]
    _, rel = rel_err(stream_math.vco(short.to(dev), sens, fs).cpu(),
                     stream_math.vco(short, sens, fs))
    if not rel < MIX_TOL:
        raise AssertionError(f"vco at 4096 samples: card vs CPU max|Δ|/max|CPU| {rel:.3g}")
    phase("16 vco", f"constant control at {VCO_SAMPLES} samples: tone {card:.6f} Hz on the card, "
          f"{cpu:.6f} Hz on the CPU (1 kHz ± {VCO_FREQ_REL_TOL:g}); random control at 4096 "
          f"samples: max|Δ|/max|CPU| {rel:.3g} < {MIX_TOL}; at {VCO_SAMPLES}: max phase error "
          f"against a float64 cumsum {phase_err['cuda']:.3g} rad on the card (parallel float32 "
          f"scan), {phase_err['cpu']:.3g} rad on the CPU, both within {VCO_PHASE_ULPS} float32 ulps "
          f"of max|φ| ({ulp:.3g} rad each)")

    coded = torch.randint(0, 2, (COVERAGE_SHAPE[0], 4800), generator=gen, dtype=torch.int32)
    for pattern in PUNCTURE_PATTERNS:
        kept = convolutional.puncture(coded.to(dev), pattern)
        if not (kept.is_cuda and torch.equal(kept.cpu(), convolutional.puncture(coded, pattern))):
            raise AssertionError(f"puncture {pattern}: card differs from CPU")
        soft = 1.0 - 2.0 * kept.float()
        for fill in (0.0, 0.5):
            got = convolutional.depuncture(soft, pattern, coded.shape[-1], fill)
            if not (got.is_cuda and torch.equal(got.cpu(), convolutional.depuncture(
                    soft.cpu(), pattern, coded.shape[-1], fill))):
                raise AssertionError(f"depuncture {pattern} fill {fill}: card differs from CPU")
    for kind in WINDOW_KINDS:
        for n in (1, 2, 33, 64, 4096):
            got = windows.make_window(kind, n, device=dev)
            if not got.is_cuda:
                raise AssertionError(f"make_window {kind} {n} on {got.device}")
            torch.testing.assert_close(got.cpu(), windows.make_window(kind, n, device="cpu"),
                                       rtol=0, atol=0, equal_nan=True)
    phase("16 card vs cpu", f"puncture/depuncture ({len(PUNCTURE_PATTERNS)} patterns, fill 0 and "
          f"0.5) and make_window ({len(WINDOW_KINDS)} kinds, n 1/2/33/64/4096) equal the CPU's "
          f"bit for bit")


def noisy_branch_metrics(lanes: int, steps: int, constraint: int, seed: int, polys=None):
    """(steps, 2^R, lanes) branch metrics of 1 - 2·coded + 0.4·N(0, 1), made on the card."""
    polys = VITERBI_CODES[constraint] if polys is None else polys
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_info = steps - (constraint - 1)
    bits = torch.randint(0, 2, (lanes, n_info), generator=gen, device="cuda",
                         dtype=torch.int32)
    coded = convolutional.conv_encode(bits, constraint, polys)
    soft = 1.0 - 2.0 * coded.float() + 0.4 * torch.randn(coded.shape, generator=gen,
                                                         device="cuda")
    return convolutional._branch_metrics(soft.reshape(lanes, steps, len(polys)))


def check_viterbi(bm: torch.Tensor, constraint: int, polys=None) -> dict:
    """Both kernels against their plain versions on `bm`, with torch.equal;
    also the device milliseconds of the plain forward pass and of the plain
    traceback from state 0 (one call each, between CUDA events)."""
    polys = VITERBI_CODES[constraint] if polys is None else polys
    dec, final = viterbi.viterbi_forward_cuda(bm, constraint, polys)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    marks[0].record()
    want_dec, want_final = viterbi.viterbi_forward(bm, constraint, polys)
    marks[1].record()
    want_bits = [viterbi.viterbi_traceback(want_dec, constraint, polys)]
    marks[2].record()
    start = torch.argmax(want_final, dim=0).to(torch.int32)
    want_bits.append(viterbi.viterbi_traceback(want_dec, constraint, polys, start))
    bits = [viterbi.viterbi_traceback_cuda(want_dec, constraint, polys, s) for s in (None, start)]
    torch.cuda.synchronize()
    label = f"K={constraint} R={len(polys)} (T, L)=({bm.shape[0]}, {bm.shape[2]})"
    if not (torch.equal(dec, want_dec) and torch.equal(final, want_final)):
        raise AssertionError(f"{label}: viterbi_forward kernel differs from the plain version")
    if not all(torch.equal(a, b) for a, b in zip(bits, want_bits)):
        raise AssertionError(f"{label}: viterbi_traceback kernel differs from the plain version")
    return {"forward_abs_err": float(torch.max(torch.abs(final - want_final))),
            "traceback_abs_err": max(float(torch.max(torch.abs(a - b)))
                                     for a, b in zip(bits, want_bits)),
            "plain_forward_ms": marks[0].elapsed_time(marks[1]),
            "plain_traceback_ms": marks[1].elapsed_time(marks[2])}


def forward_bound(bm: torch.Tensor, dec: torch.Tensor, constraint: int) -> tuple[float, str]:
    """The forward kernel's bound: bm in, decisions and final metrics out;
    2 adds and 1 compare per target state and step."""
    steps, n_codes, lanes = bm.shape
    states = 1 << (constraint - 1)
    return bound(4 * (steps * n_codes * lanes + steps * dec.shape[1] * lanes + states * lanes),
                 3 * states * steps * lanes)


def traceback_bounds(dec: torch.Tensor):
    """(one word read and one bit written per (step, lane), the floor of a
    kernel that stages all G words of a step), each (ms, by)."""
    steps, groups, lanes = dec.shape
    return (bound(4 * 2 * steps * lanes, 5 * steps * lanes),
            bound(4 * (groups + 1) * steps * lanes, 5 * steps * lanes))


def check_viterbi_kernels() -> dict:
    """Phase 8: both Viterbi kernels equal their plain versions bit for bit,
    for K = 5 and 7 at small shapes (one lane, as MIL-STD-188-110 decodes,
    a ragged block, several blocks), for every K = 3-8 at R = 2 and K = 7 at
    R = 3 with ragged lanes and steps, and at the decode bench's shape, where
    they are also timed beside the plain versions; both also at
    MIL-STD-188-110's one-lane plan. Every traceback runs from state 0 and
    from the best final state. Returns the kernel-table entries of both
    kernels (times, bounds and errors at the bench shape)."""
    cases = 0
    for constraint in VITERBI_CODES:
        for lanes in (1, 3, 130, 2100):
            for steps in (constraint + 1, 255, 512):
                check_viterbi(noisy_branch_metrics(lanes, steps, constraint, seed=steps * lanes),
                              constraint)
                cases += 1
    phase("8 viterbi", f"{cases} cases, K=5 and 7, lanes 1/3/130/2100, T K+1/255/512: "
          f"decisions, final metrics and bits equal the plain versions (torch.equal)")
    cases = 0
    for constraint, polys in VITERBI_ALL_CODES:
        for lanes in VITERBI_ALL_LANES:
            for steps in VITERBI_RAGGED_STEPS:
                bm = noisy_branch_metrics(lanes, steps, constraint, steps + lanes, polys)
                check_viterbi(bm, constraint, polys)
                cases += 1
    phase("8 viterbi", f"{cases} cases, K=3-8 at R=2, K=7 at R=3 and two codes without both "
          f"end taps, lanes "
          f"{'/'.join(map(str, VITERBI_ALL_LANES))}, T {'/'.join(map(str, VITERBI_RAGGED_STEPS))} "
          f"(ragged chunks and blocks): decisions, final metrics and bits equal the plain "
          f"versions (torch.equal)")

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
    fwd_bound = forward_bound(bm, dec, constraint)
    # MIL-STD-188-110's plan: one lane, one warp, latency-bound
    one = noisy_branch_metrics(1, MIL_STEPS, constraint, seed=7)
    check_viterbi(one, constraint)
    plain1 = [cuda_ms(lambda: viterbi.viterbi_forward(one, constraint, polys), PLAIN_VITERBI_CALLS)]
    kern1 = [cuda_ms(lambda: viterbi.viterbi_forward_cuda(one, constraint, polys))
             for _ in range(2)]
    plain1.append(cuda_ms(lambda: viterbi.viterbi_forward(one, constraint, polys),
                          PLAIN_VITERBI_CALLS))
    one_dec, _ = viterbi.viterbi_forward_cuda(one, constraint, polys)
    bound1, by1 = forward_bound(one, one_dec, constraint)
    phase("8 timing", f"viterbi_forward at {tuple(one.shape)} (one lane): kernel {kern1[0]:.4f}/"
          f"{kern1[1]:.4f} ms (mean of {TIMED_LAUNCHES}), plain {plain1[0]:.4f}/{plain1[1]:.4f} "
          f"ms; bound {bound1:.4f} ms by {by1}, {100 * bound1 / (sum(kern1) / 2):.2f}% of it")

    tb1 = [cuda_ms(lambda: viterbi.viterbi_traceback(one_dec, constraint, polys),
                   PLAIN_VITERBI_CALLS)]
    tk1 = [cuda_ms(lambda: viterbi.viterbi_traceback_cuda(one_dec, constraint, polys))
           for _ in range(2)]
    tb1.append(cuda_ms(lambda: viterbi.viterbi_traceback(one_dec, constraint, polys),
                       PLAIN_VITERBI_CALLS))
    (tb_bound1, tb_by1), (tb_all1, _) = traceback_bounds(one_dec)
    phase("8 timing", f"viterbi_traceback at {tuple(one_dec.shape)} (one lane): kernel "
          f"{tk1[0]:.4f}/{tk1[1]:.4f} ms (mean of {TIMED_LAUNCHES}), plain {tb1[0]:.4f}/"
          f"{tb1[1]:.4f} ms; bound {tb_bound1:.3g} ms by {tb_by1} (all-words floor "
          f"{tb_all1:.3g} ms), {100 * tb_bound1 / (sum(tk1) / 2):.3g}% of it")
    # the bench's decisions 4 bytes off 16-byte alignment: staged by 4-byte copies
    off = torch.empty(dec.numel() + 1, dtype=dec.dtype, device=dec.device)[1:].view(dec.shape)
    off.copy_(dec)
    unaligned_equal = torch.equal(viterbi.viterbi_traceback_cuda(off, constraint, polys),
                                  viterbi.viterbi_traceback(dec, constraint, polys))
    if not unaligned_equal:
        raise AssertionError("traceback kernel on unaligned decisions differs from plain")
    tk_off = [cuda_ms(lambda: viterbi.viterbi_traceback_cuda(off, constraint, polys))
              for _ in range(2)]
    phase("8 timing", f"viterbi_traceback at {tuple(off.shape)}, decisions 4 bytes off 16-byte "
          f"alignment (4-byte copies): kernel {tk_off[0]:.4f}/{tk_off[1]:.4f} ms (mean of "
          f"{TIMED_LAUNCHES}); bits equal the plain version's")
    tb_bound, (tb_all, _) = traceback_bounds(dec)
    table = {}
    for name, (b_ms, b_by), err, shape in (
            ("viterbi_forward", fwd_bound, errs["forward_abs_err"], list(bm.shape)),
            ("viterbi_traceback", tb_bound, errs["traceback_abs_err"], [steps, groups, lanes])):
        kern, plain = times[name]
        table[name] = {"max_abs_err": err, "ms": sum(kern) / 2, "plain_ms": sum(plain) / 2,
                       "bound_ms": b_ms, "bound_by": b_by, "shape": shape}
        floor = (f" (all-words floor {tb_all:.4f} ms, {100 * tb_all / table[name]['ms']:.2f}% "
                 f"of it)" if name == "viterbi_traceback" else "")
        phase("8 timing", f"{name} at {tuple(shape)}: kernel {kern[0]:.4f}/{kern[1]:.4f} ms "
              f"(mean of {TIMED_LAUNCHES}), plain {plain[0]:.4f}/{plain[1]:.4f} ms (mean of "
              f"{PLAIN_VITERBI_CALLS}); bound {b_ms:.4f} ms by {b_by}, "
              f"{100 * b_ms / table[name]['ms']:.2f}% of it{floor}; max|Δ| {err}")
    table["viterbi_forward"].update({"ms_one_lane": sum(kern1) / 2,
                                     "plain_ms_one_lane": sum(plain1) / 2,
                                     "bound_ms_one_lane": bound1,
                                     "shape_one_lane": list(one.shape)})
    table["viterbi_traceback"].update({"bound_ms_all_words": tb_all,
                                       "ms_one_lane": sum(tk1) / 2,
                                       "plain_ms_one_lane": sum(tb1) / 2,
                                       "bound_ms_one_lane": tb_bound1,
                                       "bound_ms_all_words_one_lane": tb_all1,
                                       "shape_one_lane": list(one_dec.shape),
                                       "ms_unaligned": sum(tk_off) / 2})
    return table


def drive_gps_path(dev: torch.device) -> dict:
    """Phase 17: the GPS L1 C/A receiver at the JAX package's gate size
    through `entry.gps_pvt_fix`; fails unless every SV is acquired and
    decoded with consistent IODE/IODC, the fix is within 50 m and the
    solved speed of the static receiver under 1 m/s."""
    out = gps_pvt_fix(dev)
    speed = (out["velocity"] or {}).get("speed_mps", math.inf)
    rr = {r["prn"]: r.get("rr_err_mps") for r in out["per_sv"]}
    phase("17 gps pvt fix", f"{out['of']} SVs, 24.3 s at {gps.FS_DEC / 1e6} MS/s on {out['device']}: "
          f"gen_s {out['gen_s']:.6f}, acquire_s {out['acquire_s']:.6f}, track_s "
          f"{out['track_s']:.6f}; error {out['value']:.6f} m, acquired {out['acquired']}/{out['of']}, "
          f"decoded {out['decoded']}/{out['of']}, speed {speed:.6f} m/s, clock bias "
          f"{out['clock_bias_m']:.3f} m, max residual {out['max_residual_m']:.3f} m, C/N0 estimate "
          f"{out['cn0_est_dbhz']:.2f} dB-Hz; range-rate errors m/s {json.dumps(rr)}")
    iode = all(r.get("iode_ok") for r in out["per_sv"])
    if not (out["pass"] and out["acquired"] == out["decoded"] == out["of"] == 6 and iode
            and out["value"] < GPS_MAX_ERROR_M and speed < GPS_MAX_SPEED_MPS):
        raise AssertionError(f"the GPS gate failed: {json.dumps(out)}")
    return out


def tracking_inputs():
    """Phase 18's three C/A channels (tests/test_torch_gnss_tracking.py):
    2.046 MS/s, 20 ms bits on code epochs, numpy noise at 48 dB-Hz; seeds
    0.05 chips and 10 Hz off the truth. Returns (x, codes, phase0, dop0)."""
    rng = np.random.default_rng(0)
    n = TRACK_BLOCKS * int(TRACK_FS / 1000)
    t = np.arange(n) / TRACK_FS
    rows = []
    for prn_id, dop, chip0 in TRACK_CHANNELS:
        code = gnss_prn.gps_ca_code(prn_id).astype(np.float64)
        bits = 1 - 2 * rng.integers(0, 2, n // int(TRACK_FS * 0.02) + 2)
        epoch = np.floor(chip0 + t * 1.023e6 * (1 + dop / 1.57542e9)).astype(np.int64)
        sig = code[epoch % 1023] * bits[epoch // (1023 * 20)] * np.exp(2j * np.pi * (dop * t + 0.1))
        std = np.sqrt(TRACK_FS / 10 ** (TRACK_CN0_DBHZ / 10) / 2)
        rows.append(sig + std * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
    codes = np.stack([gnss_prn.gps_ca_code(p) for p, _, _ in TRACK_CHANNELS]).astype(np.float32)
    phase0 = np.array([c + TRACK_SEED_ERR_CHIPS for _, _, c in TRACK_CHANNELS], np.float32)
    dop0 = np.array([d + TRACK_SEED_ERR_HZ for _, d, _ in TRACK_CHANNELS], np.float32)
    return np.stack(rows).astype(np.complex64), codes, phase0, dop0


def composite_config() -> scenario.ScenarioConfig:
    """GPS with LNAV-like bits, GLONASS FDMA and Galileo E1C under the
    suburban multipath preset at 6.132 MS/s: every overlay, the integer
    FDMA phase and delayed taps in one block."""
    sat = scenario.SatelliteConfig
    sats = (sat(signal="GpsL1Ca", prn=7, cn0_dbhz=50.0, doppler_hz=1200.0, nav_data=True,
                nav_bits=tuple(int(b) for b in 1 - 2 * (np.arange(40) % 3 == 0))),
            sat(signal="GlonassL1of", prn=1, cn0_dbhz=48.0, doppler_hz=-900.0,
                carrier_offset_hz=-7 * 562_500.0),
            sat(signal="GalileoE1C", prn=5, cn0_dbhz=47.0, doppler_hz=2100.0, range_m=2.4e7,
                elevation_deg=15.0))
    return scenario.ScenarioConfig(satellites=sats, sample_rate=6.132e6, seed=18,
                                   environment=scenario.EnvironmentConfig(
                                       multipath_preset="Suburban", multipath_enabled=True))


def check_gnss_card_against_cpu(dev: torch.device) -> None:
    """Phase 18: the GNSS functions on the card against the port's CPU
    results on the same inputs: the PCPS grid at the bench shape within
    1e-4 of its peak; acquisition decisions identical and metrics within
    rtol 1e-4; 300 tracking blocks of three channels within the tracking
    tolerances; the scenario composite with zero noise within 1e-5 of its
    peak; the code-phase fix on one capture with identical acquisitions and
    errors within 0.01 m."""
    x, codes = pcps_inputs("cpu")
    want = acquisition.pcps_grid(x, codes, PCPS_RATE_HZ, PCPS_CONFIG)
    got = acquisition.pcps_grid(x.to(dev), codes.to(dev), PCPS_RATE_HZ, PCPS_CONFIG)
    _, rel = rel_err(got.cpu(), want)
    if not (got.device.type == dev.type and rel <= REL_TOL):
        raise AssertionError(f"pcps_grid card vs CPU: max|Δ|/max {rel:.3g} on {got.device}")
    phase("18 gnss card vs cpu", f"pcps_grid {tuple(got.shape)}: max|Δ|/max(CPU) {rel:.3g} "
          f"<= {REL_TOL}")

    cfg, _, _ = gps.code_phase_scenario()
    iq = scenario.GnssScenario(cfg, device="cpu").generate()
    prns = [s.prn for s in cfg.satellites]
    bank = torch.from_numpy(np.repeat(gps.ca_codes(prns), 8, axis=1))
    res = {str(d): acquisition.acquire(torch.from_numpy(iq).to(d), bank.to(d), prns, gps.FS,
                                       gps.ACQ_CONFIG) for d in ("cpu", dev)}
    card, cpu = res[str(dev)], res["cpu"]
    for name in ("detected", "code_phase", "doppler_hz"):
        if not torch.equal(getattr(card, name).cpu(), getattr(cpu, name)):
            raise AssertionError(f"acquire {name}: card {getattr(card, name).tolist()}, CPU "
                                 f"{getattr(cpu, name).tolist()}")
    metric_rel = float(((card.peak_metric.cpu() - cpu.peak_metric).abs() / cpu.peak_metric).max())
    if not metric_rel <= REL_TOL:
        raise AssertionError(f"acquire peak metric card vs CPU: rtol {metric_rel:.3g}")
    fixes = {str(d): gps.main_code_phase(device=d, iq=iq) for d in ("cpu", dev)}
    fc, fp = fixes[str(dev)], fixes["cpu"]
    if not (fc["code_phase"] == fp["code_phase"] and fc["doppler_hz"] == fp["doppler_hz"]
            and abs(fc["value"] - fp["value"]) <= PVT_TOL_M and fc["pass"]):
        raise AssertionError(f"main_code_phase card vs CPU: {fc} vs {fp}")
    phase("18 gnss card vs cpu", f"acquire on the code-phase gate's capture: detected, code phase "
          f"and Doppler equal, peak metric rtol {metric_rel:.3g}; main_code_phase error "
          f"{fc['value']:.6f} m on the card, {fp['value']:.6f} m on the CPU (within {PVT_TOL_M} m)")

    xs, tcodes, phase0, dop0 = tracking_inputs()
    tcfg = tracking.TrackingConfig(sample_rate=TRACK_FS)
    outs = {}
    for d in ("cpu", dev):
        st = tracking.init_state(tcfg, phase0, dop0, device=d)
        outs[str(d)] = tracking.track(tcfg, st, torch.from_numpy(xs).to(d),
                                      torch.from_numpy(tcodes).to(d))[1]
    card = {k: v.cpu() for k, v in outs[str(dev)]._asdict().items()}
    cpu = outs["cpu"]._asdict()
    scale = torch.abs(torch.complex(cpu["prompt_i"], cpu["prompt_q"])).amax(-1, keepdim=True)
    worst = {}
    for name in ("prompt_i", "prompt_q", "early_mag", "late_mag"):
        worst[name] = float(((card[name] - cpu[name]).abs() / scale).max())
        if not worst[name] <= PROMPT_REL_TOL:
            raise AssertionError(f"track {name} card vs CPU: {worst[name]:.3g} of max|prompt|")
    for name, tol in TRACK_TOLS.items():
        worst[name] = float((card[name] - cpu[name]).abs().max())
        if not worst[name] <= tol:
            raise AssertionError(f"track {name} card vs CPU: max|Δ| {worst[name]:.3g} > {tol}")
    if not torch.equal(tracking.extract_nav_bits(card["prompt_i"]),
                       tracking.extract_nav_bits(cpu["prompt_i"])):
        raise AssertionError("track: nav bits differ between the card and the CPU")
    phase("18 gnss card vs cpu", f"track, 3 channels × {TRACK_BLOCKS} blocks at "
          f"{TRACK_FS / 1e6} MS/s: worst {json.dumps({k: float(f'{v:.3g}') for k, v in worst.items()})}"
          f" (prompts as a share of max|prompt|), nav bits equal")

    comp = {}
    for d in ("cpu", dev):
        sc = scenario.GnssScenario(composite_config(), device=d)
        sc.generate_block(COMPOSITE_SAMPLES)  # one block in: carried phase, n0, Doppler
        inputs, _ = sc.block_inputs(COMPOSITE_SAMPLES)
        comp[str(d)] = scenario.composite_block(*sc.sv_banks(), *inputs, 0.0,
                                                n=COMPOSITE_SAMPLES, fs=sc.config.sample_rate,
                                                fdma_den=sc._fdma_den)
    card, cpu = comp[str(dev)].cpu(), comp["cpu"]
    err = (card - cpu).abs()
    over = int((err > COMPOSITE_TOL * cpu.abs().max()).sum())
    _, rel = rel_err(card, cpu)
    if not (comp[str(dev)].device.type == dev.type and over == 0):
        raise AssertionError(f"composite_block card vs CPU: {over} samples beyond "
                             f"{COMPOSITE_TOL} of the peak, max|Δ|/max {rel:.3g}")
    phase("18 gnss card vs cpu", f"composite_block, GPS + GLONASS FDMA + Galileo E1C under "
          f"suburban multipath, {COMPOSITE_SAMPLES} samples at 6.132 MS/s, zero noise: max|Δ|/max "
          f"{rel:.3g} <= {COMPOSITE_TOL}, 0 samples beyond it")


def time_gnss_paths(dev: torch.device) -> None:
    """Phase 19: `pcps_bench()` in Mcorr/s, and the three GNSS paths with no
    hand-written kernel (the PCPS grid at the bench shape, one tracking
    step of six channels at 4.092 MS/s, one composite block of the gate's
    capture) in ms per call beside their device launches and busy time per
    call (a tracking step's ms is host time per block over 1000 blocks,
    where the host sets the pace); the grid beside its bound (bytes: x,
    codes and the grid once; operations: the mixes, the FFTs at
    5·N·log2 N, the products and |·|²)."""
    bench = pcps_bench(dev)
    phase("19 pcps bench", f"{bench['shape']} (PRNs × Doppler bins × phases), 2 periods: "
          f"{bench['mcorr_per_s']:.3f} Mcorr/s, {bench['ms_per_call']:.6f} ms per call (mean of "
          f"{bench['calls']} chained calls)")
    x, codes = pcps_inputs(dev)
    p, l = codes.shape
    d = len(acquisition.doppler_bins(PCPS_CONFIG))
    k = PCPS_CONFIG.coherent_periods
    fft = 5.0 * l * math.log2(l)
    b_ms, b_by = bound(8 * k * l + 4 * p * l + 4 * p * d * l,
                       k * (6 * d * l + d * fft + 6 * p * d * l + p * d * fft + 4 * p * d * l)
                       + p * fft)
    rows = {"pcps_grid": (lambda: acquisition.pcps_grid(x, codes, PCPS_RATE_HZ, PCPS_CONFIG), 1)}

    big = scenario.GnssScenario(gps.decoded_scenario()[0], device=dev)
    inputs, _ = big.block_inputs(GNSS_BLOCK_SAMPLES)
    rows["composite_block"] = (lambda: scenario.composite_block(
        *big.sv_banks(), *inputs, big._noise_std, torch.Generator(device=dev).manual_seed(19),
        n=GNSS_BLOCK_SAMPLES, fs=gps.FS_DEC), 1)
    table = {}
    for name, (fn, per) in rows.items():
        prof = breakdown(fn)
        table[name] = {"ms_per_call": cuda_ms(fn, 3) / per,
                       "launches_per_call": prof["device_events"] / per,
                       "busy_ms_per_call": prof["busy_ms"] / per, "idle_share": prof["idle_share"]}

    # One tracking step: six channels of the gate's capture at 4.092 MS/s.
    # Launches and busy time per block from the difference of a 20- and a
    # 10-block call (the set-up cancels); host time per block over 1000.
    full = big.generate_device()
    tcfg = tracking.TrackingConfig(sample_rate=gps.FS_DEC, costas=True, fll_gain=0.2)
    bs, n_ch = tcfg.block_size, len(big.satellites)
    st = tracking.init_state(tcfg, np.zeros(n_ch, np.float32), np.zeros(n_ch, np.float32),
                             device=dev)
    ca = torch.from_numpy(gps.ca_codes([s.prn for s in big.satellites])).to(dev)
    start = np.arange(n_ch) * 617

    def run(blocks):
        _, out = tracking.track(tcfg, st, full[: (blocks + 1) * bs], ca, start=start)
        return out.prompt_i

    few = [breakdown(lambda b=b: run(b)) for b in (10, 20)]
    run(GNSS_TIMED_BLOCKS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(GNSS_TIMED_BLOCKS).cpu()
    table["tracking step"] = {
        "ms_per_call": (time.perf_counter() - t0) * 1e3 / GNSS_TIMED_BLOCKS,
        "launches_per_call": (few[1]["device_events"] - few[0]["device_events"]) / 10,
        "busy_ms_per_call": (few[1]["busy_ms"] - few[0]["busy_ms"]) / 10, "shape": [n_ch, bs]}
    del full
    table["e1b tracking step"] = time_e1b_step(dev)
    table["pcps_grid"].update({"bound_ms": b_ms, "bound_by": b_by, "shape": [p, d, l, k]})
    table["composite_block"]["shape"] = [n_ch, GNSS_BLOCK_SAMPLES]
    phase("19 gnss paths", json.dumps(table))


def time_e1b_step(dev: torch.device) -> dict:
    """One E1B closed tracking step of the Galileo gate's six channels
    (20,460 samples a block at 5.115 MS/s), as phase 19 times the GPS step:
    host ms per block over E1B_TIMED_BLOCKS blocks, launches and busy time
    per block from a 20- less a 10-block call."""
    cfg, _ = gal.galileo_scenario((E1B_TIMED_BLOCKS + 2) * gal.T_EP)
    prns = [s.prn for s in cfg.satellites]
    rx = scenario.GnssScenario(cfg, device=dev).generate_device()
    code_t = torch.from_numpy(np.stack(gal.e1b_codes(prns)).astype(np.float32)).to(dev)
    bs = gal.tracking_config(gal.CLOSED_LOOP).block_size
    start = np.arange(len(prns)) * 617
    zeros = np.zeros(len(prns))

    def run(blocks):
        return gal.closed_pass(rx[: (blocks + 1) * bs], code_t, start, zeros, zeros).prompt_i

    few = [breakdown(lambda b=b: run(b)) for b in (10, 20)]
    run(E1B_TIMED_BLOCKS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(E1B_TIMED_BLOCKS).cpu()
    return {"ms_per_call": (time.perf_counter() - t0) * 1e3 / E1B_TIMED_BLOCKS,
            "launches_per_call": (few[1]["device_events"] - few[0]["device_events"]) / 10,
            "busy_ms_per_call": (few[1]["busy_ms"] - few[0]["busy_ms"]) / 10,
            "shape": [len(prns), bs]}


def kernel_counts() -> dict:
    return {"dechirp_power": dechirp_power.launches, "fir_decimate": fir.fir_decimate.launches,
            "nco_mix": nco.nco_mix.launches, "viterbi_forward": viterbi.viterbi_forward.launches,
            "viterbi_traceback": viterbi.viterbi_traceback.launches}


class CallSpy:
    """Wraps `module.<name>` while entered: records the shape of each call's
    first argument (with `keep`, the argument too) and the hand-written
    kernel launches made inside the calls; the calls run unchanged. (The
    I/NAV decodes: lanes = page parts; STANAG 4285: one lane; the preamble
    search: window rows; SINCGARS data: lanes = frames.)"""

    def __init__(self, module, name: str, keep: bool = False):
        self.module, self.name, self.shapes, self.firsts, self.keep = module, name, [], [], keep
        self.launches = dict.fromkeys(kernel_counts(), 0)

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def spy(first, *args, **kwargs):
            self.shapes.append(tuple(first.shape))
            if self.keep:
                self.firsts.append(first)
            before = kernel_counts()
            out = self.orig(first, *args, **kwargs)
            for k, v in kernel_counts().items():
                self.launches[k] += v - before[k]
            return out

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def check_inav_launches(name: str, counts: dict, decodes: int) -> None:
    """The I/NAV decodes launched both Viterbi kernels once each, and no
    other hand-written kernel ran."""
    want = {"dechirp_power": 0, "fir_decimate": 0, "nco_mix": 0,
            "viterbi_forward": decodes, "viterbi_traceback": decodes}
    if decodes <= 0 or counts != want:
        raise AssertionError(f"the {name} path launched {counts}, want {want}")


def drive_galileo_path(dev: torch.device) -> dict:
    """Phase 20: the Galileo E1B gate at full size (six SVs, 11.2 s at
    5.115 MS/s) through `entry.galileo_pvt`; fails unless every SV is
    acquired and decoded with words 1-5 and one IODnav, the error is under
    60 m, and each channel's pages went through one launch of each Viterbi
    kernel (no other hand-written kernel)."""
    zero_launch_counts()
    with CallSpy(inav, "viterbi_decode") as decodes:
        out = galileo_pvt(dev)
    counts = kernel_counts()
    pages = {r["prn"]: f"{r['pages_crc_ok']}/{r['pages_seen']}" for r in out["per_sv"]}
    phase("20 galileo pvt", f"{out['of']} SVs, {gal.DURATION_S} s at {gal.FS / 1e6} MS/s on "
          f"{out['device']}: "
          f"gen_s {out['gen_s']:.6f}, acquire_s {out['acquire_s']:.6f}, track_s "
          f"{out['track_s']:.6f}, decode_s {out['decode_s']:.6f}; error {out['value']:.6f} m, "
          f"acquired {out['acquired']}/{out['of']}, decoded {out['decoded']}/{out['of']}, clock "
          f"bias {out['clock_bias_m']:.3f} m, max residual {out['max_residual_m']:.3f} m, C/N0 "
          f"estimate {out['cn0_est_dbhz']:.2f} dB-Hz; pages CRC ok/seen by PRN {json.dumps(pages)}"
          f"; decodes (lanes, 240) {decodes.shapes}; launches {json.dumps(counts)}")
    words = all(r["words"] == [1, 2, 3, 4, 5] and "iodnav" in r for r in out["per_sv"])
    if not (out["pass"] and out["acquired"] == out["decoded"] == out["of"] == 6 and words
            and out["value"] < GAL_MAX_ERROR_M):
        raise AssertionError(f"the Galileo gate failed: {json.dumps(out)}")
    check_inav_launches("Galileo", counts, len(decodes.shapes))
    return {"launches": counts["viterbi_forward"], "lanes": [s[0] for s in decodes.shapes]}


def drive_dual_path(dev: torch.device) -> dict:
    """Phase 21: the joint GPS + Galileo gate at full size (5 + 5 SVs,
    24.3 s at 5.115 MS/s) through `entry.dual_pvt`; fails unless all ten
    SVs decode, the joint error is under 60 m and the static receiver's
    solved speed under 1 m/s, with one launch of each Viterbi kernel per
    Galileo channel (no other hand-written kernel)."""
    zero_launch_counts()
    with CallSpy(inav, "viterbi_decode") as decodes:
        out = dual_pvt(dev)
    counts = kernel_counts()
    joint, vel = out["joint"] or {}, out["velocity"] or {}
    speed = vel.get("speed_mps", math.inf)

    def err(fix):
        return None if fix is None else fix["error_m"]

    phase("21 dual pvt", f"{out['of']} SVs (5 GPS + 5 Galileo), {dual.DURATION_S} s at "
          f"{dual.FS / 1e6} MS/s on {out['device']}: gen_s {out['gen_s']:.6f}, stages "
          f"{json.dumps(out['stage_s'])}; joint error {err(joint) if joint else math.inf:.6f} "
          f"m, GPS-only {err(out['gps_only'])} m, Galileo-only {err(out['galileo_only'])} m, "
          f"ISB {joint.get('isb_m')} m, GDOP {joint.get('gdop')}, speed {speed:.6f} m/s, "
          f"truth-position control {err(out['truth_pos_control'])} m; acquired "
          f"{out['acquired']}/{out['of']}, decoded {out['decoded']}/{out['of']}; decodes "
          f"(lanes, 240) {decodes.shapes}; launches {json.dumps(counts)}")
    if not (out["pass"] and out["decoded"] == out["of"] == 10 and joint
            and joint["error_m"] < DUAL_MAX_ERROR_M and speed < DUAL_MAX_SPEED_MPS):
        raise AssertionError(f"the dual gate failed: {json.dumps(out)}")
    check_inav_launches("dual", counts, len(decodes.shapes))
    return {"launches": counts["viterbi_forward"], "lanes": [s[0] for s in decodes.shapes]}


def drive_glonass_path(dev: torch.device) -> None:
    """Phase 22: the GLONASS L1OF gate at full size (six FDMA channels
    k = −3…+2, 4 s at 6.132 MS/s) through `entry.glonass_track`; fails
    unless every channel is OK (acquired, lock > 2, |Doppler error| < 5 Hz,
    bit match ≥ 0.98) and no hand-written kernel was launched."""
    zero_launch_counts()
    out = glonass_track(dev)
    counts = kernel_counts()
    per = [{k: c[k] for k in ("k", "lock", "dop_err_hz", "bit_match", "cn0_dbhz", "ok")}
           for c in out["per_ch"]]
    phase("22 glonass track", f"{out['of']} FDMA channels, {glo.DURATION_S} s at "
          f"{glo.FS / 1e6} MS/s on {out['device']}: gen_s {out['gen_s']:.6f}, mix_s "
          f"{out['mix_s']:.6f}, acquire_s {out['acquire_s']:.6f}, track_s "
          f"{out['track_s']:.6f}; {out['value']}/{out['of']} OK; {json.dumps(per)}; launches "
          f"{json.dumps(counts)}")
    if not (out["pass"] and out["value"] == 6 and all(c["ok"] for c in out["per_ch"])):
        raise AssertionError(f"the GLONASS gate failed: {json.dumps(out)}")
    if any(counts.values()):
        raise AssertionError(f"the GLONASS path launched a hand-written kernel: {counts}")


def inav_branch_metrics(lanes: int, seed: int, dev: torch.device) -> torch.Tensor:
    """(120, 4, lanes) branch metrics of hard-sign I/NAV page parts on the
    card: random pages, ±1 symbols plus N(0, 0.8²), signs, then the
    decoder's own deinterleave and G2 un-inversion."""
    rng = np.random.default_rng(seed)
    parts = []
    while len(parts) < lanes:
        page = inav.encode_page(rng.integers(0, 2, 112), rng.integers(0, 2, 16))
        parts += [page[10:250], page[260:500]]
    soft = np.sign(1.0 - 2.0 * np.stack(parts[:lanes]) + 0.8 * rng.standard_normal((lanes, 240)))
    rx = torch.from_numpy(inav.decoder_input(soft)).to(dev)
    return convolutional._branch_metrics(rx.reshape(lanes, 120, 2))


def check_e1b_card_against_cpu(dev: torch.device, gal_run: dict, dual_run: dict) -> dict:
    """Phase 23: the E1B and I/NAV paths on the card against the port's CPU
    results. Both Viterbi kernels bit for bit at the I/NAV shape (T = 120,
    terminated) for one lane and each gate's lane counts, timed beside the
    plain versions at the Galileo gate's count; `decode_stream` on the card
    equal to the CPU on one channel's symbols; the E1B acquisition with the
    sub-phase bank (decisions, code phase and Doppler equal, metrics within
    rtol 1e-4) and 300 closed blocks of six channels (code phase within
    0.05 subchips, carrier 0.1 Hz, discriminators 1e-3, C/N0 0.05 dB,
    prompts 1e-3 of the channel's largest); the GLONASS mixdown within
    1e-5 of its peak. Returns the kernel table's I/NAV entries."""
    constraint, polys = 7, convolutional.K7_POLYS
    lanes_seen = sorted({1, *gal_run["lanes"], *dual_run["lanes"]})
    for lanes in lanes_seen:
        check_viterbi(inav_branch_metrics(lanes, lanes, dev), constraint, polys)
    lanes = max(gal_run["lanes"])
    bm = inav_branch_metrics(lanes, 23, dev)
    errs = check_viterbi(bm, constraint, polys)
    dec, _ = viterbi.viterbi_forward_cuda(bm, constraint, polys)
    fwd = in_turns(lambda: viterbi.viterbi_forward(bm, constraint, polys),
                   lambda: viterbi.viterbi_forward_cuda(bm, constraint, polys))
    tb = in_turns(lambda: viterbi.viterbi_traceback(dec, constraint, polys),
                  lambda: viterbi.viterbi_traceback_cuda(dec, constraint, polys))
    table = {}
    for name, (kern, plain), (b_ms, b_by), err in (
            ("viterbi_forward", fwd, forward_bound(bm, dec, constraint),
             errs["forward_abs_err"]),
            ("viterbi_traceback", tb, traceback_bounds(dec)[0], errs["traceback_abs_err"])):
        table[name] = {"ms_inav": sum(kern) / 2, "plain_ms_inav": sum(plain) / 2,
                       "bound_ms_inav": b_ms, "bound_by_inav": b_by, "max_abs_err_inav": err,
                       "shape_inav": list(bm.shape if name == "viterbi_forward" else dec.shape),
                       "launches_galileo": gal_run["launches"],
                       "launches_dual": dual_run["launches"]}
        phase("23 inav viterbi", f"{name} at {tuple(table[name]['shape_inav'])} (lanes % 4 = "
              f"{lanes % 4}{': the traceback stages by 4-byte copies' if lanes % 4 else ''}): "
              f"kernel {kern[0]:.4f}/{kern[1]:.4f} ms, plain {plain[0]:.4f}/{plain[1]:.4f} ms "
              f"(CUDA events, mean of {TIMED_LAUNCHES} back-to-back calls: the host's rate at "
              f"this size); bound {b_ms:.6f} ms by {b_by}, "
              f"{100 * b_ms / table[name]['ms_inav']:.3g}% of it; launches {gal_run['launches']} "
              f"(Galileo gate), {dual_run['launches']} (dual gate)")
    # At these sizes back-to-back launches timed with CUDA events measure the
    # host's launch rate; queued behind a busy stream they measure the kernel.
    for n in sorted({*gal_run["lanes"], *dual_run["lanes"]}):
        bm_n = inav_branch_metrics(n, 29, dev)
        dec_n, _ = viterbi.viterbi_forward_cuda(bm_n, constraint, polys)
        one = {"viterbi_forward": lambda: viterbi.viterbi_forward_cuda(bm_n, constraint, polys),
               "viterbi_traceback": lambda: viterbi.viterbi_traceback_cuda(dec_n, constraint,
                                                                           polys)}
        for name, fn in one.items():
            table[name].setdefault("device_ms_inav", {})[str(n)] = queued_ms(fn)
        fwd_ms, tb_ms = (table[k]["device_ms_inav"][str(n)] for k in one)
        phase("23 inav viterbi", f"T 120, {n} lanes (lanes % 4 = {n % 4}), {TIMED_LAUNCHES} "
              f"launches queued behind a busy stream: forward {fwd_ms:.6f} ms, traceback "
              f"{tb_ms:.6f} ms a launch")
    phase("23 inav viterbi", f"both kernels equal their plain versions bit for bit on hard-sign "
          f"I/NAV parts, T 120, lanes {lanes_seen}, from state 0 and the best state")

    cfg, truth = gal.galileo_scenario(E1B_CHECK_SECONDS)
    prns = [s.prn for s in cfg.satellites]
    eph = circular_ephemeris_for_position(gal._geometry()[1][0], truth, gal.T0_SOW + 10.9,
                                          prn=1, toe_quantum=60.0)
    tx = 1.0 - 2.0 * gal.build_sv_nav_symbols(eph, 1, gal.T0_SOW + 2250 * gal.T_EP)[37:]
    rng = np.random.default_rng(23)
    soft = -np.sign(tx + 0.7 * rng.standard_normal(len(tx)))
    pages = {d: inav.decode_stream(soft, device=d) for d in ("cpu", dev)}
    same = len(pages["cpu"]) == len(pages[dev]) and all(
        all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)
        for a, b in zip(pages["cpu"], pages[dev]))
    if not (same and pages["cpu"]):
        raise AssertionError("decode_stream on the card differs from the CPU")
    phase("23 inav decode", f"decode_stream of {len(soft)} hard-sign symbols (one channel, "
          f"inverted): {len(pages['cpu'])} pages, {sum(p['crc_ok'] for p in pages['cpu'])} CRC ok, "
          f"equal on the card and the CPU")

    rx = scenario.GnssScenario(cfg, device=dev).generate_device()
    rx_cpu = rx.cpu()
    n_per = int(round(gal.FS * gal.T_EP))
    bank = acquisition.sampled_code_bank(gal.e1b_codes(prns), gal.CHIP_RATE * scenario.SUBCHIP,
                                         gal.FS, n_per, n_subphases=4)
    acq = {str(d): acquisition.acquire(x[: gal.ACQ_EPOCHS * n_per], bank, prns, gal.FS,
                                       gal.ACQ_CONFIG) for d, x in (("cpu", rx_cpu), (dev, rx))}
    card, cpu = acq[str(dev)], acq["cpu"]
    for name in ("detected", "code_phase", "doppler_hz"):
        if not torch.equal(getattr(card, name).cpu(), getattr(cpu, name)):
            raise AssertionError(f"E1B acquire {name}: card {getattr(card, name).tolist()}, CPU "
                                 f"{getattr(cpu, name).tolist()}")
    metric_rel = float(((card.peak_metric.cpu() - cpu.peak_metric).abs() / cpu.peak_metric).max())
    if not (metric_rel <= REL_TOL and bool(cpu.detected.all())):
        raise AssertionError(f"E1B acquire peak metric card vs CPU: rtol {metric_rel:.3g}")
    phase("23 e1b card vs cpu", f"acquire, 6 PRNs × 4 sub-phases × {gal.ACQ_EPOCHS} epochs: "
          f"detected, code phase and Doppler equal, peak metric rtol {metric_rel:.3g}")

    seeds = gal.e1b_receiver(rx, prns)
    code_t = torch.from_numpy(np.stack(gal.e1b_codes(prns)).astype(np.float32))
    bs = seeds["bs"]
    n = int(seeds["istart"].max()) + E1B_CHECK_BLOCKS * bs
    outs = {str(d): gal.closed_pass(x[:n], code_t.to(d), seeds["istart"], seeds["phase_ref"],
                                    seeds["dop_ref"]) for d, x in (("cpu", rx_cpu), (dev, rx))}
    card = {k: v.cpu() for k, v in outs[str(dev)]._asdict().items()}
    cpu = outs["cpu"]._asdict()
    scale = torch.abs(torch.complex(cpu["prompt_i"], cpu["prompt_q"])).amax(-1, keepdim=True)
    worst = {}
    for name in ("prompt_i", "prompt_q", "early_mag", "late_mag"):
        worst[name] = float(((card[name] - cpu[name]).abs() / scale).max())
        if not worst[name] <= PROMPT_REL_TOL:
            raise AssertionError(f"E1B track {name} card vs CPU: {worst[name]:.3g} of max|prompt|")
    dphase = (card["code_phase"] - cpu["code_phase"]).abs()
    worst["code_phase"] = float(torch.minimum(dphase, gal.CODE_LEN - dphase).max())
    for name, tol in E1B_TRACK_TOLS.items():
        if name != "code_phase":
            worst[name] = float((card[name] - cpu[name]).abs().max())
        if not worst[name] <= tol:
            raise AssertionError(f"E1B track {name} card vs CPU: max|Δ| {worst[name]:.3g} > {tol}")
    if card["prompt_i"].shape != (6, E1B_CHECK_BLOCKS):
        raise AssertionError(f"E1B track: {tuple(card['prompt_i'].shape)} blocks")
    phase("23 e1b card vs cpu", f"closed pass, 6 channels × {E1B_CHECK_BLOCKS} blocks of {bs}: "
          f"worst {json.dumps({k: float(f'{v:.3g}') for k, v in worst.items()})} (prompts as a "
          f"share of max|prompt|, code phase in subchips)")

    gcfg, _ = glo.glonass_scenario(MIXDOWN_SAMPLES / glo.FS)
    x = scenario.GnssScenario(gcfg, device=dev).generate_device()
    nums, den = glo._fdma_plan(glo.KS)
    mixed = {str(d): glo.mixdown(x.to(d), nums, den) for d in ("cpu", dev)}
    _, rel = rel_err(mixed[str(dev)].cpu(), mixed["cpu"])
    if not rel <= GLONASS_MIX_TOL:
        raise AssertionError(f"GLONASS mixdown card vs CPU: max|Δ|/max {rel:.3g} > "
                             f"{GLONASS_MIX_TOL}")
    phase("23 glonass card vs cpu", f"mixdown of {MIXDOWN_SAMPLES} samples to 6 channels "
          f"(den {den}): max|Δ|/max(CPU) {rel:.3g} <= {GLONASS_MIX_TOL}")
    return table


def noise_capture(dev: torch.device, seed: int = 4) -> torch.Tensor:
    """`NOISE_SAMPLES` of unit complex Gaussian noise on `dev`, no preamble."""
    return randn_iq((NOISE_SAMPLES,), torch.Generator(device=dev).manual_seed(seed))


def drive_packet_path(dev: torch.device) -> dict:
    """Phase 24: `lora_packet_roundtrip` at SF7-SF12, each a 255-byte payload
    behind a 777-sample noise gap: the payload must come back equal with its
    CRC ok and the frame start within half a symbol of the gap; one SF7
    capture turned by 400 Hz must give a CFO estimate within one bin; a
    capture of noise alone must not be detected. The dechirp kernel must run
    in the preamble search and in the demodulation, and no other kernel."""
    zero_launch_counts()
    rows = []
    with CallSpy(sync, "dechirp_power_dispatch") as search:
        for sf in PACKET_SFS:
            n = lora.LoRaParams(sf=sf).samples_per_symbol
            t0 = time.perf_counter()
            out = lora_packet_roundtrip(sf, seed=sf, device=dev)
            torch.cuda.synchronize()
            rows.append({"sf": sf, "s": time.perf_counter() - t0, "samples": out["samples"],
                         "frame_start": out["frame_start"], "crc_ok": out["crc_ok"],
                         "payload_ok": out["payload"] == out["sent"]})
            if not (out["detected"] and out["payload"] == out["sent"] and out["crc_ok"] is True
                    and abs(out["frame_start"] - PACKET_GAP_SAMPLES) <= n // 2):
                raise AssertionError(f"LoRa packet at SF{sf}: {rows[-1]}, cfo {out['cfo_hz']}")
        cfo = lora_packet_roundtrip(7, cfo_hz=PACKET_CFO_HZ, seed=70, device=dev)
        bin_hz = lora.LoRaParams(sf=7).bw_hz / lora.LoRaParams(sf=7).chips_per_symbol
        if not (cfo["detected"] and abs(cfo["cfo_hz"] - PACKET_CFO_HZ) < bin_hz
                and cfo["payload"] == cfo["sent"] and cfo["crc_ok"] is True):
            raise AssertionError(f"LoRa packet with a {PACKET_CFO_HZ} Hz CFO: estimate "
                                 f"{cfo['cfo_hz']} Hz, crc_ok {cfo['crc_ok']}")
        quiet = sync.detect_preamble(lora.LoRaParams(sf=7), noise_capture(dev))
        if bool(quiet.detected):
            raise AssertionError("the preamble search detected a packet in noise alone")
    counts = kernel_counts()
    total = counts["dechirp_power"]
    in_sync = search.launches["dechirp_power"]
    split = {"sync": in_sync, "demodulation": total - in_sync}
    others = {k: v for k, v in counts.items() if k != "dechirp_power" and v}
    if in_sync <= 0 or split["demodulation"] <= 0 or others:
        raise AssertionError(f"the packet path launched {counts}, split {split}")
    phase("24 lora packets", f"SF7-SF12 on {dev}: 255-byte payloads behind a "
          f"{PACKET_GAP_SAMPLES}-sample gap all equal the input with CRC ok: {json.dumps(rows)}")
    phase("24 lora packets", f"SF7 with a {PACKET_CFO_HZ} Hz CFO: estimate {cfo['cfo_hz']:.4f} Hz "
          f"(one bin {bin_hz} Hz), frame start {cfo['frame_start']}, payload and CRC ok; "
          f"{NOISE_SAMPLES} samples of noise alone: not detected")
    phase("24 launches", f"dechirp_power launched {total} times: {split['sync']} in the "
          f"preamble search (window rows {sorted(set(search.shapes))}), "
          f"{split['demodulation']} in the demodulation; no other kernel")
    return {"launches": split, "window_shapes": set(search.shapes)}


def drive_ber_gate(dev: torch.device) -> dict:
    """Phase 25: `ber_gate()` at 1,000,000 bits a point; every scheme and
    point within 10% of theory. The waveform-level BPSK check of the
    reference (-16 dB a sample, 256 bytes × 24 lanes) within 25%, and a
    round trip of each PSK/QAM waveform on the card equal to the CPU's."""
    zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gate = ber_gate(dev)
    gate_s = time.perf_counter() - t0
    rows = [{"scheme": r.scheme, "ebn0_db": r.ebn0_db, "measured": r.measured,
             "theory": r.theory, "deviation": r.deviation} for r in gate["results"]]
    bad = [r for r in rows if not r["deviation"] < BER_GATE_MAX_DEV]
    phase("25 ber gate", f"{len(rows)} points × 1,000,000 bits on {dev} in {gate_s:.6f} s (host "
          f"clock to a synchronisation): worst deviation {gate['worst_deviation']:.6f}; "
          f"{json.dumps(rows)}")
    if bad or not gate["pass"]:
        raise AssertionError(f"BER gate points outside {BER_GATE_MAX_DEV:.0%} of theory: {bad}")
    name, snr, n_bytes, lanes = WAVEFORM_BER
    measured, ebn0 = ber.waveform_ber_monte_carlo(name, snr, n_bytes, lanes, seed=1, device=dev)
    theory = float(ber.theoretical_ber("bpsk", ebn0, device=dev))
    dev_wf = abs(measured - theory) / theory
    phase("25 waveform ber", f"{name} at {snr} dB a sample (Eb/N0 {ebn0:.4f} dB), {n_bytes} bytes "
          f"× {lanes} lanes: measured {measured:.6f}, theory {theory:.6f}, deviation "
          f"{dev_wf:.4f}")
    if not dev_wf < WAVEFORM_BER_MAX_DEV:
        raise AssertionError(f"waveform BER {measured} against theory {theory}")
    data = np.random.default_rng(25).integers(0, 256, 512, dtype=np.uint8).tobytes()
    for wf_name in LINEAR_NAMES:
        wf = create_waveform(wf_name, 8_000.0, device=dev)
        tx = wf.modulate(data)
        rx = awgn(tx, 30.0, generator=torch.Generator(device=dev).manual_seed(25))
        res = wf.demodulate(rx)
        cpu = dataclasses.replace(wf, device=torch.device("cpu")).demodulate(rx.cpu())
        got = bytes(res.bits[: len(data)].cpu().numpy().astype(np.uint8))
        if not (tx.device.type == dev.type and got == data
                and torch.equal(res.symbols.cpu(), cpu.symbols)):
            raise AssertionError(f"{wf_name} round trip on the card: payload ok {got == data}")
    counts = kernel_counts()
    if any(counts.values()):
        raise AssertionError(f"the BER and linear-modem path launched a hand-written kernel: "
                             f"{counts}")
    phase("25 linear waveforms", f"{', '.join(LINEAR_NAMES)}: {len(data)}-byte round trips at "
          f"30 dB on {dev} equal the input, indices equal the CPU's; no hand-written kernel "
          f"launched in phase 25 (none on this path)")
    return {"worst_deviation": gate["worst_deviation"], "gate_s": gate_s}


def drive_stanag_harq(dev: torch.device) -> dict:
    """Phase 26: STANAG 4285 at every mode with a 256-byte message (clean),
    1200 bps with long interleave, and the reference's four AWGN pairs: the
    bytes must equal the input and the port's CPU result on the same IQ;
    then `harq_roundtrip_demo` on the card, equal to the CPU's trial for
    trial. Both Viterbi kernels must run, and no other kernel."""
    zero_launch_counts()
    msg = np.random.default_rng(26).integers(0, 256, STANAG_BYTES, dtype=np.uint8).tobytes()
    cases = [(m, False, None) for m in sorted(stanag.MODES)] + [(1200, True, None)]
    cases += [(m, False, snr) for m, snr in STANAG_AWGN]
    lines, steps = [], {}
    with CallSpy(stanag, "viterbi_decode") as decodes:
        for mode, long, snr in cases:
            wf = stanag.Stanag4285(mode_bps=mode, long_interleave=long, device=dev)
            rx = wf.modulate(msg)
            if snr is not None:
                rx = awgn(rx, snr, generator=torch.Generator(device=dev).manual_seed(mode))
            seen = len(decodes.shapes)
            t0 = time.perf_counter()
            res = wf.demodulate(rx)
            got = bytes(res.bits[:STANAG_BYTES].cpu().numpy().astype(np.uint8))
            secs = time.perf_counter() - t0
            label = f"{mode} bps{' long' if long else ''}{'' if snr is None else f' {snr} dB'}"
            steps.update({label: s[0] // 2 for s in decodes.shapes[seen:]})
            cpu = dataclasses.replace(wf, device=torch.device("cpu")).demodulate(rx.cpu())
            if not (rx.device.type == dev.type and got == msg
                    and torch.equal(res.bits.cpu(), cpu.bits)):
                raise AssertionError(f"STANAG 4285 {label}: payload ok {got == msg}, equal to "
                                     f"the CPU {torch.equal(res.bits.cpu(), cpu.bits)}")
            lines.append(f"{label} {secs:.4f} s")
    rng, cpu_rng = np.random.default_rng(5), np.random.default_rng(5)
    trials = []
    for _ in range(HARQ_TRIALS):
        bits = rng.integers(0, 2, 96)
        cpu_bits = cpu_rng.integers(0, 2, 96)
        trials.append(arq.harq_roundtrip_demo(bits, HARQ_NOISE_STD, rng, device=dev))
        if trials[-1] != arq.harq_roundtrip_demo(cpu_bits, HARQ_NOISE_STD, cpu_rng, device="cpu"):
            raise AssertionError(f"HARQ trial {len(trials)} on the card differs from the CPU")
    wins = sum((b and not a) - 2 * (a and not b) for a, b in trials)
    if wins < 1:
        raise AssertionError(f"HARQ showed no incremental-redundancy gain: {trials}")
    counts = kernel_counts()
    fwd, tb = counts["viterbi_forward"], counts["viterbi_traceback"]
    others = {k: v for k, v in counts.items() if not k.startswith("viterbi") and v}
    if fwd <= 0 or tb <= 0 or others:
        raise AssertionError(f"the STANAG/HARQ path launched {counts}")
    phase("26 stanag 4285", f"{STANAG_BYTES}-byte message on {dev}, equal to the input and the "
          f"CPU: {'; '.join(lines)} (decode wall time to the bytes on the host); trellis steps "
          f"of each one-lane decode {json.dumps(steps)}")
    phase("26 harq", f"{HARQ_TRIALS} trials of 96 bits at noise std {HARQ_NOISE_STD} on {dev}: "
          f"(ok after TX1, ok after combining) {trials}, equal to the CPU's; gain {wins}")
    phase("26 launches", f"viterbi_forward {fwd}, viterbi_traceback {tb}; {json.dumps(counts)}")
    return {"launches": fwd, "launches_traceback": tb, "steps": steps}


def time_gcorr(dev: torch.device) -> dict:
    """Phase 27: `pcps_gcorr_bench()` in Gcorr/s, with one iteration's
    launches and busy time under the profiler."""
    zero_launch_counts()
    bench = pcps_gcorr_bench(dev)
    x, carriers, code_fft = gcorr_inputs(dev)
    prof = breakdown(lambda: gcorr_step(x, carriers, code_fft)[0])
    if any(kernel_counts().values()):
        raise AssertionError(f"the gcorr bench launched a hand-written kernel: {kernel_counts()}")
    phase("27 pcps gcorr", f"{bench['shape']} (slots × Doppler bins × lags), {bench['nfft']}-point "
          f"FFTs, {bench['iters']} chained iterations: {bench['gcorr_per_s']:.6f} Gcorr/s, "
          f"{bench['ms_per_iter']:.6f} ms an iteration, compute_s {bench['compute_s']:.6f}; one "
          f"iteration: {prof['device_events']} device events, busy {prof['busy_ms']:.6f} ms, "
          f"idle share {prof['idle_share']:.4f}")
    return bench


def check_link_card_against_cpu(dev: torch.device) -> None:
    """Phase 28: the slice's functions on the card against the port's CPU
    results on the same inputs: `crc_compute` for all seven CRCs bit for
    bit; `dechirp_windows` within 1e-4 of the peak and `detect_preamble`'s
    decisions equal on the packet captures (SF7-SF12, the CFO capture) and
    noise alone; `linear_demodulate_symbols` indices equal for six schemes."""
    data = torch.randint(0, 256, (64, 255), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(28))
    for name in crc.CRC_PARAMS:
        got = crc.crc_compute(data.to(dev), name)
        if not (got.device.type == dev.type
                and torch.equal(got.cpu(), crc.crc_compute(data, name))):
            raise AssertionError(f"crc_compute {name}: the card differs from the CPU")
    phase("28 card vs cpu", f"crc_compute of (64, 255) bytes equal bit for bit for "
          f"{', '.join(crc.CRC_PARAMS)}")
    worst, ties = 0.0, []
    captures = [(sf, 0.0) for sf in PACKET_SFS] + [(7, PACKET_CFO_HZ)]
    for sf, cfo in captures:
        params = lora.LoRaParams(sf=sf)
        payload = np.random.default_rng(sf).integers(0, 256, 255, dtype=np.uint8).tobytes()
        rx = packet_capture(params, payload, cfo, sf, dev)
        for x in (rx, noise_capture(dev, sf)):
            power = sync.dechirp_windows(params, x)[0]
            want = sync.dechirp_windows(params, x.cpu())[0]
            worst = max(worst, rel_err(power.cpu(), want)[1])
            got, ref = sync.detect_preamble(params, x), sync.detect_preamble(params, x.cpu())
            if sync.candidates_tied(want):
                ties.append(f"SF{sf}{' CFO' if cfo else ''}")
            for field in ("detected", "frame_start", "payload_start", "preamble_peak_bin"):
                if getattr(got, field).item() != getattr(ref, field).item():
                    raise AssertionError(f"detect_preamble SF{sf}: {field} differs, card "
                                         f"{got} CPU {ref}")
            if abs(got.cfo_hz.item() - ref.cfo_hz.item()) >= 1e-3 * params.bw_hz / (1 << sf):
                raise AssertionError(f"detect_preamble SF{sf}: CFO card {got} CPU {ref}")
    if not worst < REL_TOL:
        raise AssertionError(f"dechirp_windows card vs CPU: max|Δ|/max {worst:.3g}")
    phase("28 card vs cpu", f"dechirp_windows within {worst:.3g} of the peak (< {REL_TOL}) and "
          f"detect_preamble's decisions (detection, frame and payload start, preamble bin, CFO "
          f"within 1e-3 of a bin) equal on {len(captures)} packet captures and as many of noise "
          f"alone; captures whose candidate windows tie within {sync.TIE_REL} (the first of "
          f"them taken on both devices): {', '.join(ties) or 'none'}")
    gen = torch.Generator(device=dev).manual_seed(28)
    for name in LINEAR_NAMES:
        wf = create_waveform(name, 8_000.0, device=dev)
        con = wf._tables()[0]
        tx = wf.modulate(np.random.default_rng(8).integers(0, 256, 4096, dtype=np.uint8))
        rx = awgn(tx.expand(8, -1), 12.0, generator=gen)
        idx = linear_mod.linear_demodulate_symbols(rx, con, wf.samples_per_symbol())[0]
        want = linear_mod.linear_demodulate_symbols(rx.cpu(), con, wf.samples_per_symbol())[0]
        if not torch.equal(idx.cpu(), want):
            raise AssertionError(f"linear_demodulate_symbols {name}: indices differ")
    phase("28 card vs cpu", f"linear_demodulate_symbols indices equal for {', '.join(LINEAR_NAMES)}"
          f" on 8 lanes of 12 dB IQ")


def dechirp_bound(rows: int, k: int) -> tuple[float, str]:
    """Complex64 rows in, float32 power out; FFT flops 5·K·log2 K + the
    product and |·|²."""
    return bound(rows * k * (8 + 4) + 8 * k, rows * k * (5 * math.log2(k) + 9))


def time_sync_windows(dev: torch.device, shapes: set) -> dict:
    """The dechirp kernel at the preamble search's window shape of a 255-byte
    packet at SF7 and SF12 (the capture's own windows, made contiguous):
    the kernel, the plain version and cuFFT's transform alone, each the
    mean of 10 calls queued behind a sleeping stream (device time alone;
    none of them synchronises), and the bound; the kernel against the
    plain version within 1e-4."""
    table = {}
    for sf in (7, 12):
        params = lora.LoRaParams(sf=sf)
        payload = np.random.default_rng(sf).integers(0, 256, 255, dtype=np.uint8).tobytes()
        x = packet_capture(params, payload, 0.0, sf, dev)
        n = params.samples_per_symbol
        wins = x.unfold(-1, n, n // 4).contiguous()
        down = chirp.base_downchirp(params, dev)
        if tuple(wins.shape) not in shapes:
            raise AssertionError(f"SF{sf} windows {tuple(wins.shape)} are not among the "
                                 f"search's {sorted(shapes)}")
        got, ref = dechirp_power_cuda(wins, down), dechirp_power(wins, down)
        abs_err, rel = rel_err(got, ref)
        if not rel < REL_TOL:
            raise AssertionError(f"SF{sf} sync windows: max|Δ|/max {rel:.3g}")
        kern = [queued_ms(lambda: dechirp_power_cuda(wins, down)) for _ in range(2)]
        plain = [queued_ms(lambda: dechirp_power(wins, down)) for _ in range(2)]
        mixed = wins * down
        library = queued_ms(lambda: torch.fft.fft(mixed, dim=-1))
        b_ms, b_by = dechirp_bound(*wins.shape)
        table[sf] = {"ms": sum(kern) / 2, "plain_ms": sum(plain) / 2, "library_ms": library,
                     "bound_ms": b_ms, "bound_by": b_by, "shape": list(wins.shape),
                     "max_abs_err": abs_err}
        phase("24 timing", f"dechirp_power at the SF{sf} sync windows {tuple(wins.shape)}: kernel "
              f"{kern[0]:.6f}/{kern[1]:.6f} ms, plain {plain[0]:.6f}/{plain[1]:.6f} ms, "
              f"cuFFT transform alone {library:.6f} ms (all queued); "
              f"bound {b_ms:.6f} ms by {b_by}, "
              f"{100 * b_ms / table[sf]['ms']:.2f}% of it; max|Δ|/max {rel:.3g}")
    return table


def time_stanag_viterbi(steps_by_case: dict) -> dict:
    """Both Viterbi kernels at STANAG 4285's one-lane T (the 2400 bps
    decode of the 256-byte message), bit for bit against the plain
    versions, timed queued (kernel) and with CUDA events (plain, one call)."""
    constraint, polys = 7, stanag.CONV_POLYS
    steps = steps_by_case["2400 bps"]
    bm = noisy_branch_metrics(1, steps, constraint, seed=26, polys=polys)
    errs = check_viterbi(bm, constraint, polys)
    dec, _ = viterbi.viterbi_forward_cuda(bm, constraint, polys)
    table = {}
    for name, kern_fn, plain_fn, (b_ms, b_by), err, shape in (
            ("viterbi_forward", lambda: viterbi.viterbi_forward_cuda(bm, constraint, polys),
             lambda: viterbi.viterbi_forward(bm, constraint, polys),
             forward_bound(bm, dec, constraint), errs["forward_abs_err"], list(bm.shape)),
            ("viterbi_traceback", lambda: viterbi.viterbi_traceback_cuda(dec, constraint, polys),
             lambda: viterbi.viterbi_traceback(dec, constraint, polys),
             traceback_bounds(dec)[0], errs["traceback_abs_err"], list(dec.shape))):
        kern = [queued_ms(kern_fn) for _ in range(2)]
        plain = [cuda_ms(plain_fn, PLAIN_VITERBI_CALLS) for _ in range(2)]
        table[name] = {"ms_stanag": sum(kern) / 2, "plain_ms_stanag": sum(plain) / 2,
                       "bound_ms_stanag": b_ms, "bound_by_stanag": b_by,
                       "max_abs_err_stanag": err, "shape_stanag": shape}
        phase("26 timing", f"{name} at STANAG 4285's {tuple(shape)} (2400 bps, one lane): kernel "
              f"{kern[0]:.6f}/{kern[1]:.6f} ms (queued), plain {plain[0]:.4f}/{plain[1]:.4f} ms; "
              f"bound {b_ms:.3g} ms by {b_by}, {100 * b_ms / table[name]['ms_stanag']:.3g}% of it; "
              f"bit for bit")
    return table



def decisions_equal(name: str, card, cpu) -> bool:
    """A name's card decisions against the CPU's: bits and symbols equal
    (analog audio bytes within ANALOG_CODE_TOL codes, symbols empty)."""
    if name in ANALOG_NAMES:
        diff = (card.bits.cpu() - cpu.bits + 128) % 256 - 128
        return (card.bits.shape == cpu.bits.shape
                and bool(torch.all(torch.abs(diff) <= ANALOG_CODE_TOL)))
    return torch.equal(card.bits.cpu(), cpu.bits) and torch.equal(card.symbols.cpu(), cpu.symbols)


def drive_device_sweep(dev: torch.device) -> dict:
    """Phase 29: `device_sweep()` on the card with the counts set to 0 just
    before it and read just after: 50/50 ok, the bytes back for every name
    whose bytes the reference gets back, the dechirp kernel launched by the
    three LoRa names and both Viterbi kernels by MIL-STD-188-110 and STANAG
    4285. Then each name's round once more on the card, its decisions
    against the port's CPU demodulation of the same host IQ."""
    t0 = time.perf_counter()
    zero_launch_counts()
    sweep = device_sweep(dev)
    counts = kernel_counts()
    names = list_waveforms()
    missing = sorted(n for n in names if n not in SWEEP_NO_BYTES and not sweep["bytes_back"].get(n))
    if (sweep["ok"], sweep["total"], sweep["failures"], missing) != (FLEET_SIZE, FLEET_SIZE,
                                                                      [], []):
        raise AssertionError(f"device sweep {sweep['ok']}/{sweep['total']}, failures "
                             f"{sweep['failures']}, bytes missing for {missing}")
    if counts["dechirp_power"] <= 0 or counts["viterbi_forward"] <= 0 \
            or counts["viterbi_traceback"] <= 0:
        raise AssertionError(f"the device sweep launched {counts}")
    differ = []
    for name in names:
        iq, res = sweep_round(name, dev)
        cpu = create_waveform(name, SWEEP_RATE_HZ, "cpu").demodulate(torch.from_numpy(iq))
        if res.bits.device.type != dev.type or not decisions_equal(name, res, cpu):
            differ.append(name)
    if differ:
        raise AssertionError(f"card decisions differ from the CPU's for {differ}")
    secs = time.perf_counter() - t0
    back = sum(sweep["bytes_back"].values())
    phase("29 device sweep", f"{sweep['ok']}/{sweep['total']} ok on {dev}, bytes back for "
          f"{back} names (all the reference's {FLEET_SIZE - len(SWEEP_NO_BYTES)}); decisions "
          f"of all {len(names)} equal the CPU's on the same host IQ (analog bytes within "
          f"{ANALOG_CODE_TOL} code); launches {json.dumps(counts)}; phase {secs:.3f} s")
    phase("29 warm ms", json.dumps({n: round(v, 4) for n, v in sweep["warm_ms"].items()}))
    return {"launches": counts, "seconds": secs, "warm_ms": sweep["warm_ms"]}


def drive_noisy_gate(dev: torch.device) -> dict:
    """Phase 30: `fleet_noisy_gate()` on the card, every bar: the digital
    names bit-exact at their SNRs, CW, analog, FMCW and beacon bars, the
    matrix covering the factory exactly."""
    t0 = time.perf_counter()
    zero_launch_counts()
    gate = fleet_noisy_gate(dev)
    counts = kernel_counts()
    if not gate["ok"]:
        raise AssertionError(f"noisy gate: covered {gate['covered']}, failures "
                             f"{ {n: gate['results'][n] for n in gate['failures']} }")
    res = gate["results"]
    secs = time.perf_counter() - t0
    digital = sum(1 for n in res if n not in ("CW", "FMCW") and "bytes" in res[n])
    phase("30 noisy gate", f"{len(res)} names on {dev}: {digital} digital names bit-exact at "
          f"their SNRs; CW {res['CW']['frequency_hz']:.4f} Hz; AM/FM/NBFM mean |err| "
          + "/".join(f"{res[n]['mean_abs_err']:.3f}" for n in ANALOG_NAMES)
          + f"; FMCW {res['FMCW']['range_m']:.3f} m (bin {res['FMCW']['range_bin_m']:.3f} m); "
          f"beacon sweeps " + ", ".join(
              f"{n} {res[n]['audio_freq_min']:.0f}-{res[n]['audio_freq_max']:.0f} Hz"
              for n in ("ELT-121.5", "EPIRB-121.5", "PLB-121.5", "Beacon-243"))
          + f"; launches {json.dumps(counts)}; phase {secs:.3f} s")
    # How thin the matrix's SNRs are under the card's own noise (not a gate):
    # the reference passes on its key 3; other draws fail some names.
    t0 = time.perf_counter()
    rates = noisy_pass_rates(dev)
    thin = {n: r for n, r in rates.items() if r < 1.0}
    phase("30 pass rates", f"share of 40 Philox draws (seeds 0-39) passing each bar at the "
          f"matrix's SNR: {len(rates) - len(thin)} of {len(rates)} names pass every draw; "
          f"below 1: {json.dumps(thin)}; {time.perf_counter() - t0:.3f} s")
    return {"launches": counts, "seconds": secs, "pass_rates": rates}


def drive_sincgars_data(dev: torch.device) -> dict:
    """Phase 31: `sincgars_data_roundtrip()` on the card (2,048 bytes at
    1200 bps, 10 dB): 29/29 frames with their CRC good, sequences 0-28, the
    payload equal, and exactly one launch of each Viterbi kernel (the 29
    frames are lanes of one decode) and no other kernel. Then both kernels
    against their plain versions, bit for bit, on the decode's own branch
    metrics, bm (638, 4, 29), and timed there."""
    t0 = time.perf_counter()
    zero_launch_counts()
    with CallSpy(milfh, "viterbi_decode", keep=True) as decodes:
        out = sincgars_data_roundtrip(dev)
    counts = kernel_counts()
    want = {"dechirp_power": 0, "fir_decimate": 0, "nco_mix": 0, "viterbi_forward": 1,
            "viterbi_traceback": 1}
    if not (out["frames"] == out["crc_ok"] == SINCGARS_FRAMES and out["payload_equal"]
            and out["sequences"] == list(range(SINCGARS_FRAMES)) and counts == want
            and out["launches"] == {"viterbi_forward": 1, "viterbi_traceback": 1}
            and decodes.shapes == [(SINCGARS_FRAMES, SINCGARS_FRAME_BITS)]):
        raise AssertionError(f"SINCGARS data: {out['crc_ok']}/{out['frames']} frames, payload "
                             f"equal {out['payload_equal']}, sequences {out['sequences']}, "
                             f"launches {counts}, decode calls {decodes.shapes}")
    secs = time.perf_counter() - t0
    phase("31 sincgars data", f"{out['frames']} frames of {out['frame_bits']} coded bits, "
          f"{out['samples']} samples on {dev}: {out['crc_ok']}/{out['frames']} CRC ok, sequences "
          f"0-{out['sequences'][-1]}, payload equal; demodulate + deframe {out['decode_s']:.6f} s "
          f"(host clock); launches {json.dumps(counts)}; phase {secs:.3f} s")

    constraint, polys = 7, milfh.CONV_POLYS
    lanes = decodes.firsts[0]
    rx = (1.0 - 2.0 * lanes.to(torch.float32)).reshape(lanes.shape[0], -1, len(polys))
    bm = convolutional._branch_metrics(rx)
    errs = check_viterbi(bm, constraint, polys)
    dec, _ = viterbi.viterbi_forward_cuda(bm, constraint, polys)
    n = bm.shape[2]
    table = {}
    for name, kern_fn, plain_fn, (b_ms, b_by), err, shape in (
            ("viterbi_forward", lambda: viterbi.viterbi_forward_cuda(bm, constraint, polys),
             lambda: viterbi.viterbi_forward(bm, constraint, polys),
             forward_bound(bm, dec, constraint), errs["forward_abs_err"], list(bm.shape)),
            ("viterbi_traceback", lambda: viterbi.viterbi_traceback_cuda(dec, constraint, polys),
             lambda: viterbi.viterbi_traceback(dec, constraint, polys),
             traceback_bounds(dec)[0], errs["traceback_abs_err"], list(dec.shape))):
        kern = [queued_ms(kern_fn) for _ in range(2)]
        plain = [cuda_ms(plain_fn, PLAIN_VITERBI_CALLS) for _ in range(2)]
        table[name] = {"ms_sincgars": sum(kern) / 2, "plain_ms_sincgars": sum(plain) / 2,
                       "bound_ms_sincgars": b_ms, "bound_by_sincgars": b_by,
                       "max_abs_err_sincgars": err, "shape_sincgars": shape,
                       "launches_sincgars": counts[name]}
        staging = (f"; lanes % 4 = {n % 4}: the traceback stages by 4-byte copies"
                   if name == "viterbi_traceback" and n % 4 else "")
        phase("31 timing", f"{name} at SINCGARS data's {tuple(shape)}: kernel {kern[0]:.6f}/"
              f"{kern[1]:.6f} ms (queued), plain {plain[0]:.4f}/{plain[1]:.4f} ms; bound "
              f"{b_ms:.3g} ms by {b_by}, {100 * b_ms / table[name]['ms_sincgars']:.3g}% of it; "
              f"bit for bit{staging}")
    if n % 4:
        # the same decisions with the lanes padded to a multiple of 4: the 16-byte staging path
        padded = F.pad(dec, (0, -n % 4))
        if not torch.equal(viterbi.viterbi_traceback_cuda(padded, constraint, polys)[:, :n],
                           viterbi.viterbi_traceback(dec, constraint, polys)):
            raise AssertionError("traceback on lane-padded decisions differs from plain")
        padded_ms = queued_ms(lambda: viterbi.viterbi_traceback_cuda(padded, constraint, polys))
        table["viterbi_traceback"]["ms_sincgars_lanes_padded"] = padded_ms
        phase("31 timing", f"viterbi_traceback at {tuple(padded.shape)}, the decisions padded to "
              f"a multiple of 4 lanes (16-byte staging): {padded_ms:.6f} ms (queued), its first "
              f"{n} lanes' bits equal")
    return table

def channel_cases(x: torch.Tensor) -> dict:
    """Phase 32's calls on `x` (CHANNEL_CHECK_SHAPE complex64), every
    random one on the same threefry keys, keyed by a label; each returns a
    tensor or a tuple of tensors."""
    dev, n = x.device, x.shape[-1]
    k = threefry.key(32)
    cases = {
        "awgn": lambda: awgn(x, 7.0, key=k, path_loss_db=2.0),
        "cfo +": lambda: chan.cfo(x, 1234.5, 1e6, 0.3),
        "cfo -": lambda: chan.cfo(x, -330_000.0, 1e6),
        "multipath_2ray": lambda: chan.multipath_2ray(x, 7, 0.4),
        "rayleigh": lambda: chan.rayleigh(x, key=k),
        "rician": lambda: chan.rician(x, 3.5, key=k),
        "block_fading": lambda: chan.block_fading(x, 300, key=k),
        "jakes_fading": lambda: chan.jakes_fading(n, 300.0, 30.72e6, key=k, device=dev),
        "gaussian_doppler_fading": lambda: chan.gaussian_doppler_fading(n, 50.0, 1e6, key=k,
                                                                        device=dev),
        "flat_doppler_shift": lambda: chan.flat_doppler_shift(n, 120.0, 1e6, device=dev),
        "theoretical_ber_awgn": lambda: chan.theoretical_ber_awgn(
            torch.linspace(-30.0, 10.0, 41, device=dev), 7),
        "measure_snr": lambda: chan.measure_snr(x, awgn(x, 9.0, key=k)),
        "phase_noise": lambda: impairments.phase_noise(x, 100.0, 1e6, key=k),
        "iq_imbalance": lambda: impairments.iq_imbalance(x, 0.7, 3.0),
        "iq_imbalance_estimate": lambda: impairments.iq_imbalance_estimate(
            impairments.iq_imbalance(x[0], 0.7, 3.0)),
        "iq_imbalance_correct": lambda: impairments.iq_imbalance_correct(x, 1.08, 0.05),
        "dc_offset": lambda: impairments.dc_offset(x, 0.1, -0.2),
        "saleh_pa": lambda: impairments.saleh_pa(x),
        "rapp_pa": lambda: impairments.rapp_pa(x, 0.8, 3.0),
        "quantize_dac": lambda: impairments.quantize_dac(x, 8, 2.0),
    }
    for profile in ("EPA", "EVA", "ETU"):
        cases[f"tdl_channel {profile}"] = lambda p=profile: chan.tdl_channel(
            x, p, 30.72e6, 50.0, key=k)
    for model in ("ideal", "awgn", "awgn_cfo", "multipath", "rayleigh", "rician", "tdl_awgn",
                  "freq_selective", "jakes"):
        cfg = chan.ChannelConfig(model=model, snr_db=15.0, cfo_hz=-100.0, multipath_delay=2,
                                 multipath_amplitude=0.3, sample_rate=1e6, tdl_profile="EVA",
                                 doppler_hz=20.0)
        cases[f"apply_channel {model}"] = lambda c=cfg: chan.apply_channel(x, c, key=k)
    return cases


def check_channel_card_against_cpu(dev: torch.device) -> dict:
    """Phase 32: every channel and impairment function on the card against
    the port's CPU result on the same input and the same threefry draws,
    within CHANNEL_CARD_TOL of the CPU result's peak; then `channel_bench()`."""
    gen = torch.Generator().manual_seed(32)
    x = randn_iq(CHANNEL_CHECK_SHAPE, gen)
    card_cases, cpu_cases = channel_cases(x.to(dev)), channel_cases(x)
    worst = {}
    for label, fn in card_cases.items():
        card, cpu = fn(), cpu_cases[label]()
        for got, want in zip(card if isinstance(card, tuple) else (card,),
                             cpu if isinstance(cpu, tuple) else (cpu,)):
            if got.device.type != dev.type or got.shape != want.shape:
                raise AssertionError(f"{label}: {got.shape} on {got.device}, want {want.shape}")
            worst[label] = max(worst.get(label, 0.0), rel_err(got.cpu(), want)[1])
        if not worst[label] <= CHANNEL_CARD_TOL:
            raise AssertionError(f"{label}: card vs CPU max|Δ|/max {worst[label]:.3g} > "
                                 f"{CHANNEL_CARD_TOL}")
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:4]
    phase("32 channel card vs cpu", f"{len(worst)} channel and impairment calls on "
          f"{CHANNEL_CHECK_SHAPE} c64, threefry key 32: all within {CHANNEL_CARD_TOL} of the "
          f"CPU's peak; largest " + ", ".join(f"{k} {v:.3g}" for k, v in top))
    t0 = time.perf_counter()
    bench = channel_bench(dev)
    if not (math.isfinite(bench["mean_power"]) and 1.0 < bench["mean_power"] < 4.0):
        raise AssertionError(f"channel_bench: mean power {bench['mean_power']}")
    phase("32 channel bench", f"{bench['samples']} samples × {bench['iters']} awgn(20 dB) "
          f"applications on Philox: {bench['msamples_per_s']:.3f} Msamples/s, compute_s "
          f"{bench['compute_s']:.6f}, mean power {bench['mean_power']:.4f}; "
          f"{time.perf_counter() - t0:.3f} s")
    return {"worst": worst, "bench": bench}


def drive_fading_gate(dev: torch.device) -> dict:
    """Phase 33: `fading_gate()` on the card with the counts set to 0 just
    before it and read just after: every case's payload back on the
    reference's draws, the dechirp kernel launched (the LoRa-SF7 case, on
    the reference's draws and the 20 Philox draws of the pass rates)."""
    t0 = time.perf_counter()
    zero_launch_counts()
    gate = fading_gate(dev)
    counts = kernel_counts()
    if not gate["ok"] or counts["dechirp_power"] <= 0:
        raise AssertionError(f"fading gate: {gate['results']}, launches {counts}")
    secs = time.perf_counter() - t0
    phase("33 fading gate", f"{len(gate['results'])} cases on {dev}, reference's threefry draws: "
          + ", ".join(f"{k} {v['bytes']}" for k, v in gate["results"].items())
          + f" (every payload back); launches {json.dumps(counts)}; phase {secs:.3f} s")
    phase("33 pass rates", "share of 20 Philox draws decoding each case (not a gate): "
          + json.dumps(gate["pass_rates"]))
    return {"launches": counts, "seconds": secs, "pass_rates": gate["pass_rates"],
            "results": gate["results"]}


def decode_costs(dev: torch.device) -> dict:
    """Device launches, busy time and host milliseconds of one decode of
    each iterative or recursive decoder at the coded gate's shapes (Philox
    inputs: the launch counts do not depend on the values)."""
    gen = torch.Generator(device=dev).manual_seed(34)
    sys_, p1, p2, ap, soft, lq, ls = (
        4.0 * torch.randn(shape, generator=gen, device=dev)
        for shape in ((128,), (128,), (128,), (128,), (1036,), (4, 96),
                      (dvb_s2x.parity_structure("1/2", "short")["n"],)))
    hg = ldpc.ldpc_code(ldpc.make_regular_ldpc(96, 3, 6), dev)
    pi = turbo.default_interleaver(128)
    rx = randn_iq((TCM_GATE_BITS // 2 + 2,), gen)
    calls = {
        "bcjr (N=128)": lambda: turbo._bcjr_maxlog(sys_, p1, ap),
        "turbo_decode (N=128, 6 iterations)": lambda: turbo.turbo_decode(sys_, p1, p2, pi)[1],
        "map_decode (K=7, T=518)": lambda: convolutional.map_decode(soft)[0],
        "ldpc_decode ((4, 96), 25 iterations)": lambda: ldpc.ldpc_decode(lq, hg)[0],
        "dvb_s2x decode (short 1/2, 40 iterations)": lambda: dvb_s2x.decode(
            ls, "1/2", "short", iters=40)[0],
        f"tcm_decode (T={TCM_GATE_BITS // 2 + 2})": lambda: tcm.tcm_decode(rx),
    }
    out = {}
    for name, fn in calls.items():
        prof = breakdown(fn)
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out[name] = {"launches": prof["device_events"], "busy_ms": prof["busy_ms"],
                     "host_ms": (time.perf_counter() - t0) * 1e3,
                     "idle_share": prof["idle_share"]}
    return out


def drive_coded_gate(dev: torch.device) -> dict:
    """Phase 34: `coded_link_gate()` on the card with the counts set to 0
    just before it and read just after: every bar met, each Viterbi kernel
    launched CODED_GATE_VITERBI times (the convolutional gate's decode and
    TCM's, 100,000 bits) and no other kernel; every case's decisions equal
    to the port's CPU run of the gate, TCM's 100,000 bits among them (the
    CPU runs the plain Viterbi); both Viterbi kernels against their plain
    versions at the bm the gate's TCM decode launched them on, and timed
    there; then the launches and time of one decode of each recursive or
    iterative decoder."""
    t0 = time.perf_counter()
    zero_launch_counts()
    gate = coded_link_gate(dev)
    counts = kernel_counts()
    want = {"dechirp_power": 0, "fir_decimate": 0, "nco_mix": 0,
            "viterbi_forward": CODED_GATE_VITERBI, "viterbi_traceback": CODED_GATE_VITERBI}
    if not gate["ok"] or counts != want:
        failed = [name for name, case in gate["results"].items() if not case["ok"]]
        raise AssertionError(f"coded gate: failures {failed}, launches {counts}")
    secs = time.perf_counter() - t0
    res = gate["results"]
    cpu = coded_link_gate("cpu")["results"]
    for name, case in res.items():
        for key, value in case.items():
            if not np.array_equal(np.asarray(value), np.asarray(cpu[name][key])):
                raise AssertionError(f"coded gate {name}: {key} differs between card and CPU")
    phase("34 coded gate", f"{len(res)} cases on {dev}, every bar met: LDPC "
          f"{res['ldpc']['frames_ok']}/4 "
          f"frames; turbo {res['turbo']['raw_errors']} raw errors -> {res['turbo']['errors']}; "
          f"polar {res['polar']['errors']} errors; conv BER {res['conv']['coded_ber']} < uncoded "
          f"{res['conv']['uncoded_ber']}; TCM BER {res['tcm']['tcm_ber']} < 0.5 × QPSK "
          f"{res['tcm']['qpsk_ber']} over {res['tcm']['bits']} bits; DVB-S2X short 1/4, 1/2, "
          f"3/4, 9/10 decoded; LT with and without erasures; MAP soft {res['map']['errors_soft']} "
          f"<= hard {res['map']['errors_hard']} errors; every decision equal to the CPU's, "
          f"TCM's {res['tcm']['bits']} bits among them; "
          f"launches {json.dumps(counts)}; phase {secs:.3f} s")
    # both kernels at the bm of the gate's TCM decode: bit for bit against the
    # plain versions (timed once there: a loop of small launches a step), the
    # kernels timed queued
    rx = torch.from_numpy(res["tcm"]["symbols"]).to(dev)
    bm = tcm.viterbi_metrics(tcm.tcm_branch_metrics(rx)[0][None])
    k, polys = tcm._K, tcm._POLYS
    check = check_viterbi(bm, k, polys)
    dec, _ = viterbi.viterbi_forward_cuda(bm, k, polys)
    table = {}
    for name, kern_fn, plain, err, (b_ms, b_by), shape in (
            ("viterbi_forward", lambda: viterbi.viterbi_forward_cuda(bm, k, polys),
             check["plain_forward_ms"], check["forward_abs_err"], forward_bound(bm, dec, k),
             bm.shape),
            ("viterbi_traceback", lambda: viterbi.viterbi_traceback_cuda(dec, k, polys),
             check["plain_traceback_ms"], check["traceback_abs_err"], traceback_bounds(dec)[0],
             dec.shape)):
        kern = [queued_ms(kern_fn) for _ in range(2)]
        table[name] = {"ms_tcm": sum(kern) / 2, "plain_ms_tcm": plain, "bound_ms_tcm": b_ms,
                       "bound_by_tcm": b_by, "max_abs_err_tcm": err, "shape_tcm": list(shape)}
    phase("34 tcm", f"at the gate's TCM bm {tuple(bm.shape)} both kernels equal their plain "
          f"versions bit for bit: " + "; ".join(
              f"{k} {v['ms_tcm']:.6f} ms queued (plain {v['plain_ms_tcm']:.3f} ms, bound "
              f"{v['bound_ms_tcm']:.3g} ms by {v['bound_by_tcm']})" for k, v in table.items()))
    costs = decode_costs(dev)
    phase("34 decode costs", json.dumps(costs))
    return {"launches": counts, "seconds": secs, "costs": costs, "timing": table}


def drive_dvb_bench(dev: torch.device) -> dict:
    """Phase 35: `dvb_s2x_bench()`: 128 normal frames at rate 1/2, 3.0 dB,
    40 iterations, every frame parity-ok and equal to the bits sent; then
    the decode's launches and busy time under the profiler."""
    bench = dvb_s2x_bench(dev)
    if not bench["ok"]:
        raise AssertionError(f"dvb_s2x_bench: {bench['frames_ok']}/{bench['frames']} frames")
    _, llr = dvb_s2x_frames(dev)
    prof = breakdown(lambda: dvb_s2x.decode(llr, "1/2", "normal", iters=40)[0])
    del llr
    phase("35 dvb_s2x bench", f"{bench['frames']} normal frames × {bench['info_bits']} info "
          f"bits, rate 1/2, {bench['iters']} iterations on {dev}: {bench['frames_ok']}/"
          f"{bench['frames']} decoded; {bench['info_mbps']:.3f} info Mbit/s, compute_s "
          f"{bench['compute_s']:.6f}; one decode under the profiler: {prof['device_events']} "
          f"launches, busy {prof['busy_ms']:.3f} ms, idle share {prof['idle_share']:.3f}")
    return {"bench": bench, "profile": prof}


def slice_inputs(seed: int = 36) -> dict:
    """Phase 36's CPU inputs from numpy: 2^14 samples for the feed-forward
    functions, and each scalar loop's reference-test input."""
    rng = np.random.default_rng(seed)
    n = SLICE_SAMPLES

    def iq(*shape):
        return torch.from_numpy((rng.standard_normal(shape)
                                 + 1j * rng.standard_normal(shape)).astype(np.complex64))

    qpsk = torch.from_numpy(QPSK_POINTS)
    sym_idx = torch.from_numpy(rng.integers(0, 4, n // 4))
    rrc = pulse.shape_symbols(qpsk[sym_idx], pulse.root_raised_cosine_taps(4, 8, 0.35), 4)[:n]
    isi = torch.from_numpy(np.convolve(QPSK_POINTS[sym_idx.numpy()], [1.0, 0.4, -0.2])
                           .astype(np.complex64)[: n // 4])
    return {"x": iq(n), "xr": torch.from_numpy(rng.standard_normal(n).astype(np.float32)),
            "xi": torch.from_numpy(rng.integers(-8, 9, n).astype(np.float32)),
            "rrc": (rrc + 0.05 * iq(n)).to(torch.complex64), "syms": qpsk[sym_idx],
            "isi": (isi + 0.02 * iq(n // 4)).to(torch.complex64), "pre": iq(64),
            "bits": torch.from_numpy(rng.integers(0, 2, n).astype(np.int32)),
            "code": torch.from_numpy(rng.integers(0, 2, 24).astype(np.int32)),
            "err": torch.from_numpy((0.3 * rng.standard_normal(n) + 0.05).astype(np.float32)),
            "pn": torch.from_numpy(spreading.m_sequence(7).astype(np.float32))}


def slice_cases(v: dict) -> dict:
    """Every function of the eight modules as label: (call on the inputs `v`,
    tolerance); 0 means exact. Loops have their own table (`slice_loops`)."""
    x, xr, rrc, syms, pn = v["x"], v["xr"], v["rrc"], v["syms"], v["pn"]
    rrc_taps = pulse.root_raised_cosine_taps(4, 8, 0.35)
    probe = torch.sign(xr[:255]).to(torch.complex64)
    tone = torch.exp(2j * math.pi * 0.0123 * torch.arange(x.shape[0], device=x.device)).to(
        torch.complex64)
    ch = resample.pfb_channelizer(x, 8)
    wola = resample.wola_channelize(x, 8, 4)
    coeffs = measure.dwt(xr, "db4", 3)
    ff = SLICE_CARD_TOL
    return {
        "pulse.shape_symbols": (lambda: pulse.shape_symbols(syms, rrc_taps, 4), ff),
        "pulse.matched_filter": (lambda: pulse.matched_filter(x, rrc_taps), ff),
        "filters.cic_decimator": (lambda: filters.cic_decimator(v["xi"][:256], 4, 3), 0),
        "filters.median_filter": (lambda: filters.median_filter(xr, 4), 0),
        "measure.periodogram_psd": (lambda: measure.periodogram_psd(x), ff),
        "measure.welch_psd": (lambda: measure.welch_psd(x), ff),
        "measure.stft": (lambda: measure.stft(x), ff),
        "measure.goertzel_power": (lambda: measure.goertzel_power(x, 5), ff),
        "measure.channel_capacity_awgn": (lambda: measure.channel_capacity_awgn(
            xr[:64] * 10, 1e6), ff),
        "measure.eye_diagram": (lambda: measure.eye_diagram(x, 8), 0),
        "measure.signal_power_db": (lambda: measure.signal_power_db(x), ff),
        "measure.dwt": (lambda: measure.dwt(xr, "db4", 3), ff),
        "measure.idwt": (lambda: measure.idwt(coeffs, "db4"), ff),
        "measure.dwt_denoise": (lambda: measure.dwt_denoise(xr, "db4", 3), ff),
        "measure.moving_variance": (lambda: measure.moving_variance(xr, 33), ff),
        "measure.moving_minmax": (lambda: measure.moving_minmax(xr, 33), 0),
        "measure.moving_autocorrelation": (lambda: measure.moving_autocorrelation(x, 16), ff),
        "measure.constellation_persistence": (lambda: measure.constellation_persistence(x), 0),
        "measure.signal_quality": (lambda: measure.signal_quality(rrc[:4096:4], syms[:1024]), ff),
        "measure.channel_sound": (lambda: measure.channel_sound(x[:255] + probe, probe, 32), ff),
        "resample.arbitrary_resample": (lambda: resample.arbitrary_resample(x, 1.5), ff),
        "resample.pfb_channelizer": (lambda: ch, ff),
        "resample.pfb_synthesizer": (lambda: resample.pfb_synthesizer(ch), ff),
        **{f"resample.farrow_resample order {o}": (
            lambda o=o: resample.farrow_resample(x, 1.25, o), ff) for o in (1, 2, 3)},
        "resample.wola_channelize": (lambda: wola, ff),
        "resample.wola_synthesize": (lambda: resample.wola_synthesize(wola, 4), ff),
        "sync.cfo_estimate": (lambda: ops_sync.cfo_estimate(rrc * tone, 1e5, 4), ff),
        "sync.cfo_correct": (lambda: ops_sync.cfo_correct(x, 123.0, 1e5), ff),
        "sync.gardner_ted": (lambda: ops_sync.gardner_ted(rrc, 4), ff),
        "sync.mueller_muller_ted": (lambda: ops_sync.mueller_muller_ted(rrc, 4), ff),
        "sync.early_late_gate": (lambda: ops_sync.early_late_gate(rrc, 4), ff),
        "sync.best_timing_offset": (lambda: ops_sync.best_timing_offset(rrc, 4), 0),
        "sync.correlate_sync": (lambda: ops_sync.correlate_sync(x, x[1000:1064]), ff),
        "sync.schmidl_cox": (lambda: ops_sync.schmidl_cox(x, 64), SLICE_CUMSUM_TOL),
        "sync.access_code_correlate": (
            lambda: ops_sync.access_code_correlate(v["bits"], v["code"]), 0),
        "sync.access_code_detect": (
            lambda: ops_sync.access_code_detect(v["bits"], v["code"], 4), 0),
        "sync.pn_sync_correlate": (lambda: ops_sync.pn_sync_correlate(
            torch.roll(pn, 37).repeat(4) + 0.5 * xr[:508], pn), ff),
        "sync.despread_pn": (lambda: ops_sync.despread_pn(xr[:127 * 64], pn, 5), ff),
        "sync.burst_detect": (lambda: ops_sync.burst_detect(x * (torch.arange(x.shape[0]) > 8000)
                                                        .to(x.device) + 0.01 * x), ff),
        "sync.burst_synchronize": (lambda: ops_sync.burst_synchronize(x, x[5000:5064]), ff),
        # variances far from tol² (a window near it could flip between devices)
        "sync2.freq_lock_detector": (lambda: sync2.freq_lock_detector(
            torch.cat([0.003 * xr[:8192], 0.03 * xr[8192:]]), 0.01, 64), 0),
        # rotated off the 4th power's ±π branch cut
        "sync2.constellation_rotation_detect": (
            lambda: sync2.constellation_rotation_detect(
                syms * cis(torch.tensor(0.2)).to(syms.device)), ff),
        "sync2.tuning_estimate": (lambda: sync2.tuning_estimate(tone + 0.1 * x, 48e3), ff),
        "sync2.timing_error_detector": (lambda: sync2.timing_error_detector(rrc, 8), ff),
        "sync2.timing_error_detector early_late": (
            lambda: sync2.timing_error_detector(rrc, 8, "early_late"), ff),
        "sync2.hybrid_timing_phase_detector": (
            lambda: sync2.hybrid_timing_phase_detector(rrc, 8), ff),
        "sync2.feedforward_timing_estimate": (
            lambda: sync2.feedforward_timing_estimate(rrc, 8), ff),
        "sync2.blind_timing_recover": (lambda: sync2.blind_timing_recover(rrc, 8), ff),
        "sync2.cross_correlator": (lambda: sync2.cross_correlator(x, x[100:164]), ff),
        # a pattern rotated by -0.7 rad: the peak's phase is 0.7, not a rounding away from 0
        "sync2.correlate_estimate": (lambda: sync2.correlate_estimate(
            x, x[100:164] * cis(torch.tensor(-0.7)).to(x.device), 0.3), ff),
        "sync2.periodic_autocorrelator": (lambda: sync2.periodic_autocorrelator(x, 32, 4), ff),
        "sync2.golay_complementary_pair": (
            lambda: sync2.golay_complementary_pair(32, x.device), 0),
        "sync2.golay_correlate": (lambda: sync2.golay_correlate(x, 32), ff),
        "sync2.preamble_gen": (lambda: sync2.preamble_gen("golay", 64, x.device), 0),
        "sync2.feedforward_agc": (lambda: sync2.feedforward_agc(x, 1.0, 64), ff),
        "sync2.irig_b_encode": (lambda: sync2.irig_b_encode(45296, device=x.device), 0),
        "sync2.csac_allan_deviation": (lambda: sync2.csac_allan_deviation(xr, 10), ff),
        "equalizers.mmse_block_equalize": (lambda: equalizers.mmse_block_equalize(
            v["isi"], np.asarray([1.0, 0.4, -0.2]), 30.0), ff),
        "equalizers.fde_equalize": (lambda: equalizers.fde_equalize(
            x.reshape(-1, 64), torch.fft.fft(x[:64]), 25.0), ff),
        "equalizers.nearest_point": (lambda: equalizers.nearest_point(x, syms[:4]), 0),
        "equalizers.turbo_equalizer_tx": (lambda: equalizers.turbo_equalizer_tx(
            v["bits"][:1024], device=x.device)[0], 0),
        "equalizers.turbo_equalize": (lambda: equalizers.turbo_equalize(
            x[:2048] * 0.3 + equalizers.turbo_equalizer_tx(v["bits"][:1024], device=x.device)[0],
            np.asarray([0.407, 0.815, 0.407]), turbo.default_interleaver(2048, seed=11), 0.4),
            SLICE_LOOP_TOL),
        "agc.agc_block": (lambda: agc_ops.agc_block(x, 1.0), ff),
        "agc.cordic_rotate": (lambda: agc_ops.cordic_rotate(xr, v["err"], 4 * xr), 0),
        "agc.cordic_magnitude_phase": (lambda: agc_ops.cordic_magnitude_phase(xr, v["err"]), 0),
        "agc.chirp_z_transform": (lambda: agc_ops.chirp_z_transform(
            x[:64], 64, np.exp(-2j * np.pi / 64)), ff),
        # a 123.4 Hz tone inside the zoomed band (tests/test_adsb_ephemeris.py:157)
        "agc.zoom_fft": (lambda: agc_ops.zoom_fft(torch.exp(
            2j * math.pi * 0.1234 * torch.arange(4096, device=x.device)).to(torch.complex64),
            100.0, 150.0, 200, 1000.0), ff),
        "agc.cyclostationary_detector": (lambda: agc_ops.cyclostationary_detector(
            rrc[:4000], 100.0, 1000.0), ff),
        "agc.wigner_ville": (lambda: agc_ops.wigner_ville(x[:256], 64), ff),
    }


def slice_loops(v: dict) -> dict:
    """The recursions, as label: (call of `steps` steps on the inputs `v`,
    the reference test's step count, tolerance)."""
    x, xr, rrc, syms, err = v["x"], v["xr"], v["rrc"], v["syms"], v["err"]
    isi = v["isi"]
    chips = torch.repeat_interleave(torch.sign(xr[:32]), 4).to(torch.complex64)
    dll_in = torch.cat([torch.zeros(6, dtype=torch.complex64, device=x.device), chips,
                        torch.zeros(378, dtype=torch.complex64, device=x.device)])
    lt = SLICE_LOOP_TOL
    return {
        "filters.iir_filter": (lambda n: filters.iir_filter([0.5, 0.5], [1.0, -0.2], xr[:n]),
                               64, lt),
        "filters.single_pole_iir": (lambda n: filters.single_pole_iir(0.25, xr[:n]), 16, lt),
        "filters.dc_blocker": (lambda n: filters.dc_blocker(xr[:n] + 5.0), 4096, lt),
        "resample.pfb_clock_sync": (lambda n: resample.pfb_clock_sync(rrc[:(n + 2) * 4 + 33], 4),
                                    800, 0),
        "sync.costas_loop": (lambda n: ops_sync.costas_loop(syms[:n], 0.02, 4), 4000, lt),
        "sync.pll_track_tone": (lambda n: ops_sync.pll_track_tone(
            torch.exp(0.05j * torch.arange(n, device=x.device)).to(torch.complex64)), 4000, lt),
        "sync.dpll_advance": (lambda n: ops_sync.dpll_advance(err[:n], 0.1, 0.01), 100, lt),
        "sync.fll_band_edge": (lambda n: ops_sync.fll_band_edge(rrc[:n], 4), 12032, lt),
        "sync2.afc": (lambda n: sync2.afc(x[:n] + 3.0, 1e4, 0.05), 4000, lt),
        # rotated by 0.3 rad as tests/test_sync2.py:37 rotates it: x⁴ then sits off
        # angle's ±π branch cut, where a last-bit difference would flip the loop
        "sync2.carrier_recovery_mpsk": (lambda n: sync2.carrier_recovery_mpsk(
            syms[:n] * cis(torch.tensor(0.3)).to(x.device), 4, 0.05), 4000, lt),
        "sync2.pll_carrier_tracking": (lambda n: sync2.pll_carrier_tracking(
            x[:n] * 0.1 + 1.0, 0.05), 6000, lt),
        "sync2.pll_biquad": (lambda n: sync2.pll_biquad(x[:n] * 0.1 + 1.0), 6000, lt),
        "sync2.symbol_sync_mm": (lambda n: sync2.symbol_sync_mm(rrc[:(n + 2) * 4], 4, 0.05),
                                 1998, lt),
        "sync2.delay_lock_loop": (lambda n: sync2.delay_lock_loop(dll_in, chips, 4, 0.2),
                                  64, lt),
        "sync2.agc_attack_decay": (lambda n: sync2.agc_attack_decay(x[:n] * 3, 1.0, 0.2, 0.05),
                                   1000, lt),
        "sync2.burst_gating_controller": (lambda n: sync2.burst_gating_controller(
            40 * xr[:n], -10.0, -30.0, 8), 100, 0),
        "sync2.pid_controller": (lambda n: sync2.pid_controller(err[:n], 1.0, 0.1, 0.5), 100, lt),
        "sync2.control_loop_2nd": (lambda n: sync2.control_loop_2nd(err[:n], 0.1), 200, lt),
        "equalizers.lms_equalize": (lambda n: equalizers.lms_equalize(isi[:n], syms[:n], 9,
                                                                      0.02), 4000, lt),
        "equalizers.rls_equalize": (lambda n: equalizers.rls_equalize(isi[:n], syms[:n], 7),
                                    800, SLICE_RLS_TOL),
        "equalizers.cma_equalize": (lambda n: equalizers.cma_equalize(isi[:n], 11, 0.002),
                                    4096, lt),
        "equalizers.dfe_equalize": (lambda n: equalizers.dfe_equalize(isi[:n], 9, 4, 0.005,
                                                                      syms[:4]), 4096, 0),
        "equalizers.time_domain_equalizer": (lambda n: equalizers.time_domain_equalizer(
            isi[:n], 15, "lms", 0.01, reference=syms[:n // 4], constellation=syms[:4]), 1500, lt),
        "equalizers.mlse_equalize": (lambda n: equalizers.mlse_equalize(
            isi[:n], np.asarray([1.0, 0.4, -0.2]), QPSK_POINTS), 4096, 0),
        "agc.agc": (lambda n: agc_ops.agc(x[:n] * 0.05, 1.0, 0.05, 0.02), 3000, lt),
    }


def compare_outputs(label: str, got, want, tol: float) -> float:
    """max|card - CPU| / max|CPU| over every float tensor in the outputs
    (integer and bool tensors, numpy arrays and numbers equal); raises
    beyond `tol` (0: equal)."""
    if isinstance(want, torch.Tensor):
        if got.device.type != CARD or got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{label}: {got.shape} {got.dtype} on {got.device}, want "
                                 f"{want.shape} {want.dtype}")
        got = got.cpu()
        if not (want.is_floating_point() or want.is_complex()) or tol == 0:
            if not torch.equal(got, want):
                raise AssertionError(f"{label}: card differs from the CPU")
            return 0.0
        if not want.numel():
            return 0.0
        scale = float(torch.max(torch.abs(want))) or 1.0
        rel = float(torch.max(torch.abs(got - want))) / scale
        if not rel <= tol:
            raise AssertionError(f"{label}: card vs CPU max|Δ|/max {rel:.3g} > {tol}")
        return rel
    if isinstance(want, dict):
        return max([compare_outputs(f"{label}.{k}", got[k], want[k], tol) for k in want] or [0.0])
    if isinstance(want, (tuple, list)):
        return max([compare_outputs(f"{label}[{i}]", g, w, tol)
                    for i, (g, w) in enumerate(zip(got, want))] or [0.0])
    if not np.array_equal(np.asarray(got), np.asarray(want)):
        raise AssertionError(f"{label}: {got} on the card, {want} on the CPU")
    return 0.0


def on_device(v: dict, dev: torch.device) -> dict:
    return {k: t.to(dev) for k, t in v.items()}


def check_slice_card_against_cpu(dev: torch.device) -> dict:
    """Phase 36: every function of pulse, filters, measure, resample, sync,
    sync2, equalizers and agc that this slice ported, on the card against
    the port's CPU result on the same numpy-made inputs (2^14 samples; the
    loops at their reference tests' sizes): integer results equal, floats
    within the stated tolerance of the CPU's peak. Then each recursion's
    device launches a step (the profiler's event count at two step counts,
    the slope; the one-pole filters launch first_order_iir once a call at
    either count, read from its counter) and host seconds a step at the
    reference size."""
    cpu_v = slice_inputs()
    dev_v = on_device(cpu_v, dev)
    card, cpu = slice_cases(dev_v), slice_cases(cpu_v)
    worst, failures = {}, []
    for label, (fn, tol) in card.items():
        try:  # every call is checked; the phase fails at its end if any differs
            worst[label] = compare_outputs(label, fn(), cpu[label][0](), tol)
        except AssertionError as exc:
            failures.append(str(exc))
    if failures:
        raise AssertionError("; ".join(failures))
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:4]
    phase("36 slice card vs cpu", f"{len(worst)} feed-forward calls on {SLICE_SAMPLES} samples: "
          f"decisions equal, floats within {SLICE_CARD_TOL} of the CPU's peak (cumulative sums "
          f"{SLICE_CUMSUM_TOL}); largest " + ", ".join(f"{k} {v:.3g}" for k, v in top))
    card_loops, cpu_loops = slice_loops(dev_v), slice_loops(cpu_v)
    table = {}
    for label, (fn, steps, tol) in card_loops.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(steps)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        try:
            rel = compare_outputs(label, got, cpu_loops[label][0](steps), tol)
        except AssertionError as exc:
            failures.append(str(exc))
            continue
        if label in FIXED_STEP_LOOPS:  # its step count is the function's own
            per_step = breakdown(lambda: fn(steps))["device_events"] / steps
        elif label in RECURSION_KERNEL_LOOPS:  # one launch of first_order_iir a call
            counts = []
            for n in LOOP_PROFILE_STEPS:
                before = recurrence.first_order_recurrence.launches
                fn(n)
                counts.append(recurrence.first_order_recurrence.launches - before)
            if counts != [1, 1]:
                raise AssertionError(f"{label}: first_order_iir launches {counts}, want 1 a call")
            per_step = 0.0
        else:
            lo, hi = (breakdown(lambda: fn(n))["device_events"] for n in LOOP_PROFILE_STEPS)
            per_step = (hi - lo) / (LOOP_PROFILE_STEPS[1] - LOOP_PROFILE_STEPS[0])
        table[label] = {"steps": steps, "max_rel_err": rel, "launches_per_step": per_step,
                        "host_s_per_step": secs / steps}
    if failures:
        raise AssertionError("; ".join(failures))
    phase("36 slice loops", f"{len(table)} recursions at their reference tests' step counts: "
          f"decisions equal, floats within {SLICE_LOOP_TOL} of the CPU's peak (RLS "
          f"{SLICE_RLS_TOL}); launches a step (profiler, steps {LOOP_PROFILE_STEPS}) and host "
          f"µs a step: " + ", ".join(
              f"{k} {r['launches_per_step']:.2f}/{1e6 * r['host_s_per_step']:.1f}"
              for k, r in table.items()))
    return {"feed_forward": worst, "loops": table}


def gate_decisions(gate: dict) -> dict:
    """The decisions of a composed_receiver_gate result, by case and key."""
    c = gate["cases"]
    return {"link": {k: c["qpsk_link"][k] for k in ("offset", "rotation", "bits", "decoding")},
            "isi": c["isi_mlse"]["decisions"], "map": c["map_soft"]["decisions"],
            "mlse": c["mlse_vs_dfe"]["decisions"], "dfe": c["mlse_vs_dfe"]["dfe_decisions"]}


def drive_receiver_gate(dev: torch.device, refs: "CpuReferences") -> dict:
    """Phase 37: `composed_receiver_gate()` on the card at the reference's
    sizes and at the 1,500-byte packet, each with the counts set to 0 just
    before it and read just after: every bar met (the reference's four at
    its sizes; the packet decoded at full width), fir_decimate launched
    twice (shaping and matched filter) and each Viterbi kernel once (the
    hypothesis decode), no other hand-written kernel; every decision equal
    to a CPU run of the gate; the packet's seconds end to end and the
    shares of the step loops; one more reference-size gate under the
    profiler (warm: the gate has just run)."""
    out = {}
    want = {"dechirp_power": 0, "fir_decimate": RECEIVER_FIR_LAUNCHES, "nco_mix": 0,
            "viterbi_forward": 1, "viterbi_traceback": 1}
    for label, n_bits in (("reference", RECEIVER_INFO_BITS), ("packet", PACKET_INFO_BITS)):
        zero_launch_counts()
        gate = composed_receiver_gate(dev, n_bits)
        counts = kernel_counts()
        if not gate["ok"] or counts != want:
            raise AssertionError(f"receiver gate {label}: ok {gate['ok']}, launches {counts}")
        cpu = refs.get(("receiver", n_bits))
        card_dec, cpu_dec = gate_decisions(gate), cpu["decisions"]
        for case, value in card_dec.items():
            pairs = value.items() if isinstance(value, dict) else [("", value)]
            for key, got in pairs:
                ref = cpu_dec[case][key] if key else cpu_dec[case]
                if not np.array_equal(np.asarray(got), np.asarray(ref)):
                    raise AssertionError(f"receiver gate {label}: {case} {key} differs between "
                                         f"card and CPU")
        c, s = gate["cases"], gate["seconds"]
        link = c["qpsk_link"]
        phase("37 receiver gate", f"{label}: {n_bits} info bits on {dev}: {link['hypotheses']} "
              f"hypotheses decoded as lanes of one viterbi_decode (bm ({link['viterbi_steps']}, "
              f"4, {link['hypotheses']})), offset {link['offset']} rotation {link['rotation']} "
              f"decodes the payload; sounding tap error {c['isi_mlse']['tap_err']:.4f}, ghost "
              f"{c['isi_mlse']['ghost']:.4f}, MLSE SER {c['isi_mlse']['ser_mlse']} (slicer "
              f"{c['isi_mlse']['ser_naive']:.4f}); MAP soft {c['map_soft']['errors_soft']} <= "
              f"hard {c['map_soft']['errors_hard']}; null MLSE SER {c['mlse_vs_dfe']['ser_mlse']} "
              f"vs DFE {c['mlse_vs_dfe']['ser_dfe']:.4f}; every decision equal to the CPU's; "
              f"launches {json.dumps(counts)}; {s['total']:.3f} s end to end, pfb_clock_sync "
              f"{s['pfb_clock_sync']:.3f} s ({100 * s['share']['pfb_clock_sync']:.1f}%), MLSE "
              f"{s['mlse']:.3f} s ({100 * s['share']['mlse']:.1f}%), DFE {s['dfe']:.3f} s "
              f"({100 * s['share']['dfe']:.1f}%); CPU run {cpu['total_s']:.3f} s (in the "
              f"background process)")
        out[label] = {"launches": counts, "seconds": s, "cpu_seconds": cpu["total_s"]}
    # the first case only: the whole gate's ~500,000 launches took the
    # profiler ~78 s of host time
    bits = np.random.default_rng(7).integers(0, 2, RECEIVER_INFO_BITS).astype(np.int32)
    prof = breakdown(lambda: entry_module._qpsk_link(bits, dev), warm=False)
    phase("37 receiver profile", f"the reference-size gate's QPSK link (its first case: "
          f"shaping, PFB timing recovery, phase, the hypothesis decode) under the profiler: "
          f"{prof['device_events']} launches, busy {prof['busy_ms']:.3f} ms of a "
          f"{prof['span_ms']:.3f} ms span, idle share {prof['idle_share']:.4f}; largest "
          + json.dumps(prof["top_ms"]))
    out["profile"] = prof
    return out


def time_receiver_kernels(dev: torch.device) -> dict:
    """Phase 38: the three kernels of the receiver gate at its own shapes,
    against their plain versions and timed: fir_decimate at the packet's
    shaping/matched-filter input (1, 48,256) complex64, K = 33, f = 1 (queued,
    in turns with the plain version; cuDNN conv1d with TF32 off as the
    yardstick), both Viterbi kernels at the hypothesis decode's bm (12,006,
    4, 88) (bit for bit; the plain versions timed once, the kernels
    queued). Returns per-kernel entries for the kernel line."""
    gen = torch.Generator(device=dev).manual_seed(38)
    n = (2 * (PACKET_INFO_BITS + 6) + 127) // 128 * 128 // 2 + 32  # symbols with the tail
    x = randn_iq((1, n * RECEIVER_SPS), gen)
    taps = torch.from_numpy(pulse.root_raised_cosine_taps(RECEIVER_SPS, 8, 0.35)).to(dev)
    k = taps.shape[0]
    got = fir.fir_decimate_cuda(x, taps.flip(0), 1, zero_state=True)
    want = fir.fir_decimate(x, taps.flip(0), 1, zero_state=True)
    abs_err, rel = rel_err(got, want)
    if not rel < FIR_REL_TOL:
        raise AssertionError(f"fir_decimate at the receiver's shape: {rel:.3g}")
    # one row of 48,256 samples: a few microseconds of device work, so each
    # time is taken queued behind a sleeping stream (not the host's launch rate),
    # in turns: plain, kernel, kernel, plain
    plain_fn = lambda: fir.fir_decimate(x, taps.flip(0), 1, zero_state=True)
    kern_fn = lambda: fir.fir_decimate_cuda(x, taps.flip(0), 1, zero_state=True)
    plain = [queued_ms(plain_fn)]
    kern = [queued_ms(kern_fn), queued_ms(kern_fn)]
    plain.append(queued_ms(plain_fn))
    planes = F.pad(torch.view_as_real(x).permute(0, 2, 1), (k - 1, 0)).contiguous()
    weight = taps.flip(0).view(1, 1, -1).repeat(2, 1, 1)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        lib_out = F.conv1d(planes, weight, groups=2)
        library = queued_ms(lambda: F.conv1d(planes, weight, groups=2))
    _, lib_rel = rel_err(torch.view_as_complex(lib_out.permute(0, 2, 1).contiguous()), got)
    if not lib_rel < FIR_REL_TOL:
        raise AssertionError(f"the conv1d yardstick computes another function: {lib_rel:.3g}")
    b_ms, b_by = fir_bound(1, x.shape[1] + k - 1, k, 1)
    table = {"fir_decimate": {
        "ms_receiver": sum(kern) / 2, "plain_ms_receiver": sum(plain) / 2,
        "bound_ms_receiver": b_ms, "bound_by_receiver": b_by, "library_ms_receiver": library,
        "max_abs_err_receiver": abs_err, "shape_receiver": [1, int(x.shape[1]), k, 1]}}
    phase("38 receiver fir", f"fir_decimate complex (1, {x.shape[1]}) K={k} f=1 from zero state "
          f"(the gate's shaping and matched filter), queued: kernel {kern[0]:.5f}/{kern[1]:.5f} "
          f"ms, plain {plain[0]:.5f}/{plain[1]:.5f} ms, conv1d (cuDNN, FP32, max|Δ|/max|y| "
          f"{lib_rel:.3g}) {library:.5f} ms; bound {b_ms:.5f} ms by {b_by}; max|Δ|/max|ref| "
          f"{rel:.3g}")
    del x, got, want, planes, lib_out
    bm = noisy_branch_metrics(RECEIVER_HYPOTHESES, 2 * (PACKET_INFO_BITS + 6) // 2, 7, seed=38)
    check = check_viterbi(bm, 7)
    dec, _ = viterbi.viterbi_forward_cuda(bm, 7, VITERBI_CODES[7])
    for name, kern_fn, plain_ms, err, (b_ms, b_by), shape in (
            ("viterbi_forward", lambda: viterbi.viterbi_forward_cuda(bm, 7, VITERBI_CODES[7]),
             check["plain_forward_ms"], check["forward_abs_err"], forward_bound(bm, dec, 7),
             bm.shape),
            ("viterbi_traceback", lambda: viterbi.viterbi_traceback_cuda(dec, 7, VITERBI_CODES[7]),
             check["plain_traceback_ms"], check["traceback_abs_err"], traceback_bounds(dec)[0],
             dec.shape)):
        ms = [queued_ms(kern_fn) for _ in range(2)]
        table[name] = {"ms_receiver": sum(ms) / 2, "plain_ms_receiver": plain_ms,
                       "bound_ms_receiver": b_ms, "bound_by_receiver": b_by,
                       "max_abs_err_receiver": err, "shape_receiver": list(shape)}
        phase("38 receiver viterbi", f"{name} at {tuple(shape)} (the gate's hypothesis decode): "
              f"equal to the plain version bit for bit; kernel {ms[0]:.4f}/{ms[1]:.4f} ms queued, "
              f"plain {plain_ms:.3f} ms once; bound {b_ms:.5f} ms by {b_by}; no library call")
    return table


def drive_family_gate(dev: torch.device) -> dict:
    """Phase 39: `modem_family_gate()` on the card (every function of the
    modem family on its JAX test's inputs, card against CPU: decisions
    equal, floats within the stated tolerance), the 1,500-byte convolutional
    packet (each Viterbi kernel launched once, the bits back) and the LTE
    uplink subframe (symbols back, PAPR below plain OFDM's); then both
    Viterbi kernels against their plain versions at the packet's bm
    (12,006, 4, 1), timed queued. Returns the Viterbi kernels' entries."""
    gate = modem_family_gate(dev)
    worst, conv, lte = gate["worst"], gate["conv_packet"], gate["lte"]
    if not gate["ok"] or conv["launches"] != {"viterbi_forward": 1, "viterbi_traceback": 1}:
        bad = {k: worst[k] for k in gate["failed"]}
        raise AssertionError(f"family gate: ok {gate['ok']}, differing {bad}, conv {conv}, "
                             f"lte {lte}")
    top = sorted(worst.items(), key=lambda kv: -kv[1])
    phase("39 family card vs cpu", f"{len(worst)} cases equal to the CPU's decisions, floats "
          f"within {FAMILY_TOL} ({FAMILY_PHASE_TOL} for the WSJT tones, {FAMILY_DFT_TOL} for "
          f"the PMU and harmonic DFTs); worst per case: "
          + ", ".join(f"{k} {v:.3g}" for k, v in top))
    phase("39 family conv packet", f"{conv['bits']} bits ({conv['coded']} coded) decoded back "
          f"through the FEC table on the card; launches {json.dumps(conv['launches'])}")
    phase("39 family lte", f"LTE 20 MHz uplink subframe ({LTE_SYMBOLS} × {LTE_SC} QPSK on "
          f"{LTE_FFT}-point, cp {LTE_CP}; {lte['samples']} samples): max|Δ| "
          f"{lte['max_abs_err']:.3g}; PAPR SC-FDMA {lte['papr_sc_fdma_db']:.4f} dB < OFDM "
          f"{lte['papr_ofdm_db']:.4f} dB")
    phase("39 family left out", "; ".join(f"{k}: {v}" for k, v in gate["left_out"].items()))
    steps = 8 * FAMILY_PACKET_BYTES + 6
    bm = noisy_branch_metrics(1, steps, 7, seed=39)
    check = check_viterbi(bm, 7)
    dec, _ = viterbi.viterbi_forward_cuda(bm, 7, VITERBI_CODES[7])
    table = {}
    for name, fn, plain_ms, err, (b_ms, b_by), shape in (
            ("viterbi_forward", lambda: viterbi.viterbi_forward_cuda(bm, 7, VITERBI_CODES[7]),
             check["plain_forward_ms"], check["forward_abs_err"], forward_bound(bm, dec, 7),
             bm.shape),
            ("viterbi_traceback", lambda: viterbi.viterbi_traceback_cuda(dec, 7, VITERBI_CODES[7]),
             check["plain_traceback_ms"], check["traceback_abs_err"], traceback_bounds(dec)[0],
             dec.shape)):
        ms = [queued_ms(fn) for _ in range(2)]
        table[name] = {"ms_packet": sum(ms) / 2, "plain_ms_packet": plain_ms,
                       "bound_ms_packet": b_ms, "bound_by_packet": b_by,
                       "max_abs_err_packet": err, "shape_packet": list(shape),
                       "launches_family_gate": conv["launches"][name]}
        phase("39 packet viterbi", f"{name} at {tuple(shape)} (the packet's hard decode): equal "
              f"to the plain version bit for bit; kernel {ms[0]:.4f}/{ms[1]:.4f} ms queued, "
              f"plain {plain_ms:.3f} ms once; bound {b_ms:.6f} ms by {b_by}; no library call")
    return table


def fm_launch_check(label: str, counts: dict) -> None:
    want = dict.fromkeys(counts, 0)
    want.update(fir_decimate=FM_FIR_LAUNCHES, first_order_iir=FM_RECURSION_LAUNCHES)
    if counts != want:
        raise AssertionError(f"fm broadcast {label}: launches {counts}, want {want}")


def drive_fm_broadcast(dev: torch.device) -> dict:
    """Phase 40: `fm_broadcast_gate()` on the card at 1 s and at its full 60 s
    (14.4 M IQ samples at 240 kS/s), each with the counts set to 0 just
    before it and read just after: every bar met, fir_decimate launched 9
    times and first_order_iir once at both lengths (no loop over samples),
    no other hand-written kernel. Then the card against a CPU run of the
    gate on a 2 s station (RDS bits equal, L, R and mono audio within
    FM_CARD_TOL of the CPU's peak) and one warm chain on the card-resident
    60 s IQ under the profiler (the gate without the numpy synthesis and
    the host's spectra)."""
    runs = {}
    for label, seconds in (("1 s", 1.0), ("60 s", FM_SECONDS)):
        zero_launch_counts()
        gate = fm_broadcast_gate(dev, seconds)
        counts = fm_counts()
        fm_launch_check(label, counts)
        b = gate["bars"]
        if not gate["ok"]:
            raise AssertionError(f"fm broadcast {label}: bars {b}")
        phase("40 fm broadcast", f"{label} ({gate['samples']} IQ samples at {FM_RATE_HZ:.0f} S/s) "
              f"on {dev}: pilot present {b['present']}; separation L {b['separation_left_db']:.2f}"
              f" dB, R {b['separation_right_db']:.2f} dB (bar {FM_SEPARATION_DB}); RDS match "
              f"{b['rds_match']:.6f} over {b['rds_bits']} bits; mono tones {b['mono_tones_hz']} Hz "
              f"(±{b['tone_tol_hz']:.4g}); stage ms {json.dumps(gate['stage_ms'])}; launches "
              f"{json.dumps(counts)}; {gate['seconds']:.4f} s end to end")
        runs[label] = {"launches": counts, "stage_ms": gate["stage_ms"],
                       "seconds": gate["seconds"], "bars": b}
        iq = gate["iq"]
        del gate
    if runs["1 s"]["launches"] != runs["60 s"]["launches"]:
        raise AssertionError(f"fm broadcast launches grow with the length: {runs}")
    card = fm_broadcast_gate(dev, FM_CARD_SECONDS)["outputs"]
    cpu = fm_broadcast_gate("cpu", FM_CARD_SECONDS)["outputs"]
    if not torch.equal(card["rds_bits"].cpu(), cpu["rds_bits"]):
        raise AssertionError("fm broadcast: the card's RDS bits differ from the CPU's")
    diffs = {}
    for key in ("left", "right", "audio", "mpx"):
        _, diffs[key] = rel_err(card[key].cpu(), cpu[key])
        if not diffs[key] < FM_CARD_TOL:
            raise AssertionError(f"fm broadcast: {key} card vs CPU {diffs[key]:.3g}")
    phase("40 fm card vs cpu", f"{FM_CARD_SECONDS} s station: {card['rds_bits'].numel()} RDS bits "
          f"equal; max|Δ|/max|CPU| " + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items())
          + f" (bar {FM_CARD_TOL})")
    prof = breakdown(lambda: fm_broadcast_chain(iq, FM_RATE_HZ))
    phase("40 fm profile", f"one warm chain on the 60 s IQ under the profiler: "
          f"{prof['device_events']} launches, busy {prof['busy_ms']:.3f} ms of a "
          f"{prof['span_ms']:.3f} ms span, idle share {prof['idle_share']:.4f}; largest "
          + json.dumps(prof["top_ms"]))
    runs["card_vs_cpu"] = diffs
    runs["profile"] = prof
    return runs


def chain_probe(steps: int, kind: str, c0: float, c1: float = 0.0) -> dict:
    """A recursion kind's bare chain on the card (`first_order_iir_chain_probe`
    in csrc/first_order_iir.cu: one thread, `steps` dependent steps of
    `kind` on inputs held in registers): its cycles and nanoseconds a step,
    the SM clock (MHz) while it ran, and its last y. Timed on its second
    launch."""
    fn = _build.load_library("first_order_iir").r4w_first_order_iir_chain_probe
    fn.argtypes = ([ctypes.c_longlong, ctypes.c_int] + [ctypes.c_float] * 4
                   + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    y = torch.empty(1, device="cuda")
    ticks = torch.zeros(2, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(2):
        err = fn(steps, recurrence.KINDS.index(kind), recurrence.coefficient(c0),
                 recurrence.coefficient(c1), 0.5, -0.25, y.data_ptr(), ticks.data_ptr(),
                 ticks.data_ptr() + 8, stream)
        if err != 0:
            raise RuntimeError(f"first_order_iir_chain_probe launch failed with cudaError {err}")
    cycles, ns = (int(v) for v in ticks.cpu())
    return {"cycles_per_step": cycles / steps, "ns_per_step": ns / steps,
            "sm_mhz": 1e3 * cycles / ns, "y": float(y.cpu()[0])}


def probe_chain_value(steps: int, kind: str, c0: float, c1: float = 0.0) -> float:
    """The chain probe's last y by the plain version: its inputs cycle
    0.5, -0.25, -0.5, 0.25 from y = 0."""
    u = torch.tensor([0.5, -0.25, -0.5, 0.25]).repeat(steps // 4)[None]
    return float(recurrence.first_order_recurrence(u, kind, c0, c1)[0, -1])


def sm_clock_while(fn, calls: int = CLOCK_READ_CALLS) -> float:
    """The SM clock (MHz) that nvidia-smi reads while `calls` calls of `fn`,
    queued back to back, keep the card busy."""
    for _ in range(calls):
        fn()
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    torch.cuda.synchronize()
    return mhz


def time_recursion_and_fm_fir(dev: torch.device) -> dict:
    """Phase 41: the recursion kernel's linear kind (the FM path's
    de-emphasis, y = fma(b, y, u)) against its plain version bit for bit at
    (1, 2^15) and (64, 4096) float32 and (8, 4096) complex64 (with and
    without a state) and at the FM path's (1, 14.4 M) with a state; timed
    queued at (1, 2^15) beside the plain step loop (on the host) and at
    (1, 14.4 M) and (2, 14.4 M), with its bytes bound and its serial floor:
    the steps times the measured time a step of the bare chain
    (`chain_probe`), whose cycles a step and SM clock it reports beside the
    kernel's cycles a step at the clock nvidia-smi reads while it runs.
    Then the FIR kernel at (1, 14.4 M) float32 for K = 301, 201 and 101
    (the FM path's filters): kernel, plain, cuDNN conv1d with TF32 off,
    bound. Returns the kernel line's entries."""
    gen = torch.Generator(device=dev).manual_seed(41)
    b = 1.0 - 1.0 / 9.0
    for shape, dtype in (((1, 1 << 15), torch.float32), ((64, 4096), torch.float32),
                         ((8, 4096), torch.complex64)):
        u = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        state = torch.randn(shape[:1], generator=gen, device=dev, dtype=dtype)
        for st in (None, state):
            got = recurrence.first_order_recurrence_cuda(u, "linear", b, state=st)
            want = recurrence.first_order_recurrence(u.cpu(), "linear", b,
                                                     state=None if st is None else st.cpu())
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"first_order_iir at {shape} {dtype}: differs from the plain "
                                     f"loop by {float(torch.max(torch.abs(got.cpu() - want))):.3g}")
    n = int(FM_SECONDS * FM_RATE_HZ)
    u = torch.randn((1, n), generator=gen, device=dev)
    state = torch.randn((1,), generator=gen, device=dev)
    got = recurrence.first_order_recurrence_cuda(u, "linear", b, state=state).cpu()
    t0 = time.perf_counter()
    want = recurrence.first_order_recurrence(u.cpu(), "linear", b, state=state.cpu())
    loop_s = time.perf_counter() - t0
    max_abs_err = float(torch.max(torch.abs(got.double() - want.double())))
    if not torch.equal(got, want):
        raise AssertionError(f"first_order_iir at (1, {n}): differs from the plain loop by "
                             f"{max_abs_err:.3g} at {int(torch.sum(got != want))} samples")
    phase("41 recursion", f"first_order_iir (linear) equals the plain step loop bit for bit at "
          f"(1, 32768) and (64, 4096) float32 and (8, 4096) complex64, with and without a "
          f"state, and at the FM path's (1, {n}) with a state (max|Δ| {max_abs_err}; the plain "
          f"loop {loop_s:.1f} s on the host)")
    del u, state, got, want
    probe = chain_probe(n, "linear", b)
    small = chain_probe(1 << 12, "linear", b)
    if not small["y"] == probe_chain_value(1 << 12, "linear", b):
        raise AssertionError(f"the chain probe computes another chain: {small['y']}")
    phase("41 recursion floor", f"the bare linear chain ({n} dependent float32 fused "
          f"multiply-adds in one thread): {probe['cycles_per_step']:.4f} cycles a step, "
          f"{probe['ns_per_step']:.5f} ns a step, the SM at {probe['sm_mhz']:.1f} MHz")
    u = torch.randn((1, 1 << 15), generator=gen, device=dev)
    u_host = u.cpu()
    plain = [host_ms(lambda: recurrence.first_order_recurrence(u_host, "linear", b))]
    kern = [queued_ms(lambda: recurrence.first_order_recurrence_cuda(u, "linear", b))
            for _ in range(2)]
    plain.append(host_ms(lambda: recurrence.first_order_recurrence(u_host, "linear", b)))
    steps = 1 << 15
    entry = {"ms": sum(kern) / 2, "plain_ms": sum(plain) / 2, "shape": [1, steps],
             "bound_ms": 1e3 * 8 * steps / HBM_BYTES_PER_S, "bound_by": "bytes",
             "serial_floor_ms": steps * probe["ns_per_step"] * 1e-6,
             "chain_cycles_per_step": probe["cycles_per_step"], "chain_sm_mhz": probe["sm_mhz"],
             "max_abs_err": max_abs_err, "max_abs_err_shape": [1, n], "library_ms": None}
    phase("41 recursion timing", f"(1, {steps}) float32: kernel {kern[0]:.4f}/{kern[1]:.4f} ms "
          f"queued, plain step loop (host) {plain[0]:.2f}/{plain[1]:.2f} ms; bytes bound "
          f"{entry['bound_ms']:.6f} ms, serial floor {entry['serial_floor_ms']:.4f} ms")
    for rows in (1, 2):
        u = torch.randn((rows, n), generator=gen, device=dev)
        ms = queued_ms(lambda: recurrence.first_order_recurrence_cuda(u, "linear", b), 3)
        mhz = sm_clock_while(lambda: recurrence.first_order_recurrence_cuda(u, "linear", b))
        cycles = ms * 1e-3 * mhz * 1e6 / n
        key = f"fm_rows{rows}"
        entry.update({f"ms_{key}": ms, f"bound_ms_{key}": 1e3 * 8 * rows * n / HBM_BYTES_PER_S,
                      f"serial_floor_ms_{key}": n * probe["ns_per_step"] * 1e-6,
                      f"sm_mhz_{key}": mhz, f"cycles_per_step_{key}": cycles})
        phase("41 recursion timing", f"({rows}, {n}) float32: kernel {ms:.3f} ms queued "
              f"({cycles:.2f} cycles a step at the {mhz:.0f} MHz nvidia-smi read while it ran); "
              f"bytes bound {entry[f'bound_ms_{key}']:.4f} ms; serial floor "
              f"{entry[f'serial_floor_ms_{key}']:.3f} ms")
        del u
    x = torch.randn((1, n), generator=gen, device=dev)
    fir_entry = {}
    for k in FM_FIR_TAPS:
        taps = torch.randn(k, generator=gen, device=dev)
        got = fir.fir_decimate_cuda(x, taps, 1, zero_state=True)
        want = fir.fir_decimate(x, taps, 1, zero_state=True)
        abs_err, rel = rel_err(got, want)
        if not rel < FIR_REL_TOL:
            raise AssertionError(f"fir_decimate at (1, {n}) K={k}: {rel:.3g}")
        plain_fn = lambda: fir.fir_decimate(x, taps, 1, zero_state=True)
        kern_fn = lambda: fir.fir_decimate_cuda(x, taps, 1, zero_state=True)
        kern, plain = in_turns(plain_fn, kern_fn)
        planes = F.pad(x[:, None, :], (k - 1, 0))
        weight = taps.view(1, 1, -1)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            lib_out = F.conv1d(planes, weight)
            library = cuda_ms(lambda: F.conv1d(planes, weight))
        _, lib_rel = rel_err(lib_out[:, 0], got)
        if not lib_rel < FIR_REL_TOL:
            raise AssertionError(f"the conv1d yardstick computes another function: {lib_rel:.3g}")
        # float32 in and out, the taps once; 1 FMA (2 flops) per tap and output
        b_ms, b_by = bound(4 * (n + k - 1) + 4 * k + 4 * got.shape[1], 2 * got.shape[1] * k)
        fir_entry.update({f"ms_fm_k{k}": sum(kern) / 2, f"plain_ms_fm_k{k}": sum(plain) / 2,
                          f"library_ms_fm_k{k}": library, f"bound_ms_fm_k{k}": b_ms,
                          f"bound_by_fm_k{k}": b_by, f"max_abs_err_fm_k{k}": abs_err})
        phase("41 fm fir", f"fir_decimate float32 (1, {n}) K={k} f=1 from zero state: kernel "
              f"{kern[0]:.4f}/{kern[1]:.4f} ms, plain {plain[0]:.3f}/{plain[1]:.3f} ms, conv1d "
              f"(cuDNN, FP32, max|Δ|/max|y| {lib_rel:.3g}) {library:.4f} ms; bound {b_ms:.4f} ms "
              f"by {b_by}; max|Δ|/max|ref| {rel:.3g}")
        del got, want, planes, lib_out
    return {"first_order_iir": entry, "fir_decimate": fir_entry}


def drive_blocks_gate(dev: torch.device) -> dict:
    """Phase 42: `dsp_blocks_gate()` on the card: every function of
    stream_math, filters2, stream_blocks, detect, adaptive and kalman on its
    JAX test's inputs, card against CPU (decisions equal, floats within the
    stated tolerances), and each recursion kind at (4, 2^20) card = CPU bit
    for bit."""
    gate = dsp_blocks_gate(dev, RECURSION_SHAPE)
    if not gate["ok"]:
        raise AssertionError(f"dsp blocks gate: failed "
                             f"{ {k: gate['worst'][k] for k in gate['failed']} }, recursion diffs "
                             f"{gate['recursion_diffs']}")
    top = sorted(gate["worst"].items(), key=lambda kv: -kv[1])[:5]
    phase("42 blocks gate", f"{len(gate['worst'])} cases card = CPU on {dev} (decisions equal, "
          f"floats within their tolerances); largest " + ", ".join(f"{k} {v:.3g}" for k, v in top)
          + f"; each recursion kind at {RECURSION_SHAPE} differs in "
          f"{json.dumps(gate['recursion_diffs'])} samples")
    return gate


def monitor_launch_check(counts: dict, by_kind: dict) -> None:
    want = dict.fromkeys(counts, 0)
    want.update(MONITOR_LAUNCHES)
    want_kinds = {**dict.fromkeys(recurrence.KINDS, 0), **MONITOR_RECURSIONS}
    if counts != want or by_kind != want_kinds:
        raise AssertionError(f"spectrum monitor: launches {counts} by kind {by_kind}, want {want} "
                             f"by kind {want_kinds}")


def drive_spectrum_monitor(dev: torch.device) -> dict:
    """Phase 43: `spectrum_monitor_gate()` at its full width (32 blocks of
    2^20 samples at 30.72 MS/s, 1.092 s) with the counts set to 0 just
    before it and read just after: every bar met, nco_mix and fir_decimate 4
    launches each and the recursion 3 (ema, attack_release, peak_hold once
    each), no other hand-written kernel. Then the card against a CPU run
    at 2 blocks (`monitor_agreement`: decisions equal but at counted ties,
    series within tolerance), one warm chain on the card-resident capture
    under the profiler, and the NCO and FIR kernels at the monitor's shapes
    beside their plain versions, cuDNN's conv1d and their bounds."""
    zero_launch_counts()
    gate = spectrum_monitor_gate(dev, MONITOR_ROWS)
    counts = fm_counts()
    by_kind = dict(recurrence.first_order_recurrence.launches_by_kind)
    monitor_launch_check(counts, by_kind)
    b = gate["bars"]
    if not gate["ok"]:
        raise AssertionError(f"spectrum monitor: bars {b}")
    phase("43 spectrum monitor", f"{gate['samples']} samples ({MONITOR_ROWS} × {MONITOR_BLOCK}) "
          f"at {MONITOR_RATE_HZ:.0f} S/s on {dev}: groups at bins {b['centre_bins']} (planted "
          f"{b['planted_bins']}); bursts {b['bursts']} of {b['bursts_planted']} planted, worst "
          f"edge {b['worst_edge_frames']} frames; squelch open {b['open']}, closed "
          f"{b['closed']}; envelope median in bursts {b['env_in']}, outside {b['env_out']}; "
          f"peak hold max {b['peak_max']:.4f}; stage ms {json.dumps(gate['stage_ms'])}; "
          f"launches {json.dumps(counts)} by kind {json.dumps(by_kind)}; "
          f"{gate['seconds']:.4f} s end to end")
    capture = gate["capture"]
    run = {"launches": counts, "by_kind": by_kind, "stage_ms": gate["stage_ms"],
           "seconds": gate["seconds"], "bars": b}
    del gate
    warm = []
    for _ in range(2):  # the chain again on the card-resident capture, its kernels loaded
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spectrum_monitor_chain(capture)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    run["warm_chain_s"] = warm
    phase("43 monitor warm", f"the chain again on the card-resident capture: "
          f"{warm[0]:.4f}/{warm[1]:.4f} s")
    prof = breakdown(lambda: spectrum_monitor_chain(capture))
    phase("43 monitor profile", f"one warm chain on the card-resident capture under the "
          f"profiler: {prof['device_events']} launches, busy {prof['busy_ms']:.3f} ms of a "
          f"{prof['span_ms']:.3f} ms span, idle share {prof['idle_share']:.4f}; largest "
          + json.dumps(prof["top_ms"]))
    run["profile"] = prof
    card = spectrum_monitor_gate(dev, MONITOR_CARD_ROWS)["outputs"]
    cpu = spectrum_monitor_gate("cpu", MONITOR_CARD_ROWS)["outputs"]
    agreement = monitor_agreement(card, cpu)
    if not agreement["ok"]:
        raise AssertionError(f"spectrum monitor: card against CPU {agreement}")
    phase("43 monitor card vs cpu", f"{MONITOR_CARD_ROWS} blocks: " + json.dumps(agreement))
    run["card_vs_cpu"] = agreement
    del card, cpu
    run["timing"] = time_ddc_kernels(capture, 2.88e6, MONITOR_RATE_HZ, MONITOR_DECIMATION,
                                     "monitor", "43 monitor")
    return run


def time_ddc_kernels(capture: torch.Tensor, freq: float, rate: float, decimation: int, key: str,
                     label: str) -> dict:
    """nco_mix and fir_decimate at a DDC's shapes, (rows, n) c64 and K = 63
    with f = `decimation` from zero state: kernel and plain in turns,
    cuDNN's conv1d (FP32, two planes, groups=2, stride f) as the FIR's
    yardstick, each beside its bound; numbers keyed ``*_{key}``."""
    base = nco.nco_mix_cuda(capture, -freq, rate)
    _, nco_rel = rel_err(base, nco.nco_mix(capture, -freq, rate))
    if not nco_rel < NCO_REL_TOL:
        raise AssertionError(f"nco_mix at the {key} shape: {nco_rel:.3g}")
    kern, plain = in_turns(lambda: nco.nco_mix(capture, -freq, rate),
                           lambda: nco.nco_mix_cuda(capture, -freq, rate))
    b_ms, b_by = bound(16 * capture.numel(), 0)
    out = {"nco_mix": {f"ms_{key}": sum(kern) / 2, f"plain_ms_{key}": sum(plain) / 2,
                       f"bound_ms_{key}": b_ms, f"bound_by_{key}": b_by,
                       f"library_ms_{key}": None, f"max_rel_err_{key}": nco_rel,
                       f"shape_{key}": list(capture.shape)}}
    phase(f"{label} nco", f"nco_mix at {tuple(capture.shape)}: kernel {kern[0]:.4f}/"
          f"{kern[1]:.4f} ms, plain {plain[0]:.4f}/{plain[1]:.4f} ms; bound {b_ms:.4f} ms by "
          f"{b_by}; max|Δ|/max|plain| {nco_rel:.3g}")
    taps = torch.from_numpy(filters.design_lowpass(
        DDC_TAPS, rate / (2.5 * decimation), rate)).to(capture.device)
    out["fir_decimate"] = time_fir_shape(base, taps, decimation, key, f"{label} fir")
    return out


def _kind_input(kind: str, shape, gen: torch.Generator, dtype=torch.float32) -> torch.Tensor:
    """Random samples for a kind: magnitudes (|randn|) for the envelope and
    peak kinds, which rectify their input, signed samples for the rest."""
    u = torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)
    return torch.abs(u) if kind in ("attack_release", "peak_hold") and not u.is_complex() else u


def check_recursion_kinds(dev: torch.device) -> dict:
    """Phase 44: each recursion kind on the card against its plain version
    bit for bit at (4, 2^20), (1, 2^15) and complex (8, 4096), and the two
    linear forms at the FM row's (1, 14.4 M); each kind's bare chain
    (`chain_probe`), its time queued at (4, 2^20) and (1, 14.4 M) with the
    cycles a step at the SM clock nvidia-smi reads while it runs, its bytes
    bound, and the plain step loop's time (host) at (1, 2^15). Returns the
    per-kind entries."""
    gen = torch.Generator(device=dev).manual_seed(44)
    n_fm = int(FM_SECONDS * FM_RATE_HZ)
    table = {}
    for kind, (c0, c1) in RECURSION_COEFS.items():
        shapes = [(RECURSION_SHAPE, torch.float32), ((1, 1 << 15), torch.float32),
                  ((8, 4096), torch.complex64)]
        if kind in ("linear", "one_pole"):
            shapes.append(((1, n_fm), torch.float32))
        for shape, dtype in shapes:
            u = _kind_input(kind, shape, gen, dtype)
            state = _kind_input(kind, shape[:1], gen, dtype)
            got = recurrence.first_order_recurrence_cuda(u, kind, c0, c1, state).cpu()
            want = recurrence.first_order_recurrence(u.cpu(), kind, c0, c1, state.cpu())
            if not torch.equal(got, want):
                raise AssertionError(f"first_order_iir {kind} at {shape} {dtype}: differs from the "
                                     f"plain loop at {int(torch.sum(got != want))} samples")
        probe = chain_probe(CHAIN_PROBE_STEPS, kind, c0, c1)
        small = chain_probe(1 << 12, kind, c0, c1)
        if not small["y"] == probe_chain_value(1 << 12, kind, c0, c1):
            raise AssertionError(f"the {kind} chain probe computes another chain: {small['y']}")
        entry = {"chain_cycles_per_step": probe["cycles_per_step"],
                 "chain_ns_per_step": probe["ns_per_step"], "chain_sm_mhz": probe["sm_mhz"]}
        for label, shape in (("gate", RECURSION_SHAPE), ("fm", (1, n_fm))):
            u = _kind_input(kind, shape, gen)
            ms = queued_ms(lambda: recurrence.first_order_recurrence_cuda(u, kind, c0, c1), 3)
            mhz = sm_clock_while(lambda: recurrence.first_order_recurrence_cuda(u, kind, c0, c1),
                                 max(4, int(2000 / max(ms, 1.0))))
            steps = shape[1]
            entry.update({f"ms_{label}": ms, f"shape_{label}": list(shape),
                          f"bound_ms_{label}": 1e3 * 8 * shape[0] * steps / HBM_BYTES_PER_S,
                          f"serial_floor_ms_{label}": steps * probe["ns_per_step"] * 1e-6,
                          f"sm_mhz_{label}": mhz,
                          f"cycles_per_step_{label}": ms * 1e-3 * mhz * 1e6 / steps})
            del u
        u_host = _kind_input(kind, (1, 1 << 15), gen).cpu()
        entry["plain_ms"] = min(host_ms(lambda: recurrence.first_order_recurrence(
            u_host, kind, c0, c1)) for _ in range(2))
        entry["plain_shape"] = [1, 1 << 15]
        table[kind] = entry
        phase("44 recursion kinds", f"{kind} ({c0}, {c1}): card = plain bit for bit at "
              + ", ".join(str(tuple(sh)) for sh, _ in shapes) + f"; bare chain "
              f"{probe['cycles_per_step']:.3f} cycles a step ({probe['ns_per_step']:.4f} ns at "
              f"{probe['sm_mhz']:.0f} MHz); kernel {entry['ms_gate']:.3f} ms at "
              f"{RECURSION_SHAPE} ({entry['cycles_per_step_gate']:.2f} cycles a step at "
              f"{entry['sm_mhz_gate']:.0f} MHz, floor {entry['serial_floor_ms_gate']:.3f} ms, "
              f"bytes bound {entry['bound_ms_gate']:.4f} ms), {entry['ms_fm']:.3f} ms at "
              f"(1, {n_fm}) ({entry['cycles_per_step_fm']:.2f} cycles a step, floor "
              f"{entry['serial_floor_ms_fm']:.3f} ms); plain step loop (host) "
              f"{entry['plain_ms']:.2f} ms at (1, 32768)")
    return table


def time_cfar_fir(dev: torch.device) -> dict:
    """`radar.cfar_1d`'s window sums at the blocks gate's CFAR window, 64
    rows of 4096 cells edge-padded by 10 (K = 21 taps, f = 1, float32):
    the FIR kernel against its plain version, timed in turns beside cuDNN's
    conv1d (TF32 off) and its bound."""
    rows, cells = radar_gates.CFAR_WINDOW
    guard, train = 2, 8
    win = guard + train
    k = 2 * win + 1
    taps = np.zeros(k, np.float32)
    taps[:train] = 1.0
    taps[-train:] = 1.0
    gen = torch.Generator(device=dev).manual_seed(45)
    x = torch.empty((rows, cells + 2 * win), device=dev).exponential_(generator=gen)
    rev = torch.from_numpy(taps).to(dev).flip(0)
    got = fir.fir_decimate_cuda(x, rev, 1, zero_state=True)
    abs_err, rel = rel_err(got, fir.fir_decimate(x, rev, 1, zero_state=True))
    if not rel < FIR_REL_TOL:
        raise AssertionError(f"fir_decimate at the CFAR window: {rel:.3g}")
    kern, plain = in_turns(lambda: fir.fir_decimate(x, rev, 1, zero_state=True),
                           lambda: fir.fir_decimate_cuda(x, rev, 1, zero_state=True))
    padded = F.pad(x, (k - 1, 0))[:, None, :]
    weight = rev.view(1, 1, -1)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        lib_out = F.conv1d(padded, weight)[:, 0]
        library = cuda_ms(lambda: F.conv1d(padded, weight))
    _, lib_rel = rel_err(lib_out, got)
    if not lib_rel < FIR_REL_TOL:
        raise AssertionError(f"the conv1d yardstick computes another function: {lib_rel:.3g}")
    n = x.shape[1]
    b_ms, b_by = bound(4 * rows * n + 4 * k + 4 * rows * n, 2 * rows * n * k)
    phase("45 cfar fir", f"fir_decimate float32 ({rows}, {n}) K={k} f=1 (cfar_1d's window sums) "
          f"from zero state: kernel {kern[0]:.4f}/{kern[1]:.4f} ms, plain {plain[0]:.4f}/"
          f"{plain[1]:.4f} ms, conv1d (cuDNN, FP32, max|Δ|/max|y| {lib_rel:.3g}) {library:.4f} ms; "
          f"bound {b_ms:.4f} ms by {b_by}; max|Δ|/max|ref| {rel:.3g}")
    return {"ms_cfar": sum(kern) / 2, "plain_ms_cfar": sum(plain) / 2, "library_ms_cfar": library,
            "bound_ms_cfar": b_ms, "bound_by_cfar": b_by, "max_abs_err_cfar": abs_err,
            "shape_cfar": [rows, n, k, 1]}


def drive_array_blocks_gate(dev: torch.device) -> dict:
    """Phase 45: `array_blocks_gate()` on the card with the counts set to 0
    just before it and read just after: every function of core.linalg,
    radar, radar_sonar, radar_adv, beamforming, mimo, propagation and ew on
    its JAX test's inputs, card against CPU (decisions equal, floats within
    the stated tolerances), `cfar_1d`'s window sums on the FIR kernel; then
    the FIR kernel timed at that window."""
    zero_launch_counts()
    gate = array_blocks_gate(dev)
    counts = fm_counts()
    if not gate["ok"] or counts["fir_decimate"] <= 0:
        raise AssertionError(f"array blocks gate: failed "
                             f"{ {k: gate['worst'][k] for k in gate['failed']} }, launches {counts}")
    top = sorted(gate["worst"].items(), key=lambda kv: -kv[1])[:5]
    phase("45 array blocks gate", f"{len(gate['worst'])} cases card = CPU on {dev} (decisions "
          f"equal, floats within their tolerances); largest "
          + ", ".join(f"{k} {v:.3g}" for k, v in top) + f"; launches {json.dumps(counts)}")
    return {"launches": counts, "timing": time_cfar_fir(dev)}


def drive_radar_gate(dev: torch.device) -> dict:
    """Phase 46: `array_radar_gate()` at its full CPI (16 × 128 × 4096) over
    5 CPIs with the counts set to 0 just before it and read just after:
    every bar met, no hand-written kernel launched (the path is cuFFT, one
    matrix product, one convolution and small solves). Then the last CPI's
    cube on the card against a CPU run (`radar_agreement`), and one warm CPI
    on the card-resident cube under the profiler."""
    zero_launch_counts()
    gate = array_radar_gate(dev, radar_gates.CPIS)
    counts = fm_counts()
    b = gate["bars"]
    phase("46 radar gate", f"{radar_gates.CPIS} CPIs of {tuple(gate['shape'])} on {dev}: detected "
          f"{b['detected']}, beams {b['beams']}, false detections a CPI "
          f"{[c['false_detections'] for c in gate['cpis']]} (max {b['false_detections_max']}, bar "
          f"{radar_gates.FALSE_DETECTIONS_MAX}), clusters {[c['clusters'] for c in gate['cpis']]}; "
          f"MVDR under conventional {b['mvdr_worst_db']:.3f} dB worst away from the jammer (bar "
          f"{radar_gates.MVDR_REDUCTION_DB}); tracks {json.dumps(b['tracks'])}; launches "
          f"{json.dumps(counts)}")
    for k, c in enumerate(gate["cpis"]):
        phase("46 radar cpi", f"CPI {k}: beams {c['beam']}, MUSIC deg {c['music_deg']} (error "
              f"against truth {c['music_err_deg']}, information); stage ms "
              + json.dumps({n: round(v, 4) for n, v in gate["stage_ms"][k].items()})
              + f"; {gate['seconds'][k]:.4f} s end to end")
    if not gate["ok"] or any(counts.values()):
        raise AssertionError(f"radar gate: bars {b}, launches {counts}")
    last = gate["last"]
    card = radar_gates.cpi_on(dev, last["cube_host"], gate["listen_host"])
    cpu = radar_gates.cpi_on("cpu", last["cube_host"], gate["listen_host"])
    agreement = radar_gates.radar_agreement(card, cpu)
    phase("46 radar card vs cpu", f"CPI {radar_gates.CPIS - 1}: " + json.dumps(agreement))
    if not agreement["ok"]:
        raise AssertionError(f"radar gate: card against CPU {agreement}")
    del card, cpu
    cube, listen, replica = last["cube"], gate["listen"], gate["replica"]
    tracker = radar_gates.radar_adv.RadarTracker(dt=cube.shape[1] / radar_gates.PRF_HZ,
                                                 device=dev)
    prof = breakdown(lambda: radar_gates.radar_cpi(cube, listen, replica, tracker,
                                                   radar_gates._Stages(dev)))
    phase("46 radar profile", f"one warm CPI on the card-resident cube under the profiler: "
          f"{prof['device_events']} launches, busy {prof['busy_ms']:.3f} ms of a "
          f"{prof['span_ms']:.3f} ms span, idle share {prof['idle_share']:.4f}; largest "
          + json.dumps(prof["top_ms"]))
    return {"launches": counts, "stage_ms": gate["stage_ms"], "seconds": gate["seconds"],
            "bars": b, "card_vs_cpu": agreement, "profile": prof}


def drive_two_ray_case(dev: torch.device, fading_run: dict) -> dict:
    """Phase 47: the static 2-ray case of `fading_gate()` (QPSK behind a
    known preamble through a 2-ray channel on the reference's key-9 draws,
    the LS estimate on the preamble, the frequency-domain equaliser at
    n_fft 4096): every byte back in phase 33's gate, its Philox pass rate;
    then the case on the card against a CPU run (the same taps, the
    estimate within TWO_RAY_ESTIMATE_TOL, the same bytes), with the counts set to 0 just
    before the card run and read just after."""
    gated = fading_run["results"][TWO_RAY_LABEL]
    zero_launch_counts()
    card = two_ray_fde_case(dev)
    counts = fm_counts()
    cpu = two_ray_fde_case("cpu")
    _, est_rel = rel_err(torch.from_numpy(card["estimate"]), torch.from_numpy(cpu["estimate"]))
    same_taps = [d for d, _ in card["taps"]] == [d for d, _ in cpu["taps"]]
    if not (gated["ok"] and card["ok"] and card["bytes"] == cpu["bytes"] and same_taps
            and est_rel < TWO_RAY_ESTIMATE_TOL):
        raise AssertionError(f"2-ray case: gate {gated}, card {card['bytes']} taps {card['taps']}, "
                             f"cpu {cpu['bytes']} taps {cpu['taps']}, estimate {est_rel:.3g}")
    phase("47 two-ray fde", f"{TWO_RAY_LABEL} on {dev}: bytes {card['bytes']} (every byte back, "
          f"in phase 33's fading gate too; Philox pass rate "
          f"{fading_run['pass_rates'][TWO_RAY_LABEL]}); taps "
          + ", ".join(f"{d}: {abs(g):.4f}" for d, g in card["taps"])
          + f"; card = CPU (taps, bytes; estimate within {est_rel:.3g}); launches "
          + json.dumps(counts))
    return {"launches": counts}


def drive_sensing_blocks_gate(dev: torch.device) -> dict:
    """Phase 48: `sensing_blocks_gate()` on the card with the counts set to 0
    just before it and read just after: every BLOCKS entry of spectral2,
    cognitive, instruments and sensing and both analysis classes on their
    JAX tests' inputs, card against CPU (decisions equal, floats within the
    stated tolerances), the worst case by name."""
    zero_launch_counts()
    gate = cognitive_gates.sensing_blocks_gate(dev)
    counts = fm_counts()
    if not gate["ok"]:
        raise AssertionError(f"sensing blocks gate: failed "
                             f"{ {k: gate['worst'][k] for k in gate['failed']} }, missing "
                             f"{gate['missing']}")
    top = sorted(gate["worst"].items(), key=lambda kv: -kv[1])[:5]
    phase("48 sensing blocks gate", f"{len(gate['worst'])} cases card = CPU on {dev} (every "
          f"BLOCKS entry of the four modules and both analysis classes; decisions equal, floats "
          f"within their tolerances); worst {gate['worst_case'][0]} {gate['worst_case'][1]:.3g}; "
          f"largest " + ", ".join(f"{k} {v:.3g}" for k, v in top)
          + f"; launches {json.dumps(counts)}")
    return {"launches": counts, "worst_case": gate["worst_case"]}


def access_launch_check(counts: dict, channels: int) -> None:
    want = dict.fromkeys(counts, 0)
    want.update({"nco_mix": channels, "fir_decimate": channels + ACCESS_SELF_CHECK_FIRS})
    if counts != want:
        raise AssertionError(f"spectrum access gate: launches {counts}, want {want}")


def drive_spectrum_access(dev: torch.device) -> dict:
    """Phase 49: `spectrum_access_gate()` at its full width (32 blocks of
    2^20 samples at 30.72 MS/s, 1.092 s) with the counts set to 0 just
    before it and read just after: every bar met; nco_mix one launch and
    fir_decimate one launch a down-converted channel, and fir_decimate two
    for the self-check; no other hand-written kernel. Then the cycle twice
    more on the card-resident blocks (warm), once under the profiler, and
    the first 4 blocks and the self-check on the card against CPU runs
    (`access_agreement`); before those, the full-size waterfall stage
    against the CPU (`waterfall_agreement`, 2^25 values)."""
    zero_launch_counts()
    gate = cognitive_gates.spectrum_access_gate(dev, cognitive_gates.DSA_ROWS)
    counts = fm_counts()
    out, b = gate["outputs"], gate["bars"]
    access_launch_check(counts, len(out["candidates"]))
    phase("49 spectrum access", f"{gate['samples']} samples ({cognitive_gates.DSA_ROWS} × "
          f"{cognitive_gates.DSA_BLOCK}) at {cognitive_gates.DSA_RATE_HZ:.0f} S/s on {dev}: busy "
          f"blocks a channel {b['busy_blocks']}; duty {json.dumps(b['duty'])} (planted "
          f"{json.dumps(b['duty_planted'])}); idle channels {out['candidates']}; features "
          + json.dumps({c: round(v, 6) for c, v in b["feature"].items()})
          + f" (threshold {cognitive_gates.FEATURE_THRESHOLD}), off-feature max "
          f"{max(b['off_feature'].values()):.6f}; flagged {b['flagged']}; labels "
          f"{json.dumps(b['labels'])}; entropy "
          + json.dumps({c: round(v, 4) for c, v in b["entropy"].items()})
          + f"; grants {json.dumps(b['grants'])}, MCS {json.dumps(out['mcs'])}; excision "
          f"{b.get('excise_drop_db', float('nan')):.2f} dB at the tone's bin, median "
          f"{b.get('excise_median_shift_db', float('nan')):+.3f} dB; self-check "
          f"{json.dumps(b['self_check'])}; power dBm "
          f"{[round(float(v), 3) for v in gate['self_check']['power_dbm']]}; stage ms "
          + json.dumps({k: round(v, 3) for k, v in gate["stage_ms"].items()})
          + f"; launches {json.dumps(counts)}; {gate['seconds']:.4f} s end to end")
    if not gate["ok"]:
        raise AssertionError(f"spectrum access gate: bars {b}")
    waterfall = cognitive_gates.waterfall_agreement(out)
    phase("49 access waterfall", f"the card's {out['waterfall'].shape[0]} × "
          f"{out['waterfall'].shape[1]} waterfall enhanced and scored on the card against the "
          f"CPU: " + json.dumps(waterfall))
    if not waterfall["ok"]:
        raise AssertionError(f"spectrum access gate: waterfall card against CPU {waterfall}")
    capture = gate["capture"]
    run = {"launches": counts, "stage_ms": gate["stage_ms"], "seconds": gate["seconds"],
           "channels": len(out["candidates"]), "waterfall_vs_cpu": waterfall}
    del gate, out
    warm = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cognitive_gates.spectrum_access_chain(capture)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    run["warm_chain_s"] = warm
    phase("49 access warm", f"the cycle again on the card-resident blocks: "
          f"{warm[0]:.4f}/{warm[1]:.4f} s")
    prof = breakdown(lambda: cognitive_gates.spectrum_access_chain(capture), warm=False)
    phase("49 access profile", f"one warm cycle on the card-resident blocks under the "
          f"profiler: {prof['device_events']} launches, busy {prof['busy_ms']:.3f} ms of a "
          f"{prof['span_ms']:.3f} ms span, idle share {prof['idle_share']:.4f}; largest "
          + json.dumps(prof["top_ms"]))
    run["profile"] = prof
    host = capture[:cognitive_gates.CARD_CPU_ROWS].cpu()
    del capture
    card = cognitive_gates.spectrum_access_chain(host.to(dev))
    cpu = cognitive_gates.spectrum_access_chain(host)
    mcs = card["mcs"][cognitive_gates.USERS[0]]
    card_sc = cognitive_gates.self_check(mcs, dev)
    cpu_sc = cognitive_gates.self_check(mcs, "cpu")
    agreement = cognitive_gates.access_agreement(card, cpu, card_sc, cpu_sc)
    phase("49 access card vs cpu", f"{cognitive_gates.CARD_CPU_ROWS} blocks and the "
          f"self-check: " + json.dumps(agreement))
    if not agreement["ok"]:
        raise AssertionError(f"spectrum access gate: card against CPU {agreement}")
    run["card_vs_cpu"] = agreement
    return run


def time_access_kernels(dev: torch.device) -> dict:
    """Phase 50: nco_mix and fir_decimate at the access gate's DDC shape,
    (32, 2^20) c64, K = 63, f = 16, against their plain versions and timed
    beside conv1d (stride 16, TF32 off) and their bounds, on a capture of
    the gate's scene."""
    host, _ = cognitive_gates.dsa_scene(cognitive_gates.DSA_ROWS, cognitive_gates.DSA_BLOCK)
    capture = torch.from_numpy(host).to(dev)
    del host
    return time_ddc_kernels(capture, cognitive_gates.channel_centre_hz(
        cognitive_gates.BPSK_CHANNEL), cognitive_gates.DSA_RATE_HZ,
        cognitive_gates.DDC_DECIMATION, "access", "50 access")


def drive_protocol_blocks_gate(dev: torch.device) -> dict:
    """Phase 51: `protocol_blocks_gate()` on the card with the counts set to
    0 just before it and read just after: every BLOCKS entry of packets and
    audio and every public function of protocols, applied and adsb on their
    JAX tests' inputs, card against CPU (decisions equal, floats within the
    stated tolerances), the worst case by name."""
    zero_launch_counts()
    gate = dispatch_gates.protocol_blocks_gate(dev)
    counts = fm_counts()
    if not gate["ok"]:
        raise AssertionError(f"protocol blocks gate: failed "
                             f"{ {k: gate['worst'][k] for k in gate['failed']} }, missing "
                             f"{gate['missing']}")
    top = sorted(gate["worst"].items(), key=lambda kv: -kv[1])[:5]
    phase("51 protocol blocks gate", f"{len(gate['worst'])} cases card = CPU on {dev} (every "
          f"BLOCKS entry of packets and audio, every public function of protocols, applied and "
          f"adsb; decisions equal, floats within their tolerances); worst "
          f"{gate['worst_case'][0]} {gate['worst_case'][1]:.3g}; largest "
          + ", ".join(f"{k} {v:.3g}" for k, v in top) + f"; launches {json.dumps(counts)}")
    return {"launches": counts, "worst_case": gate["worst_case"]}


def dispatch_launch_check(counts: dict) -> None:
    want = dict.fromkeys(counts, 0)
    want.update(DISPATCH_LAUNCHES)
    if counts != want:
        raise AssertionError(f"dispatch monitor gate: launches {counts}, want {want}")


def drive_dispatch_monitor(dev: torch.device) -> dict:
    """Phase 52: `dispatch_monitor_gate()` at its full width (8.0 s at
    2.4 MS/s in 20 rows of 960,000 samples, eight NBFM channels) with the
    counts set to 0 just before it and read just after: every bar met;
    nco_mix 8 launches (one a channel), fir_decimate 11 (8 down-converters,
    the channel select, the audio filter, the voice band-pass),
    first_order_iir 1 (the squelch); no other hand-written kernel. Then the
    chain twice more on the card-resident rows (warm), once under the
    profiler, and a CPU run of the whole capture against the card's run
    (`dispatch_agreement`)."""
    zero_launch_counts()
    gate = dispatch_gates.dispatch_monitor_gate(dev)
    counts = fm_counts()
    out, b = gate["outputs"], gate["bars"]
    dispatch_launch_check(counts)
    voice = [{k: (round(v, 3) if isinstance(v, float) else v) for k, v in row.items()
              if k != "pitch_frames_passing"} for row in b["voice"]]
    phase("52 dispatch monitor", f"{gate['samples']} samples ({dispatch_gates.ROWS} × "
          f"{dispatch_gates.BLOCK}) at {dispatch_gates.CAPTURE_RATE_HZ:.0f} S/s on {dev}: squelch "
          f"{json.dumps(b['squelch'])}; tones {json.dumps(b['tones'])} ({b['tone_windows_checked']} "
          f"planted windows checked), false tones {json.dumps(b['false_tones'])} (idle E, G at most "
          f"{dispatch_gates.MAX_IDLE_FALSE_TONES}; carrier F, H at most "
          f"{b['carrier_false_bound']}, at {dispatch_gates.CARRIER_FALSE_MIN_HZ} Hz or above); ANI "
          f"{b.get('dial')} (want {dispatch_gates.EXPECTED_ANI!r}); pages {b.get('pages')}; voice "
          f"{json.dumps(voice)}; stage ms "
          + json.dumps({k: round(v, 3) for k, v in gate["stage_ms"].items()})
          + f"; launches {json.dumps(counts)}; {gate['seconds']:.4f} s end to end")
    if not gate["ok"]:
        raise AssertionError(f"dispatch monitor gate: bars {b}")
    capture = gate["capture"]
    run = {"launches": counts, "stage_ms": gate["stage_ms"], "seconds": gate["seconds"],
           "bars": {k: b[k] for k in ("squelch", "false_tones", "pages", "voice")}}
    truth = gate["truth"]
    card_out = {k: out[k] for k in ("open", "tones", "dial", "pages", "channels", "audio",
                                     "voice")}
    del gate, out
    warm = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dispatch_gates.dispatch_monitor_chain(capture)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    run["warm_chain_s"] = warm
    phase("52 dispatch warm", f"the chain again on the card-resident rows: "
          f"{warm[0]:.4f}/{warm[1]:.4f} s")
    prof = breakdown(lambda: dispatch_gates.dispatch_monitor_chain(capture), warm=False)
    phase("52 dispatch profile", f"one warm chain on the card-resident rows under the "
          f"profiler: {prof['device_events']} launches, busy {prof['busy_ms']:.3f} ms of a "
          f"{prof['span_ms']:.3f} ms span, idle share {prof['idle_share']:.4f}; largest "
          + json.dumps(prof["top_ms"]))
    run["profile"] = prof
    host = capture.cpu()
    del capture
    t0 = time.perf_counter()
    cpu = dispatch_gates.dispatch_monitor_chain(host)
    cpu_s = time.perf_counter() - t0
    agreement = dispatch_gates.dispatch_agreement(card_out, cpu, truth)
    phase("52 dispatch card vs cpu", f"the whole capture on the CPU ({cpu_s:.2f} s on the "
          f"host): " + json.dumps(agreement))
    if not agreement["ok"]:
        raise AssertionError(f"dispatch monitor gate: card against CPU {agreement}")
    run["card_vs_cpu"] = agreement
    run["cpu_chain_s"] = cpu_s
    run["inputs"] = {"capture": host, "channels": card_out["channels"],
                     "voice_shape": [len(card_out["voice"]), max(
                         v["bandpassed"].shape[-1] for v in card_out["voice"])]}
    return run


def time_fir_shape(x: torch.Tensor, taps: torch.Tensor, factor: int, key: str,
                   label: str, timer=cuda_ms) -> dict:
    """fir_decimate at one of a path's shapes from zero state: kernel against
    its plain version within FIR_REL_TOL, kernel and plain timed in turns,
    cuDNN's conv1d (FP32, the two planes as groups for complex input, stride
    `factor`, TF32 off) as the library yardstick, beside its bound, each by
    `timer` (back to back, or `queued_ms` for device time at launch-bound
    shapes); the numbers keyed ``*_{key}``."""
    rows, n = x.shape
    k = taps.shape[0]
    rev = taps.flip(0)
    got = fir.fir_decimate_cuda(x, rev, factor, zero_state=True)
    abs_err, rel = rel_err(got, fir.fir_decimate(x, rev, factor, zero_state=True))
    if not rel < FIR_REL_TOL:
        raise AssertionError(f"fir_decimate at the {key} shape: {rel:.3g}")
    kern, plain = in_turns(lambda: fir.fir_decimate(x, rev, factor, zero_state=True),
                           lambda: fir.fir_decimate_cuda(x, rev, factor, zero_state=True), timer)
    if x.is_complex():
        planes = F.pad(torch.view_as_real(x).permute(0, 2, 1), (k - 1, 0)).contiguous()
        weight = rev.view(1, 1, -1).repeat(2, 1, 1)
        groups = 2
    else:
        planes = F.pad(x[:, None, :], (k - 1, 0))
        weight = rev.view(1, 1, -1)
        groups = 1
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        lib_out = F.conv1d(planes, weight, stride=factor, groups=groups)
        library = timer(lambda: F.conv1d(planes, weight, stride=factor, groups=groups))
    lib_y = (torch.view_as_complex(lib_out.permute(0, 2, 1).contiguous()) if x.is_complex()
             else lib_out[:, 0])
    _, lib_rel = rel_err(lib_y, got)
    if not lib_rel < FIR_REL_TOL:
        raise AssertionError(f"the conv1d yardstick computes another function: {lib_rel:.3g}")
    item = 8 if x.is_complex() else 4
    n_out = got.shape[1]
    b_ms, b_by = bound(item * rows * n + 4 * k + item * rows * n_out,
                       (4 if x.is_complex() else 2) * rows * n_out * k)
    how = " device (queued)" if timer is queued_ms else ""
    phase(label, f"fir_decimate {'c64' if x.is_complex() else 'float32'} ({rows}, {n}) K={k} "
          f"f={factor} from zero state{how}: kernel {kern[0]:.4f}/{kern[1]:.4f} ms, plain "
          f"{plain[0]:.4f}/{plain[1]:.4f} ms, conv1d (cuDNN, FP32, max|Δ|/max|y| {lib_rel:.3g}) "
          f"{library:.4f} ms; bound {b_ms:.4f} ms by {b_by}; max|Δ|/max|ref| {rel:.3g}")
    return {f"ms_{key}": sum(kern) / 2, f"plain_ms_{key}": sum(plain) / 2,
            f"library_ms_{key}": library, f"bound_ms_{key}": b_ms, f"bound_by_{key}": b_by,
            f"max_abs_err_{key}": abs_err, f"shape_{key}": [rows, n, k, factor]}


def time_dispatch_kernels(dev: torch.device, run: dict) -> dict:
    """Phase 53: the hand kernels at the dispatch monitor's shapes, each
    against its plain version and timed: nco_mix at the capture rows
    (20, 960,070) c64 and fir_decimate there (K = 63, f = 10), beside
    conv1d (`time_ddc_kernels`); fir_decimate at the channel select's
    (8, 1,920,000) c64 K = 255 f = 10, the audio filter's (8, 192,000)
    float32 K = 63 f = 3, the voice band-pass at (8, 64,000) float32 K = 127
    f = 1 (the audio rows) and at the gate's own segment batch; the
    recursion's ema kind at the squelch's (8, 192,000) bit for bit,
    timed beside its bytes bound and its serial floor (the bare chain)."""
    dg = dispatch_gates
    capture = run["inputs"]["capture"].to(dev)
    out = time_ddc_kernels(capture, dg.CHANNELS[0].offset_hz, dg.CAPTURE_RATE_HZ,
                           dg.DDC_DECIMATION, "dispatch", "53 dispatch")
    del capture
    chans = run["inputs"]["channels"].to(dev)
    taps = lambda k, fc, fs: torch.from_numpy(filters.design_lowpass(k, fc, fs)).to(dev)
    fir_entry = time_fir_shape(chans, taps(dg.SELECT_TAPS, dg.SELECT_CUTOFF_HZ,
                                           dg.CHANNEL_RATE_HZ), dg.SELECT_DECIMATION,
                               "dispatch_select", "53 dispatch select fir")
    iq = fir.fir_decimate_cuda(chans, taps(dg.SELECT_TAPS, dg.SELECT_CUTOFF_HZ,
                                           dg.CHANNEL_RATE_HZ).flip(0), dg.SELECT_DECIMATION,
                               zero_state=True)
    del chans
    from r4w_tpu_torch.ops.modem import quadrature_demod
    fm = quadrature_demod(iq, dg.IF_RATE_HZ / (2 * math.pi * dg.VOICE_DEVIATION_HZ))
    fir_entry.update(time_fir_shape(fm, taps(dg.AUDIO_TAPS, dg.AUDIO_CUTOFF_HZ, dg.IF_RATE_HZ),
                                    dg.AUDIO_DECIMATION, "dispatch_audio",
                                    "53 dispatch audio fir"))
    audio = fir.fir_decimate_cuda(fm, taps(dg.AUDIO_TAPS, dg.AUDIO_CUTOFF_HZ,
                                           dg.IF_RATE_HZ).flip(0), dg.AUDIO_DECIMATION,
                                  zero_state=True)
    bp = torch.from_numpy(filters.design_bandpass(dg.VOICE_TAPS, dg.VOICE_LO_HZ, dg.VOICE_HI_HZ,
                                                  dg.AUDIO_RATE_HZ)).to(dev)
    fir_entry.update(time_fir_shape(audio, bp, 1, "dispatch_voice_rows",
                                    "53 dispatch voice fir"))
    segs, length = run["inputs"]["voice_shape"]
    fir_entry.update(time_fir_shape(audio[:segs, :length].contiguous(), bp, 1, "dispatch_voice",
                                    "53 dispatch voice fir"))
    out["fir_decimate"].update(fir_entry)
    # the squelch's recursion: |iq|² through the ema kind from zero state
    from r4w_tpu_torch.core.hostio import magnitude
    u = (magnitude(iq) ** 2).contiguous()
    got = recurrence.first_order_recurrence_cuda(u, "ema", dg.SQUELCH_ALPHA)
    want = recurrence.first_order_recurrence(u.cpu(), "ema", dg.SQUELCH_ALPHA)
    if not torch.equal(got.cpu(), want):
        raise AssertionError(f"first_order_iir ema at {tuple(u.shape)}: differs from the plain "
                             f"loop at {int(torch.sum(got.cpu() != want))} samples")
    ms = [queued_ms(lambda: recurrence.first_order_recurrence_cuda(u, "ema", dg.SQUELCH_ALPHA),
                    3) for _ in range(2)]
    u_host = u.cpu()
    plain = min(host_ms(lambda: recurrence.first_order_recurrence(
        u_host, "ema", dg.SQUELCH_ALPHA)) for _ in range(2))
    steps = u.shape[1]
    probe = chain_probe(steps, "ema", dg.SQUELCH_ALPHA)
    rows = u.shape[0]
    rec = {"ms_dispatch": sum(ms) / 2, "plain_ms_dispatch": plain, "shape_dispatch": [rows, steps],
           "bound_ms_dispatch": 1e3 * 8 * rows * steps / HBM_BYTES_PER_S,
           "bound_by_dispatch": "bytes", "serial_floor_ms_dispatch": steps * probe[
               "ns_per_step"] * 1e-6, "chain_cycles_per_step_dispatch": probe["cycles_per_step"],
           "chain_sm_mhz_dispatch": probe["sm_mhz"], "max_abs_err_dispatch": 0.0,
           "library_ms_dispatch": None}
    phase("53 dispatch recursion", f"first_order_iir ema at the squelch's ({rows}, {steps}) "
          f"float32: card = plain bit for bit; kernel {ms[0]:.4f}/{ms[1]:.4f} ms queued, plain "
          f"step loop (host) {plain:.1f} ms; bytes bound {rec['bound_ms_dispatch']:.5f} ms, "
          f"serial floor {rec['serial_floor_ms_dispatch']:.4f} ms (bare chain "
          f"{probe['cycles_per_step']:.3f} cycles a step at {probe['sm_mhz']:.0f} MHz)")
    out["first_order_iir"] = rec
    return out


def dpd_solve_spread(dev: torch.device) -> dict:
    """The DPD fit (order 7, float32 normal equations with a condition
    number near 2·10⁴) on the hopping gate's training burst on the card and
    on the CPU: the coefficients' max|Δ|/max|CPU| and the transmit EVM each
    gives on the gate's first 25 dwells."""
    from r4w_tpu_torch.ops import infra_fills as inf
    from r4w_tpu_torch.ops.impairments import rapp_pa
    hg = hop_gates
    scene = hg.hop_scene(hg.BLOCK_HOPS)
    coef, evm = {}, {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        x = torch.from_numpy(scene["train"]).to(d)
        c, _ = inf.dpd_learn_polynomial(x, rapp_pa(x, hg.PA_SATURATION, hg.PA_SMOOTHNESS),
                                        order=hg.DPD_ORDER)
        sym = hg.spec().build_waveform(d).modulate(scene["bits"].reshape(-1)).reshape(
            hg.BLOCK_HOPS, -1)
        ideal = hg.DRIVE * sym.repeat_interleave(hg.UPSAMPLE, dim=-1)
        coef[name] = c.cpu()
        evm[name] = float(hg.transmit_evm_db(rapp_pa(inf.dpd_apply(ideal, c), hg.PA_SATURATION,
                                                     hg.PA_SMOOTHNESS), ideal))
    return {"coef_rel": dispatch_gates.compare(coef["card"], coef["cpu"]),
            "evm_delta_db": abs(evm["card"] - evm["cpu"]), "evm_db": evm}


def drive_infra_blocks_gate(dev: torch.device) -> dict:
    """Phase 54: `infra_blocks_gate()` on the card with the counts set to 0
    just before it and read just after: every BLOCKS entry of navigation,
    biomedical and infra_fills, every alias of `alias_blocks`, and the
    public classes and functions of timing and waveform_spec on their JAX
    tests' inputs, card against CPU (decisions equal, floats within the
    stated tolerances), the worst case by name and the DPD coefficients'
    card-against-CPU difference; then the DPD fit on the hopping gate's
    burst card against CPU (the transmit EVM within EVM_TOL_DB)."""
    zero_launch_counts()
    gate = hop_gates.infra_blocks_gate(dev)
    counts = fm_counts()
    if not gate["ok"]:
        raise AssertionError(f"infra blocks gate: failed "
                             f"{ {k: gate['worst'][k] for k in gate['failed']} }, missing "
                             f"{gate['missing']}")
    top = sorted(gate["worst"].items(), key=lambda kv: -kv[1])[:5]
    phase("54 infra blocks gate", f"{len(gate['worst'])} cases card = CPU on {dev} (every "
          f"BLOCKS entry of navigation, biomedical and infra_fills, every alias, timing and "
          f"waveform_spec; decisions equal, floats within their tolerances); worst "
          f"{gate['worst_case'][0]} {gate['worst_case'][1]:.3g}; largest "
          + ", ".join(f"{k} {v:.3g}" for k, v in top)
          + f"; DPD coefficients max|Δ|/max|CPU| {gate['dpd_coef_rel']:.3g}; launches "
          + json.dumps(counts))
    spread = dpd_solve_spread(dev)
    phase("54 dpd solve", "order-7 fit on the hopping gate's burst, card against CPU: "
          + json.dumps(spread))
    if not (spread["coef_rel"] <= hop_gates.COEF_TOL
            and spread["evm_delta_db"] <= hop_gates.EVM_TOL_DB):
        raise AssertionError(f"DPD fit: card and CPU differ {spread}")
    return {"launches": counts, "worst_case": gate["worst_case"],
            "dpd_coef_rel": gate["dpd_coef_rel"], "dpd_spread": spread}


def hop_launch_check(run: dict, scene: dict) -> dict:
    """The launches the hopping gate must make, by stage: the transmitter
    one NCO launch a channel of the pattern, each receiver one NCO launch a
    channel of each block and two FIR launches a block; nothing else."""
    pattern = scene["pattern"]
    blocks = range(0, scene["hops"], hop_gates.BLOCK_HOPS)
    rx_nco = sum(len(np.unique(pattern[b:b + hop_gates.BLOCK_HOPS])) for b in blocks)
    zero = dict.fromkeys(run["launches"]["transmit"], 0)
    want = {"transmit": {**zero, "nco_mix": len(np.unique(pattern))},
            "stream_receive": {**zero, "nco_mix": rx_nco, "fir_decimate": 2 * len(blocks)},
            "receive_20db": {**zero, "nco_mix": rx_nco, "fir_decimate": 2 * len(blocks)}}
    if run["launches"] != want:
        raise AssertionError(f"hopping link gate: launches {run['launches']}, want {want}")
    return want


def drive_hopping_link(dev: torch.device) -> dict:
    """Phase 55: `hopping_link_gate()` at its full width (250 hops, 10.0 s at
    2.048 MS/s, 64 channels) with the counts set to 0 just before it and
    read just after: every bar met; nco_mix one launch a channel in the
    transmitter (63) and one a channel of each block in each receiver,
    fir_decimate 2 a block; no other hand-written kernel. Then the chain
    again on the same scene (warm), the device part (transmitter, channel,
    both receivers from the card-resident captures, no TCP) under the
    profiler, and the CPU's transmitter, stream and receivers on the same
    scene and captures against the card's (`hopping_agreement`)."""
    hg = hop_gates
    zero_launch_counts()
    gate = hg.hopping_link_gate(dev)
    counts = fm_counts()
    run, scene, b = gate["run"], gate["scene"], gate["bars"]
    per_stage = hop_launch_check(run, scene)
    phase("55 hopping link", f"{gate['samples']} samples ({scene['hops']} hops × {hg.PERIOD}) at "
          f"{hg.CAPTURE_RATE_HZ:.0f} S/s on {dev}: messages {b['messages']}/{scene['hops']} "
          f"byte-equal over TCP ({gate['stream_mb_per_s']:.1f} MB/s, {gate['stream_s']:.4f} s "
          f"for the stream with its recording and receiving); hop control "
          f"{[b[k] for k in ('channel_at_ok', 'in_guard_ok', 'boundaries_ok')]}, {b['visited']} "
          f"channels; recorder find {b['find_ok']}, read {b['read_ok']}, {b['file_bytes']} bytes; "
          f"timestamps {b['time_ok']}; transmit EVM {b['evm_db']['without']:.4f} → "
          f"{b['evm_db']['with']:.4f} dB ({b['dpd_gain_db']:.4f} dB by DPD); {b['bit_errors']} "
          f"bit errors of {b['bits_scored']} at {hg.ESN0_DB} dB (SNR estimate "
          f"{b['snr_db'][0]:.4f}-{b['snr_db'][1]:.4f} dB); {b['bit_errors_20db']} at "
          f"{hg.BER_ESN0_DB} dB (BER {b['ber_20db']:.3g}); stage ms "
          + json.dumps({k: round(v, 3) for k, v in gate["stage_ms"].items()})
          + f"; launches {json.dumps(counts)} (by stage {json.dumps(per_stage)}); "
          f"{gate['seconds']:.4f} s end to end")
    if not gate["ok"]:
        raise AssertionError(f"hopping link gate: bars {b}")
    out = {"launches": counts, "launches_by_stage": per_stage, "stage_ms": gate["stage_ms"],
           "seconds": gate["seconds"], "stream_mb_per_s": gate["stream_mb_per_s"],
           "bars": {k: b[k] for k in ("evm_db", "dpd_gain_db", "bit_errors", "bits_scored",
                                      "bit_errors_20db", "ber_20db", "snr_db")}}
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hg.hopping_link_chain(scene, dev, tmp + "/warm.iq")
        torch.cuda.synchronize()
        out["warm_s"] = time.perf_counter() - t0
    phase("55 hopping warm", f"the link again on the same scene: {out['warm_s']:.4f} s")
    const = hg.spec().build_waveform(dev).constellation_points()
    taps = hg.design_taps(dev)
    noise = torch.from_numpy(scene["noise"]).to(dev)

    def device_part():
        tx = hg.transmit(scene, dev)
        hg.receive(hg.add_noise(tx["tx"], noise, tx["power"], hg.ESN0_DB), run["ctl"], const,
                   taps)
        hg.receive(hg.add_noise(tx["tx"], noise, tx["power"], hg.BER_ESN0_DB), run["ctl"],
                   const, taps)

    prof = breakdown(device_part, warm=True)
    del noise
    phase("55 hopping profile", f"one warm device part (transmitter, channel, both receivers "
          f"from the card-resident captures, no TCP) under the profiler: "
          f"{prof['device_events']} launches, busy {prof['busy_ms']:.3f} ms of a "
          f"{prof['span_ms']:.3f} ms span, idle share {prof['idle_share']:.4f}; largest "
          + json.dumps(prof["top_ms"]))
    out["profile"] = prof
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cpu_tx, cpu_link, cpu_low = hg.cpu_runs(gate, tmp + "/cpu.iq")
        out["cpu_s"] = time.perf_counter() - t0
        agreement = hg.hopping_agreement(gate, cpu_tx, cpu_link, cpu_low, scene)
    phase("55 hopping card vs cpu", f"the whole scene and capture on the CPU ({out['cpu_s']:.2f} s "
          f"on the host): " + json.dumps(agreement))
    if not agreement["ok"]:
        raise AssertionError(f"hopping link gate: card against CPU {agreement}")
    out["card_vs_cpu"] = agreement
    out["inputs"] = {"capture": run["capture"], "pattern": scene["pattern"], "ctl": run["ctl"]}
    return out


def time_hop_kernels(dev: torch.device, run: dict) -> dict:
    """Phase 56: the hand kernels at the hopping link's shapes, each against
    its plain version and timed: nco_mix through `rotator_apply`'s ω path
    (`nco_rotate_cuda`) at (HOP_NCO_ROWS, 77,824) c64, within NCO_REL_TOL as
    in phase 13; fir_decimate at the de-hopper's (25, 77,824) c64 K = 63
    f = 16 and (25, 4,864) c64 K = 63 f = 8 from zero state, within
    FIR_REL_TOL as in phase 12, beside conv1d (TF32 off) and their bounds;
    all timed queued behind a sleeping stream (device time: at these few-MB
    shapes back-to-back calls measure the host's launch rate)."""
    hg = hop_gates
    capture = run["inputs"]["capture"]
    pattern = run["inputs"]["pattern"]
    block = capture[:hg.BLOCK_HOPS, :hg.DWELL].contiguous()
    x = block[:HOP_NCO_ROWS].contiguous()
    w = -hg.channel_increment(int(pattern[0]))
    got = nco.nco_rotate_cuda(x, w)
    abs_err, rel = rel_err(got, nco.nco_rotate(x, w))
    if not rel < NCO_REL_TOL:
        raise AssertionError(f"nco_rotate at the hop shape: {rel:.3g}")
    kern, plain = in_turns(lambda: nco.nco_rotate(x, w), lambda: nco.nco_rotate_cuda(x, w),
                           queued_ms)
    b_ms, b_by = bound(16 * x.numel(), 0)
    key = "hop_rotator"
    out = {"nco_mix": {f"ms_{key}": sum(kern) / 2, f"plain_ms_{key}": sum(plain) / 2,
                       f"bound_ms_{key}": b_ms, f"bound_by_{key}": b_by,
                       f"library_ms_{key}": None, f"max_rel_err_{key}": rel,
                       f"max_abs_err_{key}": abs_err, f"shape_{key}": list(x.shape)}}
    phase("56 hop rotator nco", f"nco_mix through rotator_apply's ω path at {tuple(x.shape)} "
          f"(ω = {w:.6f} rad/sample), device (queued): kernel {kern[0]:.4f}/{kern[1]:.4f} ms, "
          f"plain "
          f"{plain[0]:.4f}/{plain[1]:.4f} ms; bound {b_ms:.4f} ms by {b_by}; max|Δ|/max|plain| "
          f"{rel:.3g}")
    base = hg.rotate_by_channel(block, pattern[:hg.BLOCK_HOPS], -1.0)
    taps1, taps2 = hg.design_taps(dev)
    fir_entry = time_fir_shape(base, taps1, hg.DDC_DECIMATION, "hop_ddc", "56 hop ddc fir",
                               queued_ms)
    y1 = fir.fir_decimate_cuda(base, taps1.flip(0), hg.DDC_DECIMATION, zero_state=True)
    fir_entry.update(time_fir_shape(y1, taps2, hg.SYM_DECIMATION, "hop_symbol",
                                    "56 hop symbol fir", queued_ms))
    out["fir_decimate"] = fir_entry
    return out


def drive_e1c_gate(dev: torch.device) -> dict:
    """Phase 57: `e1c_pilot_gate()` at full width (8 Galileo E1C SVs at 34
    dB-Hz and 2 absent controls over 50 periods at 5 MS/s; then the dual
    E1C + E1B capture over 4.35 s) with the counts set to 0 just before it
    and read just after: 8/8 acquired, 0/2 false alarms, 8/8 tracked by the
    reference's rule, the E1B pass with every CRC-ok page's data equal to
    the truth; each SV's I/NAV decode one launch of each Viterbi kernel, no
    other hand-written kernel. Phase 58: the gate again from a fresh capture
    (warm). Phase 59: the pilot stage on the gate's capture under the
    profiler."""
    e1c_common.clear_memo()
    zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with CallSpy(inav, "decode_parts") as decodes:
        out = e1c_pilot_gate(dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = fm_counts()
    e1b = out["e1b"]
    per = {r["prn"]: {k: round(r[k], 4) if isinstance(r[k], float) else r[k]
                      for k in ("tracked", "lock", "sec_dom", "sec_shift", "doppler_err_hz",
                                "dop_resid_hz", "boc_jump_subchips", "cn0_est_dbhz",
                                "cn0_acq_dbhz")} for r in out["per_prn"]}
    pages = {sv["prn"]: f"{sv['pages_data_match']}/{sv['pages_crc_ok']}/{sv['pages_seen']}"
             for sv in e1b["per_sv"]}
    phase("57 e1c pilot gate", f"{out['of']} SVs at {e1c_common.GATE_CN0_DBHZ} dB-Hz, "
          f"{out['periods']} periods at {e1c_common.GATE_RATE_HZ / 1e6} MS/s on {out['device']}: "
          f"acquired {out['acquired']}/{out['of']}, false alarms {out['false_alarms']}/"
          f"{len(out['controls'])} (PRNs {out['controls']}), tracked {out['value']}/{out['of']}, "
          f"C/N0 mean {out['cn0_mean_dbhz']}; E1B {e1b['svs_pages_ok']}/{e1b['of']} SVs over "
          f"{e1b['epochs']} epochs (pages match/CRC ok/seen {json.dumps(pages)}); bars "
          f"{json.dumps(out['bars'])}; first run {first_s:.4f} s")
    phase("57 e1c per prn", json.dumps(per))
    phase("57 e1c stages", "pilot gen_s {:.4f}, acquire_s {:.4f}, track_s {:.4f} ({}); E1B "
          "gen_s {:.4f}, acquire_s {:.4f}, track_s {:.4f} ({}), decode_s {:.4f}; decodes "
          "(parts, 240) {}; launches {}".format(
              out["gen_s"], out["acquire_s"], out["track_s"],
              json.dumps({k: round(v, 4) for k, v in out["stages_s"].items()}), e1b["gen_s"],
              e1b["acquire_s"], e1b["track_s"],
              json.dumps({k: round(v, 4) for k, v in e1b["stages_s"].items()}), e1b["decode_s"],
              decodes.shapes, json.dumps(counts)))
    if not out["ok"]:
        raise AssertionError(f"the E1C pilot gate failed its bars {out['bars']}: {per}, {pages}")
    want = {**dict.fromkeys(counts, 0), "viterbi_forward": len(decodes.shapes),
            "viterbi_traceback": len(decodes.shapes)}
    if len(decodes.shapes) != out["of"] or counts != want:
        raise AssertionError(f"the E1C gate launched {counts}, want {want}")
    run = {"launches": counts, "lanes": [s[0] for s in decodes.shapes], "first_s": first_s,
           "per_prn": per, "out": out}
    e1c_common.clear_memo()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = e1c_pilot_gate(dev)
    torch.cuda.synchronize()
    run["warm_s"] = time.perf_counter() - t0
    phase("58 e1c warm", f"the gate again from a fresh capture: {run['warm_s']:.4f} s (first "
          f"{first_s:.4f} s); bars {json.dumps(warm['bars'])}")
    if not warm["ok"]:
        raise AssertionError(f"the E1C pilot gate failed warm: {warm['bars']}")
    cfg, rx, prns, n, waves, acq_all, _ = e1c_common.e1c_capture(
        e1c_common.gate_config(), out["periods"], dev)
    acq = acquisition.AcquisitionResult(*[f[:n] for f in acq_all])

    def pilot_stage():
        e1c_tracking.track_channels(rx, cfg.sample_rate, prns[:n], waves[:n], acq,
                                    out["periods"], e1c_common.GATE_CN0_DBHZ)

    prof = breakdown(pilot_stage, warm=False)
    phase("59 e1c profile", f"the pilot stage (8 channels, 50 periods: sweep, two joint "
          f"searches and coherent sweeps, carrier seed, pilot pass) under the profiler: "
          f"{prof['device_events']} launches, busy {prof['busy_ms']:.3f} ms of a "
          f"{prof['span_ms']:.3f} ms span, idle share {prof['idle_share']:.4f}; largest "
          + json.dumps(prof["top_ms"]))
    run["profile"] = prof
    return run


def check_e1c_card_against_cpu(dev: torch.device, run: dict) -> dict:
    """Phase 60: the gate's 50-period pilot stage on the CPU against the
    card: acquisition of the card's capture (decisions, code phases and
    Doppler bins equal, metrics within 1e-3 relative), `track_channels` on
    the CPU from the CPU's acquisition (sec_shift and tracked equal; lock
    within E1C_LOCK_TOL, C/N0 within E1C_CN0_TOL_DB, refined Doppler within
    E1C_DOP_TOL_HZ, jump within E1C_JUMP_TOL subchips), and the I/NAV decode
    of the card's soft symbols on the CPU (page bits equal)."""
    out = run["out"]
    cfg, rx, prns, n, waves, acq_card, _ = e1c_common.e1c_capture(
        e1c_common.gate_config(), out["periods"], dev)
    t0 = time.perf_counter()
    rx_cpu = rx.cpu()
    acq_cpu = e1c_common.acquire_e1c(rx_cpu, prns, waves, cfg.sample_rate, out["periods"])
    acq_s = time.perf_counter() - t0
    for field in ("detected", "code_phase", "doppler_hz"):
        if not torch.equal(getattr(acq_card, field).cpu(), getattr(acq_cpu, field)):
            raise AssertionError(f"E1C acquisition {field}: card {getattr(acq_card, field)}, "
                                 f"CPU {getattr(acq_cpu, field)}")
    metric_rel = float(torch.max(torch.abs(acq_card.peak_metric.cpu() - acq_cpu.peak_metric)
                                 / acq_cpu.peak_metric))
    t1 = time.perf_counter()
    per_cpu, _ = e1c_tracking.track_channels(
        rx_cpu, cfg.sample_rate, prns[:n], waves[:n],
        acquisition.AcquisitionResult(*[f[:n] for f in acq_cpu]), out["periods"],
        e1c_common.GATE_CN0_DBHZ)
    track_s = time.perf_counter() - t1
    worst = {"lock": 0.0, "cn0_est_dbhz": 0.0, "doppler_hz": 0.0, "boc_jump_subchips": 0.0}
    for g, w in zip(out["per_prn"], per_cpu):
        for key in ("detected", "sec_shift", "tracked"):
            if g[key] != w[key]:
                raise AssertionError(f"E1C PRN {g['prn']} {key}: card {g[key]}, CPU {w[key]}")
        for key in worst:
            worst[key] = max(worst[key], abs(g[key] - w[key]))
    tols = {"lock": E1C_LOCK_TOL, "cn0_est_dbhz": E1C_CN0_TOL_DB, "doppler_hz": E1C_DOP_TOL_HZ,
            "boc_jump_subchips": E1C_JUMP_TOL}
    if any(worst[k] > tols[k] for k in worst):
        raise AssertionError(f"E1C pilot stage card vs CPU: {worst}, tolerances {tols}")
    pages_equal = True
    for soft, sv in zip(out["e1b"]["soft"], out["e1b"]["per_sv"]):
        cpu_pages = [g["data112"].tolist() for g in inav.decode_stream(soft, "cpu")
                     if g["crc_ok"]]
        pages_equal &= cpu_pages == sv["data112"]
    if not pages_equal:
        raise AssertionError("E1C I/NAV pages decoded on the CPU differ from the card's")
    phase("60 e1c card vs cpu", f"acquisition of the card's capture on the CPU ({acq_s:.2f} s): "
          f"decisions, code phases and Doppler bins equal, metrics max rel {metric_rel:.3g}; "
          f"pilot stage on the CPU ({track_s:.2f} s): sec_shift and tracked equal for all "
          f"{n} SVs, worst |Δ| {json.dumps({k: float(f'{v:.4g}') for k, v in worst.items()})} "
          f"(tolerances {json.dumps(tols)}); I/NAV pages of the card's soft symbols decoded on "
          f"the CPU equal the card's")
    if not metric_rel <= 1e-3:
        raise AssertionError(f"E1C acquisition metrics card vs CPU {metric_rel}")
    return {"worst": worst, "metric_rel": metric_rel, "cpu_s": acq_s + track_s}


def time_e1c_viterbi(dev: torch.device, run: dict) -> dict:
    """Phase 62: both Viterbi kernels at the E1C gate's I/NAV shape (T 120,
    the parts of one SV's decode as lanes) bit for bit against their plain
    versions, timed queued behind a sleeping stream (device time) beside
    their bounds; the plain versions by CUDA events."""
    constraint, polys = 7, convolutional.K7_POLYS
    lanes = max(run["lanes"])
    bm = inav_branch_metrics(lanes, 57, dev)
    errs = check_viterbi(bm, constraint, polys)
    dec, _ = viterbi.viterbi_forward_cuda(bm, constraint, polys)
    fwd = in_turns(lambda: viterbi.viterbi_forward(bm, constraint, polys),
                   lambda: viterbi.viterbi_forward_cuda(bm, constraint, polys), queued_ms)
    tb = in_turns(lambda: viterbi.viterbi_traceback(dec, constraint, polys),
                  lambda: viterbi.viterbi_traceback_cuda(dec, constraint, polys), queued_ms)
    table = {}
    for name, (kern, plain), (b_ms, b_by), err, shape in (
            ("viterbi_forward", fwd, forward_bound(bm, dec, constraint),
             errs["forward_abs_err"], bm.shape),
            ("viterbi_traceback", tb, traceback_bounds(dec)[0], errs["traceback_abs_err"],
             dec.shape)):
        table[name] = {"ms_e1c": sum(kern) / 2, "plain_ms_e1c": sum(plain) / 2,
                       "bound_ms_e1c": b_ms, "bound_by_e1c": b_by, "library_ms_e1c": None,
                       "max_abs_err_e1c": err, "shape_e1c": list(shape),
                       "launches_e1c_gate": run["launches"][name]}
        phase("62 e1c viterbi", f"{name} at {tuple(shape)} (an E1C gate SV's I/NAV parts, "
              f"lanes % 4 = {lanes % 4}): equal to the plain version bit for bit; kernel "
              f"{kern[0]:.6f}/{kern[1]:.6f} ms, plain {plain[0]:.6f}/{plain[1]:.6f} ms (both "
              f"queued, mean of {TIMED_LAUNCHES}); bound {b_ms:.7f} ms by {b_by}, "
              f"{100 * b_ms / table[name]['ms_e1c']:.3g}% of it; launches "
              f"{run['launches'][name]} in the gate")
    return table


def drive_rf_scene(dev: torch.device, refs: "CpuReferences") -> dict:
    """Phase 61: `rf_scene_gate()` at full width (1 s at 30.72 MS/s in blocks
    of 2^20: five emitters, the loopback simulator's AWGN, the attenuator,
    a triggered 2^16 + 2^23 capture saved as SigMF and replayed, tags,
    PDUs, the BFSK decode, metrics over HTTP, config) with the counts set to
    0 just before it and read just after (fir_decimate 2: the decode's two
    stages; no other hand-written kernel), every bar; then warm; one warm
    chain under the profiler; the FIR at the decode's two shapes against
    its plain version, timed queued beside conv1d and its bound; then the
    whole scene on the CPU (the background process's run) against the card
    (bars, tags, trigger, payload, tone peaks equal; the capture's IQ within
    SCENE_IQ_TOL of its peak)."""
    sg = scene_gates
    zero_launch_counts()
    gate = rf_scene_gate(dev)
    counts = fm_counts()
    b = gate["bars"]
    tones = {k: {"peak_hz": v["peak_hz"], "err_hz": round(v["err_hz"], 4),
                 "doppler_hz": round(v["doppler_hz"], 4)} for k, v in gate["tones"].items()}
    phase("61 rf scene", f"{gate['samples']} samples at {sg.RATE_HZ / 1e6} MS/s on {dev}: "
          f"bars {json.dumps(b)}; tones {json.dumps(tones)}, ratio {gate['ratio_db']:.4f} dB "
          f"(predicted {gate['want_ratio_db']:.4f}); trigger block {gate['trigger_block']}, "
          f"jammer tags {gate['jammer']['tags']} ratio {gate['jammer']['ratio']:.2f}; payload "
          f"{gate['payload']['payload']!r}; capture {gate['capture_samples']} samples; stage s "
          f"{json.dumps({k: round(v, 4) for k, v in gate['stage_s'].items()})}; first run "
          f"{gate['seconds']:.4f} s; launches {json.dumps(counts)}")
    if not gate["ok"]:
        raise AssertionError(f"the RF scene gate failed its bars {b}")
    want = {**dict.fromkeys(counts, 0), "fir_decimate": len(sg.DDC_STAGES)}
    if counts != want:
        raise AssertionError(f"the RF scene gate launched {counts}, want {want}")
    warm = rf_scene_gate(dev)
    phase("61 rf scene warm", f"again: {warm['seconds']:.4f} s (first {gate['seconds']:.4f} s), "
          f"stage s {json.dumps({k: round(v, 4) for k, v in warm['stage_s'].items()})}; bars "
          f"{json.dumps(warm['bars'])}")
    if not warm["ok"]:
        raise AssertionError(f"the RF scene gate failed warm: {warm['bars']}")
    # the scene's noise: threefry on the card (its bits equal the host's numpy)
    block = 1 << 20
    key = threefry.fold_in(threefry.key(21), 0)
    bits_equal = torch.equal(threefry.random_bits_tensor(key, 2 * block, dev).cpu(),
                             torch.from_numpy(threefry.random_bits(key, 2 * block)
                                              .astype(np.int64)))
    _, normal_rel = rel_err(threefry.normal_tensor(key, (2, block), dev).cpu(),
                            torch.from_numpy(threefry.normal(key, (2, block))))
    draw_ms = cuda_ms(lambda: threefry.normal_tensor(key, (2, block), dev))
    numpy_ms = host_ms(lambda: threefry.normal(key, (2, block)))
    phase("61 threefry", f"(2, 2^20) normals a block: bits equal to numpy's {bits_equal}, "
          f"normals max|Δ|/max {normal_rel:.3g}; {draw_ms:.4f} ms on the card (CUDA events, "
          f"mean of {TIMED_LAUNCHES}), {numpy_ms:.1f} ms in numpy on the host")
    if not (bits_equal and normal_rel < 1e-6):
        raise AssertionError(f"threefry on the card: bits {bits_equal}, normals {normal_rel}")
    settings = r4w_config.R4wConfig.from_dict(sg.PROFILE).with_profile("scene")
    with tempfile.TemporaryDirectory() as tmp:
        prof = breakdown(lambda: sg.run_chain(sg.scene(device=dev), settings, tmp,
                                              MetricsRegistry()), warm=False)
    phase("61 rf scene profile", f"one warm chain (engine, simulator, attenuator, capture and "
          f"its SigMF save; no analysis) under the profiler: {prof['device_events']} launches, "
          f"busy {prof['busy_ms']:.3f} ms of a {prof['span_ms']:.3f} ms span, idle share "
          f"{prof['idle_share']:.4f}; largest " + json.dumps(prof["top_ms"]))
    # the hand kernel at the shapes the decode gives it
    off, length = gate["payload"]["window"]
    x = gate["capture"][off:off + length][None, :].contiguous()
    timing = {}
    rate = sg.RATE_HZ
    for (factor, k, cutoff), key in zip(sg.DDC_STAGES, ("scene_ddc", "scene_symbol")):
        taps = torch.from_numpy(filters.design_lowpass(k, cutoff, rate)).to(dev)
        timing.update(time_fir_shape(x, taps, factor, key, f"61 rf scene fir {key}", queued_ms))
        x = fir.fir_decimate_cuda(x, taps.flip(0), factor, zero_state=True)
        rate /= factor
    cpu = refs.get(("scene",))
    cpu_s = cpu["wall_s"]
    same = {k: gate[k] == cpu[k] for k in ("bars", "trigger_block", "payload")}
    same["jammer_tags"] = gate["jammer"]["tags"] == cpu["jammer"]["tags"]
    same["tone_peaks"] = all(gate["tones"][k]["peak_hz"] == cpu["tones"][k]["peak_hz"]
                             for k in gate["tones"])
    _, iq_rel = rel_err(gate["capture"].cpu(), torch.from_numpy(cpu["capture"]))
    ratio_delta = abs(gate["ratio_db"] - cpu["ratio_db"])
    phase("61 rf scene card vs cpu", f"the whole scene on the CPU (the background process, "
          f"{cpu_s:.2f} s on the host): "
          f"{json.dumps(same)}; capture IQ max|Δ|/max|CPU| {iq_rel:.3g} (< {SCENE_IQ_TOL}); "
          f"tone ratio |Δ| {ratio_delta:.3g} dB")
    if not (all(same.values()) and iq_rel < SCENE_IQ_TOL):
        raise AssertionError(f"the RF scene card vs CPU: {same}, IQ {iq_rel}")
    return {"launches": counts, "seconds": gate["seconds"], "warm_s": warm["seconds"],
            "stage_s": gate["stage_s"], "cpu_s": cpu_s, "iq_rel": iq_rel, "profile": prof,
            "timing": timing, "threefry_ms": draw_ms, "threefry_numpy_ms": numpy_ms}


def build_native_runtime() -> dict:
    """Phase 63: the native iqcore runtime built with g++ from the checkout
    (into build/, at first use), its conversions against their plain
    versions."""
    t0 = time.perf_counter()
    if not r4w_native.native_available():
        raise AssertionError(f"the native runtime did not build: {r4w_native.build_error()}")
    build_s = time.perf_counter() - t0
    x = np.random.default_rng(63).uniform(-1.2, 1.2, 1 << 16).astype(np.float32)
    native = {name: getattr(r4w_native, name)(x) for name in ("f32_to_i8", "f32_to_u8")}
    get_lib = r4w_native.get_lib
    r4w_native.get_lib = lambda: None
    try:
        plain = {name: getattr(r4w_native, name)(x) for name in native}
    finally:
        r4w_native.get_lib = get_lib
    same = {name: bool(np.array_equal(native[name], plain[name])) for name in native}
    phase("63 native", f"{r4w_native.library_path().name} built and loaded in {build_s:.2f} s; "
          f"i8/u8 conversions of 2^16 floats equal their plain versions {json.dumps(same)}")
    if not all(same.values()):
        raise AssertionError(f"native conversions differ from the plain versions: {same}")
    return {"build_s": build_s}


def drive_remote_lab(dev: torch.device) -> dict:
    """Phase 64: `remote_lab_gate()` at full width (the 255-byte LoRa-SF7
    packet, then the reference's 5 s run on an unpaced stream), with the
    counts set to 0 just before it and read just after (the dechirp kernel
    once a demodulated batch, no other), every bar; the dechirp shapes the
    demodulator gave the kernel; ten warm batches of 2^16 samples under the
    profiler."""
    zero_launch_counts()
    with CallSpy(lora_modem, "dechirp_power_dispatch") as spy:
        gate = remote_gates.remote_lab_gate(dev)
    counts = fm_counts()
    b, one, run = gate["bars"], gate["packet"], gate["run"]
    hist = run["histogram_s"]
    phase("64 remote lab", f"on {dev}: bars {json.dumps(b)}; control plane "
          f"{json.dumps(gate['control']['ok'])}; packet {one['samples']} samples of "
          f"{one['burst_samples']} in {one['packets']} datagrams, seq gaps {one['seq_gaps']}, "
          f"decoded {one['decoded'][:16]!r}..., first batch {one['first_batch_s']:.4f} s")
    phase("64 remote lab run", f"{run['elapsed_s']:.3f} s: demodulated {run['msps']:.3f} Msps "
          f"(bar {remote_gates.MIN_MSPS}), offered {run['offered_msps']:.3f} Msps; "
          f"{run['batches']} batches, {run['samples']} samples; packets {run['packets']}, "
          f"seq gaps {run['seq_gaps']} (packets_dropped {run['packets_dropped']}), overrun "
          f"floats {run['overrun_floats']}; latency ms {json.dumps(run['latency_ms'])}; "
          f"histogram p50/p99/p999 {1e3 * hist['p50_s']:.4f}/{1e3 * hist['p99_s']:.4f}/"
          f"{1e3 * hist['p999_s']:.4f} ms; launches {json.dumps(counts)}")
    if not gate["ok"]:
        raise AssertionError(f"the remote-lab gate failed its bars {b}")
    batches = run["batches"] + 1  # and phase 1's packet; its CPU decode launches nothing
    want = {**dict.fromkeys(counts, 0), "dechirp_power": batches}
    if (counts != want or spy.launches["dechirp_power"] != batches
            or len(spy.shapes) != batches + 1):
        raise AssertionError(f"the remote-lab gate launched {counts} ({spy.launches} in the "
                             f"demodulator) in {len(spy.shapes)} demodulations, want {want}")
    shapes = sorted(set(spy.shapes), key=spy.shapes.count, reverse=True)
    runner = WaveformRunner(remote_gates.WAVEFORM, remote_gates.RATE_HZ, dev)

    def batches():
        for _ in range(PROFILED_BATCHES):
            runner.process(gate["batch"])

    prof = breakdown(batches)
    phase("64 remote lab profile", f"{PROFILED_BATCHES} warm batches of {gate['batch'].shape[0]} "
          f"samples (each: upload, demodulation, the bits read back) under the profiler: "
          f"{prof['device_events']} launches, busy {prof['busy_ms']:.3f} ms of a "
          f"{prof['span_ms']:.3f} ms span, idle share {prof['idle_share']:.4f}; largest "
          f"{json.dumps(prof['top_ms'])}; dechirp shapes {shapes[:3]}")
    return {"launches": counts, "run": run, "packet": {k: v for k, v in one.items()
                                                       if k != "decoded"},
            "profile": prof, "dechirp_shapes": shapes}


def drive_block_graph(dev: torch.device) -> dict:
    """Phase 65: `block_graph_gate()` at a full LoRa packet with the counts
    set to 0 just before it and read just after (dechirp, first_order_iir and
    fir_decimate at least once each, nco_mix and Viterbi none), every bar;
    warm; one warm graph under the profiler; the card's report against a CPU
    run's (decisions, shapes, dtypes and errors equal, power within 0.01 dB,
    previews within 1e-4)."""
    zero_launch_counts()
    with CallSpy(lora_modem, "dechirp_power_dispatch") as spy:
        gate = remote_gates.block_graph_gate(dev)
    counts = fm_counts()
    nodes = gate["report"]["nodes"]
    summary = {k: (v.get("shape"), v.get("dtype"), v.get("error")) for k, v in nodes.items()}
    phase("65 block graph", f"on {dev}: bars {json.dumps(gate['bars'])}; order "
          f"{gate['report']['order']}; nodes {json.dumps(summary)}; rx decoded "
          f"{nodes['rx'].get('decoded_hex')}...; first run {gate['seconds']:.4f} s; launches "
          f"{json.dumps(counts)}")
    if not gate["ok"]:
        raise AssertionError(f"the block-graph gate failed its bars {gate['bars']}")
    missing = [k for k in GRAPH_LAUNCHES if counts[k] < 1]
    if missing or counts["nco_mix"] or counts["viterbi_forward"] or counts["viterbi_traceback"]:
        raise AssertionError(f"the block graph launched {counts}: want each of {GRAPH_LAUNCHES}")
    warm = remote_gates.block_graph_gate(dev)
    graph = remote_gates.graph_nodes()
    prof = breakdown(lambda: run_pipeline(graph, seed=remote_gates.GRAPH_SEED,
                                          sample_rate=remote_gates.RATE_HZ, device=dev),
                     warm=False)
    phase("65 block graph warm", f"again: {warm['seconds']:.4f} s (first {gate['seconds']:.4f} s), "
          f"bars {json.dumps(warm['bars'])}; one warm graph under the profiler: "
          f"{prof['device_events']} launches, busy {prof['busy_ms']:.3f} ms of a "
          f"{prof['span_ms']:.3f} ms span, idle share {prof['idle_share']:.4f}; largest "
          f"{json.dumps(prof['top_ms'])}")
    if not warm["ok"]:
        raise AssertionError(f"the block-graph gate failed warm: {warm['bars']}")
    t0 = time.perf_counter()
    cpu = remote_gates.block_graph_gate("cpu")
    cpu_s = time.perf_counter() - t0
    verdict = remote_gates.compare_reports(gate["report"], cpu["report"])
    phase("65 block graph card vs cpu", f"the graph on the CPU in {cpu_s:.2f} s: reports equal "
          f"{verdict['equal']}, worst power |Δ| {verdict['worst_power_db']:.3g} dB (< "
          f"{remote_gates.POWER_TOL_DB}), worst preview |Δ| {verdict['worst_preview']:.3g} (< "
          f"{remote_gates.PREVIEW_TOL}) at {verdict['worst_preview_at']}; {verdict['diffs']}")
    if not (cpu["ok"] and verdict["equal"]):
        raise AssertionError(f"the block graph card vs CPU: {verdict}")
    return {"launches": counts, "seconds": gate["seconds"], "warm_s": warm["seconds"],
            "cpu_s": cpu_s, "profile": prof, "verdict": verdict,
            "dechirp_shapes": sorted(set(spy.shapes))}


def check_host_layer(dev: torch.device) -> dict:
    """Phase 66: the registry's 523 blocks resolved on the card (each
    `mod_` waveform on it), every schema built, the reference's category
    counts; `hopping_link_gate`'s link as a `SampleSchedule` (250 hops, 20.48 M
    samples, guards painted over the hops) card against CPU; the torch
    accelerator at 2^20 against the numpy one; the example C-ABI plugin
    built, loaded and round-tripped on the card."""
    reg = default_registry()
    t0 = time.perf_counter()
    on_card, schemas = 0, 0
    for info in reg.list():
        made = info.factory(device=dev)
        if info.name.startswith("mod_"):
            if made is None or made.device.type != dev.type:
                raise AssertionError(f"{info.name} did not resolve on {dev}")
            on_card += 1
        schemas += bool(reg.param_schema(info.name))
    counts = {c.value: n for c, n in reg.categories().items()}
    phase("66 registry", f"{len(reg.list())} blocks resolved ({on_card} waveforms on {dev}), "
          f"{schemas} non-empty schemas, in {time.perf_counter() - t0:.2f} s; categories equal "
          f"the reference's {counts == REGISTRY_COUNTS}")
    if len(reg.list()) != 523 or counts != REGISTRY_COUNTS:
        raise AssertionError(f"registry: {len(reg.list())} blocks, {counts}")
    sched = remote_gates.hop_schedule()
    n = remote_gates.HOP_COUNT * int(round(remote_gates.HOP_DWELL_S * remote_gates.HOP_RATE_HZ))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = sched.masks(n, device=dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = sched.masks(n, device="cpu")
    cpu_s = time.perf_counter() - t0
    same = all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu))
    phase("66 schedule", f"{len(sched.events)} events (250 hops, 250 guards) over {n} samples at "
          f"{remote_gates.HOP_RATE_HZ / 1e6} MS/s: masks on {dev} in {card_s:.4f} s, on the CPU "
          f"in {cpu_s:.4f} s, equal {same}; guard samples {int((card[2] == 3).sum())}")
    if not same:
        raise AssertionError("the schedule's masks differ card against CPU")
    rng = np.random.default_rng(66)
    x = (rng.standard_normal(ACCEL_SAMPLES) + 1j * rng.standard_normal(ACCEL_SAMPLES)).astype(
        np.complex64)
    taps = (rng.standard_normal(ACCEL_TAPS) + 1j * rng.standard_normal(ACCEL_TAPS)).astype(
        np.complex64)
    chirp_x = np.exp(1j * np.pi * 1e-6 * np.arange(ACCEL_SAMPLES) ** 2).astype(np.complex64)
    tacc, sim = r4w_accel.create_accelerator("torch", dev), r4w_accel.create_accelerator("sim")
    accel_errs = {}
    for name, args in (("fft", (x,)), ("fir", (x, taps)), ("chirp_correlate", (x, chirp_x))):
        got = getattr(tacc, name)(*args)
        want = torch.from_numpy(np.asarray(getattr(sim, name)(*args), np.complex128))
        if got.device.type != dev.type or tuple(got.shape) != tuple(want.shape):
            raise AssertionError(f"accelerator {name}: {got.device} {tuple(got.shape)}")
        accel_errs[name] = rel_err(got.cpu().to(torch.complex128), want)[1]
    phase("66 accelerator", f"{tacc.capabilities().name}: fft, fir ({ACCEL_TAPS} taps) and "
          f"chirp_correlate at 2^20 against SimulatedAccelerator, max|Δ|/max "
          f"{json.dumps(accel_errs)} (< {ACCEL_REL_TOL})")
    if not all(e < ACCEL_REL_TOL for e in accel_errs.values()):
        raise AssertionError(f"the torch accelerator differs from the numpy one: {accel_errs}")
    src = Path(r4w_native.__file__).with_name("example_plugin.cpp")
    t0 = time.perf_counter()
    so = r4w_native.build(src, ("-O2", "-shared", "-fPIC"), include=src.parent)
    saved = dict(waveform_base._REGISTRY), list(waveform_base._CANONICAL)
    try:
        pm = PluginManager(search_paths=[str(so.parent)])
        info = pm.load_native_plugin(str(so))
        if info is None:
            raise AssertionError(f"the example plugin did not load: {pm.errors}")
        wf = create_waveform("manchester-ook", 125_000.0, dev)
        payload = bytes(range(0, 256, 7))
        tx = wf.modulate(payload)
        res = wf.demodulate(tx)
        ok = (tx.device.type == res.bits.device.type == dev.type
              and bytes(res.bits.cpu().numpy().astype(np.uint8)) == payload)
    finally:
        waveform_base._REGISTRY.clear()
        waveform_base._REGISTRY.update(saved[0])
        waveform_base._CANONICAL[:] = saved[1]
    phase("66 plugin", f"{so.name} built and loaded in {time.perf_counter() - t0:.2f} s: "
          f"{info.name} {info.waveforms}, {len(payload)} bytes round trip on {dev} {ok}")
    if not ok:
        raise AssertionError("the example plugin's round trip failed on the card")
    return {"schedule_card_s": card_s, "schedule_cpu_s": cpu_s, "accel_rel": accel_errs}


def time_dechirp_rows(rows: int, dev: torch.device, key: str, label: str, sf: int = 7) -> dict:
    """The dechirp kernel at (rows, 2^sf), a LoRa demodulation's shape
    (SF7's 128 points unless named), against its plain version within 1e-4,
    kernel and plain queued in turns, cuFFT's transform alone as the library
    yardstick, beside the bound; keyed ``*_{key}``."""
    params = lora.LoRaParams(sf=sf)
    k = params.chips_per_symbol
    gen = torch.Generator(device=dev).manual_seed(rows)
    syms = torch.randint(0, k, (rows,), generator=gen, device=dev, dtype=torch.int32)
    x = chirp.symbol_chirps(params, syms) + 0.5 * randn_iq((rows, k), gen)
    down = chirp.base_downchirp(params, dev)
    got = dechirp_power_cuda(x, down)
    abs_err, rel = rel_err(got, dechirp_power(x, down))
    if not rel < REL_TOL:
        raise AssertionError(f"dechirp_power at {key} ({rows}, {k}): {rel:.3g}")
    kern, plain = in_turns(lambda: dechirp_power(x, down), lambda: dechirp_power_cuda(x, down),
                           queued_ms)
    mixed = x * down
    library = queued_ms(lambda: torch.fft.fft(mixed, dim=-1))
    b_ms, b_by = dechirp_bound(rows, k)
    phase(label, f"dechirp_power at ({rows}, {k}) device (queued): kernel {kern[0]:.6f}/"
          f"{kern[1]:.6f} ms, plain {plain[0]:.6f}/{plain[1]:.6f} ms, cuFFT transform alone "
          f"{library:.6f} ms; bound {b_ms:.6f} ms by {b_by}; max|Δ|/max {rel:.3g}")
    return {f"ms_{key}": sum(kern) / 2, f"plain_ms_{key}": sum(plain) / 2,
            f"library_ms_{key}": library, f"bound_ms_{key}": b_ms, f"bound_by_{key}": b_by,
            f"max_abs_err_{key}": abs_err, f"shape_{key}": [rows, k]}


def time_host_layer_kernels(dev: torch.device, lab: dict, graph: dict) -> dict:
    """Phase 67: the three kernels at the shapes the two gates gave them:
    dechirp at the remote lab's batch rows and at the packet's (the graph's
    rx), the FIR at the graph's decimator ((1, 48,288) c64, K = 63, f = 4)
    beside conv1d, the recursion's linear kind at the graph's DC blocker
    ((1, 48,288) c64, α 0.995) bit for bit, beside its bytes bound and its
    serial floor."""
    out = {"dechirp_power": {}, "fir_decimate": {}, "first_order_iir": {}}
    batch_rows = lab["dechirp_shapes"][0][0]
    out["dechirp_power"].update(time_dechirp_rows(batch_rows, dev, "remote_batch",
                                                  "67 remote lab dechirp"))
    packet_rows = graph["dechirp_shapes"][0][0]
    out["dechirp_power"].update(time_dechirp_rows(packet_rows, dev, "graph_packet",
                                                  "67 block graph dechirp"))
    n = remote_gates.BURST_SAMPLES
    gen = torch.Generator(device=dev).manual_seed(67)
    x = randn_iq((1, n), gen)
    taps = torch.from_numpy(filters.design_lowpass(*remote_gates.GRAPH_TAPS)).to(dev)
    out["fir_decimate"].update(time_fir_shape(x, taps, remote_gates.GRAPH_FACTOR, "graph",
                                              "67 block graph fir", queued_ms))
    alpha = 0.995
    u = torch.diff(x, dim=-1, prepend=torch.zeros((1, 1), dtype=x.dtype, device=dev)).contiguous()
    got = recurrence.first_order_recurrence_cuda(u, "linear", alpha)
    want = recurrence.first_order_recurrence(u.cpu(), "linear", alpha)
    if not torch.equal(got.cpu(), want):
        raise AssertionError(f"first_order_iir linear at ({n},) c64 differs from the plain loop "
                             f"at {int(torch.sum(got.cpu() != want))} samples")
    ms = [queued_ms(lambda: recurrence.first_order_recurrence_cuda(u, "linear", alpha), 3)
          for _ in range(2)]
    u_host = u.cpu()
    plain = min(host_ms(lambda: recurrence.first_order_recurrence(u_host, "linear", alpha))
                for _ in range(2))
    probe = chain_probe(n, "linear", alpha)
    rec = {"ms_graph": sum(ms) / 2, "plain_ms_graph": plain, "shape_graph": [1, n, "c64"],
           "bound_ms_graph": 1e3 * 16 * n / HBM_BYTES_PER_S, "bound_by_graph": "bytes",
           "serial_floor_ms_graph": n * probe["ns_per_step"] * 1e-6,
           "chain_cycles_per_step_graph": probe["cycles_per_step"], "max_abs_err_graph": 0.0,
           "library_ms_graph": None}
    phase("67 block graph recursion", f"first_order_iir linear at the DC blocker's (1, {n}) c64: "
          f"card = plain bit for bit; kernel {ms[0]:.4f}/{ms[1]:.4f} ms queued, plain step loop "
          f"(host) {plain:.1f} ms; bytes bound {rec['bound_ms_graph']:.5f} ms, serial floor "
          f"{rec['serial_floor_ms_graph']:.4f} ms (bare chain {probe['cycles_per_step']:.3f} "
          f"cycles a step at {probe['sm_mhz']:.0f} MHz)")
    out["first_order_iir"] = rec
    return out


def _cpu_reference_worker(conn, jobs) -> None:
    """The CPU halves of phases 37, 61, 68, 70 and 74-76, in a spawned process
    (no CUDA): each job's result is sent as it completes, or the traceback."""
    try:
        for job in jobs:
            t0 = time.perf_counter()
            if job[0] == "receiver":
                gate = composed_receiver_gate("cpu", job[1])
                value = {"decisions": gate_decisions(gate), "total_s": gate["seconds"]["total"]}
            elif job[0] == "survey":
                value = registry_survey("cpu")
            elif job[0] == "scene":
                gate = rf_scene_gate("cpu")
                value = {k: gate[k] for k in ("bars", "trigger_block", "payload", "jammer",
                                              "tones", "ratio_db")}
                value["capture"] = gate["capture"].numpy()
            elif job[0] == "dryrun":
                with contextlib.redirect_stdout(io.StringIO()):
                    value = dryrun_multichip(1, "cpu")
            elif job[0] == "cli":
                value = frontend_gates.cli_reference("cpu")
            elif job[0] == "explorer":
                value = frontend_gates.explorer_reference("cpu")
            else:
                run = mesh_gates.run_mesh(GATE, "cpu")
                value = {"outcome": mesh_gates.outcome(run), "air_seconds": run["air_seconds"],
                         "seconds": run["seconds"]}
            value["wall_s"] = time.perf_counter() - t0
            conn.send((job, value))
    except BaseException:  # noqa: BLE001 - reported to the parent, which fails the phase
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


class CpuReferences:
    """The CPU runs that phases 37, 61, 68, 70 and 74-76 hold the card against,
    computed from the start of the script in one spawned process while the
    card runs the phases before them (they depend on nothing the card
    computes). A reader thread takes each result off the pipe as it comes,
    so the process never blocks on a full pipe. The process is a daemon and
    is stopped by `close`."""

    JOBS = (("receiver", RECEIVER_INFO_BITS), ("receiver", PACKET_INFO_BITS), ("survey",),
            ("mesh",), ("scene",), ("dryrun",), ("explorer",), ("cli",))

    def __init__(self):
        ctx = mp.get_context("spawn")
        rx, tx = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(target=_cpu_reference_worker, args=(tx, self.JOBS), daemon=True)
        self.proc.start()
        tx.close()
        self.results: dict = {}
        self.arrived = threading.Condition()
        self.reader = threading.Thread(target=self._read, args=(rx,), daemon=True)
        self.reader.start()

    def _read(self, rx) -> None:
        while True:
            try:
                key, value = rx.recv()
            except (EOFError, OSError):
                key, value = "ended", None
            with self.arrived:
                self.results[key] = value
                self.arrived.notify_all()
            if key in ("error", "ended"):
                return

    def get(self, job: tuple, timeout_s: float = 1200.0) -> dict:
        with self.arrived:
            ready = self.arrived.wait_for(
                lambda: job in self.results or "error" in self.results
                or "ended" in self.results, timeout_s)
            if job in self.results:
                return self.results[job]
        if not ready:
            raise AssertionError(f"the CPU reference {job} did not arrive in {timeout_s} s")
        if "error" in self.results:
            raise AssertionError(f"the CPU reference process failed:\n{self.results['error']}")
        raise AssertionError(f"the CPU reference process ended before {job} (exit code "
                             f"{self.proc.exitcode})")

    def close(self) -> None:
        self.proc.terminate()
        self.proc.join(10)
        self.reader.join(10)


def drive_registry_survey(dev: torch.device, refs: "CpuReferences") -> dict:
    """Phase 68: every registry block (523) and the pipeline's demodulator
    through `run_pipeline` with its schema's defaults, on the card with the
    counts set to 0 just before it and read just after (the dechirp kernel
    at least once, by the demodulator), then the same graphs on the CPU:
    the erring blocks and their errors' causes equal on both, every block
    that runs on both with the same shape and dtype and a power within 0.01
    dB, or exempt by name (`registry_survey.EXEMPT`)."""
    zero_launch_counts()
    card = registry_survey(dev)
    counts = fm_counts()
    cpu = refs.get(("survey",))
    verdict = compare_surveys(card, cpu)
    slow = sorted(((v["seconds"], k) for k, v in card["blocks"].items()), reverse=True)[:8]
    phase("68 registry survey", f"{len(card['blocks'])} nodes (523 blocks and waveform_rx): on "
          f"{dev} {len(card['ok'])} ok, {len(card['errors'])} erring in {card['seconds']:.2f} s; "
          f"on the CPU (the background process) {len(cpu['ok'])} ok, {len(cpu['errors'])} "
          f"erring in {cpu['seconds']:.2f} s; error sets equal {not (verdict['card_only'] or verdict['cpu_only'])}; card-only "
          f"{json.dumps(verdict['card_only'])}; CPU-only {json.dumps(verdict['cpu_only'])}; "
          f"erring on both for another cause {json.dumps(verdict['differing_errors'])}; "
          f"mismatches {json.dumps(verdict['mismatch'])}; exempt {json.dumps(verdict['exempt'])}; "
          f"worst power |Δ| {verdict['worst_power_db']:.3g} dB at {verdict['worst_at']} (< "
          f"{SURVEY_POWER_TOL_DB}); launches {json.dumps(counts)}; slowest on the card "
          + ", ".join(f"{k} {t:.2f} s" for t, k in slow))
    phase("68 registry survey errors", "erring on both (parameters the schema cannot give): "
          + ", ".join(sorted(set(card["errors"]) & set(cpu["errors"]))))
    if not verdict["equal"]:
        raise AssertionError(f"the registry survey: card against CPU {verdict}")
    if counts["dechirp_power"] < 1:
        raise AssertionError(f"the survey launched no dechirp kernel: {counts}")
    return {"launches": counts, "card_s": card["seconds"], "cpu_s": cpu["seconds"],
            "ok": len(card["ok"]), "errors": len(card["errors"])}


def drive_mesh_gate(dev: torch.device) -> dict:
    """Phase 69: `mesh_lora_gate()`, the 16-node LongFast mesh over the LoRa
    PHY (SF11, 250 kHz), on the card with the counts set to 0 just before it
    and read just after: every bar; the dechirp kernel once a round that
    carried frames (the gate's run and its +10 dB run), no other kernel;
    deliveries and failures in 2 dB SNR buckets; frames, samples and GB of
    IQ; the first run's seconds, a warm run's, and one warm round (the
    busiest) under the profiler."""
    zero_launch_counts()
    with CallSpy(lora_modem, "dechirp_power_dispatch") as spy:
        t0 = time.perf_counter()
        gate = mesh_lora_gate(dev)
        gate_s = time.perf_counter() - t0
    counts = fm_counts()
    run, high = gate["run"], gate["high"]
    air_rounds = len(run["sim"].air) + len(high["sim"].air)
    want = {**dict.fromkeys(counts, 0), "dechirp_power": air_rounds}
    phase("69 mesh gate", f"{GATE.nodes} nodes, {GATE.preset} (SF{run['sim'].params.sf}, "
          f"{run['sim'].params.bw_hz / 1e3:.0f} kHz, CR 4/{4 + run['sim'].params.cr}) on {dev}: "
          f"bars {json.dumps(gate['bars'])}; rounds {run['rounds']}, moved {run['moved']}; "
          f"{run['frames']} frames ({json.dumps(gate['outcomes'])}), {gate['strong_frames']} on "
          f"links >= {mesh_gates.STRONG_DB} dB; {run['samples']} samples, {run['iq_gb']:.4f} GB "
          f"of IQ; payloads {json.dumps(gate['payloads'])}; +10 dB run: moved {high['moved']}, "
          f"{high['frames']} frames, payloads {json.dumps(gate['high_payloads'])}; the gate's "
          f"run {run['seconds']:.3f} s (PHY {run['air_seconds']:.3f} s), whole gate {gate_s:.3f} "
          f"s; launches {json.dumps(counts)} (dechirp one a round with frames: {air_rounds})")
    phase("69 mesh snr buckets", "link SNR bucket (dB): deliveries/failed "
          + ", ".join(f"[{edge:g}, {edge + 2:g}) {b['deliveries']}/{b['failed']}"
                      for edge, b in gate["buckets"].items()))
    if not gate["ok"]:
        raise AssertionError(f"the mesh gate failed its bars {gate['bars']}")
    if counts != want:
        raise AssertionError(f"the mesh gate launched {counts}, want {want}")
    warm = mesh_gates.run_mesh(GATE, dev)
    busiest = max(warm["sim"].air, key=lambda a: a["rows"])
    sim = warm["sim"]
    sim.round = busiest["round"]
    prof = breakdown(lambda: sim._air(busiest["frames"], busiest["snrs"]), warm=False)
    other = prof["device_events"] - 1
    phase("69 mesh warm", f"again: {warm['seconds']:.3f} s (first {run['seconds']:.3f} s), PHY "
          f"{warm['air_seconds']:.3f} s; the busiest round ({busiest['rows']} rows, "
          f"{busiest['samples']} samples) under the profiler: {prof['device_events']} launches "
          f"(dechirp 1, {other} others), busy {prof['busy_ms']:.3f} ms of a {prof['span_ms']:.3f} "
          f"ms span, idle share {prof['idle_share']:.4f}; largest {json.dumps(prof['top_ms'])}")
    return {"gate": gate, "launches": counts, "first_s": run["seconds"], "gate_s": gate_s,
            "warm_s": warm["seconds"], "profile": prof, "dechirp_shapes": sorted(set(spy.shapes))}


def check_mesh_card_against_cpu(dev: torch.device, mesh_run: dict,
                                refs: "CpuReferences") -> dict:
    """Phase 70: the mesh gate's run on the CPU against the card's (every
    delivery's outcome and bytes, every status, inbox, the rounds and moved
    counts equal); the +10 dB run against the PHY-less simulation (the
    gate's bar, printed); the dechirp kernel at the busiest round's SF11
    shape against its plain version (1e-4) and cuFFT, timed."""
    gate = mesh_run["gate"]
    cpu = refs.get(("mesh",))
    cpu_s = cpu["seconds"]
    verdict = mesh_gates.compare_runs(mesh_gates.outcome(gate["run"]), cpu["outcome"])
    phase("70 mesh card vs cpu", f"the gate's run on the CPU (the background process) in "
          f"{cpu_s:.2f} s (PHY {cpu['air_seconds']:.2f} s): {json.dumps(verdict)}; "
          f"+10 dB run equals the PHY-less simulation {gate['bars']['high_snr_equals_no_phy']} "
          f"(status and inboxes of {GATE.nodes} nodes)")
    if not verdict["equal"]:
        raise AssertionError(f"the mesh gate card vs CPU: {verdict}")
    rows = max(shape[0] for shape in mesh_run["dechirp_shapes"])
    timing = time_dechirp_rows(rows, dev, "mesh_sf11", "70 mesh dechirp",
                               sf=GATE.lora_params().sf)
    return {"cpu_s": cpu_s, "dechirp_power": timing}


def _mesh_packet_roundtrip() -> tuple:
    """A host callable for the sandbox: a mesh packet through its wire bytes."""
    pkt = mesh.MeshPacket(src=3, dst=12, packet_id=0x30001, want_ack=True, payload=b"sandboxed")
    back = mesh.MeshPacket.decode(pkt.encode())
    return back.src, back.dst, back.packet_id, back.payload


def _touch_card() -> float:
    return float(torch.ones(4, device="cuda").sum())


def check_capi(dev: torch.device) -> dict:
    """Phase 71: the C API built from the checkout's byte copies (g++ -O2,
    into build/), its BPSK, QPSK and LoRa-SF7 modulators against the port's
    on the card (3e-6), each demodulator reading the other's IQ back to the
    payload, its FFT against torch.fft.fft on the card (complex128, 1e-9
    relative), its chirps against the port's on the card, and
    examples/11_capi_demo.c compiled against the port's header and run."""
    t0 = time.perf_counter()
    if capi.get_lib() is None:
        raise AssertionError(f"the C API did not build: {capi.build_error()}")
    build_s = time.perf_counter() - t0
    errs = {}
    for name, make in (("BPSK", lambda: capi.CWaveform.bpsk(8000.0, 1000.0)),
                       ("QPSK", lambda: capi.CWaveform.qpsk(8000.0, 1000.0))):
        data = bytes(range(0, 256, 9))
        card = create_waveform(name, 8000.0, dev).modulate(data)
        wf = make()
        got = wf.modulate(data)
        errs[name] = float(np.max(np.abs(got - card.cpu().numpy())))
        if not (card.device.type == dev.type and errs[name] <= CAPI_IQ_ATOL
                and wf.demodulate(card) == data):
            raise AssertionError(f"C API {name}: max|Δ| {errs[name]:.3g}, or the C demodulator "
                                 f"misread the card's IQ")
    params = lora.LoRaParams(sf=7, bw_hz=125_000)
    payload = bytes(range(7, 7 + 40))
    tx = lora_modem.modulate(params, torch.tensor(list(payload), dtype=torch.int32, device=dev),
                             include_preamble=True, device=dev)
    c_lora = capi.CWaveform.lora(7, 125_000, 125_000.0)
    c_iq = c_lora.modulate(payload)
    errs["LoRa-SF7"] = float(np.max(np.abs(c_iq - tx.cpu().numpy())))
    pre = params.n_preamble_samples()
    c_reads_card = c_lora.demodulate(tx[pre:])[: len(payload)] == payload
    card_res = lora_modem.demodulate(params, torch.from_numpy(c_iq[pre:].astype(np.complex64)).to(dev))
    card_reads_c = bytes(card_res.payload.cpu().numpy().astype(np.uint8).tolist())[: len(payload)] \
        == payload
    if not (errs["LoRa-SF7"] <= CAPI_IQ_ATOL and c_reads_card and card_reads_c):
        raise AssertionError(f"C API LoRa: max|Δ| {errs['LoRa-SF7']:.3g}, C reads card "
                             f"{c_reads_card}, card reads C {card_reads_c}")
    gen = torch.Generator(device=dev).manual_seed(71)
    x = torch.complex(torch.randn(4096, generator=gen, device=dev, dtype=torch.float64),
                      torch.randn(4096, generator=gen, device=dev, dtype=torch.float64))
    want = torch.fft.fft(x).cpu().numpy()
    fft_rel = float(np.max(np.abs(capi.fft_forward(x) - want)) / np.max(np.abs(want)))
    cc = capi.CChirp(7, 125_000, 1)
    chirp_err = max(float(np.max(np.abs(cc.upchirp() - chirp.base_upchirp(params, dev).cpu().numpy()))),
                    float(np.max(np.abs(cc.downchirp()
                                        - chirp.base_downchirp(params, dev).cpu().numpy()))))
    if not (fft_rel <= CAPI_FFT_REL and chirp_err <= CAPI_CHIRP_ATOL):
        raise AssertionError(f"C API FFT {fft_rel:.3g} (<= {CAPI_FFT_REL}), chirps "
                             f"{chirp_err:.3g} (<= {CAPI_CHIRP_ATOL})")
    so = capi.library_path()
    with tempfile.TemporaryDirectory() as tmp:
        exe = Path(tmp) / "capi_demo"
        root = Path(__file__).resolve().parent
        subprocess.run(["gcc", "-O2", "-o", str(exe), str(root / "examples" / "11_capi_demo.c"),
                        "-I", str(root / "r4w_tpu_torch" / "native"), str(so), "-lm",
                        f"-Wl,-rpath,{so.parent}"], check=True, capture_output=True, timeout=120)
        demo = subprocess.run([str(exe)], capture_output=True, text=True, timeout=120)
    if demo.returncode != 0 or "OK" not in demo.stdout:
        raise AssertionError(f"examples/11_capi_demo.c: rc {demo.returncode}\n{demo.stdout}\n"
                             f"{demo.stderr}")
    phase("71 c api", f"{so.name} built and loaded in {build_s:.2f} s; modulators against the "
          f"port's on {dev}, max|Δ| {json.dumps(errs)} (<= {CAPI_IQ_ATOL}); the C demodulators "
          f"read the card's BPSK/QPSK/LoRa IQ back, the card's LoRa demodulator reads the C IQ "
          f"back; FFT of 4096 complex128 against torch.fft.fft on the card, max|Δ|/max "
          f"{fft_rel:.3g} (<= {CAPI_FFT_REL}); chirps max|Δ| {chirp_err:.3g}; the C demo "
          f"compiled against the port's header and printed {demo.stdout.strip().splitlines()[-1]!r}")
    return {"build_s": build_s, "iq_err": errs, "fft_rel": fft_rel}


def check_sandbox(dev: torch.device) -> dict:
    """Phase 72: the sandbox in this process, which has initialised CUDA:
    its levels and address space; L1, L2, L3 (seccomp, a 256 MB memory
    limit) and L7 each run the mesh's packet round trip and return it; a
    child that touches the card comes back as an error within its timeout;
    the parent's card still launches the dechirp kernel afterwards."""
    levels = sandbox.available_levels()
    vm = sandbox._address_space()
    want = _mesh_packet_roundtrip()
    results = {}
    for level in (1, 2, 3, 7):
        box = sandbox.Sandbox(sandbox.IsolationLevel(level), timeout_s=SANDBOX_TIMEOUT_S,
                              memory_limit_mb=SANDBOX_MEMORY_MB)
        t0 = time.perf_counter()
        res = box.run(_mesh_packet_roundtrip)
        results[level] = {"ok": res.ok and res.value == want, "isolation": list(res.isolation),
                          "seconds": time.perf_counter() - t0, "error": res.error}
    box = sandbox.Sandbox(sandbox.IsolationLevel.L3_SECCOMP, timeout_s=SANDBOX_TIMEOUT_S,
                          memory_limit_mb=SANDBOX_MEMORY_MB)
    t0 = time.perf_counter()
    res = box.run(_touch_card)
    card_child_s = time.perf_counter() - t0
    card_child = {"ok": res.ok, "error": (res.error or "").strip().splitlines()[-1:],
                  "exit_code": res.exit_code}
    params = lora.LoRaParams(sf=7)
    gen = torch.Generator(device=dev).manual_seed(72)
    x = randn_iq((64, params.chips_per_symbol), gen)
    down = chirp.base_downchirp(params, dev)
    before = dechirp_power.launches
    _, rel = rel_err(dechirp_power_cuda(x, down), dechirp_power(x, down))
    parent_ok = dechirp_power.launches == before + 1 and rel < REL_TOL
    phase("72 sandbox", f"after CUDA's initialisation: levels {[int(v) for v in levels]}, VmSize "
          f"{vm / 2**30:.2f} GiB; the mesh packet round trip at L1/L2/L3/L7: "
          f"{json.dumps(results)}; a child touching the card: {json.dumps(card_child)} in "
          f"{card_child_s:.2f} s (timeout {SANDBOX_TIMEOUT_S} s); the parent's card afterwards: "
          f"one dechirp launch, max|Δ|/max {rel:.3g}")
    if not all(r["ok"] for r in results.values()):
        raise AssertionError(f"the sandbox levels: {results}")
    if card_child["ok"] or not res.error or card_child_s >= SANDBOX_TIMEOUT_S:
        raise AssertionError(f"a child touching the card: {card_child}, {card_child_s:.2f} s")
    if not parent_ok:
        raise AssertionError(f"the parent's card after the sandbox: rel {rel}")
    return {"vm_bytes": vm, "levels": [int(v) for v in levels], "results": results}


def check_viz(dev: torch.device) -> None:
    """Phase 73: the figures' data for one LoRa-SF7 burst (the survey's
    255-byte packet) on the card against the CPU within 1e-4 dB: the Welch
    spectrum and the waterfall. Drawing needs matplotlib."""
    payload = remote_gates.gate_payload()
    burst = create_waveform("LoRa-SF7", remote_gates.RATE_HZ, dev).modulate(payload)
    f_card, spec_card = viz._spectrum_db(burst, remote_gates.RATE_HZ)
    f_cpu, spec_cpu = viz._spectrum_db(burst.cpu(), remote_gates.RATE_HZ)
    fall_card, fall_cpu = viz._waterfall_db(burst), viz._waterfall_db(burst.cpu())
    d_spec = float(np.max(np.abs(spec_card - spec_cpu)))
    d_fall = float(np.max(np.abs(fall_card - fall_cpu)))
    drawn = ("drawing not run: matplotlib is not installed"
             if importlib.util.find_spec("matplotlib") is None else "matplotlib present")
    phase("73 viz", f"a {burst.shape[-1]}-sample LoRa-SF7 burst on {dev}: spectrum "
          f"{spec_card.shape} max|Δ| {d_spec:.3g} dB, waterfall {fall_card.shape} max|Δ| "
          f"{d_fall:.3g} dB against the CPU (<= {VIZ_DB_TOL}); {drawn}")
    if not (np.array_equal(f_card, f_cpu) and fall_card.shape == fall_cpu.shape
            and d_spec <= VIZ_DB_TOL and d_fall <= VIZ_DB_TOL):
        raise AssertionError(f"viz card vs CPU: spectrum {d_spec}, waterfall {d_fall}")


def drive_multi_device(dev: torch.device, refs: "CpuReferences") -> dict:
    """Phase 74: the multi-device layer at world size 1 under NCCL (the
    card's machine has one card). `dryrun_multichip(1)`'s five patterns in a
    process of their own on the card and again on the CPU under gloo (the
    background process's run): the
    mean BER equal, PRN index 3 the strongest with the peaks within 1e-5,
    the same Doppler bin, no pipeline errors, the composites within 1e-4 of
    each other; then `parallel.ber_sweep(mesh=make_mesh(("dp",)))` at the
    LoRa sweep's SF7 size (512 lanes × 12 SNRs) in this process, with the
    counts set to 0 just before it and read just after (the dechirp kernel),
    equal to the unsharded sweep on the same draws. World size 1 shows the
    collectives' correctness, not their scaling."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    card = dryrun_multichip(1, dev)
    card_s = time.perf_counter() - t0
    cpu = refs.get(("dryrun",))
    cpu_s = cpu["wall_s"]
    peaks_card, peaks_cpu = np.asarray(card["prn_peaks"]), np.asarray(cpu["prn_peaks"])
    peak_rel = float(np.max(np.abs(peaks_card - peaks_cpu)) / np.max(peaks_cpu))
    comp_card = np.asarray(card["composite"]["re"]) + 1j * np.asarray(card["composite"]["im"])
    comp_cpu = np.asarray(cpu["composite"]["re"]) + 1j * np.asarray(cpu["composite"]["im"])
    comp_err = float(np.max(np.abs(comp_card - comp_cpu)))
    scale = float(np.max(np.abs(comp_cpu)))
    agree = {"mean_ber": card["mean_ber"] == cpu["mean_ber"],
             "prn": int(np.argmax(peaks_card)) == int(np.argmax(peaks_cpu)) == 3
             and peak_rel <= DRYRUN_PEAK_REL_TOL,
             "doppler": card["doppler"]["best"] == cpu["doppler"]["best"],
             "pipeline": card["pp_errs"] == cpu["pp_errs"] == [0],
             "composite": comp_err <= COMPOSITE_REL_TOL * max(scale, 1.0)}
    phase("74 multi-device dryrun", f"on {dev} ({parallel.backend_for(dev)}, a process of its "
          f"own, {card_s:.2f} s; "
          f"patterns {json.dumps({k: round(v, 4) for k, v in card['seconds'].items()})} s) and "
          f"on the CPU (gloo, {cpu_s:.2f} s): mean BER {card['mean_ber']} / {cpu['mean_ber']}, "
          f"PRN peaks within {peak_rel:.3g} of each other (<= {DRYRUN_PEAK_REL_TOL}), Doppler "
          f"{card['doppler']['best']} / {cpu['doppler']['best']} Hz, pipeline errors "
          f"{card['pp_errs']}, composites {comp_err:.3g} apart at scale {scale:.3g}; agree "
          f"{json.dumps(agree)}")
    if not all(agree.values()):
        raise AssertionError(f"dryrun_multichip(1): card against CPU {agree}")
    params = lora.LoRaParams(sf=7)
    payload = (torch.arange(SWEEP_PAYLOAD_BYTES, dtype=torch.int32, device=dev)
               % params.chips_per_symbol)
    ber_fn = functools.partial(lora.loopback_ber, params)
    lanes = sweep_lanes(7)
    mesh = parallel.make_mesh(("dp",), device=dev)
    try:
        backend, world = torch.distributed.get_backend(), mesh.size()
        zero_launch_counts()
        t0 = time.perf_counter()
        sharded = parallel.ber_sweep(ber_fn, payload, SWEEP_SNRS_DB, n_lanes=lanes,
                                     seed=MULTI_SWEEP_SEED, mesh=mesh)
        torch.cuda.synchronize()
        sharded_s = time.perf_counter() - t0
        counts = fm_counts()
        t0 = time.perf_counter()
        plain = parallel.ber_sweep(ber_fn, payload, SWEEP_SNRS_DB, n_lanes=lanes,
                                   seed=MULTI_SWEEP_SEED)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        equal = torch.equal(sharded, plain)
    finally:
        torch.distributed.destroy_process_group()
    seconds = time.perf_counter() - t_phase
    phase("74 multi-device sweep", f"ber_sweep over a {backend} mesh of {world} on {dev}: "
          f"{lanes} lanes × {len(SWEEP_SNRS_DB)} SNRs of {SWEEP_PAYLOAD_BYTES} bytes at SF7 in "
          f"{sharded_s:.3f} s (unsharded {plain_s:.3f} s, first runs, the host's clock); equal to "
          f"the unsharded sweep {equal}; BER {[round(float(b), 6) for b in sharded.cpu()]}; "
          f"launches {json.dumps(counts)}; phase {seconds:.1f} s")
    if not equal or backend != parallel.backend_for(dev) or counts["dechirp_power"] < 1:
        raise AssertionError(f"the sharded sweep: equal {equal}, backend {backend}, {counts}")
    return {"launches": counts, "seconds": seconds, "dryrun_card_s": card_s,
            "dryrun_cpu_s": cpu_s, "sweep_s": sharded_s}


def _http_json(url: str, body=None, timeout: float = 300.0):
    """One request to the explorer: GET without `body`, else POST of `body`
    (bytes, or an object sent as JSON); the JSON answer."""
    data = None if body is None else body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _no_error(label: str, answer) -> None:
    """An explorer answer carries no error: the handler turns an exception
    into an "error" key and the stream pump into stats.pump_error."""
    if isinstance(answer, dict) and ("error" in answer
                                     or "pump_error" in answer.get("stats", {})):
        raise AssertionError(f"the explorer's {label} answered {answer}")


def _stream_rows(url: str, want_rows: int) -> dict:
    """Poll the live stream until `want_rows` rows exist; the last answer."""
    deadline = time.perf_counter() + STREAM_WAIT_S
    while True:
        out = _http_json(url + "/api/stream/rows?since=0")
        _no_error("stream rows", out)
        if out["next"] >= want_rows or time.perf_counter() > deadline:
            return out
        time.sleep(0.05)


def drive_explorer(dev: torch.device, refs: "CpuReferences") -> dict:
    """Phase 75: the port's explorer served on 127.0.0.1 at an ephemeral port
    on the card, every JSON answer free of "error" and "pump_error": the page,
    the waveforms, the 523-block catalog and the FIR blocks' schemas; phase 65's
    block graph at the 255-byte LoRa-SF7 burst through /api/pipeline with the
    counts set to 0 just before it and read just after (dechirp, FIR and
    recursion), its report against the CPU's (`compare_reports`: power
    within 0.01 dB, previews within 1e-4); the sky view for both presets at
    0 and 300 s against the CPU's; the live stream (fs 250 kHz, FFT 256, a
    QPSK burst of 32 reps) with the waterfall computed on the card, its rows
    against the CPU's waterfall of the same burst within the JSON's 0.1 dB
    rounding; an agent's start_tx with target "stream" through /api/remote;
    and the demo round of LoRa-SF12 with the 255-byte payload over the nine
    channel models (counts set to 0 before, read after), card = CPU. The
    drawing of the demo's PNGs needs matplotlib and is not run here."""
    from r4w_tpu_torch.agent import AgentServer

    t_phase = time.perf_counter()
    httpd = explorer.serve(port=0, background=True, device=dev)
    url = "http://%s:%d" % httpd.server_address[:2]
    cpu = refs.get(("explorer",))
    try:
        with urllib.request.urlopen(url + "/", timeout=60) as r:
            page = r.read()
        names = _http_json(url + "/api/waveforms")
        blocks = _http_json(url + "/api/blocks")
        schemas = _http_json(url + "/api/blocks?schema=1&q=fir")
        if not (b"r4w-tpu explorer" in page and names == list_waveforms() and len(blocks) == 523
                and schemas and all("schema" in row for row in schemas)):
            raise AssertionError(f"the explorer's catalog: {len(names)} waveforms, "
                                 f"{len(blocks)} blocks, {len(schemas)} schema rows")
        phase("75 explorer", f"{url} on {dev}: page {len(page)} bytes, {len(names)} waveforms, "
              f"{len(blocks)} blocks, {len(schemas)} FIR blocks with schemas")

        zero_launch_counts()
        t0 = time.perf_counter()
        report = _http_json(url + "/api/pipeline", {"nodes": remote_gates.graph_nodes(),
                                                    "seed": 0})
        pipeline_s = time.perf_counter() - t0
        pipeline_counts = fm_counts()
        _no_error("pipeline", report)
        verdict = remote_gates.compare_reports(report, cpu["pipeline"])
        errors = {k: v["error"] for k, v in report["nodes"].items() if "error" in v}
        phase("75 explorer pipeline", f"the block graph at the 255-byte LoRa-SF7 burst in "
              f"{pipeline_s:.3f} s (first, over HTTP): order {report['order']}, rx decoded "
              f"{report['nodes']['rx'].get('decoded_ok')}, node errors {json.dumps(errors)}; "
              f"against the CPU: equal {verdict['equal']}, worst power |Δ| "
              f"{verdict['worst_power_db']:.3g} dB (< {remote_gates.POWER_TOL_DB}), worst preview "
              f"|Δ| {verdict['worst_preview']:.3g} (< {remote_gates.PREVIEW_TOL}); launches "
              f"{json.dumps(pipeline_counts)}")
        missing = [k for k in GRAPH_LAUNCHES if pipeline_counts[k] < 1]
        if not verdict["equal"] or missing or errors != remote_gates.GRAPH_ERRORS \
                or report["nodes"]["rx"].get("decoded_ok") is not True:
            raise AssertionError(f"the explorer's pipeline: {verdict['diffs']}, launches "
                                 f"{pipeline_counts}, errors {errors}")

        for preset in ("e1c_8prn", "gps_l1ca_6sv"):
            for t in (0, 300):
                sky = _http_json(url + f"/api/gnss_sky?preset={preset}&t={t}")
                _no_error("sky view", sky)
                if sky != json.loads(json.dumps(explorer.gnss_sky(preset, t, device="cpu"))):
                    raise AssertionError(f"the sky view {preset} at {t} s differs from the CPU's")
        phase("75 explorer sky", "both presets at 0 and 300 s equal the CPU's")

        start = _http_json(url + "/api/stream/start", {"fs": STREAM_FS, "fft": STREAM_FFT})
        _no_error("stream start", start)
        try:
            t0 = time.perf_counter()
            tx = _http_json(url + "/api/stream/tx", {"name": "QPSK", "hex": "CAFE1234",
                                                     "snr": 15, "reps": STREAM_REPS})
            _no_error("stream tx", tx)
            want_rows = tx["samples"] // (16 * STREAM_FFT) * 16
            rows = _stream_rows(url, want_rows)
            stream_s = time.perf_counter() - t0
        finally:
            stopped = _http_json(url + "/api/stream/stop", {})
        burst = explorer.stream_burst("QPSK", "CAFE1234", 15.0, STREAM_REPS, STREAM_FS, "cpu")
        frames = Waterfall(STREAM_FS, STREAM_FFT, hop=STREAM_FFT).compute(
            torch.from_numpy(burst[: rows["next"] * STREAM_FFT]))
        got = np.asarray(rows["rows"])
        want = np.round(frames[rows["next"] - len(got):], 1)
        row_err = float(np.max(np.abs(got - want))) if got.shape == want.shape else math.inf
        phase("75 explorer stream", f"a {tx['samples']}-sample QPSK burst in {tx['packets']} "
              f"packets: {rows['next']} rows of {STREAM_FFT} bins (want {want_rows}) in "
              f"{stream_s:.3f} s, stats {json.dumps(rows['stats'])}; the last {len(got)} rows "
              f"against the CPU's waterfall of the burst: max|Δ| {row_err:.3g} dB (<= "
              f"{STREAM_ROW_TOL_DB}); stopped {stopped}")
        if rows["next"] != want_rows or not row_err <= STREAM_ROW_TOL_DB \
                or stopped != {"stopped": True}:
            raise AssertionError(f"the live stream: {rows['next']} rows, max|Δ| {row_err}")

        agent = AgentServer(port=0, device=dev)
        agent.serve_in_thread()
        try:
            a = {"agent_host": "127.0.0.1", "agent_port": agent.port}
            pong = _http_json(url + "/api/remote", {**a, "command": "ping"})
            _http_json(url + "/api/stream/start", {"fs": 125000.0, "fft": 128})
            try:
                sent = _http_json(url + "/api/remote", {
                    **a, "command": "start_tx", "target": "stream", "waveform": "QPSK",
                    "message": "remote lab", "repeat": True, "pps": 50})
                remote_rows = _stream_rows(url, 16)
                halted = _http_json(url + "/api/remote", {**a, "command": "stop_tx"})
            finally:
                _http_json(url + "/api/stream/stop", {})
        finally:
            agent._running = False
            agent.join_tx(5.0)
        phase("75 explorer remote", f"agent ping {pong.get('response')}, start_tx -> stream "
              f"{json.dumps(sent)}, {remote_rows['next']} rows, stats "
              f"{json.dumps(remote_rows['stats'])}, stop_tx {halted.get('response')}")
        if (pong.get("response"), sent.get("response"), halted.get("response")) \
                != ("pong", "ok", "ok") or remote_rows["next"] < 16:
            raise AssertionError(f"the remote lab through the explorer: {pong}, {sent}, "
                                 f"{halted}, {remote_rows['next']} rows")
    finally:
        httpd.shutdown()
        httpd.server_close()

    zero_launch_counts()
    t0 = time.perf_counter()
    demo = frontend_gates.demo_rounds(dev)
    demo_s = time.perf_counter() - t0
    demo_counts = fm_counts()
    verdict = frontend_gates.compare_demo(demo, cpu["demo"])
    phase("75 explorer demo", f"LoRa-SF12, the 255-byte payload, over the nine channel models "
          f"on {dev} in {demo_s:.2f} s (first; the CPU's in the background process): decoded "
          f"{json.dumps({m: r['metrics']['decoded_ok'] for m, r in demo.items()})}; against "
          f"the CPU equal {verdict['equal']}, worst spectrum |Δ| {verdict['worst_db']:.3g} dB "
          f"(<= {frontend_gates.DEMO_DB_TOL}), worst waterfall |Δ amplitude| / max "
          f"{verdict['worst_waterfall_rel']:.3g} (<= {frontend_gates.DEMO_WATERFALL_REL_TOL}; in "
          f"dB {verdict['worst_waterfall_db']:.3g}, at a sidelobe's rounding), worst float metric "
          f"{verdict['worst_rel']:.3g} relative; launches {json.dumps(demo_counts)}; "
          f"{verdict['diffs'][:4]}")
    if not verdict["equal"] or demo_counts["dechirp_power"] < 1:
        raise AssertionError(f"the demo rounds: {verdict['diffs']}, launches {demo_counts}")
    prof = breakdown(lambda: explorer.demo_round(frontend_gates.DEMO_WAVEFORM,
                                                 frontend_gates.PAYLOAD_HEX, channel="awgn",
                                                 device=dev))
    phase("75 explorer demo profile", f"one warm LoRa-SF12 awgn round: {prof['device_events']} "
          f"launches, busy {prof['busy_ms']:.3f} ms of a {prof['span_ms']:.3f} ms span, idle "
          f"share {prof['idle_share']:.4f}; largest {json.dumps(prof['top_ms'])}")
    seconds = time.perf_counter() - t_phase
    phase("75 explorer seconds", f"{seconds:.1f} s")
    return {"pipeline_launches": pipeline_counts, "demo_launches": demo_counts,
            "seconds": seconds, "pipeline_s": pipeline_s, "demo_s": demo_s, "profile": prof}


def drive_cli(dev: torch.device, refs: "CpuReferences") -> dict:
    """Phase 76: the port's command line in-process through `cli.main` with
    the default device (the card), at a 255-byte LoRa payload: `simulate`
    of LoRa-SF12 over the nine channel models and of LoRa-SF7, the 2 s
    `benchmark`, a six-waveform `compare`, files through tx/rx, analyze,
    record/playback, convert, and the other subcommands
    (`frontend_gates.cli_runs`), with the counts set to 0 just before them
    and read just after (dechirp by the LoRa commands, both Viterbi kernels
    by `compare`); then once ``python -m r4w_tpu_torch simulate`` in a
    process of its own. Every printed line equal to the CPU's run of the
    same commands (the background process), but the lines
    `frontend_gates.compare_cli` names. The subcommands that need PyYAML or
    matplotlib are listed as not run."""
    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="r4w_cli_card_")
    frontend_gates.prepare_inputs(workdir)
    runs = frontend_gates.cli_runs(workdir)
    marks = []
    zero_launch_counts()
    t0 = time.perf_counter()
    card = frontend_gates.run_cli_set(runs, dev, workdir,
                                      on_run=lambda label: marks.append((label, fm_counts())))
    cli_s = time.perf_counter() - t0
    total = fm_counts()
    ends = [c for _, c in marks[1:]] + [total]
    per_run = {}
    for (label, before), after in zip(marks, ends):
        moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        if moved:
            per_run[label] = moved
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "r4w_tpu_torch", "simulate", "-w", "LoRa-SF7",
                           "--hex", frontend_gates.PAYLOAD_HEX], capture_output=True, text=True,
                          timeout=PYTHON_M_TIMEOUT_S, cwd=Path(__file__).resolve().parent)
    python_m_s = time.perf_counter() - t0
    cpu = refs.get(("cli",))
    verdict = frontend_gates.compare_cli(card, cpu, runs, workdir, cpu["workdir"])
    python_m_equal = (proc.returncode == 0
                      and proc.stdout.splitlines() == cpu["simulate LoRa-SF7"]["lines"])
    bench = frontend_gates.benchmark_numbers(card["benchmark"]["lines"])
    for label, _, _ in runs:
        phase("76 cli", f"{label}: exit {card[label]['code'] if not isinstance(card[label]['code'], str) else 'message'} "
              f"in {card[label]['seconds']:.3f} s; {' | '.join(card[label]['lines'][:3])[:200]}")
    phase("76 cli launches", f"{len(runs)} commands on {dev} in {cli_s:.2f} s: launches "
          f"{json.dumps(total)}; by command {json.dumps(per_run)}")
    phase("76 cli benchmark", f"LoRa-SF7, 255 bytes, 2 s on {dev}: "
          f"{bench['msamples_per_s']} Msamples/s, {bench['iterations']} demodulations, latency "
          f"avg {bench['avg_ms']} ms, p99 {bench['p99_ms']} ms (the host's clock)")
    phase("76 cli python -m", f"python -m r4w_tpu_torch simulate -w LoRa-SF7 (a process of its "
          f"own on the card) in {python_m_s:.2f} s: exit {proc.returncode}, lines equal to the "
          f"CPU's {python_m_equal}; {' | '.join(proc.stdout.splitlines()[-2:])}")
    phase("76 cli not run", "; ".join(f"{k}: {v}" for k, v in frontend_gates.CLI_NOT_RUN.items()))
    simulate = ["simulate", "-w", "LoRa-SF12", "--hex", frontend_gates.PAYLOAD_HEX]
    prof = breakdown(lambda: frontend_gates.run_cli(simulate, dev))
    wf = create_waveform("LoRa-SF7", 125_000.0, dev)
    burst = wf.modulate(bytes(range(255)))
    # one demodulation alone (~40 launches) can record no device events
    prof_demod = breakdown(lambda: [wf.demodulate(burst) for _ in range(PROFILED_BATCHES)])
    for label, p in (("simulate LoRa-SF12 awgn", prof),
                     (f"{PROFILED_BATCHES} of the benchmark's demodulations", prof_demod)):
        phase("76 cli profile", f"warm, {label}: {p['device_events']} launches, busy "
              f"{p['busy_ms']:.3f} ms of a {p['span_ms']:.3f} ms span, idle share "
              f"{p['idle_share']:.4f}; largest {json.dumps(p['top_ms'])}")
    seconds = time.perf_counter() - t_phase
    phase("76 cli against cpu", f"every command's lines against the CPU's: equal "
          f"{verdict['equal']}; files within {verdict['worst_file']:.3g} (<= "
          f"{frontend_gates.FILE_TOL}); {json.dumps(verdict['diffs'])[:1500]}; phase "
          f"{seconds:.1f} s")
    if not (verdict["equal"] and python_m_equal):
        raise AssertionError(f"the CLI on the card against the CPU: {verdict['diffs']}, "
                             f"python -m {proc.returncode} {proc.stderr[-2000:]}")
    if total["dechirp_power"] < 1 or total["viterbi_forward"] < 1 \
            or total["viterbi_traceback"] < 1:
        raise AssertionError(f"the CLI launched {total}")
    return {"launches": total, "per_run": per_run, "seconds": seconds, "cli_s": cli_s,
            "benchmark": bench, "python_m_s": python_m_s, "profile": prof,
            "profile_demod": prof_demod}


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
    # the CPU runs of phases 37, 68 and 70, computed meanwhile in a process of their own
    refs = CpuReferences()
    # A register array indexed by a value the compiler cannot fold goes to
    # local memory; the traceback's step and the FIR's register window must
    # not touch it.
    for name, (path, _) in built.items():
        ops = local_memory_ops(path)
        used = {k: v for k, v in ops.items() if v}
        phase("2 sass", f"{path.name}: {len(ops)} kernels; LDL/STL instructions: "
              f"{json.dumps(used) if used else 'none'}")
        if name in SASS_GUARDS:
            kernel, instances = SASS_GUARDS[name]
            found = {k: v for k, v in ops.items() if kernel in k}
            if len(found) != instances or any(found.values()):
                raise AssertionError(f"want {instances} {kernel} instances with no LDL/STL in "
                                     f"the SASS, got {found}")
            phase("2 sass", f"{kernel}: {len(found)} instances, no LDL/STL in any")

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
    check_dechirp_ragged(dev)

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
        # the yardstick: the cuFFT transform alone, on rows already dechirped
        mixed = x * down
        library = cuda_ms(lambda: torch.fft.fft(mixed, dim=-1))
        timings[sf] = {"rows": rows, "k": k, "abs_err": abs_err, "rel_err": rel,
                       "ms": sum(kern) / 2, "plain_ms": sum(plain) / 2, "library_ms": library}
        phase("3 timing", f"SF{sf} sweep shape ({rows}, {k}): kernel "
              f"{kern[0]:.4f}/{kern[1]:.4f} ms, plain cuFFT path {plain[0]:.4f}/"
              f"{plain[1]:.4f} ms, cuFFT transform only (torch.fft.fft) {library:.4f} ms per "
              f"call (mean of {TIMED_LAUNCHES}); max|Δ| {abs_err:.4g}, /max(ref) {rel:.3g}")
        del x, mixed

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

    fir_timing = check_fir_kernel(dev)
    nco_timing = check_nco_kernel(dev)

    # The DDC path starts here: only its launches count.
    zero_launch_counts()
    drive_ddc_path(dev)

    # 15. The DDC path went through both kernels.
    fir_launches, nco_launches = fir.fir_decimate.launches, nco.nco_mix.launches
    if fir_launches <= 0 or nco_launches <= 0:
        raise AssertionError(f"the DDC path launched fir_decimate {fir_launches}, nco_mix "
                             f"{nco_launches} times")
    phase("15 launches", f"fir_decimate kernel launched {fir_launches} times, nco_mix "
          f"{nco_launches} times in phase 14")

    check_card_against_cpu(dev)

    # The GPS receiver starts here. Its path has no hand-written kernel (its
    # grid, tracking loop and composite are torch operations); the counts
    # must stay at zero through it.
    zero_launch_counts()
    drive_gps_path(dev)
    counts = kernel_counts()
    if any(counts.values()):
        raise AssertionError(f"the GPS path launched a hand-written kernel: {counts}")
    phase("17 launches", f"the GPS path launched no hand-written kernel: {json.dumps(counts)}")
    check_gnss_card_against_cpu(dev)
    time_gnss_paths(dev)

    # The Galileo, joint and GLONASS receivers, each with the counts set to 0
    # just before it and read just after: the I/NAV decodes launch both Viterbi
    # kernels once per channel, GLONASS none.
    gal_run = drive_galileo_path(dev)
    dual_run = drive_dual_path(dev)
    drive_glonass_path(dev)
    inav_timing = check_e1b_card_against_cpu(dev, gal_run, dual_run)

    # The link round trips, each path with the counts set to 0 just before it
    # and read just after: LoRa packets (the dechirp kernel in the preamble
    # search and the demodulation), the BER gate (no hand-written kernel),
    # STANAG 4285 and HARQ (both Viterbi kernels), the gcorr bench (none).
    packet_run = drive_packet_path(dev)
    sync_timing = time_sync_windows(dev, packet_run["window_shapes"])
    drive_ber_gate(dev)
    stanag_run = drive_stanag_harq(dev)
    stanag_timing = time_stanag_viterbi(stanag_run["steps"])
    time_gcorr(dev)
    check_link_card_against_cpu(dev)

    # The waveform fleet, each path with the counts set to 0 just before it and
    # read just after: the device sweep (the dechirp kernel in the LoRa names,
    # both Viterbi kernels in MIL-STD-188-110 and STANAG 4285), the noisy
    # gate, and SINCGARS data (both Viterbi kernels once, 29 frames as lanes).
    sweep_run = drive_device_sweep(dev)
    gate_run = drive_noisy_gate(dev)
    sincgars_timing = drive_sincgars_data(dev)

    # The channel models and the FEC codecs, each path with the counts set to
    # 0 just before it and read just after: the fading gate (the dechirp
    # kernel in LoRa-SF7's case), the coded-link gate (both Viterbi kernels,
    # by the convolutional gate and TCM), the DVB-S2X bench (none).
    check_channel_card_against_cpu(dev)
    fading_run = drive_fading_gate(dev)
    coded_run = drive_coded_gate(dev)
    drive_dvb_bench(dev)

    # Synchronisation, equalisation and AGC: every function of the slice card
    # against CPU, then the composed receiver gate with the counts set to 0
    # just before each run and read just after (the FIR kernel twice, each
    # Viterbi kernel once), then the three kernels at the gate's shapes.
    check_slice_card_against_cpu(dev)
    receiver_run = drive_receiver_gate(dev, refs)
    receiver_timing = time_receiver_kernels(dev)

    # The modem family: every function card against CPU with the packet's
    # convolutional decode (each Viterbi kernel once), then the broadcast FM
    # receiver at 1 s and 60 s with the counts set to 0 just before each and
    # read just after (fir_decimate 9, first_order_iir 1), then the recursion
    # kernel and the FIR at the FM path's shapes.
    packet_timing = drive_family_gate(dev)
    fm_run = drive_fm_broadcast(dev)
    fm_timing = time_recursion_and_fm_fir(dev)

    # The stream and detection slice: every block card against CPU, then the
    # wideband spectrum monitor at full width with the counts set to 0 just
    # before it and read just after (nco_mix 4, fir_decimate 4,
    # first_order_iir 3), then each recursion kind against its plain version.
    drive_blocks_gate(dev)
    monitor_run = drive_spectrum_monitor(dev)
    kind_timing = check_recursion_kinds(dev)

    # Radar, arrays and propagation: every block card against CPU (the FIR
    # kernel under cfar_1d), then the digital-array pulse-Doppler radar at a
    # full CPI with the counts set to 0 just before it and read just after
    # (no hand-written kernel on its path), then the static 2-ray case.
    blocks_run = drive_array_blocks_gate(dev)
    radar_run = drive_radar_gate(dev)
    drive_two_ray_case(dev, fading_run)

    # Spectrum analysis, cognitive radio, instruments and sensing: every block
    # card against CPU, then the DSA sensing cycle at full width with the
    # counts set to 0 just before it and read just after (nco_mix and
    # fir_decimate once a down-converted channel, fir_decimate twice more for
    # the self-check), then the two kernels at the cycle's DDC shape.
    sensing_run = drive_sensing_blocks_gate(dev)
    access_run = drive_spectrum_access(dev)
    access_timing = time_access_kernels(dev)

    # Packets, protocols, ADS-B, audio and applied: every block card against
    # CPU, then the NBFM dispatch monitor at full width with the counts set to
    # 0 just before it and read just after (nco_mix 8, fir_decimate 11,
    # first_order_iir 1), then the three kernels at the monitor's shapes.
    protocol_run = drive_protocol_blocks_gate(dev)
    dispatch_run = drive_dispatch_monitor(dev)
    dispatch_timing = time_dispatch_kernels(dev, dispatch_run)
    del dispatch_run["inputs"]

    # Navigation, biomedical, the infrastructure fills, timing and waveform
    # specs: every block card against CPU, then the frequency-hopping 16-QAM
    # link with DPD over TCP at full width with the counts set to 0 just
    # before it and read just after (nco_mix one launch a channel in the
    # transmitter and a channel of each block in each receiver, fir_decimate
    # two a block), then the two kernels at the link's shapes.
    infra_run = drive_infra_blocks_gate(dev)
    hop_run = drive_hopping_link(dev)
    hop_timing = time_hop_kernels(dev, hop_run)
    del hop_run["inputs"]

    # The Galileo E1C pilot chain and the host layer's data plane: the 8-SV
    # pilot gate at full width with the counts set to 0 just before it and
    # read just after (each Viterbi kernel once an SV), warm, profiled and
    # card against CPU; the 30.72 MS/s RF scene through the loopback SDR into
    # a triggered SigMF capture and its replay (fir_decimate twice), warm and
    # card against CPU; the Viterbi kernels at the E1C I/NAV shape.
    e1c_run = drive_e1c_gate(dev)
    check_e1c_card_against_cpu(dev, e1c_run)
    scene_run = drive_rf_scene(dev, refs)
    e1c_timing = time_e1c_viterbi(dev, e1c_run)

    # The block registry, the block-graph pipeline and the remote-lab host
    # layer: the native runtime built from the checkout; the remote lab
    # (agent -> UDP -> native receiver -> demodulation on the card) and the
    # pipeline wizard's graph, each with the counts set to 0 just before it
    # and read just after (dechirp once a batch; dechirp, first_order_iir and
    # fir_decimate in the graph); the registry, schedule, accelerator and
    # plugin on the card; the three kernels at the gates' shapes.
    build_native_runtime()
    lab_run = drive_remote_lab(dev)
    graph_run = drive_block_graph(dev)
    check_host_layer(dev)
    host_timing = time_host_layer_kernels(dev, lab_run, graph_run)
    host_launches = {name: {"launches_remote_lab_gate": lab_run["launches"][name],
                            "launches_block_graph_gate": graph_run["launches"][name]}
                     for name in lab_run["launches"]}

    # The LoRa mesh, the C API, the sandbox and the figures: every registry
    # block on the card against the CPU (the counts set to 0 just before the
    # card's survey and read just after); the 16-node LongFast mesh over the
    # LoRa PHY on the card with the counts set to 0 just before it and read
    # just after (dechirp once a round), warm, profiled, against the CPU, and
    # dechirp at its SF11 shape; the C API, the sandbox under CUDA, the
    # figures' data.
    survey_run = drive_registry_survey(dev, refs)
    mesh_run = drive_mesh_gate(dev)
    mesh_check = check_mesh_card_against_cpu(dev, mesh_run, refs)
    check_capi(dev)
    check_sandbox(dev)
    check_viz(dev)
    for name in host_launches:
        host_launches[name]["launches_registry_survey"] = survey_run["launches"][name]
        host_launches[name]["launches_mesh_gate"] = mesh_run["launches"][name]

    # The command line, the explorer and the multi-device layer, each part
    # with the counts set to 0 just before it and read just after: the
    # sharded LoRa sweep over an NCCL mesh of one card (dechirp) and the
    # dry run's five patterns; the explorer's pipeline (dechirp, recursion,
    # FIR) and demo rounds (dechirp) on the card; the CLI's commands
    # (dechirp by the LoRa commands, both Viterbi kernels by compare).
    multi_run = drive_multi_device(dev, refs)
    explorer_run = drive_explorer(dev, refs)
    cli_run = drive_cli(dev, refs)
    refs.close()
    for name in host_launches:
        host_launches[name]["launches_multi_device_sweep"] = multi_run["launches"][name]
        host_launches[name]["launches_explorer_pipeline"] = \
            explorer_run["pipeline_launches"][name]
        host_launches[name]["launches_explorer_demo"] = explorer_run["demo_launches"][name]
        host_launches[name]["launches_cli"] = cli_run["launches"][name]

    t7 = timings[7]
    bound7, by7 = dechirp_bound(t7["rows"], t7["k"])
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
        "library_ms": t7["library_ms"],
        "library": "cuFFT transform only: torch.fft.fft on the pre-dechirped rows",
        "shape": [t7["rows"], t7["k"]],
        "max_rel_err": max(t["rel_err"] for t in timings.values()),
        "ms_sf12": timings[12]["ms"],
        "plain_ms_sf12": timings[12]["plain_ms"],
        "bound_ms_sf12": dechirp_bound(timings[12]["rows"], timings[12]["k"])[0],
        "library_ms_sf12": timings[12]["library_ms"],
        "launches_packet_sync": packet_run["launches"]["sync"],
        "launches_packet_demod": packet_run["launches"]["demodulation"],
        "launches_fleet_sweep": sweep_run["launches"]["dechirp_power"],
        "launches_noisy_gate": gate_run["launches"]["dechirp_power"],
        "launches_fading_gate": fading_run["launches"]["dechirp_power"],
        "launches_radar_gate": radar_run["launches"]["dechirp_power"],
        "launches_sensing_blocks_gate": sensing_run["launches"]["dechirp_power"],
        "launches_access_gate": access_run["launches"]["dechirp_power"],
        "launches_protocol_blocks_gate": protocol_run["launches"]["dechirp_power"],
        "launches_dispatch_gate": dispatch_run["launches"]["dechirp_power"],
        "launches_infra_blocks_gate": infra_run["launches"]["dechirp_power"],
        "launches_hop_gate": hop_run["launches"]["dechirp_power"],
        "launches_e1c_gate": e1c_run["launches"]["dechirp_power"],
        "launches_rf_scene_gate": scene_run["launches"]["dechirp_power"],
        **{f"{key}_sync_sf{sf}": value for sf, row in sync_timing.items()
           for key, value in row.items()},
        **host_launches["dechirp_power"],
        **host_timing["dechirp_power"],
        **mesh_check["dechirp_power"],
    }]
    for name, line, count in (("viterbi_forward", 403, fwd), ("viterbi_traceback", 479, tb)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "r4w_tpu_torch/csrc/viterbi.cu",
            "replaces": f"r4w_tpu/kernels/pallas_kernels.py:{line}",
            "launches": count,
            **viterbi_timing[name],
            **inav_timing[name],
            **stanag_timing[name],
            "launches_stanag_harq": stanag_run["launches" if name == "viterbi_forward"
                                               else "launches_traceback"],
            **sincgars_timing[name],
            "launches_fleet_sweep": sweep_run["launches"][name],
            "launches_noisy_gate": gate_run["launches"][name],
            "launches_coded_gate": coded_run["launches"][name],
            **coded_run["timing"][name],
            "launches_receiver_gate": receiver_run["packet"]["launches"][name],
            **receiver_timing[name],
            **packet_timing[name],
            "launches_radar_gate": radar_run["launches"][name],
            "launches_sensing_blocks_gate": sensing_run["launches"][name],
            "launches_access_gate": access_run["launches"][name],
            "launches_protocol_blocks_gate": protocol_run["launches"][name],
            "launches_dispatch_gate": dispatch_run["launches"][name],
            "launches_infra_blocks_gate": infra_run["launches"][name],
            "launches_hop_gate": hop_run["launches"][name],
            **e1c_timing[name],
            "launches_rf_scene_gate": scene_run["launches"][name],
            **host_launches[name],
            "library_ms": None,
            "library_ms_receiver": None,
            "library_ms_packet": None,
        })
    kernels.append({
        "name": "fir_decimate",
        "route": "cuda",
        "source": "r4w_tpu_torch/csrc/fir_decimate.cu",
        "replaces": "r4w_tpu/kernels/pallas_kernels.py:185",
        "launches": fir_launches,
        **fir_timing,
        "launches_receiver_gate": receiver_run["packet"]["launches"]["fir_decimate"],
        **receiver_timing["fir_decimate"],
        "launches_fm_gate": fm_run["60 s"]["launches"]["fir_decimate"],
        "launches_fm_gate_1s": fm_run["1 s"]["launches"]["fir_decimate"],
        **fm_timing["fir_decimate"],
        "launches_monitor_gate": monitor_run["launches"]["fir_decimate"],
        **monitor_run["timing"]["fir_decimate"],
        "launches_array_blocks_gate": blocks_run["launches"]["fir_decimate"],
        **blocks_run["timing"],
        "launches_radar_gate": radar_run["launches"]["fir_decimate"],
        "launches_sensing_blocks_gate": sensing_run["launches"]["fir_decimate"],
        "launches_access_gate": access_run["launches"]["fir_decimate"],
        **access_timing["fir_decimate"],
        "launches_protocol_blocks_gate": protocol_run["launches"]["fir_decimate"],
        "launches_dispatch_gate": dispatch_run["launches"]["fir_decimate"],
        **dispatch_timing["fir_decimate"],
        "launches_infra_blocks_gate": infra_run["launches"]["fir_decimate"],
        "launches_hop_gate": hop_run["launches"]["fir_decimate"],
        "launches_hop_gate_by_stage": {k: v["fir_decimate"] for k, v in
                                       hop_run["launches_by_stage"].items()},
        **hop_timing["fir_decimate"],
        "launches_e1c_gate": e1c_run["launches"]["fir_decimate"],
        "launches_rf_scene_gate": scene_run["launches"]["fir_decimate"],
        **scene_run["timing"],
        **host_launches["fir_decimate"],
        **host_timing["fir_decimate"],
    })
    kernels.append({
        "name": "nco_mix",
        "route": "cuda",
        "source": "r4w_tpu_torch/csrc/nco_mix.cu",
        "replaces": "r4w_tpu/kernels/pallas_kernels.py:244",
        "launches": nco_launches,
        **nco_timing,
        "library_ms": None,
        "launches_monitor_gate": monitor_run["launches"]["nco_mix"],
        **monitor_run["timing"]["nco_mix"],
        "launches_radar_gate": radar_run["launches"]["nco_mix"],
        "launches_sensing_blocks_gate": sensing_run["launches"]["nco_mix"],
        "launches_access_gate": access_run["launches"]["nco_mix"],
        **access_timing["nco_mix"],
        "launches_protocol_blocks_gate": protocol_run["launches"]["nco_mix"],
        "launches_dispatch_gate": dispatch_run["launches"]["nco_mix"],
        **dispatch_timing["nco_mix"],
        "launches_infra_blocks_gate": infra_run["launches"]["nco_mix"],
        "launches_hop_gate": hop_run["launches"]["nco_mix"],
        "launches_hop_gate_by_stage": {k: v["nco_mix"] for k, v in
                                       hop_run["launches_by_stage"].items()},
        **hop_timing["nco_mix"],
        "launches_e1c_gate": e1c_run["launches"]["nco_mix"],
        "launches_rf_scene_gate": scene_run["launches"]["nco_mix"],
        **host_launches["nco_mix"],
    })
    kernels.append({
        "name": "first_order_iir",
        "route": "cuda",
        "source": "r4w_tpu_torch/csrc/first_order_iir.cu",
        "replaces": None,
        "stands_for": RECURSION_STANDS_FOR,
        "launches": fm_run["60 s"]["launches"]["first_order_iir"],
        "launches_fm_gate_1s": fm_run["1 s"]["launches"]["first_order_iir"],
        **fm_timing["first_order_iir"],
        "launches_monitor_gate": monitor_run["launches"]["first_order_iir"],
        "launches_monitor_by_kind": monitor_run["by_kind"],
        "kinds": kind_timing,
        "launches_radar_gate": radar_run["launches"]["first_order_iir"],
        "launches_sensing_blocks_gate": sensing_run["launches"]["first_order_iir"],
        "launches_access_gate": access_run["launches"]["first_order_iir"],
        "launches_protocol_blocks_gate": protocol_run["launches"]["first_order_iir"],
        "launches_dispatch_gate": dispatch_run["launches"]["first_order_iir"],
        **dispatch_timing["first_order_iir"],
        "launches_infra_blocks_gate": infra_run["launches"]["first_order_iir"],
        "launches_hop_gate": hop_run["launches"]["first_order_iir"],
        "launches_e1c_gate": e1c_run["launches"]["first_order_iir"],
        "launches_rf_scene_gate": scene_run["launches"]["first_order_iir"],
        **host_launches["first_order_iir"],
        **host_timing["first_order_iir"],
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
