"""Remaining infrastructure fills + named aliases.

PyTorch counterpart of ``r4w_tpu.ops.infra_fills``:

* IO plumbing — file_source_sink.rs, file_descriptor_source_sink.rs,
  tcp_source_sink.rs, socket_pdu.rs, stream_control.rs,
  signal_recorder_indexed.rs. This is the reference's host code as it is.
  Sinks take tensors on any device (or numpy arrays) and copy them to the
  host; sources return a tensor on `device`, the card unless named.
* Frequency hopping as standalone blocks — frequency_hopper.rs,
  frequency_hopping.rs, frequency_hopping_controller.rs (the FHSS
  waveform in waveforms/fhss.py is the full modem; these are the
  GNU-Radio-style hop-control blocks). The LFSR pattern is the
  reference's (`spreading.lfsr_bits`, words LSB first, the modulo's bias
  kept); the schedule is host numpy that returns int32, float32 and bool
  tensors.
* speech_enhancement_beamforming.rs — delay-and-sum + spectral
  postfilter composition.
* Digital predistortion: the indirect-learning fit and the polynomial's
  application, its terms summed from zero in ascending order. The fit's
  columns y·|y|^(2k) take the reference's |·| (`core.hostio.complex_abs`)
  and its repeated squaring (`sync._integer_pow`); the ridge-regularised
  normal equations are the reference's float32 ones
  (`core.linalg.complex_lstsq`). At order 7 the columns reach |y|⁶ and
  those equations have a condition number near 2·10⁴, so two summation
  orders part in the coefficients: by 3.2e-4 between the card and the CPU
  on the hopping gate's burst, and by up to ~1% between the port and the
  reference, moving the transmit EVM that follows by 0.02 and up to 0.2 dB.
* simd_utils.rs — batched complex kernels so pipelines can name them.
  `rotator_apply` runs on the NCO kernel (`kernels.nco.nco_rotate_dispatch`,
  one launch a call): its phase φ₀ + Δ·n is the NCO's float32 rule with
  ω = float32(Δ), along the last axis (the reference ramps along axis 0,
  the same axis for its 1-D streams); leading axes are rows, each ramp
  starting at φ₀.
* Named aliases (same math already shipped elsewhere):
  cross_ambiguity_function.rs → ops/ew.cross_ambiguity,
  fmcw_radar.rs → waveforms FMCW, iq_balance.rs →
  ops/impairments.iq_imbalance_correct, linear_equalizer.rs →
  ops/equalizers LMS, ml_sequence_detector.rs → ops/equalizers MLSE,
  noise_reduction.rs → ops/applied.spectral_subtraction,
  phase_noise_model.rs → ops/impairments.phase_noise (the port's
  signature: ``phase_noise(x, linewidth_hz, sample_rate, *, key)``),
  power_amplifier_dpd.rs → the DPD pair here,
  tapped_delay_line.rs → channel/tdl.tdl_channel.
"""

from __future__ import annotations

import os
import socket
import struct

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import complex_abs
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, to_tensor
from r4w_tpu_torch.kernels.nco import nco_rotate_dispatch
from r4w_tpu_torch.ops.packets import _host


def _tensor(data: np.ndarray, device) -> torch.Tensor:
    """Host data as a tensor on `device` (the card unless named)."""
    return to_tensor(np.array(data, copy=True), device=device)


# ------------------------------------------------------------ file IO


def file_sink(path: str, x, mode: str = "wb"):
    """Raw sample file sink (file_source_sink.rs)."""
    arr = _host(x)
    with open(path, mode) as f:
        arr.tofile(f)
    return arr.shape[0]


def file_source(path: str, dtype=np.complex64, count: int = -1,
                offset_items: int = 0, device=None):
    """Raw sample file source (file_source_sink.rs)."""
    dt = np.dtype(dtype)
    with open(path, "rb") as f:
        f.seek(offset_items * dt.itemsize)
        data = np.fromfile(f, dtype=dt, count=count)
    return _tensor(data, device)


def fd_sink(fd: int, x):
    """File-descriptor sink (file_descriptor_source_sink.rs)."""
    data = _host(x).tobytes()
    written = 0
    while written < len(data):
        written += os.write(fd, data[written:])
    return written


def fd_source(fd: int, n_items: int, dtype=np.complex64, device=None):
    """File-descriptor source (file_descriptor_source_sink.rs)."""
    dt = np.dtype(dtype)
    want = n_items * dt.itemsize
    chunks = []
    got = 0
    while got < want:
        b = os.read(fd, want - got)
        if not b:
            break
        chunks.append(b)
        got += len(b)
    return _tensor(np.frombuffer(b"".join(chunks), dtype=dt), device)


class TcpSink:
    """Length-prefixed TCP sample sink (tcp_source_sink.rs)."""

    def __init__(self, host: str, port: int):
        self.sock = socket.create_connection((host, port), timeout=10)

    def send(self, x):
        data = _host(x).astype(np.complex64).tobytes()
        self.sock.sendall(struct.pack(">I", len(data)) + data)

    def close(self):
        self.sock.close()


class TcpSource:
    """Accepting side of the TCP sample link (tcp_source_sink.rs)."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        self.server = socket.socket()
        self.server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.server.bind((host, port))
        self.server.listen(1)
        self.conn = None

    @property
    def port(self) -> int:
        return self.server.getsockname()[1]

    def accept(self):
        self.conn, _ = self.server.accept()

    def recv(self, device=None):
        hdr = self._recv_exact(4)
        n = struct.unpack(">I", hdr)[0]
        data = self._recv_exact(n)
        return to_tensor(np.frombuffer(data, np.complex64), device=device)

    def _recv_exact(self, n: int) -> bytearray:
        out = bytearray(n)
        view = memoryview(out)
        got = 0
        while got < n:
            k = self.conn.recv_into(view[got:], n - got)
            if not k:
                raise ConnectionError("peer closed")
            got += k
        return out

    def close(self):
        if self.conn:
            self.conn.close()
        self.server.close()


def socket_pdu_pair():
    """Connected UDP PDU socket pair (socket_pdu.rs): returns
    (send(bytes), recv()->bytes, close)."""
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(5.0)
    port = rx.getsockname()[1]
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def send(data: bytes):
        tx.sendto(data, ("127.0.0.1", port))

    def recv() -> bytes:
        return rx.recvfrom(65536)[0]

    def close():
        tx.close()
        rx.close()

    return send, recv, close


class StreamControl:
    """Run/pause/single-step gate over a block pipeline
    (stream_control.rs)."""

    def __init__(self):
        self.state = "running"
        self._steps = 0

    def pause(self):
        self.state = "paused"

    def resume(self):
        self.state = "running"

    def single_step(self):
        self.state = "paused"
        self._steps += 1

    def process(self, x):
        if self.state == "running":
            return x
        if self._steps > 0:
            self._steps -= 1
            return x
        return to_tensor(x)[0:0]


class IndexedRecorder:
    """Indexed IQ recorder (signal_recorder_indexed.rs): appends
    blocks to a data file and keeps an in-memory (offset, n, meta)
    index for random access."""

    def __init__(self, path: str):
        self.path = path
        self.index: list[tuple[int, int, dict]] = []
        self._off = 0
        open(path, "wb").close()

    def record(self, x, **meta):
        arr = _host(x).astype(np.complex64)
        with open(self.path, "ab") as f:
            arr.tofile(f)
        self.index.append((self._off, arr.shape[0], meta))
        self._off += arr.shape[0]
        return len(self.index) - 1

    def read(self, entry: int, device=None):
        off, n, meta = self.index[entry]
        dt = np.dtype(np.complex64)
        with open(self.path, "rb") as f:
            f.seek(off * dt.itemsize)
            data = np.fromfile(f, dtype=dt, count=n)
        return _tensor(data, device), meta

    def find(self, **query):
        return [i for i, (_, _, m) in enumerate(self.index)
                if all(m.get(k) == v for k, v in query.items())]


# ----------------------------------------------------- frequency hop


def hop_pattern_lfsr(n_channels: int, n_hops: int, seed: int = 0x5A, device=None):
    """LFSR-driven pseudo-random hop pattern (frequency_hopper.rs):
    full-range, repeats only after the LFSR period."""
    from r4w_tpu_torch.ops import spreading as _spreading
    bits_needed = max(1, int(np.ceil(np.log2(n_channels))))
    bits = np.asarray(_spreading.lfsr_bits(
        16, 0b1000000000010110, seed, n_hops * bits_needed))
    words = bits.reshape(n_hops, bits_needed)
    vals = words @ (1 << np.arange(bits_needed))
    return to_tensor((vals % n_channels).astype(np.int32), device=device)


def hop_frequencies(pattern, base_hz: float, spacing_hz: float):
    """Channel index → RF frequency (frequency_hopping.rs)."""
    return base_hz + to_tensor(pattern, REAL_DTYPE) * spacing_hz


class FrequencyHoppingController:
    """Sample-indexed hop scheduling (frequency_hopping_controller.rs):
    dwell/guard timing and the channel active at any sample index —
    the deterministic (not wall-clock) form. Its answers are tensors on
    `device` (the card unless named)."""

    def __init__(self, pattern, dwell_samples: int,
                 guard_samples: int = 0, device=None):
        self.pattern = _host(pattern)
        self.dwell = int(dwell_samples)
        self.guard = int(guard_samples)
        self.period = self.dwell + self.guard
        self.device = device

    def channel_at(self, sample_idx):
        idx = _host(sample_idx) // self.period
        return to_tensor(self.pattern[idx % self.pattern.shape[0]].astype(np.int32),
                         device=self.device)

    def in_guard(self, sample_idx):
        return to_tensor((_host(sample_idx) % self.period) >= self.dwell,
                         device=self.device)

    def hop_boundaries(self, n_samples: int):
        return to_tensor(np.arange(0, n_samples, self.period, dtype=np.int32),
                         device=self.device)


# ----------------------------------------------- speech beamforming


def speech_enhance_beamform(mics, delays, fs: float,
                            noise_frames: int = 6):
    """Delay-and-sum + spectral-subtraction postfilter
    (speech_enhancement_beamforming.rs): array gain first, then the
    single-channel restoration pass."""
    from r4w_tpu_torch.ops.audio import voice_restore
    from r4w_tpu_torch.ops.beamforming import delay_and_sum
    das = delay_and_sum(to_tensor(mics, REAL_DTYPE), delays)
    return voice_restore(das, fs, noise_frames=noise_frames)


# -------------------------------------------------------------- DPD


def _envelope_powers(z: torch.Tensor, terms: int) -> list:
    """[|z|^(2k) for k < terms]: |z| as the reference computes it, each
    power by repeated squaring; None for k = 0 (the factor 1)."""
    from r4w_tpu_torch.ops.sync import _integer_pow
    r = complex_abs(z)
    return [None] + [_integer_pow(r, 2 * k) for k in range(1, terms)]


def dpd_learn_polynomial(pa_in, pa_out, order: int = 5):
    """Indirect-learning digital predistortion
    (power_amplifier_dpd.rs / digital_predistortion.rs): fit the PA
    post-inverse y→x with an odd-order memoryless polynomial
    Σ c_k y|y|^{2k}; the same coefficients applied PRE-PA linearize
    the chain. Returns (coef, gain) as tensors on the samples' device;
    the least squares is core.linalg.complex_lstsq."""
    from r4w_tpu_torch.core.linalg import complex_lstsq

    x = to_tensor(pa_in, IQ_DTYPE).reshape(-1)
    y = to_tensor(pa_out, IQ_DTYPE, device=x.device).reshape(-1)
    # normalize the gain so the polynomial fits shape, not scale
    g = torch.vdot(y, x) / torch.vdot(y, y)
    y = y * g
    powers = _envelope_powers(y, (order + 1) // 2)
    cols = [y if p is None else y * p for p in powers]
    a = torch.stack(cols, dim=-1)
    coef = complex_lstsq(a, x)
    return coef.to(IQ_DTYPE), g


def dpd_apply(x, coef):
    """Apply the learned predistortion polynomial before the PA."""
    z = to_tensor(x, IQ_DTYPE)
    c = to_tensor(coef, IQ_DTYPE, device=z.device)
    out = torch.zeros_like(z)
    for k, p in enumerate(_envelope_powers(z, c.shape[0])):
        term = c[k] * z
        out = out + (term if p is None else term * p)
    return out


# ----------------------------------------------------------- simd ops


def cmul(a, b):
    """Batched complex multiply (simd_utils.rs — this exists so pipelines
    can name it)."""
    a = to_tensor(a, IQ_DTYPE)
    return a * to_tensor(b, IQ_DTYPE, device=a.device)


def cmac(acc, a, b):
    """Complex multiply-accumulate (simd_utils.rs)."""
    acc = to_tensor(acc, IQ_DTYPE)
    return acc + cmul(to_tensor(a, IQ_DTYPE, device=acc.device), b)


def rotator_apply(x, phase_inc: float, phase0: float = 0.0):
    """Phase rotator (simd_utils.rs / rotator role): e^{j(φ0+nΔ)}·x along
    the last axis of x (..., n), each row from φ0; one NCO launch."""
    return nco_rotate_dispatch(to_tensor(x, IQ_DTYPE), float(phase_inc), float(phase0))


BLOCKS = {
    "file_sink": ("file_sink", "sink",
                  "raw sample file sink (file_source_sink.rs)"),
    "file_source": ("file_source", "source",
                    "raw sample file source (file_source_sink.rs)",
                    ("dtype", "count")),
    "fd_sink": ("fd_sink", "sink",
                "file-descriptor sink "
                "(file_descriptor_source_sink.rs)"),
    "fd_source": ("fd_source", "source",
                  "file-descriptor source "
                  "(file_descriptor_source_sink.rs)"),
    "tcp_sink": ("TcpSink", "sink",
                 "length-prefixed TCP sink (tcp_source_sink.rs)",
                 ("host", "port")),
    "tcp_source": ("TcpSource", "source",
                   "TCP sample source (tcp_source_sink.rs)", ("port",)),
    "socket_pdu": ("socket_pdu_pair", "source",
                   "UDP PDU socket pair (socket_pdu.rs)"),
    "stream_control": ("StreamControl", "math",
                       "run/pause/step gate (stream_control.rs)"),
    "signal_recorder_indexed": ("IndexedRecorder", "sink",
                                "indexed IQ recorder "
                                "(signal_recorder_indexed.rs)",
                                ("path",)),
    "frequency_hopper": ("hop_pattern_lfsr", "source",
                         "LFSR hop pattern (frequency_hopper.rs)",
                         ("n_channels", "n_hops")),
    "frequency_hopping": ("hop_frequencies", "math",
                          "channel -> RF map (frequency_hopping.rs)",
                          ("base_hz", "spacing_hz")),
    "frequency_hopping_controller": (
        "FrequencyHoppingController", "sync",
        "sample-indexed hop schedule "
        "(frequency_hopping_controller.rs)",
        ("dwell_samples", "guard_samples")),
    "speech_enhancement_beamforming": (
        "speech_enhance_beamform", "filter",
        "DAS + spectral postfilter "
        "(speech_enhancement_beamforming.rs)", ("fs",)),
    "dpd_learn": ("dpd_learn_polynomial", "filter",
                  "indirect-learning DPD fit "
                  "(power_amplifier_dpd.rs)", ("order",)),
    "dpd_apply": ("dpd_apply", "filter",
                  "apply predistortion polynomial "
                  "(digital_predistortion.rs)"),
    "simd_cmul": ("cmul", "math",
                  "batched complex multiply (simd_utils.rs)"),
    "simd_cmac": ("cmac", "math",
                  "complex multiply-accumulate (simd_utils.rs)"),
    "rotator": ("rotator_apply", "math",
                "phase rotator (simd_utils.rs rotator role)",
                ("phase_inc",)),
}


def alias_blocks():
    """Named aliases for capabilities shipped in other modules —
    registered so a reference user finds every block by its name.
    Returns name -> (factory, category, description)."""
    from r4w_tpu_torch.channel import tdl as _tdl
    from r4w_tpu_torch.ops import applied, equalizers, ew, impairments
    from r4w_tpu_torch.waveforms import create_waveform
    return {
        "cross_ambiguity_function": (
            lambda **k: ew.cross_ambiguity, "radar",
            "CAF surface (cross_ambiguity_function.rs -> "
            "ops/ew.cross_ambiguity)"),
        "fmcw_radar": (
            lambda **k: create_waveform("fmcw",
                                        k.get("sample_rate", 1e6),
                                        k.get("device")),
            "radar",
            "FMCW waveform (fmcw_radar.rs -> create_waveform('fmcw'))"),
        "iq_balance": (
            lambda **k: impairments.iq_imbalance_correct, "filter",
            "IQ balance correction (iq_balance.rs -> "
            "impairments.iq_imbalance_correct)"),
        "linear_equalizer": (
            lambda **k: equalizers.lms_equalize, "filter",
            "adaptive linear equalizer (linear_equalizer.rs -> "
            "ops/equalizers.lms_equalize)"),
        "ml_sequence_detector": (
            lambda **k: equalizers.mlse_equalize, "demodulator",
            "MLSE (ml_sequence_detector.rs -> "
            "ops/equalizers.mlse_equalize)"),
        "noise_reduction": (
            lambda **k: applied.spectral_subtraction, "filter",
            "spectral subtraction (noise_reduction.rs -> "
            "ops/applied.spectral_subtraction)"),
        "phase_noise_model": (
            lambda **k: impairments.phase_noise, "channel",
            "Wiener phase noise (phase_noise_model.rs -> "
            "impairments.phase_noise)"),
        "power_amplifier_dpd": (
            lambda **k: (dpd_learn_polynomial, dpd_apply), "filter",
            "indirect-learning DPD (power_amplifier_dpd.rs / "
            "digital_predistortion.rs)"),
        "tapped_delay_line": (
            lambda **k: _tdl.tdl_channel, "channel",
            "TDL fading core (tapped_delay_line.rs -> "
            "channel/tdl.tdl_channel)"),
    }
