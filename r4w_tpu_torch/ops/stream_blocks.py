"""Stream plumbing and scalar-math blocks: the GNU-Radio utility tail.

PyTorch counterpart of ``r4w_tpu.ops.stream_blocks`` (probe.rs,
probe_avg_mag_sqrd.rs, probe_power.rs, probe_rate.rs, probe_density.rs,
peak_detector.rs, peak_hold.rs, plateau_detector.rs, sample_and_hold.rs,
sample_counter.rs, integrate_and_dump.rs, keep_m_in_n.rs,
moving_avg_decim.rs, stretch.rs, mute.rs, power_squelch.rs,
envelope_detector.rs, random_source.rs, signal_source.rs,
signal_generator.rs, null_sink_source.rs, vector_sink.rs,
vector_insert.rs, throttle.rs, endian_swap.rs, bitwise_ops.rs,
numeric_conversions.rs, float_to_complex.rs, magnitude_squared.rs,
nlog10.rs, log_blk.rs, max_blk.rs, exponentiate.rs, transcendental.rs,
phase_ops.rs, phase_shift.rs, phase_unwrap.rs, frequency_shift.rs,
rf_mixer.rs, multiply_matrix.rs, matrix_eigenvalue.rs, check_lfsr.rs,
stream_switch.rs, stream_to_streams.rs, stream_byte_converter.rs).
Samples are on the last axis, leading axes a batch.

The recursions run on `kernels.recurrence.first_order_recurrence_dispatch`,
one launch of the Hopper kernel a call on the card for every row at once:
the probes and the squelch (kind ``ema``), the envelope detector
(``attack_release``) and the peak hold (``peak_hold``). Where the reference
scans a 1-D stream with one carried state, the port carries one state per
leading row; on a 1-D stream it equals the reference. The plateau
detector's run counter and the sample-and-hold are the parallel
`events.latest_set`. The random source draws the reference's own
threefry bits (`channel.threefry`). `VectorSink`, `Throttle` and
`probe_rate` are host-side, as in the reference.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from r4w_tpu_torch.channel import threefry
from r4w_tpu_torch.core.hostio import cis, magnitude
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, real_scalar, resolve_device, to_tensor
from r4w_tpu_torch.kernels.nco import nco_mix_dispatch
from r4w_tpu_torch.kernels.recurrence import first_order_recurrence_dispatch, initial_state
from r4w_tpu_torch.ops import filters as _filters
from r4w_tpu_torch.ops.events import latest_set
from r4w_tpu_torch.ops.sync import _integer_pow


def _recursion(u: torch.Tensor, kind: str, c0: float, c1: float = 0.0, state=0.0):
    """(series, final) of one recursion launch over u's last axis from
    `state` (one per leading row)."""
    y0 = initial_state(u, state)
    series = first_order_recurrence_dispatch(u, kind, c0, c1, y0)
    final = series[..., -1] if u.shape[-1] else y0.expand(u.shape[:-1])
    return series, final


# ------------------------------------------------------------- probes


def probe_avg_mag_sqrd(x, alpha: float = 0.0001, state: float = 0.0):
    """Single-pole IIR average of |x|² (probe_avg_mag_sqrd.rs), each step
    fma(α, |x|² − avg, avg). Returns (series, final): the probe can be read
    mid-stream and chained across blocks through `state`."""
    x = to_tensor(x)
    return _recursion(magnitude(x) ** 2, "ema", alpha, state=state)


def probe_power(x) -> torch.Tensor:
    """Mean power of a block (probe_power.rs)."""
    return torch.mean(magnitude(x) ** 2)


def probe_density(bits, alpha: float = 0.01, state: float = 0.5):
    """IIR-averaged density of ones in a bit stream (probe_density.rs)."""
    return _recursion(to_tensor(bits, REAL_DTYPE), "ema", alpha, state=state)


def probe_rate(n_items: int, t0: float, t1: float) -> float:
    """Items/second between two host timestamps (probe_rate.rs)."""
    dt = max(t1 - t0, 1e-12)
    return float(n_items) / dt


# ---------------------------------------------------- peaks & plateaus


def peak_detector(x, threshold: float = 0.0, look: int = 1):
    """Boolean mask of local maxima above `threshold` (peak_detector.rs): a
    sample at least as large as its `look` neighbours on both sides."""
    x = to_tensor(x, REAL_DTYPE)
    edge = torch.full(x.shape[:-1] + (look,), -torch.inf, dtype=REAL_DTYPE, device=x.device)
    windows = torch.cat([edge, x, edge], dim=-1).unfold(-1, 2 * look + 1, 1)
    return (x >= torch.amax(windows, dim=-1)) & (x > threshold)


def peak_hold(x, decay: float = 0.999, state: float = 0.0):
    """Peak hold with exponential decay (peak_hold.rs), each step
    max(|x|, round(decay·h)). Returns (series, final)."""
    return _recursion(magnitude(x), "peak_hold", decay, state=state)


def plateau_detector(gate, min_len: int = 8):
    """Mark the END of each run of >= min_len consecutive ones
    (plateau_detector.rs: one pulse a plateau). The run counter is t minus
    the latest zero at or before t."""
    g = to_tensor(gate).to(torch.int32) != 0
    steps = torch.arange(g.shape[-1], device=g.device).expand(g.shape)
    _, last_zero = latest_set(~g, steps)
    runs = torch.where(g, steps - last_zero, 0)
    ended = torch.cat([runs[..., :-1] * (~g[..., 1:]), runs[..., -1:]], dim=-1)
    return ended >= min_len


def sample_and_hold(x, ctrl):
    """Hold the most recent sample where ctrl == 1 (sample_and_hold.rs),
    zero before the first."""
    x = to_tensor(x)
    c = to_tensor(ctrl, device=x.device).to(torch.bool)
    held, _ = latest_set(c.expand(x.shape), x)
    return held


def sample_counter(x, state: int = 0):
    """Running sample count alongside the (pass-through) stream
    (sample_counter.rs)."""
    x = to_tensor(x)
    return x, torch.as_tensor(state, dtype=torch.int32, device=x.device) + x.shape[-1]


# --------------------------------------------------- rate manipulation


def integrate_and_dump(x, length: int):
    """Sum consecutive groups of `length` samples (integrate_and_dump.rs)."""
    x = to_tensor(x)
    n = (x.shape[-1] // length) * length
    return torch.sum(x[..., :n].reshape(*x.shape[:-1], -1, length), dim=-1)


def keep_m_in_n(x, m: int, n: int, offset: int = 0):
    """Keep m samples out of every n (keep_m_in_n.rs)."""
    x = to_tensor(x)
    k = (x.shape[-1] // n) * n
    blocks = x[..., :k].reshape(*x.shape[:-1], -1, n)
    return blocks[..., offset:offset + m].reshape(*x.shape[:-1], -1)


def moving_avg_decim(x, length: int, decim: int = 1, scale: float = 1.0):
    """Moving average with built-in decimation (moving_avg_decim.rs), the
    boxcar as one FIR."""
    x = to_tensor(x)
    x = x.to(IQ_DTYPE) if x.is_complex() else x.to(REAL_DTYPE)
    kern = np.full(length, np.float32(scale / length), np.float32)
    return _filters.fir_apply(kern, x)[..., ::decim]


def stretch(x, lo: float):
    """Clamp from below: samples under `lo` are pulled up to it
    (stretch.rs)."""
    return torch.clamp(to_tensor(x, REAL_DTYPE), min=lo)


def mute(x, muted) -> torch.Tensor:
    """Zero the stream while muted (mute.rs); `muted` is a scalar or a
    per-sample gate."""
    x = to_tensor(x)
    g = 1.0 - to_tensor(muted, REAL_DTYPE, device=x.device)
    return (x * g).to(x.dtype)


def power_squelch(x, threshold_db: float, alpha: float = 0.01, state: float = 0.0):
    """Gate the stream open while the IIR-averaged power exceeds the
    threshold (power_squelch.rs). Returns (gated x, the probe's final)."""
    x = to_tensor(x)
    series, final = probe_avg_mag_sqrd(x, alpha=alpha, state=state)
    gate = (series > float(np.float32(10.0 ** (threshold_db / 10.0)))).to(REAL_DTYPE)
    return (x * gate).to(x.dtype), final


def envelope_detector(x, attack: float = 0.2, release: float = 0.001, state: float = 0.0):
    """Rectify and smooth with an asymmetric one-pole (envelope_detector.rs):
    each step fma(a, |x| − env, env), a = attack while |x| > env, else
    release. Returns (series, final)."""
    return _recursion(magnitude(x), "attack_release", attack, release, state)


# ------------------------------------------------------------ sources


def random_source(key, n: int, kind: str = "uniform_byte", device=None):
    """Seeded random stream (random_source.rs) from a `channel.threefry`
    key: the reference's own draws (bytes, bits and uniforms bit for bit,
    normals within 3e-7), made on the host and put on `device`."""
    if kind == "uniform_byte":
        values = threefry.randint(key, (n,), 0, 256)
    elif kind == "uniform":
        values = threefry.uniform(key, (n,), -1.0, 1.0)
    elif kind == "gaussian":
        values = threefry.normal(key, (n,))
    elif kind == "bits":
        values = threefry.bernoulli(key, 0.5, (n,)).astype(np.int32)
    else:
        raise ValueError(f"unknown random source kind '{kind}'")
    return to_tensor(values, device=device)


def _time_axis(n: int, sample_rate: float, device) -> torch.Tensor:
    return torch.arange(n, dtype=REAL_DTYPE, device=device) / real_scalar(sample_rate, device)


def signal_source(n: int, sample_rate: float, freq_hz: float, waveform: str = "cos",
                  amplitude: float = 1.0, offset: float = 0.0, phase: float = 0.0, device=None):
    """Classic signal source (signal_source.rs, signal_generator.rs):
    cos/sin/complex exponential/square/triangle/sawtooth/const."""
    t = _time_axis(n, sample_rate, resolve_device(device))
    arg = 2.0 * np.pi * freq_hz * t + phase
    frac = torch.remainder(arg / real_scalar(2.0 * np.pi, t.device), 1.0)
    if waveform == "cos":
        y = torch.cos(arg)
    elif waveform == "sin":
        y = torch.sin(arg)
    elif waveform in ("exp", "complex"):
        y = cis(arg)
    elif waveform == "square":
        y = torch.where(frac < 0.5, 1.0, -1.0)
    elif waveform == "triangle":
        y = 4.0 * torch.abs(frac - 0.5) - 1.0
    elif waveform == "sawtooth":
        y = 2.0 * frac - 1.0
    elif waveform == "const":
        y = torch.ones_like(t)
    else:
        raise ValueError(f"unknown waveform '{waveform}'")
    y = amplitude * y + offset
    return y.to(IQ_DTYPE if waveform in ("exp", "complex") else REAL_DTYPE)


def signal_generator_sweep(n: int, sample_rate: float, f0_hz: float, f1_hz: float,
                           amplitude: float = 1.0, device=None):
    """Linear frequency sweep source (signal_generator.rs sweep mode)."""
    t = _time_axis(n, sample_rate, resolve_device(device))
    k = (f1_hz - f0_hz) / (n / sample_rate)
    phase = 2.0 * np.pi * (f0_hz * t + 0.5 * k * t * t)
    return amplitude * cis(phase)


def null_source(n: int, dtype=IQ_DTYPE, device=None):
    """All-zero source (null_sink_source.rs)."""
    return torch.zeros((n,), dtype=dtype, device=resolve_device(device))


def null_sink(x) -> int:
    """Discard the stream; returns the number of items consumed
    (null_sink_source.rs)."""
    return int(to_tensor(x).shape[0])


class VectorSink:
    """Accumulate blocks to a host-side vector (vector_sink.rs)."""

    def __init__(self):
        self._chunks: list[np.ndarray] = []

    def process(self, x):
        self._chunks.append(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                            else np.asarray(x))
        return x

    def data(self) -> np.ndarray:
        if not self._chunks:
            return np.zeros((0,))
        return np.concatenate(self._chunks)

    def reset(self):
        self._chunks.clear()


def vector_insert(x, vec, period: int, offset: int = 0):
    """Insert `vec` into the stream every `period` input samples
    (vector_insert.rs)."""
    x = to_tensor(x)
    vec = to_tensor(vec, x.dtype, device=x.device)
    n = (x.shape[0] // period) * period
    blocks = x[:n].reshape(-1, period)
    vrep = vec.expand(blocks.shape[0], vec.shape[0])
    out = torch.cat([blocks[:, :offset], vrep, blocks[:, offset:]], dim=1)
    return torch.cat([out.reshape(-1), x[n:]])


class Throttle:
    """Host-side average-rate limiter (throttle.rs, throttle_blk.rs): sleeps
    so that the cumulative items a second do not exceed the target."""

    def __init__(self, rate_items_per_sec: float):
        self.rate = float(rate_items_per_sec)
        self._t0: float | None = None
        self._items = 0

    def process(self, x):
        n = int(x.shape[0])
        now = time.monotonic()
        if self._t0 is None:
            self._t0 = now
        self._items += n
        due = self._t0 + self._items / self.rate
        if due > now:
            time.sleep(due - now)
        return x


# ----------------------------------------------------- scalar math ops


def magnitude_squared(x):
    """|x|² (magnitude_squared.rs)."""
    x = to_tensor(x)
    if x.is_complex():
        return x.real * x.real + x.imag * x.imag
    return (x * x).to(REAL_DTYPE)


def nlog10(x, n: float = 10.0, k: float = 0.0, floor: float = 1e-20):
    """n·log10(x) + k with a numerical floor (nlog10.rs)."""
    return n * torch.log10(torch.clamp(to_tensor(x, REAL_DTYPE), min=floor)) + k


def log_block(x, base: float | None = None, floor: float = 1e-20):
    """Elementwise logarithm (log_blk.rs)."""
    y = torch.log(torch.clamp(to_tensor(x, REAL_DTYPE), min=floor))
    if base is not None:
        y = y / real_scalar(float(np.log(base)), y.device)
    return y


def max_block(*xs):
    """Elementwise max across streams (max_blk.rs)."""
    out = to_tensor(xs[0], REAL_DTYPE)
    for x in xs[1:]:
        out = torch.maximum(out, to_tensor(x, REAL_DTYPE, device=out.device))
    return out


def exponentiate(x, exponent: float):
    """x**k, keeping a complex type (exponentiate.rs); an integer k by
    repeated squaring, as the reference's ``lax.integer_pow``."""
    x = to_tensor(x)
    if isinstance(exponent, (int, np.integer)) and exponent >= 1:
        return _integer_pow(x, int(exponent))
    return torch.pow(x, exponent)


_TRANSCENDENTAL = {
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "exp": torch.exp, "log": torch.log, "sqrt": torch.sqrt,
}


def transcendental(x, name: str):
    """Apply a named transcendental function (transcendental.rs)."""
    try:
        fn = _TRANSCENDENTAL[name]
    except KeyError:
        raise ValueError(f"unknown transcendental '{name}'") from None
    return fn(to_tensor(x))


# -------------------------------------------------------- phase / mix


def phase_shift(x, phase_rad: float):
    """Constant phase rotation (phase_shift.rs, phase_ops.rs)."""
    x = to_tensor(x, IQ_DTYPE)
    return x * cis(torch.as_tensor(phase_rad, dtype=REAL_DTYPE, device=x.device))


def phase_unwrap(phase):
    """Unwrap radian phase (phase_unwrap.rs): a cumulative correction of
    the 2π jumps."""
    p = to_tensor(phase, REAL_DTYPE)
    jumps = torch.round(torch.diff(p, dim=-1) / real_scalar(2.0 * np.pi, p.device))
    corr = torch.cat([p.new_zeros(p.shape[:-1] + (1,)), torch.cumsum(jumps, dim=-1)], dim=-1)
    return p - 2.0 * np.pi * corr


def phase_wrap(phase):
    """Wrap to (-π, π] (phase_ops.rs)."""
    return torch.angle(cis(to_tensor(phase, REAL_DTYPE)))


def frequency_shift(x, shift_hz: float, sample_rate: float, phase0: float = 0.0):
    """Mix by a complex exponential (frequency_shift.rs). Returns (shifted,
    the next block's phase0) so that blocks chain continuously."""
    x = to_tensor(x, IQ_DTYPE)
    n = x.shape[-1]
    w = 2.0 * np.pi * shift_hz / sample_rate
    return nco_mix_dispatch(x, shift_hz, sample_rate, phase0), (phase0 + w * n) % (2.0 * np.pi)


def rf_mixer(x, lo, mode: str = "complex"):
    """Mixer (rf_mixer.rs): a complex multiply, or real mixing that makes
    the sum and difference products."""
    x = to_tensor(x)
    lo = to_tensor(lo, device=x.device)
    if mode == "complex":
        return x.to(IQ_DTYPE) * lo.to(IQ_DTYPE)
    if mode == "real":
        return ((x.real if x.is_complex() else x) * (lo.real if lo.is_complex() else lo)).to(
            REAL_DTYPE)
    raise ValueError(f"unknown mixer mode '{mode}'")


# ---------------------------------------------------- vectors/matrices


def multiply_matrix(x, a):
    """Per-sample matrix multiply y = A @ x (multiply_matrix.rs); x is a
    (..., K) stream of K-vectors, a is (M, K)."""
    x = to_tensor(x)
    return torch.einsum("mk,...k->...m", to_tensor(a, x.dtype, device=x.device), x)


def matrix_eigenvalue(a, hermitian: bool = True, iters: int = 200):
    """Dominant eigenpair (matrix_eigenvalue.rs): `eigh` for a Hermitian
    matrix, else `iters` steps of power iteration."""
    a = to_tensor(a)
    if hermitian:
        w, v = torch.linalg.eigh(a)
        return w[-1], v[:, -1]
    v = torch.ones(a.shape[0], dtype=a.dtype, device=a.device) / np.sqrt(a.shape[0])
    for _ in range(iters):
        v = a @ v
        v = v / torch.linalg.vector_norm(v)
    lam = (torch.conj(v) @ (a @ v)) / (torch.conj(v) @ v)
    return lam, v


# ----------------------------------------------------------- bit utils


def endian_swap(words, word_bits: int = 16):
    """Byte-swap within words (endian_swap.rs), as int64 holding the
    reference's uint32 values."""
    w = to_tensor(words).to(torch.int64) & 0xFFFFFFFF
    if word_bits == 16:
        return ((w & 0xFF) << 8) | ((w >> 8) & 0xFF)
    if word_bits == 32:
        return (((w & 0xFF) << 24) | ((w & 0xFF00) << 8) | ((w >> 8) & 0xFF00)
                | ((w >> 24) & 0xFF))
    raise ValueError("word_bits must be 16 or 32")


def bitwise_op(x, y, op: str):
    """Elementwise and/or/xor/not on integer streams (bitwise_ops.rs)."""
    x = to_tensor(x, torch.int32)
    if op == "not":
        return ~x
    y = to_tensor(y, torch.int32, device=x.device)
    if op == "and":
        return x & y
    if op == "or":
        return x | y
    if op == "xor":
        return x ^ y
    raise ValueError(f"unknown bitwise op '{op}'")


def short_to_float(x, scale: float = 32768.0):
    """int16 -> float32 (numeric_conversions.rs)."""
    x = to_tensor(x, REAL_DTYPE)
    return x / real_scalar(scale, x.device)


def float_to_short(x, scale: float = 32768.0):
    return torch.clamp(to_tensor(x, REAL_DTYPE) * scale, -32768, 32767).to(torch.int16)


def float_to_complex(re, im=None):
    """Two real streams -> one complex stream (float_to_complex.rs)."""
    re = to_tensor(re, REAL_DTYPE)
    im = torch.zeros_like(re) if im is None else to_tensor(im, REAL_DTYPE, device=re.device)
    return torch.complex(re, im)


def repack_bits(bits, k_in: int, k_out: int, msb_first: bool = True):
    """Repack k_in-bit symbols into k_out-bit symbols
    (stream_byte_converter.rs)."""
    b = to_tensor(bits, torch.int32)
    shifts = torch.arange(k_in, dtype=torch.int32, device=b.device)
    if msb_first:
        shifts = shifts.flip(0)
    raw = ((b[:, None] >> shifts[None, :]) & 1).reshape(-1)
    n = (raw.shape[0] // k_out) * k_out
    groups = raw[:n].reshape(-1, k_out)
    weights = torch.arange(k_out, dtype=torch.int32, device=b.device)
    if msb_first:
        weights = weights.flip(0)
    return torch.sum(groups << weights[None, :], dim=-1, dtype=torch.int32)


def check_lfsr(bits, taps: int, nbits: int, sync_len: int = 64):
    """Self-synchronizing PRBS checker (check_lfsr.rs): seed the register
    from the first `nbits` received bits, then count the bits that differ
    from the register's prediction. Returns (errors, tested).

    The register before bit i holds the `nbits` bits received before it
    (bit p of the state is bit i-1-p), so each prediction is the XOR of the
    received bits at the tap positions: a fixed XOR chain over the static
    taps, for every bit at once. Registers of 31 bits and more take the
    reference's host path."""
    if nbits >= 31:
        b = np.asarray(bits).astype(np.int64)
        state = 0
        for i in range(nbits):
            state = ((state << 1) | int(b[i])) & ((1 << nbits) - 1)
        errors = 0
        for i in range(nbits, len(b)):
            fb = bin(state & taps).count("1") & 1
            errors += int(fb != b[i])
            state = ((state << 1) | int(b[i])) & ((1 << nbits) - 1)
        return errors, len(b) - nbits
    b = to_tensor(bits).to(torch.int32)
    n = b.shape[0]
    fb = torch.zeros(max(n - nbits, 0), dtype=torch.int32, device=b.device)
    for p in range(nbits):
        if (taps >> p) & 1:
            fb = fb ^ b[nbits - 1 - p:n - 1 - p]
    errors = torch.sum((fb != b[nbits:]).to(torch.int32), dtype=torch.int32)
    return errors, n - nbits


# ---------------------------------------------------- stream selection


def stream_switch(streams, select: int):
    """Select one of N streams (stream_switch.rs)."""
    return torch.stack([to_tensor(s) for s in streams])[select]


def stream_to_streams(x, n: int):
    """Deinterleave one stream into n (stream_to_streams.rs)."""
    x = to_tensor(x)
    k = (x.shape[0] // n) * n
    return x[:k].reshape(-1, n).T


def streams_to_stream(xs):
    """Interleave n streams into one (the inverse of stream_to_streams)."""
    stack = torch.stack([to_tensor(s) for s in xs])  # (n, L)
    return stack.T.reshape(-1)


# The reference's block table, as it is: name -> (attr, category,
# description, params).
BLOCKS = {
    "probe_avg_mag_sqrd": ("probe_avg_mag_sqrd", "measurement",
                           "IIR |x|^2 probe (probe_avg_mag_sqrd.rs)",
                           ("alpha",)),
    "probe_power": ("probe_power", "measurement",
                    "block mean power (probe_power.rs)"),
    "probe_density": ("probe_density", "measurement",
                      "IIR ones-density probe (probe_density.rs)",
                      ("alpha",)),
    "probe_rate": ("probe_rate", "measurement",
                   "items/sec between host timestamps (probe_rate.rs)"),
    "peak_detector": ("peak_detector", "measurement",
                      "local-maxima detector (peak_detector.rs)",
                      ("threshold", "look")),
    "peak_hold": ("peak_hold", "measurement",
                  "decaying peak hold (peak_hold.rs)", ("decay",)),
    "plateau_detector": ("plateau_detector", "measurement",
                         "plateau end pulses (plateau_detector.rs)",
                         ("min_len",)),
    "sample_and_hold": ("sample_and_hold", "math",
                        "gated sample & hold (sample_and_hold.rs)"),
    "sample_counter": ("sample_counter", "math",
                       "running item counter (sample_counter.rs)"),
    "integrate_and_dump": ("integrate_and_dump", "math",
                           "block integrate & dump (integrate_and_dump.rs)",
                           ("length",)),
    "keep_m_in_n": ("keep_m_in_n", "math",
                    "keep m of every n samples (keep_m_in_n.rs)",
                    ("m", "n", "offset")),
    "moving_avg_decim": ("moving_avg_decim", "filter",
                         "moving average + decimate (moving_avg_decim.rs)",
                         ("length", "decim")),
    "stretch": ("stretch", "math", "dynamic-range floor (stretch.rs)",
                ("lo",)),
    "mute": ("mute", "math", "stream mute gate (mute.rs)"),
    "power_squelch": ("power_squelch", "sync",
                      "power-gated squelch (power_squelch.rs)",
                      ("threshold_db", "alpha")),
    "envelope_detector": ("envelope_detector", "demodulator",
                          "attack/release envelope (envelope_detector.rs)",
                          ("attack", "release")),
    "random_source": ("random_source", "source",
                      "seeded random stream (random_source.rs)", ("kind",)),
    "signal_source": ("signal_source", "source",
                      "tone/square/triangle source (signal_source.rs)",
                      ("sample_rate", "freq_hz", "waveform")),
    "signal_generator_sweep": ("signal_generator_sweep", "source",
                               "linear sweep source (signal_generator.rs)",
                               ("f0_hz", "f1_hz")),
    "null_source": ("null_source", "source",
                    "all-zero source (null_sink_source.rs)"),
    "null_sink": ("null_sink", "sink",
                  "discard sink (null_sink_source.rs)"),
    "vector_sink": ("VectorSink", "sink",
                    "host-side accumulator (vector_sink.rs)"),
    "vector_insert": ("vector_insert", "math",
                      "periodic vector insertion (vector_insert.rs)",
                      ("period", "offset")),
    "throttle": ("Throttle", "sink",
                 "host rate limiter (throttle.rs)", ("rate",)),
    "magnitude_squared": ("magnitude_squared", "math",
                          "|x|^2 (magnitude_squared.rs)"),
    "nlog10": ("nlog10", "math", "n*log10(x)+k (nlog10.rs)", ("n", "k")),
    "log_block": ("log_block", "math", "elementwise log (log_blk.rs)"),
    "max_block": ("max_block", "math", "elementwise max (max_blk.rs)"),
    "exponentiate": ("exponentiate", "math", "x**k (exponentiate.rs)",
                     ("exponent",)),
    "transcendental": ("transcendental", "math",
                       "named transcendental fn (transcendental.rs)",
                       ("name",)),
    "phase_shift": ("phase_shift", "math",
                    "constant phase rotation (phase_shift.rs)",
                    ("phase_rad",)),
    "phase_unwrap": ("phase_unwrap", "math",
                     "phase unwrapping (phase_unwrap.rs)"),
    "phase_wrap": ("phase_wrap", "math", "wrap to (-pi,pi] (phase_ops.rs)"),
    "frequency_shift": ("frequency_shift", "math",
                        "complex mixer w/ carried phase "
                        "(frequency_shift.rs)",
                        ("shift_hz", "sample_rate")),
    "rf_mixer": ("rf_mixer", "math",
                 "complex/real mixer (rf_mixer.rs)", ("mode",)),
    "multiply_matrix": ("multiply_matrix", "math",
                        "per-sample matrix multiply (multiply_matrix.rs)"),
    "matrix_eigenvalue": ("matrix_eigenvalue", "math",
                          "dominant eigenpair (matrix_eigenvalue.rs)"),
    "endian_swap": ("endian_swap", "math",
                    "byte swap in words (endian_swap.rs)", ("word_bits",)),
    "bitwise_op": ("bitwise_op", "math",
                   "and/or/xor/not streams (bitwise_ops.rs)", ("op",)),
    "short_to_float": ("short_to_float", "math",
                       "i16 -> f32 (numeric_conversions.rs)"),
    "float_to_short": ("float_to_short", "math",
                       "f32 -> i16 (numeric_conversions.rs)"),
    "float_to_complex": ("float_to_complex", "math",
                         "re/im -> complex (float_to_complex.rs)"),
    "repack_bits": ("repack_bits", "math",
                    "k-bit -> l-bit repacking (stream_byte_converter.rs)",
                    ("k_in", "k_out")),
    "check_lfsr": ("check_lfsr", "measurement",
                   "self-sync PRBS checker (check_lfsr.rs)",
                   ("taps", "nbits")),
    "stream_switch": ("stream_switch", "math",
                      "N-way stream selector (stream_switch.rs)",
                      ("select",)),
    "stream_to_streams": ("stream_to_streams", "math",
                          "deinterleave 1->N (stream_to_streams.rs)",
                          ("n",)),
    "streams_to_stream": ("streams_to_stream", "math",
                          "interleave N->1 (stream_to_streams.rs)"),
}
