"""Cognitive-radio & link-adaptation fills.

PyTorch counterpart of ``r4w_tpu.ops.cognitive`` (cognitive_engine.rs,
cognitive_radio_spectrum_broker.rs, cognitive_radio_spectrum_learner.rs,
dynamic_spectrum_manager.rs, spectrum_coexistence_analyzer.rs,
interference_classifier.rs, interference_excision.rs,
link_adaptation_engine.rs, carrier_aggregation_scheduler.rs,
adaptive_power_controller.rs, power_control.rs,
timing_advance_estimator.rs, lorawan_mac_scheduler.rs, csma_ca_mac.rs,
waveform_diversity_scheduler.rs, rf_signal_router.rs, spectral_mask.rs /
spectral_mask_painter.rs, lpi_metrics.rs).

Decision logic is host-side control plane, the reference's numpy and
Python as they are (the broker, learner and engine keep their state in
numpy); the signal-facing pieces (occupancy sensing, excision, masks) are
torch on the samples' device. `channel_occupancy`, `coexistence_report`
and `interference_excise` take leading rows, each row's frames kept apart
(one call for a stack of blocks); on one row they give the reference's
result. Every median is the mean of the two middle values at an even
length (``jnp.median``'s rule). `csma_backoff_trace` draws its uniforms
from the reference's threefry key, so its slots and rounds are the
reference's; `power_control_converge` is a 100-step loop.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from r4w_tpu_torch.channel import threefry
from r4w_tpu_torch.core.hostio import complex_abs
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, real_scalar, to_tensor
from r4w_tpu_torch.ops.spectral2 import _frames, median, spectral_entropy
from r4w_tpu_torch.waveforms.serial_tone import interp

# ------------------------------------------------------ spectrum mgmt


def _db(p: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(torch.clamp(p, min=1e-30))


def channel_occupancy(x, n_channels: int, n_fft: int = 1024, threshold_db: float = 6.0):
    """Per-channel occupancy from the averaged PSD
    (dynamic_spectrum_manager.rs sensing stage): channels spanning the
    fftshifted band; occupied = mean power > the channels' median +
    threshold. x (..., n) gives (busy, ch_db), each (..., n_channels)."""
    x = to_tensor(x, IQ_DTYPE)
    spec = torch.fft.fftshift(torch.fft.fft(_frames(x, n_fft), dim=-1), dim=-1)
    psd = torch.mean(complex_abs(spec) ** 2, dim=-2)
    per = n_fft // n_channels
    ch = torch.mean(psd[..., : per * n_channels].reshape(*psd.shape[:-1], n_channels, per),
                    dim=-1)
    ch_db = _db(ch)
    floor = median(ch_db, dim=-1, keepdim=True)
    return ch_db > floor + threshold_db, ch_db


class SpectrumBroker:
    """Lease-based channel broker (cognitive_radio_spectrum_broker.rs):
    secondary users request channels; the broker grants the cleanest
    free one and tracks leases."""

    def __init__(self, n_channels: int):
        self.n_channels = n_channels
        self.leases: dict[int, str] = {}

    def request(self, user: str, occupancy_db) -> int | None:
        occ = np.asarray(occupancy_db.cpu() if isinstance(occupancy_db, torch.Tensor)
                         else occupancy_db)
        order = np.argsort(occ)
        for ch in order:
            ch = int(ch)
            if ch not in self.leases:
                self.leases[ch] = user
                return ch
        return None

    def release(self, user: str):
        self.leases = {c: u for c, u in self.leases.items() if u != user}


class SpectrumLearner:
    """Per-channel idle-probability learner
    (cognitive_radio_spectrum_learner.rs): exponential estimate of
    P(idle) from observations; pick() returns the historically best
    channel."""

    def __init__(self, n_channels: int, alpha: float = 0.1):
        self.p_idle = np.full(n_channels, 0.5)
        self.alpha = alpha

    def observe(self, busy_mask):
        if isinstance(busy_mask, torch.Tensor):
            busy_mask = busy_mask.cpu().numpy()
        idle = 1.0 - np.asarray(busy_mask).astype(float)
        self.p_idle += self.alpha * (idle - self.p_idle)

    def pick(self) -> int:
        return int(np.argmax(self.p_idle))


@dataclasses.dataclass
class CognitiveEngine:
    """Sense→decide→act loop (cognitive_engine.rs): combines the
    occupancy sensor, the learner, and the link adaptor into one
    policy step."""
    n_channels: int
    learner: SpectrumLearner = None

    def __post_init__(self):
        if self.learner is None:
            self.learner = SpectrumLearner(self.n_channels)

    def step(self, x, snr_db: float):
        busy, _ = channel_occupancy(x, self.n_channels)
        busy = busy.cpu().numpy()
        self.learner.observe(busy)
        channel = self.learner.pick()
        mcs = link_adapt(snr_db)
        return {"channel": channel, "mcs": mcs, "busy": busy}


def coexistence_report(x, n_channels: int = 16):
    """Interference coexistence metrics per channel
    (spectrum_coexistence_analyzer.rs): duty cycle + mean power from a
    frame-by-frame occupancy matrix, against the median over its frames and
    channels + 6 dB. x (..., n) gives (duty, mean dB), each (...,
    n_channels)."""
    x = to_tensor(x, IQ_DTYPE)
    n_fft = 256
    spec = complex_abs(torch.fft.fftshift(torch.fft.fft(_frames(x, n_fft), dim=-1),
                                          dim=-1)) ** 2
    per = n_fft // n_channels
    ch = torch.mean(spec[..., : per * n_channels].reshape(*spec.shape[:-1], n_channels, per),
                    dim=-1)                                   # (..., frames, ch)
    ch_db = _db(ch)
    floor = median(ch_db.reshape(*ch_db.shape[:-2], -1), dim=-1, keepdim=True)[..., None]
    busy = ch_db > floor + 6.0
    return torch.mean(busy.to(REAL_DTYPE), dim=-2), torch.mean(ch_db, dim=-2)


# ----------------------------------------------------- interference


def interference_classify(x, sample_rate: float) -> str:
    """Classify dominant interference: tone / chirp / pulsed / wideband
    (interference_classifier.rs) — spectral + envelope features, in numpy
    on the host as the reference."""
    x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    mag = np.abs(x)
    duty = np.mean(mag > 0.3 * mag.max())
    spec = np.abs(np.fft.fft(x * np.hanning(x.shape[0]))) ** 2
    occ = np.mean(spec > 0.05 * spec.max())
    d = x[1:] * np.conj(x[:-1])
    inst = np.angle(d)
    slope = np.polyfit(np.arange(inst.shape[0]), inst, 1)[0]
    if duty < 0.3:
        return "pulsed"
    if occ < 0.01:
        return "tone"
    if abs(slope) > 1e-5 and occ < 0.5:
        return "chirp"
    return "wideband"


def interference_excise(x, threshold_sigma: float = 4.0, n_fft: int = 1024):
    """Frequency-domain excision (interference_excision.rs): null the FFT
    bins of each frame that exceed k·(the frame's median magnitude); the
    tail past the last whole frame passes. x (..., n)."""
    x = to_tensor(x, IQ_DTYPE)
    n = (x.shape[-1] // n_fft) * n_fft
    spec = torch.fft.fft(_frames(x, n_fft), dim=-1)
    mag = complex_abs(spec)
    med = median(mag, dim=-1, keepdim=True)
    keep = mag < threshold_sigma * med
    clean = torch.fft.ifft(torch.where(keep, spec, torch.zeros((), dtype=spec.dtype,
                                                               device=spec.device)), dim=-1)
    return torch.cat([clean.reshape(*x.shape[:-1], n), x[..., n:]], dim=-1)


# ------------------------------------------------------ link adaptation

# (snr threshold dB, name, bits/sym, code rate) — 3GPP-flavored ladder
_MCS_TABLE = (
    (-2.0, "bpsk-1/2", 1, 0.5),
    (2.0, "qpsk-1/2", 2, 0.5),
    (6.0, "qpsk-3/4", 2, 0.75),
    (10.0, "16qam-1/2", 4, 0.5),
    (14.0, "16qam-3/4", 4, 0.75),
    (18.0, "64qam-2/3", 6, 2 / 3),
    (22.0, "64qam-5/6", 6, 5 / 6),
)


def link_adapt(snr_db: float, hysteresis_db: float = 0.0, current: int | None = None):
    """SNR → MCS index (link_adaptation_engine.rs) with optional
    hysteresis against the current index."""
    idx = 0
    for i, (thr, *_rest) in enumerate(_MCS_TABLE):
        if snr_db >= thr + (hysteresis_db if current is not None and i > current else 0.0):
            idx = i
    return idx


def mcs_info(idx: int):
    thr, name, bps, rate = _MCS_TABLE[idx]
    return {"name": name, "bits_per_symbol": bps, "code_rate": rate, "min_snr_db": thr}


def carrier_aggregation_schedule(channel_snrs_db, demands_bits, syms_per_channel: int = 1000):
    """Greedy multi-carrier scheduler (carrier_aggregation_scheduler.rs):
    assign each user the best remaining carrier until demand or carriers
    run out. Returns {user: [(channel, bits)]}. Deterministic."""
    if isinstance(channel_snrs_db, torch.Tensor):
        channel_snrs_db = channel_snrs_db.cpu().numpy()
    snrs = list(np.asarray(channel_snrs_db, float))
    remaining = dict(enumerate(snrs))
    out = {u: [] for u in demands_bits}
    need = dict(demands_bits)
    users = sorted(need, key=lambda u: -need[u])
    while remaining and any(v > 0 for v in need.values()):
        for u in users:
            if need[u] <= 0 or not remaining:
                continue
            best = max(remaining, key=lambda c: remaining[c])
            snr = remaining.pop(best)
            mcs = _MCS_TABLE[link_adapt(snr)]
            bits = int(syms_per_channel * mcs[2] * mcs[3])
            out[u].append((best, bits))
            need[u] -= bits
    return out


def power_control_step(sinr_db, target_db: float, step_db: float = 1.0):
    """Closed-loop up/down power-control command (power_control.rs /
    adaptive_power_controller.rs): ±step toward the target, per link."""
    s = to_tensor(sinr_db, REAL_DTYPE)
    return torch.where(s < target_db, real_scalar(step_db, s.device),
                       real_scalar(-step_db, s.device))


def power_control_converge(gains, noise, target_db: float, n_iter: int = 100):
    """Distributed Foschini–Miljanic iteration across interfering links, a
    step loop: p ← target_lin · (interference+noise)/gain. gains: (L, L)
    with g[i,i] the wanted link. Returns (p, SINR dB)."""
    g = to_tensor(gains, REAL_DTYPE)
    nl = to_tensor(noise, REAL_DTYPE, device=g.device)
    target = real_scalar(10.0 ** (target_db / 10.0), g.device)
    diag = torch.diagonal(g)
    p = torch.ones(g.shape[0], dtype=REAL_DTYPE, device=g.device)
    for _ in range(n_iter):
        interf = g @ p - diag * p + nl
        p = target * interf / diag
    sinr = diag * p / (g @ p - diag * p + nl)
    return p, 10.0 * torch.log10(torch.clamp(sinr, min=1e-30))


def timing_advance(rx_correlation_peak_idx: int, expected_idx: int, sample_rate: float,
                   c: float = 299_792_458.0):
    """Round-trip timing-advance estimate (timing_advance_estimator.rs):
    sample offset → one-way distance → advance command in samples."""
    off = rx_correlation_peak_idx - expected_idx
    dist = off / sample_rate * c / 2.0
    return -off, dist


# ------------------------------------------------------------- MAC


def lorawan_schedule(dev_airtimes_s, duty_cycle: float = 0.01, horizon_s: float = 3600.0):
    """Duty-cycle-constrained LoRaWAN uplink schedule
    (lorawan_mac_scheduler.rs): earliest-allowed TX times per device
    honoring the 1% band duty cycle. Returns start times."""
    out = {}
    for dev, airtime in dev_airtimes_s.items():
        wait = airtime * (1.0 - duty_cycle) / duty_cycle
        times = []
        t = 0.0
        while t + airtime <= horizon_s:
            times.append(t)
            t += airtime + wait
        out[dev] = times
    return out


def csma_backoff_trace(busy_timeline, cw_min: int = 4, cw_max: int = 64, seed: int = 0):
    """CSMA/CA backoff simulation against a busy/idle timeline
    (csma_ca_mac.rs): (the slot at which TX succeeds, -1 if the timeline
    ends first; the number of backoff rounds). A step loop over the slots
    in int32 on the timeline's device, the uniforms the reference's own
    (``threefry.uniform`` on key `seed`), so both equal its result."""
    busy = to_tensor(busy_timeline).to(torch.bool)
    n = busy.shape[0]
    dev = busy.device
    u = torch.from_numpy(threefry.uniform(threefry.key(seed), (n + 1,))).to(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    bo = torch.floor(u[0] * float(cw_min)).to(torch.int32)
    cw = torch.full((), cw_min, **i32)
    rounds = torch.zeros((), **i32)
    result = torch.full((), -1, **i32)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    cw_cap = torch.full((), cw_max, **i32)
    for t in range(n):
        b, ut = busy[t], u[t + 1]
        idle = ~b
        attempt = ~done & (bo == 0)
        success = attempt & idle
        collide = attempt & b
        counting = ~done & (bo > 0)
        result = torch.where(success, torch.full((), t, **i32), result)
        done = done | success
        rounds = rounds + collide.to(torch.int32)
        cw = torch.where(collide, torch.minimum(2 * cw, cw_cap), cw)
        bo = torch.where(collide, torch.floor(ut * cw.to(REAL_DTYPE)).to(torch.int32),
                         bo - (counting & idle).to(torch.int32))
    return result, rounds


def waveform_diversity_pick(env_report: dict) -> str:
    """Rule-based waveform selection (waveform_diversity_scheduler.rs):
    map the sensed environment to the best waveform family."""
    if env_report.get("jamming", False):
        return "fhss"
    if env_report.get("multipath_rms_us", 0.0) > 1.0:
        return "ofdm"
    if env_report.get("snr_db", 99.0) < 0.0:
        return "lora"
    return "qam"


def rf_route(signal_ports: dict, route_table: dict) -> dict:
    """Static RF signal routing matrix (rf_signal_router.rs):
    out[dst] = sum of its routed inputs."""
    out = {}
    for dst, srcs in route_table.items():
        acc = None
        for s in srcs:
            x = to_tensor(signal_ports[s])
            acc = x if acc is None else acc + x
        out[dst] = acc
    return out


# ---------------------------------------------------------- masks/LPI


def spectral_mask(freq_offsets_hz, mask_points):
    """Piecewise-linear spectral emission mask evaluated at |offsets|
    (spectral_mask.rs). mask_points: [(offset_hz, limit_db)...]; the
    reference's ``jnp.interp`` as a searchsorted lerp."""
    pts = sorted(mask_points)
    fo = torch.abs(to_tensor(freq_offsets_hz, REAL_DTYPE))
    xs = torch.tensor([p[0] for p in pts], dtype=REAL_DTYPE, device=fo.device)
    ys = torch.tensor([p[1] for p in pts], dtype=REAL_DTYPE, device=fo.device)
    return interp(fo, xs, ys)


def mask_compliance(psd_db, freqs_hz, mask_points):
    """Check a measured PSD against the mask (spectral_mask_painter.rs):
    (ok, worst_margin_db)."""
    psd = to_tensor(psd_db, REAL_DTYPE)
    limit = spectral_mask(to_tensor(freqs_hz, REAL_DTYPE, device=psd.device), mask_points)
    margin = limit - psd
    return torch.all(margin >= 0.0), torch.min(margin)


def lpi_metrics(x, n_fft: int = 1024):
    """Low-probability-of-intercept metrics (lpi_metrics.rs): peak/avg PSD
    ratio (dB), spectral entropy, envelope kurtosis — low ratio + high
    entropy = hard to intercept."""
    x = to_tensor(x, IQ_DTYPE)
    psd = torch.mean(complex_abs(torch.fft.fft(_frames(x, n_fft), dim=-1)) ** 2, dim=-2)
    papr_db = 10.0 * torch.log10(torch.amax(psd, dim=-1) / torch.mean(psd, dim=-1))
    ent = spectral_entropy(x, n_fft)
    mag = complex_abs(x)
    dev = mag - torch.mean(mag, dim=-1, keepdim=True)
    dev2 = dev * dev
    var = torch.mean(dev2, dim=-1)
    kurt = torch.mean(dev2 * dev2, dim=-1) / torch.clamp(var * var, min=1e-12)
    return {"psd_peak_avg_db": papr_db, "spectral_entropy": ent, "envelope_kurtosis": kurt}


BLOCKS = {
    "dynamic_spectrum_manager": ("channel_occupancy", "measurement",
                                 "per-channel occupancy sensing "
                                 "(dynamic_spectrum_manager.rs)",
                                 ("n_channels", "threshold_db")),
    "cognitive_radio_spectrum_broker": (
        "SpectrumBroker", "math",
        "lease-based channel broker "
        "(cognitive_radio_spectrum_broker.rs)", ("n_channels",)),
    "cognitive_radio_spectrum_learner": (
        "SpectrumLearner", "math",
        "idle-probability learner "
        "(cognitive_radio_spectrum_learner.rs)", ("n_channels",)),
    "cognitive_engine": ("CognitiveEngine", "math",
                         "sense->decide->act loop "
                         "(cognitive_engine.rs)", ("n_channels",)),
    "spectrum_coexistence_analyzer": (
        "coexistence_report", "measurement",
        "duty cycle + power per channel "
        "(spectrum_coexistence_analyzer.rs)", ("n_channels",)),
    "interference_classifier": ("interference_classify", "measurement",
                                "tone/chirp/pulsed/wideband "
                                "(interference_classifier.rs)",
                                ("sample_rate",)),
    "interference_excision": ("interference_excise", "filter",
                              "FFT-bin excision "
                              "(interference_excision.rs)",
                              ("threshold_sigma", "n_fft")),
    "link_adaptation_engine": ("link_adapt", "math",
                               "SNR -> MCS ladder "
                               "(link_adaptation_engine.rs)",
                               ("hysteresis_db",)),
    "carrier_aggregation_scheduler": (
        "carrier_aggregation_schedule", "math",
        "greedy carrier assignment "
        "(carrier_aggregation_scheduler.rs)"),
    "power_control": ("power_control_step", "math",
                      "closed-loop power commands (power_control.rs)",
                      ("target_db", "step_db")),
    "adaptive_power_controller": ("power_control_converge", "math",
                                  "Foschini-Miljanic iteration "
                                  "(adaptive_power_controller.rs)",
                                  ("target_db",)),
    "timing_advance_estimator": ("timing_advance", "sync",
                                 "RTT -> advance command "
                                 "(timing_advance_estimator.rs)",
                                 ("sample_rate",)),
    "lorawan_mac_scheduler": ("lorawan_schedule", "math",
                              "duty-cycle uplink schedule "
                              "(lorawan_mac_scheduler.rs)",
                              ("duty_cycle",)),
    "csma_ca_mac": ("csma_backoff_trace", "math",
                    "CSMA/CA backoff vs timeline (csma_ca_mac.rs)",
                    ("cw_min", "cw_max")),
    "waveform_diversity_scheduler": ("waveform_diversity_pick", "math",
                                     "environment -> waveform rule "
                                     "(waveform_diversity_scheduler"
                                     ".rs)"),
    "rf_signal_router": ("rf_route", "math",
                         "routing matrix (rf_signal_router.rs)"),
    "spectral_mask": ("spectral_mask", "measurement",
                      "piecewise emission mask (spectral_mask.rs)"),
    "spectral_mask_painter": ("mask_compliance", "measurement",
                              "PSD-vs-mask check "
                              "(spectral_mask_painter.rs)"),
    "lpi_metrics": ("lpi_metrics", "measurement",
                    "interceptability metrics (lpi_metrics.rs)",
                    ("n_fft",)),
}
