"""Tapped-delay-line multipath with the 3GPP profiles, on tensors.

PyTorch counterpart of ``r4w_tpu.channel.tdl``. `TDL_PROFILES`,
`profile_taps`, `rms_delay_spread` and `coherence_bandwidth` are numpy
and copied from the reference; `tdl_channel` gives every tap its own
Jakes fading process (one (N,) process a tap, shared by every row of a
batch, as the reference's) and a static integer delay.
"""

from __future__ import annotations

import numpy as np
import torch

from r4w_tpu_torch.channel import threefry
from r4w_tpu_torch.channel.channel import check_source, delay
from r4w_tpu_torch.channel.doppler import jakes_fading
from r4w_tpu_torch.core.types import IQ_DTYPE, to_tensor

# 3GPP TS 36.101 tap profiles: (delay_ns, power_db) (channel.rs:95-136)
TDL_PROFILES = {
    "EPA": (
        [0, 30, 70, 90, 110, 190, 410],
        [0.0, -1.0, -2.0, -3.0, -8.0, -17.2, -20.8],
    ),
    "EVA": (
        [0, 30, 150, 310, 370, 710, 1090, 1730, 2510],
        [0.0, -1.5, -1.4, -3.6, -0.6, -9.1, -7.0, -12.0, -16.9],
    ),
    "ETU": (
        [0, 50, 120, 200, 230, 500, 1600, 2300, 5000],
        [-1.0, -1.0, -1.0, 0.0, 0.0, 0.0, -3.0, -5.0, -7.0],
    ),
}


def profile_taps(profile: str, sample_rate: float):
    """(delays_in_samples int[], normalized linear amplitudes f32[])."""
    delays_ns, powers_db = TDL_PROFILES[profile.upper()]
    delays = np.round(np.asarray(delays_ns) * 1e-9 * sample_rate).astype(int)
    p_lin = 10.0 ** (np.asarray(powers_db) / 10.0)
    p_lin = p_lin / p_lin.sum()  # unit total power
    return delays, np.sqrt(p_lin).astype(np.float32)


def rms_delay_spread(profile: str) -> float:
    """RMS delay spread in seconds (channel.rs:183-230)."""
    delays_ns, powers_db = TDL_PROFILES[profile.upper()]
    d = np.asarray(delays_ns) * 1e-9
    p = 10.0 ** (np.asarray(powers_db) / 10.0)
    p = p / p.sum()
    mean = (p * d).sum()
    return float(np.sqrt((p * (d - mean) ** 2).sum()))


def coherence_bandwidth(profile: str) -> float:
    """Approximate 50%-correlation coherence BW = 1/(5·τ_rms)."""
    return 1.0 / (5.0 * rms_delay_spread(profile))


def tdl_channel(samples, profile: str, sample_rate, doppler_hz, n_oscillators: int = 16, *,
                key=None, generator: torch.Generator | None = None) -> torch.Tensor:
    """Apply a fading TDL: y[n] = Σ_taps a_k · h_k[n] · x[n - d_k].

    With a key, tap k's process takes the k-th of the key's splits into one
    key a tap. At sample rates where a profile's delays round to the same
    sample (every EPA delay is 0 at 125 kS/s), the taps only sum fading
    processes, as in the reference.
    """
    check_source(key, generator)
    samples = to_tensor(samples, IQ_DTYPE)
    n = samples.shape[-1]
    delays, amps = profile_taps(profile, float(sample_rate))
    keys = threefry.split(key, len(delays)) if key is not None else [None] * len(delays)
    out = torch.zeros_like(samples)
    for d, a, k in zip(delays, amps, keys):
        h = jakes_fading(n, doppler_hz, sample_rate, n_oscillators, key=k, generator=generator,
                         device=samples.device)
        out = out + float(a) * h * delay(samples, int(d))
    return out
