"""Channel models on tensors.

PyTorch counterpart of ``r4w_tpu.channel.channel``. Every random model
takes exactly one source of randomness:

- ``generator=``: a ``torch.Generator`` (Philox), drawn on its device;
- ``key=``: a `channel.threefry` key, ``(k0, k1)`` (``threefry.key(seed)``
  for ``jax.random.key(seed)``). The function then makes the reference's
  own draws on the host, following the reference's key splits exactly, and
  moves them to the samples' device, so the port's output for a key is the
  reference's for the same key up to float32 rounding.

`awgn` also takes the noise itself (``noise=``). All functions take and
return (..., N) complex64 blocks and operate on the last axis; they follow
the device of a tensor input, and put other inputs on the CUDA card.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

from r4w_tpu_torch.channel import threefry
from r4w_tpu_torch.core.hostio import cis
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, real_scalar, resolve_device, to_tensor
from r4w_tpu_torch.observe.spans import traced

# float32 constants as the reference rounds them, held as Python floats (exact)
TWO_PI = float(np.float32(2.0 * np.pi))                              # `2.0 * jnp.pi`
INV_SQRT2 = float(np.float32(1.0) / np.sqrt(np.float32(2.0)))        # `1.0 / jnp.sqrt(2.0)`
SQRT2 = float(np.sqrt(np.float32(2.0)))                              # `jnp.sqrt(2.0)`


def check_source(key, generator) -> None:
    """Raise unless exactly one of `key` and `generator` is given."""
    if (key is None) == (generator is None):
        raise ValueError("pass exactly one of key and generator")


def draw_device(generator: torch.Generator | None, device) -> torch.device:
    """Where draws land: `device` if named, else the generator's device, else
    `DEFAULT_DEVICE` (threefry draws are made on the host and moved there)."""
    if device is None and generator is not None:
        return generator.device
    return resolve_device(device)


def normal(shape, *, key=None, generator: torch.Generator | None = None,
           device=None) -> torch.Tensor:
    """Standard normal float32 draws of `shape` on `draw_device(generator,
    device)`: the reference's ``jax.random.normal(key, shape)`` for a
    threefry `key` (made in numpy for the CPU, on the device itself for a
    card: the same bits, `threefry.normal_tensor`), else Philox."""
    check_source(key, generator)
    device = draw_device(generator, device)
    if key is not None:
        if device.type != "cpu":
            return threefry.normal_tensor(key, tuple(shape), device)
        return torch.from_numpy(threefry.normal(key, tuple(shape))).to(device)
    return torch.randn(tuple(shape), generator=generator, dtype=REAL_DTYPE, device=device)


def uniform(shape, minval: float = 0.0, maxval: float = 1.0, *, key=None,
            generator: torch.Generator | None = None, device=None) -> torch.Tensor:
    """Uniform float32 draws on [minval, maxval): the reference's
    ``jax.random.uniform(key, shape, float32, minval, maxval)`` for a
    threefry `key`, else Philox."""
    check_source(key, generator)
    device = draw_device(generator, device)
    if key is not None:
        return torch.from_numpy(threefry.uniform(key, tuple(shape), minval, maxval)).to(device)
    u = torch.rand(tuple(shape), generator=generator, dtype=REAL_DTYPE, device=device)
    return u * float(np.float32(maxval) - np.float32(minval)) + float(np.float32(minval))


def _complex_normal(shape, std, *, key=None, generator: torch.Generator | None = None,
                    device=None) -> torch.Tensor:
    """Circular complex Gaussian with per-component std `std`: with a key,
    the real part from its first split and the imaginary from its second,
    as the reference draws them; with a generator, real then imaginary."""
    check_source(key, generator)
    if key is not None:
        re_key, im_key = threefry.split(key)
        re = normal(shape, key=re_key, device=device)
        im = normal(shape, key=im_key, device=device)
    else:
        re = normal(shape, generator=generator, device=device)
        im = normal(shape, generator=generator, device=device)
    return torch.complex(re * std, im * std)


@traced("channel.awgn", lambda rx, *_, **__: {"samples": rx.numel()})
def awgn(samples, snr_db, *, generator: torch.Generator | None = None,
         noise: torch.Tensor | None = None, key=None, path_loss_db=0.0,
         measured_power=None) -> torch.Tensor:
    """AWGN at a target SNR.

    Noise power follows the measured mean signal power over the last axis
    (or `measured_power` if given); path loss attenuates the signal before
    the noise is added. `snr_db` broadcasts against (..., 1), so a
    (lanes, SNRs, N) block takes SNRs of shape (SNRs, 1).

    Pass exactly one of `generator` (draws fresh noise of the samples'
    shape on its device), `key` (the reference's noise for that threefry
    key) and `noise` (unit variance per component, broadcasting to the
    samples; or a function of the samples' shape and device that returns
    such noise, as a sharded sweep draws a slice of the whole grid's).
    """
    if sum(s is not None for s in (generator, noise, key)) != 1:
        raise ValueError("pass exactly one of generator, key and noise")
    samples = to_tensor(samples, IQ_DTYPE)
    device = samples.device
    if measured_power is None:
        sig_power = torch.mean(samples.real ** 2 + samples.imag ** 2, dim=-1,
                               keepdim=True)
    else:
        sig_power = torch.as_tensor(measured_power, dtype=REAL_DTYPE, device=device)
    snr_lin = 10.0 ** (torch.as_tensor(snr_db, dtype=REAL_DTYPE, device=device) / 10.0)
    noise_std = torch.sqrt(sig_power / snr_lin / 2.0)
    attenuation = 10.0 ** (-torch.as_tensor(path_loss_db, dtype=REAL_DTYPE,
                                            device=device) / 20.0)
    if noise is None:
        noise = _complex_normal(samples.shape, 1.0, key=key, generator=generator,
                                device=device)
    elif callable(noise):
        noise = noise(samples.shape, device)
    return samples * attenuation + noise.to(device=device, dtype=IQ_DTYPE) * noise_std


def cfo(samples, cfo_hz, sample_rate, initial_phase=0.0) -> torch.Tensor:
    """Carrier frequency offset rotation.

    The time index is split as t = t_hi·4096 + t_lo: f·4096 is an exact
    float32 exponent shift, and its fraction mod 1 carries the low mantissa
    bits, so the phase stays within ~1e-4 cycles on long blocks. The
    modulo is the floor modulo (``torch.remainder``), as ``jnp.mod`` is.
    """
    samples = to_tensor(samples, IQ_DTYPE)
    device = samples.device
    idx = torch.arange(samples.shape[-1], device=device)
    t_hi = torch.div(idx, 4096, rounding_mode="floor").to(REAL_DTYPE)
    t_lo = torch.remainder(idx, 4096).to(REAL_DTYPE)
    f = real_scalar(cfo_hz, device) / real_scalar(sample_rate, device)
    c_hi = torch.remainder(f * 4096.0, 1.0)
    cycles = torch.remainder(torch.remainder(c_hi * t_hi, 1.0)
                             + torch.remainder(f * t_lo, 1.0), 1.0)
    phase = float(np.float32(initial_phase)) + TWO_PI * cycles
    return samples * cis(phase)


def delay(samples: torch.Tensor, d: int) -> torch.Tensor:
    """`samples` delayed by `d` >= 0 samples along the last axis, zeros in front."""
    n = samples.shape[-1]
    d = min(int(d), n)
    if d == 0:
        return samples
    zeros = torch.zeros((*samples.shape[:-1], d), dtype=samples.dtype, device=samples.device)
    return torch.cat([zeros, samples[..., : n - d]], dim=-1)


def multipath_2ray(samples, delay_samples: int, amplitude: float) -> torch.Tensor:
    """Two-ray static multipath: y[n] = x[n] + a·x[n-d]."""
    samples = to_tensor(samples, IQ_DTYPE)
    if delay_samples == 0 or amplitude == 0.0:
        return samples
    return samples + amplitude * delay(samples, delay_samples)


def rayleigh(samples, *, key=None, generator: torch.Generator | None = None) -> torch.Tensor:
    """Per-sample iid Rayleigh fading h ~ CN(0, 1)."""
    samples = to_tensor(samples, IQ_DTYPE)
    h = _complex_normal(samples.shape, INV_SQRT2, key=key, generator=generator,
                        device=samples.device)
    return samples * h


def rician(samples, k_factor, *, key=None,
           generator: torch.Generator | None = None) -> torch.Tensor:
    """Rician fading: line of sight plus scatter, K = LOS/scatter power."""
    samples = to_tensor(samples, IQ_DTYPE)
    k = np.float32(k_factor)
    los_amp = np.sqrt(k / (k + np.float32(1.0)))
    scatter_amp = np.sqrt(np.float32(1.0) / (k + np.float32(1.0)))
    scattered = _complex_normal(samples.shape, float(scatter_amp / np.float32(SQRT2)),
                                key=key, generator=generator, device=samples.device)
    return samples * (float(los_amp) + scattered)


def block_fading(samples, coherence_samples: int, *, key=None,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """Block Rayleigh fading: one CN(0, 1) coefficient per coherence block."""
    samples = to_tensor(samples, IQ_DTYPE)
    n = samples.shape[-1]
    n_blocks = -(-n // coherence_samples)
    h = _complex_normal((*samples.shape[:-1], n_blocks), INV_SQRT2, key=key,
                        generator=generator, device=samples.device)
    return samples * h.repeat_interleave(coherence_samples, dim=-1)[..., :n]


ChannelModelName = Literal[
    "ideal", "awgn", "awgn_cfo", "multipath", "rayleigh", "rician",
    "tdl_awgn", "jakes", "freq_selective",
]


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """The reference's `ChannelConfig`: a model name and its parameters."""

    model: str = "awgn"
    snr_db: float = 20.0
    sample_rate: float = 125_000.0
    cfo_hz: float = 0.0
    path_loss_db: float = 0.0
    multipath_delay: int = 0
    multipath_amplitude: float = 0.0
    rician_k: float = 5.0
    doppler_hz: float = 50.0
    tdl_profile: str = "EPA"


def apply_channel(samples, config: ChannelConfig, *, key=None,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """Apply `config`'s model. Models: ideal, awgn, awgn_cfo (awgnwithcfo),
    multipath, rayleigh, rician, tdl_awgn (tdlawgn, freq_selective,
    frequencyselective) and jakes (jakesfading). With a key, the draws
    follow the reference's splits: awgn_cfo's noise comes from the second
    of two split keys, tdl_awgn's and jakes' fading from the first and the
    noise from the second."""
    check_source(key, generator)
    model = config.model.lower()
    snr, loss = config.snr_db, config.path_loss_db
    if model == "ideal":
        return to_tensor(samples, IQ_DTYPE)
    if model == "awgn":
        return awgn(samples, snr, key=key, generator=generator, path_loss_db=loss)
    if model in ("awgn_cfo", "awgnwithcfo"):
        rotated = cfo(samples, config.cfo_hz, config.sample_rate)
        k2 = None if key is None else threefry.split(key)[1]
        return awgn(rotated, snr, key=k2, generator=generator, path_loss_db=loss)
    if model == "multipath":
        faded = multipath_2ray(samples, config.multipath_delay, config.multipath_amplitude)
        return awgn(faded, snr, key=key, generator=generator, path_loss_db=loss)
    if model == "rayleigh":
        return rayleigh(samples, key=key, generator=generator)
    if model == "rician":
        return rician(samples, config.rician_k, key=key, generator=generator)
    k1, k2 = (None, None) if key is None else threefry.split(key)
    if model in ("tdl_awgn", "tdlawgn", "freq_selective", "frequencyselective"):
        from r4w_tpu_torch.channel.tdl import tdl_channel

        faded = tdl_channel(samples, config.tdl_profile, config.sample_rate,
                            config.doppler_hz, key=k1, generator=generator)
        return awgn(faded, snr, key=k2, generator=generator, path_loss_db=loss)
    if model in ("jakes", "jakesfading"):
        from r4w_tpu_torch.channel.doppler import jakes_fading

        samples = to_tensor(samples, IQ_DTYPE)
        h = jakes_fading(samples.shape[-1], config.doppler_hz, config.sample_rate, key=k1,
                         generator=generator, device=samples.device)
        return awgn(samples * h, snr, key=k2, generator=generator, path_loss_db=loss)
    raise ValueError(f"unknown channel model: {config.model}")


def theoretical_ber_awgn(snr_db, spreading_factor: int, device=None) -> torch.Tensor:
    """Approximate LoRa BER over AWGN at `snr_db`, float32, clipped to [0, 0.5]."""
    snr = to_tensor(snr_db, REAL_DTYPE, device)
    snr_lin = 10.0 ** (snr / 10.0)
    sf = spreading_factor
    gamma = snr_lin * (2.0 ** sf) / real_scalar(sf, snr.device)
    q = 0.5 * torch.special.erfc(torch.sqrt(gamma / 2.0) / real_scalar(SQRT2, snr.device))
    return torch.clamp(q, 0.0, 0.5)


def measure_snr(clean, noisy) -> torch.Tensor:
    """Empirical SNR in dB between a clean signal and its noisy copy (last axis)."""
    clean = to_tensor(clean, IQ_DTYPE)
    noise = to_tensor(noisy, IQ_DTYPE, clean.device) - clean
    ps = torch.mean(torch.abs(clean) ** 2, dim=-1)
    pn = torch.mean(torch.abs(noise) ** 2, dim=-1)
    return 10.0 * torch.log10(ps / torch.clamp(pn, min=1e-30))


__all__ = ["ChannelConfig", "apply_channel", "awgn", "block_fading", "cfo", "measure_snr",
           "multipath_2ray", "rayleigh", "rician", "theoretical_ber_awgn"]
