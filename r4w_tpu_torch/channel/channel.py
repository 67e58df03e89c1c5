"""Channel models on tensors.

PyTorch counterpart of ``r4w_tpu.channel.channel``; so far only AWGN.
Randomness comes from an explicit ``torch.Generator`` in place of a
``jax.random`` key. The two give different streams from the same seed,
so a caller that must match the JAX package passes the noise itself.

All functions take and return (..., N) complex64 blocks and operate on
the last axis.
"""

from __future__ import annotations

import torch

from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, to_tensor


def _complex_normal(shape, std, *, generator: torch.Generator, device=None) -> torch.Tensor:
    """Circular complex Gaussian with per-component std `std`."""
    device = generator.device if device is None else device
    re = torch.randn(shape, generator=generator, dtype=REAL_DTYPE, device=device)
    im = torch.randn(shape, generator=generator, dtype=REAL_DTYPE, device=device)
    return torch.complex(re * std, im * std)


def awgn(samples, snr_db, *, generator: torch.Generator | None = None,
         noise: torch.Tensor | None = None, path_loss_db=0.0,
         measured_power=None) -> torch.Tensor:
    """AWGN at a target SNR.

    Noise power follows the measured mean signal power over the last axis
    (or `measured_power` if given); path loss attenuates the signal before
    the noise is added. `snr_db` broadcasts against (..., 1), so a
    (lanes, SNRs, N) block takes SNRs of shape (SNRs, 1).

    Pass exactly one of `generator` (draws fresh noise of the samples'
    shape on its device) and `noise` (unit variance per component,
    broadcasting to the samples).
    """
    if (generator is None) == (noise is None):
        raise ValueError("pass exactly one of generator and noise")
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
        noise = _complex_normal(samples.shape, 1.0, generator=generator, device=device)
    return samples * attenuation + noise.to(device=device, dtype=IQ_DTYPE) * noise_std
