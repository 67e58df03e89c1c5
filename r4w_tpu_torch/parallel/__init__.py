"""Batched Monte-Carlo runs on one device.

PyTorch counterpart of the single-device part of ``r4w_tpu.parallel``.
Where the JAX package vmaps a per-item function, the port's modem
functions take leading batch dimensions themselves, so a batch or a
(lanes, SNRs) grid is one call. Mesh construction and the sharded sums
come with the multi-device port.
"""

from __future__ import annotations

import torch

from r4w_tpu_torch.core.types import REAL_DTYPE, to_tensor


def batch_modulate(modulate_fn, payloads) -> torch.Tensor:
    """Modulate a batch of equal-length payloads, (B, n) -> (B, ...).

    `modulate_fn` takes the batch dimension, as the port's modulators do.
    """
    return modulate_fn(to_tensor(payloads))


def batch_demodulate(demodulate_fn, bursts):
    """Demodulate (B, N) IQ bursts with a batch-aware `demodulate_fn`."""
    return demodulate_fn(to_tensor(bursts))


def monte_carlo_ber(trial_ber, n_lanes: int, snrs_db, *,
                    generator: torch.Generator) -> torch.Tensor:
    """(lanes × SNRs) BER matrix from one batched call.

    trial_ber(snr_db, generator) -> BER of `snr_db`'s shape; it receives
    the SNRs as a (n_lanes, len(snrs_db)) grid on the generator's device
    and draws every lane's noise from `generator`.
    """
    snrs = torch.as_tensor(snrs_db, dtype=REAL_DTYPE, device=generator.device)
    return trial_ber(snrs.expand(n_lanes, -1), generator)


def ber_sweep(ber_fn, payload, snrs_db, n_lanes: int = 128,
              seed: int = 0) -> torch.Tensor:
    """Mean BER per SNR over n_lanes Monte-Carlo channels.

    ber_fn(payload, snr_db, *, generator) -> BER of `snr_db`'s shape (e.g.
    `lora.loopback_ber` with its params bound). The noise comes from a
    generator seeded with `seed` on the payload's device.
    """
    payload = to_tensor(payload)
    generator = torch.Generator(device=payload.device).manual_seed(seed)
    grid = monte_carlo_ber(lambda snr, gen: ber_fn(payload, snr, generator=gen),
                           n_lanes, snrs_db, generator=generator)
    return torch.mean(grid, dim=0)
