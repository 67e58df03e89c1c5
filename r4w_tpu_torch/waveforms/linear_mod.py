"""Linear-modulation helpers.

PyTorch counterpart of ``r4w_tpu.waveforms.linear_mod``; so far only the
bit packing that the serial-tone HF modems share.
"""

from __future__ import annotations

import torch

from r4w_tpu_torch.ops.coding import bits_to_bytes


def pack_demod_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pad a bit stream (..., n) to whole bytes and pack it MSB first."""
    rem = bits.shape[-1] % 8
    if rem:
        bits = torch.nn.functional.pad(bits, (0, 8 - rem))
    return bits_to_bytes(bits)
