"""Spreading-code generators.

PyTorch counterpart of ``r4w_tpu.ops.spreading``; so far only the
Fibonacci LFSR, which builds the MIL-STD-188-110 preamble and scrambler
tables. Codes are tiny and static, so they are numpy arrays built once on
the host; callers move them to a device as constants.
"""

from __future__ import annotations

import numpy as np


def lfsr_bits(degree: int, polynomial: int, initial_state: int = 0x01,
              length: int | None = None) -> np.ndarray:
    """Fibonacci LFSR output bits: MSB out, feedback = parity(state & poly),
    shift left. `length` defaults to one period, 2^degree - 1."""
    n = length if length is not None else (1 << degree) - 1
    state = initial_state
    mask = (1 << degree) - 1
    out = np.empty(n, np.int8)
    for i in range(n):
        out[i] = (state >> (degree - 1)) & 1
        fb = bin(state & polynomial).count("1") & 1
        state = ((state << 1) | fb) & mask
    return out
