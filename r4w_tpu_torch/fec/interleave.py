"""Interleavers on tensors: block, convolutional (as an index map) and
patterned, pure index permutations over the last axis.

PyTorch counterpart of ``r4w_tpu.fec.interleave``. A trailing partial
block is dropped, as the reference drops it. Permutations are
`index_select`s, which raise on a bad index.
"""

from __future__ import annotations

import numpy as np
import torch

from r4w_tpu_torch.core.types import to_tensor


def block_interleave(x, rows: int, cols: int) -> torch.Tensor:
    """Write row-wise, read column-wise over blocks of rows*cols."""
    x = to_tensor(x)
    n = rows * cols
    blocks = x.shape[-1] // n
    y = x[..., : blocks * n].reshape(*x.shape[:-1], blocks, rows, cols)
    return y.transpose(-1, -2).reshape(*x.shape[:-1], blocks * n)


def block_deinterleave(x, rows: int, cols: int) -> torch.Tensor:
    return block_interleave(x, cols, rows)


def conv_interleave_indices(n: int, branches: int, depth: int) -> np.ndarray:
    """Index map for a convolutional (Forney) interleaver flattened to a
    block of n elements: element i is delayed by (i % B)·depth slots."""
    delays = (np.arange(n) % branches) * depth
    dest = np.arange(n) + delays * branches
    order = np.argsort(dest, kind="stable")
    return order.astype(np.int32)


def patterned_interleave(x, pattern) -> torch.Tensor:
    """Permute by an explicit repeating pattern."""
    x = to_tensor(x)
    pat = torch.from_numpy(np.asarray(pattern, np.int64)).to(x.device)
    p = pat.numel()
    blocks = x.shape[-1] // p
    y = x[..., : blocks * p].reshape(*x.shape[:-1], blocks, p)
    return y.index_select(-1, pat).reshape(*x.shape[:-1], blocks * p)


def patterned_deinterleave(x, pattern) -> torch.Tensor:
    return patterned_interleave(x, np.argsort(np.asarray(pattern, np.int64)))
