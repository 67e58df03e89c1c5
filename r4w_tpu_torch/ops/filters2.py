"""Digital up-conversion and the emphasis filters.

PyTorch counterpart of ``r4w_tpu.ops.filters2.digital_up_converter``
(digital_up_converter.rs), the inverse of
`stream_math.digital_down_convert`, and of its emphasis group
(`pre_emphasis`, `de_emphasis`, `fm_deemphasis`; pre_emphasis.rs,
fm_emphasis.rs). The de-emphasis recursions run on
`kernels.recurrence.first_order_recurrence_dispatch`, one launch of the
Hopper kernel a call on the card. Samples are on the last axis, leading
axes a batch. The rest of that module is not ported yet.
"""

from __future__ import annotations

import torch

from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, to_tensor
from r4w_tpu_torch.kernels.nco import nco_mix_dispatch
from r4w_tpu_torch.kernels.recurrence import first_order_recurrence_dispatch
from r4w_tpu_torch.ops import filters as _filters
from r4w_tpu_torch.ops import resample as _resample


def digital_up_converter(x, interp: int, center_hz: float,
                         sample_rate_out: float, n_taps: int = 63):
    """DUC: polyphase interpolate by `interp` (anti-image lowpass at the
    output Nyquist/interp), then mix to `center_hz` along the last axis."""
    taps = _filters.design_lowpass(n_taps, sample_rate_out / (2 * interp),
                                   sample_rate_out)
    y = _resample.polyphase_interpolate(to_tensor(x, IQ_DTYPE), taps, interp)
    return nco_mix_dispatch(y, center_hz, sample_rate_out)


# ------------------------------------------------------- pre-emphasis


def pre_emphasis(x, alpha: float = 0.95):
    """First-difference pre-emphasis y[n]=x[n]-a·x[n-1]
    (pre_emphasis.rs)."""
    x = to_tensor(x, REAL_DTYPE)
    return torch.cat([x[..., :1], x[..., 1:] - alpha * x[..., :-1]], dim=-1)


def de_emphasis(x, alpha: float = 0.95):
    """Inverse of pre_emphasis: one-pole IIR y[n] = x[n] + α·y[n-1] from
    y[-1] = 0 (fm_emphasis.rs)."""
    return first_order_recurrence_dispatch(to_tensor(x, REAL_DTYPE), alpha)


def fm_deemphasis(x, sample_rate: float, tau_us: float = 75.0):
    """Broadcast-FM de-emphasis single-pole IIR with time constant tau
    (fm_emphasis.rs)."""
    dt = 1.0 / sample_rate
    alpha = dt / (tau_us * 1e-6 + dt)
    y, _ = _filters.single_pole_iir(alpha, to_tensor(x, REAL_DTYPE))
    return y
