"""Digital up-conversion.

PyTorch counterpart of ``r4w_tpu.ops.filters2.digital_up_converter``
(digital_up_converter.rs), the inverse of
`stream_math.digital_down_convert`; the rest of that module is not ported
yet.
"""

from __future__ import annotations

from r4w_tpu_torch.core.types import IQ_DTYPE, to_tensor
from r4w_tpu_torch.kernels.nco import nco_mix_dispatch
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
