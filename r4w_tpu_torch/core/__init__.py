from r4w_tpu_torch.core.types import (
    IQ_DTYPE,
    REAL_DTYPE,
    SYMBOL_DTYPE,
    BufferTooShort,
    CommonParams,
    DspError,
    InvalidParameter,
    db_to_linear_amplitude,
    db_to_linear_power,
    linear_power_to_db,
    next_pow2,
)

__all__ = [
    "IQ_DTYPE",
    "REAL_DTYPE",
    "SYMBOL_DTYPE",
    "BufferTooShort",
    "CommonParams",
    "DspError",
    "InvalidParameter",
    "db_to_linear_amplitude",
    "db_to_linear_power",
    "linear_power_to_db",
    "next_pow2",
]
