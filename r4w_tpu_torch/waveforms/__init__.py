"""Waveform package: registry-backed factory over the ported waveforms.

Importing this package registers every ported waveform with the factory;
so far that is the LoRa family and MIL-STD-188-110.
"""

from r4w_tpu_torch.waveforms.base import (
    DemodResult,
    Waveform,
    WaveformFactory,
    WaveformInfo,
    create_waveform,
    list_waveforms,
    register_waveform,
)
from r4w_tpu_torch.waveforms import lora_waveform  # noqa: F401  registers LoRa
from r4w_tpu_torch.waveforms import milstd188110  # noqa: F401  110A + autobaud

__all__ = [
    "DemodResult",
    "Waveform",
    "WaveformFactory",
    "WaveformInfo",
    "create_waveform",
    "list_waveforms",
    "register_waveform",
]
