"""Waveform package: registry-backed factory over the ported waveforms.

Importing this package registers every ported waveform with the factory;
so far that is the LoRa family, MIL-STD-188-110, the GNSS signals
(GPS L1 C/A and L5, GLONASS L1OF, Galileo E1), the PSK and QAM families
and STANAG 4285.
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
from r4w_tpu_torch.waveforms import gnss_waveforms  # noqa: F401  GPS/GLONASS/Galileo
from r4w_tpu_torch.waveforms import psk, qam  # noqa: F401  BPSK-8PSK, 16-256-QAM
from r4w_tpu_torch.waveforms import stanag4285  # noqa: F401  STANAG 4285

__all__ = [
    "DemodResult",
    "Waveform",
    "WaveformFactory",
    "WaveformInfo",
    "create_waveform",
    "list_waveforms",
    "register_waveform",
]
