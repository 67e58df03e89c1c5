"""Waveform package: registry-backed factory over the waveform fleet.

Importing this package registers all 50 waveforms with the factory, in
the reference's order (the order of `r4w_tpu.waveforms`'s registration
imports, which `list_waveforms()` returns).
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

# Registration imports: their order is the order of list_waveforms().
from r4w_tpu_torch.waveforms import simple_waveforms  # noqa: F401  CW/OOK/ASK/FSK
from r4w_tpu_torch.waveforms import ppm  # noqa: F401  PPM/ADS-B
from r4w_tpu_torch.waveforms import analog  # noqa: F401  AM/FM/NBFM
from r4w_tpu_torch.waveforms import psk  # noqa: F401  BPSK/QPSK/8-PSK
from r4w_tpu_torch.waveforms import qam  # noqa: F401  16/64/256-QAM
from r4w_tpu_torch.waveforms import ofdm  # noqa: F401
from r4w_tpu_torch.waveforms import dsss  # noqa: F401
from r4w_tpu_torch.waveforms import iot_waveforms  # noqa: F401  Zigbee/UWB/FMCW
from r4w_tpu_torch.waveforms import hf_waveforms  # noqa: F401  ALE/3G-ALE
from r4w_tpu_torch.waveforms import stanag4285  # noqa: F401  STANAG 4285
from r4w_tpu_torch.waveforms import milstd188110  # noqa: F401  110A + autobaud
from r4w_tpu_torch.waveforms import pmr_waveforms  # noqa: F401  P25/TETRA/DMR
from r4w_tpu_torch.waveforms import milfh_waveforms  # noqa: F401  FHSS (imported), SINCGARS/HQ
from r4w_tpu_torch.waveforms import link16  # noqa: F401  Link-16
from r4w_tpu_torch.waveforms import beacon  # noqa: F401  emergency beacons
from r4w_tpu_torch.waveforms import fhss  # noqa: F401
from r4w_tpu_torch.waveforms import lora_waveform  # noqa: F401  LoRa/SF7/SF12
from r4w_tpu_torch.waveforms import gnss_waveforms  # noqa: F401  GPS/GLONASS/Galileo

__all__ = [
    "DemodResult",
    "Waveform",
    "WaveformFactory",
    "WaveformInfo",
    "create_waveform",
    "list_waveforms",
    "register_waveform",
]
