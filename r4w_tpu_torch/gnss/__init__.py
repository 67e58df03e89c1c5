"""GNSS stack: PRN codes, BOC/CBOC, batched PCPS acquisition, DLL/PLL
tracking, coordinates/orbits/atmosphere, LNAV, scenario engine.

PyTorch counterpart of ``r4w_tpu.gnss``, with the same public names.
Acquisition, tracking and the scenario's composite run on tensors (the
CUDA card by default); the PRN codes, BOC, coordinates, orbits and
atmosphere, ephemeris, LNAV, the I/NAV words and the position solve are
numpy, copies of the JAX package's own numpy modules; I/NAV decoding runs
the port's Viterbi decoder on a device. The receivers, from IQ to a
result, are modules run with ``python -m`` and not imported here:
`gps_pvt_fix` (GPS L1 C/A), `galileo_pvt` (Galileo E1B), `dual_pvt` (both
on one capture, a joint fix) and `glonass_track` (GLONASS L1OF FDMA
tracking).
"""

from r4w_tpu_torch.gnss import (boc, coordinates, environment, ephemeris, inav, inav_words,
                                nav_message, prn)
from r4w_tpu_torch.gnss.acquisition import (
    AcquisitionResult,
    PcpsConfig,
    acquire,
    pcps_grid,
)
from r4w_tpu_torch.gnss.scenario import (
    GnssScenario,
    ReceiverConfig,
    SatelliteConfig,
    ScenarioConfig,
    load_scenario_yaml,
)
from r4w_tpu_torch.gnss.tracking import (
    TrackingConfig,
    TrackingState,
    dll_s_curve,
    extract_nav_bits,
    init_state,
    track,
)

__all__ = [
    "boc", "coordinates", "environment", "ephemeris", "nav_message", "prn",
    "inav", "inav_words",
    "AcquisitionResult", "PcpsConfig", "acquire", "pcps_grid",
    "GnssScenario", "ReceiverConfig", "SatelliteConfig", "ScenarioConfig",
    "load_scenario_yaml",
    "TrackingConfig", "TrackingState", "dll_s_curve", "extract_nav_bits",
    "init_state", "track",
]
