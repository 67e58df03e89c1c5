"""GNSS stack: PRN codes, BOC/CBOC, batched PCPS acquisition, DLL/PLL
tracking, coordinates/orbits/atmosphere, LNAV, scenario engine.

PyTorch counterpart of ``r4w_tpu.gnss``, with the same public names.
Acquisition, tracking and the scenario's composite run on tensors (the
CUDA card by default); the PRN codes, BOC, coordinates, orbits and
atmosphere, ephemeris, LNAV and the position solve are numpy, copies of
the JAX package's own numpy modules. `gps_pvt_fix` is the GPS L1 C/A
receiver from IQ to a position fix.
"""

from r4w_tpu_torch.gnss import boc, coordinates, environment, ephemeris, nav_message, prn
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
    "AcquisitionResult", "PcpsConfig", "acquire", "pcps_grid",
    "GnssScenario", "ReceiverConfig", "SatelliteConfig", "ScenarioConfig",
    "load_scenario_yaml",
    "TrackingConfig", "TrackingState", "dll_s_curve", "extract_nav_bits",
    "init_state", "track",
]
