"""DSP ops ported so far: the LoRa coding chain (`coding`), soft demapping
and the rest of the modem blocks (`modem`), the spreading-code generators
and the RAKE receiver (`spreading`), the filters and
designs (`filters`), pulse shaping (`pulse`), resampling, channelizers
and PFB timing recovery (`resample`), the stream math with the DDC and
VCO (`stream_math`), the second-tier filters with the DUC (`filters2`),
measurement (`measure`), OFDM channel estimation
and equalisation (`ofdm`), the hardware impairments (`impairments`),
synchronisation (`sync`, `sync2`), the equalizers (`equalizers`) and AGC
with the CORDIC, chirp-Z and time-frequency blocks (`agc`), the event
primitives (`events`), symbol mapping and the composed modems with the
broadcast FM receivers (`mapping`), the scramblers and the FEC table
(`scramblers`), the specialty modems (`exotic_modems`), the stream
blocks (`stream_blocks`), the detectors (`detect`), the adaptive filters
(`adaptive`), the Kalman filters (`kalman`), and radar, arrays and
propagation: `radar`, `radar_sonar`, `radar_adv`, `beamforming`, `mimo`,
`propagation` and `ew`. Like the reference's
``r4w_tpu.ops``, the package imports and exports the modules of its list
that the port has, and the stream and detection modules (`stream_math`,
`filters2`, `stream_blocks`, `detect`), which the reference's list leaves
out; `sync2`, `ofdm`, `events`, `mapping`, `scramblers` and
`exotic_modems`, also left out of it, import as submodules. Of the radar,
array and propagation modules the reference's list has `radar` and `ew`;
the port exports `radar_sonar`, `radar_adv`, `beamforming`, `mimo` and
`propagation` beside them."""

from r4w_tpu_torch.ops import (
    adaptive,
    agc,
    beamforming,
    coding,
    detect,
    equalizers,
    ew,
    filters,
    filters2,
    impairments,
    kalman,
    measure,
    mimo,
    modem,
    propagation,
    pulse,
    radar,
    radar_adv,
    radar_sonar,
    resample,
    spreading,
    stream_blocks,
    stream_math,
    sync,
)

__all__ = [
    "adaptive",
    "agc",
    "beamforming",
    "coding",
    "detect",
    "equalizers",
    "ew",
    "filters",
    "filters2",
    "impairments",
    "kalman",
    "measure",
    "mimo",
    "modem",
    "propagation",
    "pulse",
    "radar",
    "radar_adv",
    "radar_sonar",
    "resample",
    "spreading",
    "stream_blocks",
    "stream_math",
    "sync",
]
