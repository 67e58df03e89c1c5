"""DSP ops ported so far: the LoRa coding chain (`coding`), soft demapping
and the rest of the modem blocks (`modem`), the spreading-code generators
and the RAKE receiver (`spreading`), the filters and
designs (`filters`), pulse shaping (`pulse`), resampling, channelizers
and PFB timing recovery (`resample`), the DDC and VCO (`stream_math`),
the DUC (`filters2`), measurement (`measure`), OFDM channel estimation
and equalisation (`ofdm`), the hardware impairments (`impairments`),
synchronisation (`sync`, `sync2`), the equalizers (`equalizers`) and AGC
with the CORDIC, chirp-Z and time-frequency blocks (`agc`), the event
primitives (`events`), symbol mapping and the composed modems with the
broadcast FM receivers (`mapping`), the scramblers and the FEC table
(`scramblers`) and the specialty modems (`exotic_modems`). Like the
reference's ``r4w_tpu.ops``, the package imports and exports the modules
of its list that the port has, and the modules the port added since (the
reference's list leaves out `sync2`, `stream_math`, `filters2`, `ofdm`,
`events`, `mapping`, `scramblers` and `exotic_modems`, which import
as submodules all the same)."""

from r4w_tpu_torch.ops import (
    agc,
    coding,
    equalizers,
    filters,
    impairments,
    measure,
    modem,
    pulse,
    resample,
    spreading,
    sync,
)

__all__ = [
    "agc",
    "coding",
    "equalizers",
    "filters",
    "impairments",
    "measure",
    "modem",
    "pulse",
    "resample",
    "spreading",
    "sync",
]
