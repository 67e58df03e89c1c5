"""Carry state across from the JAX package.

The ported slices have no weights; their state is the parameter sets and
the constant tables. `params_from_reference` reads an ``r4w_tpu`` LoRa
parameter set by its dataclass fields (duck-typed, so JAX is never
imported), and `tables_numpy` and `viterbi_tables_numpy` hand the port's
tables back as numpy so they can be held against the reference's own.
`fir_from_reference` takes a reference FIR's taps and streaming state
(numpy) onto a device, so a stream begun in the JAX package goes on in
the port. `channel_config_from_reference` reads a reference
`ChannelConfig` by its fields; `ldpc_code_from_reference` and
`dvb_s2x_structure_from_reference` take the reference's code structures
(the ``make_regular_ldpc`` tuple, a ``parity_structure`` dict) onto a
device with the decoders' layouts. `tle_from_reference`,
`modcod_from_reference` (and `modcod_table_from_reference` for
`AdaptiveModcod`'s ladder) and `radar_track_from_reference` read the
radar and link slice's dataclasses by their fields, so that a test builds
the port's from the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from r4w_tpu_torch.channel.channel import ChannelConfig
from r4w_tpu_torch.core.types import DEFAULT_DEVICE, IQ_DTYPE, REAL_DTYPE
from r4w_tpu_torch.fec import convolutional, dvb_s2x, ldpc
from r4w_tpu_torch.kernels import dechirp, viterbi
from r4w_tpu_torch.ops import coding, mimo, propagation, radar_adv
from r4w_tpu_torch.waveforms.lora import chirp
from r4w_tpu_torch.waveforms.lora.params import LoRaParams

WHITENING_BYTES = 255  # the longest LoRa payload


def params_from_reference(p) -> LoRaParams:
    """An ``r4w_tpu`` `LoRaParams` (or anything with its fields) -> the port's."""
    return LoRaParams(**{f.name: getattr(p, f.name) for f in dataclasses.fields(LoRaParams)})


def tables_numpy(params: LoRaParams) -> dict[str, np.ndarray]:
    """The port's constant tables for `params`, as the CPU caches hold them.

    Keys: ``upchirp`` and ``downchirp`` (reference: ``_base_chirps_np``),
    ``hamming_encode`` and ``hamming_decode`` (``_hamming_tables``),
    ``whitening`` (``_whitening_sequence(255)``) and ``twiddle``, the
    (K,) table whose entry (n·b) mod K is ``_dft_mats(K)``'s entry (n, b).
    """
    device = torch.device("cpu")
    up, down = chirp._base_chirps(params.sf, params.bw_hz, params.oversample, device)
    enc, dec = coding._hamming_luts(params.cr, device)
    tables = {
        "upchirp": up,
        "downchirp": down,
        "hamming_encode": enc,
        "hamming_decode": dec,
        "whitening": coding.whitening_sequence(WHITENING_BYTES, device),
        "twiddle": dechirp._twiddle(params.chips_per_symbol, device),
    }
    return {name: t.numpy() for name, t in tables.items()}


def viterbi_tables_numpy(constraint: int, polys) -> dict:
    """The port's trellis tables for a rate-1/R code of constraint `constraint`.

    Keys: ``outputs`` (S, 2, R) and ``next_state`` (S, 2) (reference:
    ``convolutional._trellis``), ``code_index`` (S, 2), the codeword index
    per (state, input bit) that the forward kernel reads (the reference's
    ``oidx`` in ``pallas_kernels._viterbi_consts``), and ``word_width``, the
    decisions packed per int32 word (its ``w``).
    """
    outputs, next_state = convolutional._trellis(constraint, tuple(polys))
    return {"outputs": outputs, "next_state": next_state,
            "code_index": viterbi.code_index(constraint, tuple(polys)),
            "word_width": viterbi.word_width(constraint)}


def fir_from_reference(taps, state=None, device=DEFAULT_DEVICE):
    """A reference FIR's parameters and streaming state as the port's tensors.

    `taps` is the (K,) tap array and `state` the last K-1 input samples
    that ``r4w_tpu.ops.filters.fir_filter`` or ``decimating_fir`` returned
    (numpy, real or complex, any leading batch axes), or None before the
    first block. Returns (taps float32, state float32 or complex64 or
    None), both on `device`, to pass to the port's `fir_filter` or
    `decimating_fir` with the next block.
    """
    device = torch.device(device)
    taps_t = torch.as_tensor(np.array(taps, dtype=np.float32), device=device)
    if state is None:
        return taps_t, None
    state = np.array(state)  # a copy: numpy views of JAX arrays are read-only
    dtype = IQ_DTYPE if np.iscomplexobj(state) else REAL_DTYPE
    return taps_t, torch.as_tensor(state, device=device).to(dtype)


def channel_config_from_reference(cfg) -> ChannelConfig:
    """An ``r4w_tpu`` `ChannelConfig` (or anything with its fields) -> the port's."""
    return ChannelConfig(**{f.name: getattr(cfg, f.name)
                            for f in dataclasses.fields(ChannelConfig)})


def ldpc_code_from_reference(h_g, device=DEFAULT_DEVICE) -> ldpc.LdpcCode:
    """The reference's ``make_regular_ldpc`` tuple ``(h, g, k, data_cols)``
    (numpy) as an `LdpcCode` on `device`, for `ldpc_encode`, `ldpc_decode`
    and `ldpc_extract_data`."""
    h, g, k, data_cols = h_g
    return ldpc.ldpc_code((np.array(h), np.array(g), int(k), np.array(data_cols)),
                          torch.device(device))


def dvb_s2x_structure_from_reference(st: dict, device=DEFAULT_DEVICE) -> dvb_s2x.Structure:
    """A reference ``dvb_s2x.parity_structure`` dict on `device`: dimensions,
    the information columns' rows and columns, and the decoder's layout."""
    return dvb_s2x.structure_on({key: np.array(v) for key, v in st.items()},
                                torch.device(device))


def _fields(cls, obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)}


def tle_from_reference(tle) -> propagation.Tle:
    """An ``r4w_tpu`` `propagation.Tle` (or anything with its fields) -> the port's."""
    return propagation.Tle(**_fields(propagation.Tle, tle))


def modcod_from_reference(mc) -> mimo.ModCod:
    """An ``r4w_tpu`` `mimo.ModCod` -> the port's."""
    return mimo.ModCod(**_fields(mimo.ModCod, mc))


def modcod_table_from_reference(table) -> tuple:
    """A ladder of reference `ModCod`s (``DEFAULT_MODCOD_TABLE``, an
    `AdaptiveModcod`'s ``table``) -> the port's, for its `AdaptiveModcod`."""
    return tuple(modcod_from_reference(mc) for mc in table)


def radar_track_from_reference(track) -> radar_adv.RadarTrack:
    """An ``r4w_tpu`` `radar_adv.RadarTrack` -> the port's (numpy state, copied)."""
    fields = _fields(radar_adv.RadarTrack, track)
    fields["x"], fields["cov"] = np.array(track.x), np.array(track.cov)
    return radar_adv.RadarTrack(**fields)
