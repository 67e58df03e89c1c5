"""Block registry + plugin system.

PyTorch counterpart of ``r4w_tpu.registry``: block_gateway.rs
(BlockRegistry/BlockCategory — runtime block discovery for pipeline
builders) and plugin/mod.rs (C-ABI dynamic waveform plugins and Python
module plugins, manager.rs:148). The catalog registers the port's own
functions under the reference's 523 names: the hand-listed entries, each
``r4w_tpu_torch.ops`` module's BLOCKS table, the `infra_fills.alias_blocks`
aliases and a ``mod_<waveform>`` modulator for each factory name. Waveform
builders, the ``mod_`` factories and plugin builders take a device (the
card unless named). The reference's `jit_safety` probe (JAX abstract
tracing) has no counterpart.
"""

from __future__ import annotations

import dataclasses
import enum
import importlib
import importlib.util
import os
import sys
from typing import Callable


class BlockCategory(enum.Enum):
    SOURCE = "source"
    SINK = "sink"
    FILTER = "filter"
    MODULATOR = "modulator"
    DEMODULATOR = "demodulator"
    SYNC = "sync"
    FEC = "fec"
    MEASUREMENT = "measurement"
    CHANNEL = "channel"
    RESAMPLER = "resampler"
    GNSS = "gnss"
    RADAR = "radar"
    MATH = "math"


@dataclasses.dataclass(frozen=True)
class BlockInfo:
    name: str
    category: BlockCategory
    description: str
    factory: Callable
    params: tuple[str, ...] = ()


class BlockRegistry:
    """Runtime block catalog (block_gateway.rs:28)."""

    def __init__(self):
        self._blocks: dict[str, BlockInfo] = {}

    def register(self, name: str, category: BlockCategory,
                 description: str, factory: Callable,
                 params: tuple[str, ...] = ()):
        self._blocks[name.lower()] = BlockInfo(name, category, description,
                                               factory, params)

    def get(self, name: str) -> BlockInfo | None:
        return self._blocks.get(name.lower())

    def create(self, name: str, **kwargs):
        info = self.get(name)
        if info is None:
            raise KeyError(f"unknown block '{name}'")
        return info.factory(**kwargs)

    def list(self, category: BlockCategory | None = None) -> list[BlockInfo]:
        out = sorted(self._blocks.values(), key=lambda b: b.name)
        if category:
            out = [b for b in out if b.category == category]
        return out

    def categories(self) -> dict[BlockCategory, int]:
        out: dict[BlockCategory, int] = {}
        for b in self._blocks.values():
            out[b.category] = out.get(b.category, 0) + 1
        return out

    def param_schema(self, name: str) -> list[dict]:
        """Typed parameter metadata for a block — name/type/default/
        required/role(/doc) per parameter of the block's primary
        callable (the forms-quality metadata role of the reference's
        block_metadata.rs:1-5148, harvested mechanically from
        signatures + annotations + docstrings instead of 5k hand-
        written lines). Cached per block."""
        if not hasattr(self, "_schema_cache"):
            self._schema_cache: dict[str, list[dict]] = {}
        key = name.lower()
        if key not in self._schema_cache:
            info = self.get(key)
            if info is None:
                raise KeyError(f"unknown block '{name}'")
            from r4w_tpu_torch.block_schema import build_schema
            self._schema_cache[key] = build_schema(info)
        return self._schema_cache[key]


def _ofdm_ops():
    from r4w_tpu_torch.ops import ofdm as ofdm_ops

    return ofdm_ops


def _eq_ops():
    from r4w_tpu_torch.ops import equalizers

    return equalizers


def _modem_ops():
    from r4w_tpu_torch.ops import modem

    return modem


def _dvb():
    from r4w_tpu_torch.fec import dvb_s2x

    return dvb_s2x


def _detect():
    from r4w_tpu_torch.ops import detect

    return detect


def _smath():
    from r4w_tpu_torch.ops import stream_math

    return stream_math


def _proto():
    from r4w_tpu_torch.ops import protocols

    return protocols


def _applied():
    from r4w_tpu_torch.ops import applied

    return applied


def _mimo():
    from r4w_tpu_torch.ops import mimo

    return mimo


def _tcm():
    from r4w_tpu_torch.fec import tcm

    return tcm


def _conv():
    from r4w_tpu_torch.fec import convolutional

    return convolutional


def _radv():
    from r4w_tpu_torch.ops import radar_adv

    return radar_adv


def _measure():
    from r4w_tpu_torch.ops import measure

    return measure


def _pvt():
    from r4w_tpu_torch.gnss import pvt

    return pvt


# Catalog modules registered via their BLOCKS tables (see _populate).
_CATALOG_MODULES = (
    "r4w_tpu_torch.ops.stream_blocks",
    "r4w_tpu_torch.ops.filters2",
    "r4w_tpu_torch.ops.sync2",
    "r4w_tpu_torch.ops.mapping",
    "r4w_tpu_torch.ops.scramblers",
    "r4w_tpu_torch.ops.packets",
    "r4w_tpu_torch.ops.audio",
    "r4w_tpu_torch.ops.beamforming",
    "r4w_tpu_torch.ops.radar_sonar",
    "r4w_tpu_torch.ops.spectral2",
    "r4w_tpu_torch.ops.cognitive",
    "r4w_tpu_torch.ops.propagation",
    "r4w_tpu_torch.ops.exotic_modems",
    "r4w_tpu_torch.ops.sensing",
    "r4w_tpu_torch.ops.biomedical",
    "r4w_tpu_torch.ops.instruments",
    "r4w_tpu_torch.ops.navigation",
    "r4w_tpu_torch.ops.infra_fills",
)


def _populate(reg: BlockRegistry):
    """Register the built-in catalog (the pipeline-builder surface the
    GUI's pipeline_wizard consumes)."""
    from r4w_tpu_torch.ops import (coding, filters, impairments, measure, pulse,
                             radar, resample, spreading, sync)
    from r4w_tpu_torch import channel as ch

    C = BlockCategory
    entries = [
        ("fir_filter", C.FILTER, "FIR filter (streaming state)",
         lambda **k: filters.fir_filter, ("taps",)),
        ("iir_filter", C.FILTER, "IIR biquad/direct-form II",
         lambda **k: filters.iir_filter, ("b", "a")),
        ("dc_blocker", C.FILTER, "DC removal", lambda **k: filters.dc_blocker),
        ("cic_decimator", C.FILTER, "CIC decimating filter",
         lambda **k: filters.cic_decimator, ("rate", "stages")),
        ("median_filter", C.FILTER, "sliding median",
         lambda **k: filters.median_filter, ("length",)),
        ("moving_average", C.FILTER, "boxcar average",
         lambda **k: filters.moving_average, ("length",)),
        ("rrc_shaper", C.FILTER, "root-raised-cosine pulse shaping",
         lambda **k: pulse.shape_symbols, ("sps", "rolloff")),
        ("polyphase_decimator", C.RESAMPLER, "decimating FIR",
         lambda **k: resample.polyphase_decimate, ("factor",)),
        ("rational_resampler", C.RESAMPLER, "L/M resampler",
         lambda **k: resample.rational_resample, ("up", "down")),
        ("arbitrary_resampler", C.RESAMPLER, "fractional-ratio resampler",
         lambda **k: resample.arbitrary_resample, ("ratio",)),
        ("pfb_channelizer", C.RESAMPLER, "polyphase channelizer",
         lambda **k: resample.pfb_channelizer, ("n_channels",)),
        ("costas_loop", C.SYNC, "carrier recovery",
         lambda **k: sync.costas_loop, ("loop_bw", "order")),
        ("cfo_estimator", C.SYNC, "blind CFO estimate",
         lambda **k: sync.cfo_estimate, ("order",)),
        ("correlate_sync", C.SYNC, "preamble correlation sync",
         lambda **k: sync.correlate_sync, ("threshold",)),
        ("schmidl_cox", C.SYNC, "OFDM timing metric",
         lambda **k: sync.schmidl_cox, ("half_len",)),
        ("awgn_channel", C.CHANNEL, "AWGN at target SNR",
         lambda **k: ch.awgn, ("snr_db",)),
        ("rayleigh_channel", C.CHANNEL, "iid Rayleigh fading",
         lambda **k: ch.rayleigh),
        ("tdl_channel", C.CHANNEL, "3GPP EPA/EVA/ETU fading TDL",
         lambda **k: ch.tdl_channel, ("profile", "doppler_hz")),
        ("phase_noise", C.CHANNEL, "Wiener phase noise",
         lambda **k: impairments.phase_noise, ("linewidth_hz",)),
        ("iq_imbalance", C.CHANNEL, "gain/phase IQ imbalance",
         lambda **k: impairments.iq_imbalance, ("gain_db", "phase_deg")),
        ("welch_psd", C.MEASUREMENT, "Welch averaged PSD",
         lambda **k: measure.welch_psd, ("nperseg",)),
        ("evm", C.MEASUREMENT, "error-vector magnitude",
         lambda **k: measure.evm_rms),
        ("snr_m2m4", C.MEASUREMENT, "blind SNR estimator",
         lambda **k: measure.snr_estimate_m2m4),
        ("eye_diagram", C.MEASUREMENT, "overlapped symbol traces",
         lambda **k: measure.eye_diagram, ("sps",)),
        ("gold_code", C.SOURCE, "Gold spreading code",
         lambda **k: spreading.gold_code, ("degree", "index")),
        ("zadoff_chu", C.SOURCE, "Zadoff-Chu sequence",
         lambda **k: spreading.zadoff_chu, ("root", "length")),
        ("cfar", C.RADAR, "cell-averaging CFAR",
         lambda **k: radar.cfar_1d, ("guard", "train", "pfa")),
        ("pulse_compressor", C.RADAR, "matched-filter compression",
         lambda **k: radar.pulse_compress),
        ("range_doppler", C.RADAR, "range-Doppler map",
         lambda **k: radar.range_doppler_map),
        ("gray_code", C.MATH, "Gray encode/decode",
         lambda **k: (coding.gray_encode, coding.gray_decode)),
        ("ofdm_channel_est", C.SYNC,
         "pilot LS channel estimate + interpolation (ofdm_channel_est.rs)",
         lambda **k: _ofdm_ops().estimate_channel, ("pattern",)),
        ("ofdm_frame_equalizer", C.SYNC,
         "packet pilot/training equalizer ZF/MMSE (ofdm_frame_equalizer.rs)",
         lambda **k: _ofdm_ops().equalize_frame, ("pattern", "method")),
        ("ofdm_pilot_interpolator", C.SYNC,
         "pilot->full-band linear interpolation (ofdm_pilot_interpolator.rs)",
         lambda **k: _ofdm_ops().PilotPattern, ("positions", "values")),
        ("rake_receiver", C.SYNC,
         "multipath finger search + MRC/EGC/selection (rake_receiver.rs)",
         lambda **k: (spreading.rake_search, spreading.rake_combine),
         ("max_fingers", "mode")),
        ("turbo_equalizer", C.SYNC,
         "iterative FD soft-IC MMSE + BCJR (turbo_equalizer.rs)",
         lambda **k: _eq_ops().turbo_equalize,
         ("channel_taps", "n_iters")),
        ("time_domain_equalizer", C.SYNC,
         "train + decision-directed adaptive FIR (time_domain_equalizer.rs)",
         lambda **k: _eq_ops().time_domain_equalizer,
         ("n_taps", "algorithm")),
        ("fbmc_polyphase_mapper", C.MODULATOR,
         "FBMC/OQAM PHYDYAS synthesis/analysis (fbmc_polyphase_mapper.rs)",
         lambda **k: _modem_ops().fbmc_modulate, ("overlap",)),
        ("nr_resource_grid_mapper", C.MODULATOR,
         "5G NR slot grid with DMRS/PTRS (nr_resource_grid_mapper.rs)",
         lambda **k: _modem_ops().nr_map, ("numerology", "num_prbs")),
        ("dvb_s2x_ldpc", C.MATH,
         "DVB-S2X LDPC 11 rates, Normal/Short frames (dvb_s2x_ldpc_codec.rs)",
         lambda **k: _dvb(), ("rate", "frame")),
        # catalog long tail (r2): detectors / stream math / protocols /
        # applied DSP
        ("energy_detector", C.MEASUREMENT,
         "frame energy vs median floor (signal_detector.rs)",
         lambda **k: _detect().energy_detect, ("frame", "threshold_db")),
        ("burst_detector", C.MEASUREMENT,
         "hysteresis burst gate (burst_detector.rs)",
         lambda **k: _detect().burst_detect, ("frame", "on_db", "off_db")),
        ("squelch", C.MEASUREMENT, "power squelch (squelch.rs)",
         lambda **k: _detect().squelch, ("open_db", "close_db")),
        ("voice_activity", C.MEASUREMENT,
         "energy+ZCR VAD (voice_activity_detector.rs)",
         lambda **k: _detect().voice_activity, ("frame",)),
        ("sync_word_detector", C.SYNC,
         "bit-stream sync-word search (sync_word_detector.rs)",
         lambda **k: _detect().sync_word_detect, ("word", "max_errors")),
        ("spectral_kurtosis", C.MEASUREMENT,
         "impulsive-bin detector (spectral_kurtosis_detector.rs)",
         lambda **k: _detect().spectral_kurtosis, ("nfft",)),
        ("spectrum_sensor", C.MEASUREMENT,
         "PSD occupancy + holes (blind_spectrum_sensing.rs)",
         lambda **k: (_detect().spectrum_sense, _detect().spectrum_holes),
         ("nfft", "threshold_db")),
        ("cusum_detector", C.MEASUREMENT,
         "two-sided CUSUM changepoint (time_series_changepoint_detector.rs)",
         lambda **k: _detect().cusum_changepoint, ("drift", "threshold")),
        ("teager_kaiser", C.MATH,
         "Teager-Kaiser energy operator (teager_kaiser_energy.rs)",
         lambda **k: _detect().teager_kaiser),
        ("vco", C.SOURCE, "voltage-controlled oscillator (vco.rs)",
         lambda **k: _smath().vco, ("sensitivity_hz_per_unit",)),
        ("ddc", C.RESAMPLER,
         "digital down-converter (digital_down_converter.rs)",
         lambda **k: _smath().digital_down_convert,
         ("center_hz", "decimation")),
        ("quantizer", C.MATH,
         "uniform scalar quantizer (uniform_scalar_quantizer.rs)",
         lambda **k: _smath().uniform_quantize, ("n_bits",)),
        ("sigma_delta", C.MATH,
         "first-order sigma-delta (sigma_delta_modulator.rs)",
         lambda **k: _smath().sigma_delta_modulate),
        ("mu_law", C.MATH, "mu-law companding (companding_codec.rs)",
         lambda **k: (_smath().mu_law_encode, _smath().mu_law_decode)),
        ("adpcm", C.MATH, "IMA ADPCM 4-bit codec (adpcm_codec.rs)",
         lambda **k: (_smath().adpcm_encode, _smath().adpcm_decode)),
        ("ax25", C.SINK, "AX.25/HDLC framing (ax25.rs)",
         lambda **k: (_proto().ax25_encode, _proto().ax25_decode)),
        ("aprs", C.SINK, "APRS packets (aprs_decoder.rs)",
         lambda **k: (_proto().aprs_encode, _proto().aprs_decode)),
        ("ais", C.SINK, "AIS NMEA position reports (ais_decoder.rs)",
         lambda **k: (_proto().ais_encode_position, _proto().ais_decode)),
        ("acars", C.SINK, "ACARS character blocks (acars_decoder.rs)",
         lambda **k: (_proto().acars_encode, _proto().acars_decode)),
        ("slip", C.SINK, "SLIP framing (slip_decoder.rs)",
         lambda **k: (_proto().slip_encode, _proto().slip_decode)),
        ("ctcss", C.MEASUREMENT,
         "38-tone CTCSS detect/generate (ctcss_squelch.rs)",
         lambda **k: (_proto().ctcss_detect, _proto().ctcss_generate),
         ("threshold",)),
        ("wavelet_denoiser", C.FILTER,
         "Haar soft-threshold denoise (wavelet_denoiser.rs)",
         lambda **k: _applied().wavelet_denoise, ("level",)),
        ("spectral_subtraction", C.FILTER,
         "noise-floor subtraction (spectral_subtraction_denoiser.rs)",
         lambda **k: _applied().spectral_subtraction, ("nfft",)),
        ("cepstrum", C.MEASUREMENT,
         "real cepstrum + pitch (cepstral_analysis.rs)",
         lambda **k: (_applied().real_cepstrum, _applied().cepstral_pitch)),
        ("lpc_codec", C.MATH, "LPC vocoder (speech_codec_lpc.rs)",
         lambda **k: (_applied().lpc_coefficients,
                      _applied().lpc_analysis_synthesis), ("order",)),
        ("bearing_fault", C.MEASUREMENT,
         "envelope-spectrum fault metric "
         "(vibration_bearing_fault_detector.rs)",
         lambda **k: _applied().bearing_fault_metric, ("fault_hz",)),
        ("trilateration", C.MEASUREMENT,
         "range-based LS position (trilateration_solver.rs)",
         lambda **k: _applied().trilaterate),
        ("fastica", C.MATH,
         "2x2 blind source separation (blind_source_separation.rs)",
         lambda **k: _applied().fastica_2x2),
        ("omp", C.MATH, "OMP sparse recovery (compressive_sensing.rs)",
         lambda **k: _applied().omp, ("sparsity",)),
        ("modulation_classifier", C.MEASUREMENT,
         "cumulant-feature AMC (automatic_modulation_classifier.rs)",
         lambda **k: _applied().classify_modulation),
        ("alamouti", C.MODULATOR,
         "2x1 STBC encode/decode (alamouti_codec.rs)",
         lambda **k: (_mimo().alamouti_encode, _mimo().alamouti_decode)),
        ("diversity_combiner", C.SYNC,
         "MRC/EGC/selection combining (antenna_diversity_combiner.rs)",
         lambda **k: (_mimo().mrc_combine, _mimo().egc_combine,
                      _mimo().selection_combine)),
        ("sic", C.SYNC,
         "two-user successive interference cancellation "
         "(successive_interference_canceller.rs)",
         lambda **k: _mimo().sic_decode, ("gains",)),
        ("waterfilling", C.MATH,
         "waterfilling power allocation (waterfilling.rs)",
         lambda **k: _mimo().waterfilling, ("total_power",)),
        ("adaptive_modcod", C.MATH,
         "SNR-driven MCS ladder with hysteresis (adaptive_modcod.rs)",
         lambda **k: _mimo().AdaptiveModcod),
        ("uwb_ranging", C.MEASUREMENT,
         "two-way ranging + leading-edge TOA (ultra_wideband_ranging.rs)",
         lambda **k: (_mimo().twr_range, _mimo().leading_edge_toa)),
        ("tcm", C.FEC,
         "pragmatic 8PSK trellis-coded modulation (trellis_coding.rs)",
         lambda **k: (_tcm().tcm_encode, _tcm().tcm_decode)),
        ("map_decoder", C.FEC,
         "max-log-MAP soft-output decode (map_decoder.rs/viterbi_sova.rs)",
         lambda **k: _conv().map_decode),
        ("stap", C.RADAR,
         "space-time adaptive processing "
         "(space_time_adaptive_processor.rs)",
         lambda **k: (_radv().stap_weights, _radv().stap_output)),
        ("clutter_filter", C.RADAR,
         "Doppler clutter notch (clutter_filter.rs)",
         lambda **k: _radv().clutter_notch, ("n_zero_bins",)),
        ("coherent_integrator", C.RADAR,
         "coherent/noncoherent pulse integration (coherent_integrator.rs)",
         lambda **k: (_radv().coherent_integrate,
                      _radv().noncoherent_integrate)),
        ("radar_tracker", C.RADAR,
         "gated constant-velocity Kalman tracking "
         "(automotive_radar_tracker.rs)",
         lambda **k: _radv().RadarTracker, ("dt", "gate")),
        ("mlse_equalizer", C.SYNC,
         "ML sequence estimation over the ISI trellis "
         "(sequential_detection_mlse.rs)",
         lambda **k: _eq_ops().mlse_equalize,
         ("channel_taps", "constellation")),
        ("channel_sounder", C.MEASUREMENT,
         "PN-probe CIR estimation (channel_sounder.rs)",
         lambda **k: _measure().channel_sound, ("probe", "n_taps")),
        ("pvt_solver", C.GNSS,
         "position/velocity/time least squares + DOP",
         lambda **k: (_pvt().solve_position, _pvt().solve_velocity)),
        ("burst_shaper", C.MODULATOR,
         "raised-cosine burst edge ramps (burst_shaper.rs)",
         lambda **k: _smath().burst_shape, ("ramp",)),
    ]
    for e in entries:
        name, cat, desc, fac = e[:4]
        params = e[4] if len(e) > 4 else ()
        reg.register(name, cat, desc, fac, params)

    # Batch-registered catalog modules: each defines a BLOCKS table
    # name -> (attr, category, description[, params]) next to the code.
    for modpath in _CATALOG_MODULES:
        mod = importlib.import_module(modpath)
        for bname, spec in mod.BLOCKS.items():
            attr, cat_s, desc = spec[:3]
            params = tuple(spec[3]) if len(spec) > 3 else ()
            reg.register(
                bname, BlockCategory(cat_s), desc,
                lambda mod=mod, attr=attr, **k: getattr(mod, attr),
                params)

    # named aliases for capabilities shipped in other modules
    from r4w_tpu_torch.ops.infra_fills import alias_blocks

    for bname, (factory, cat_s, desc) in alias_blocks().items():
        reg.register(bname, BlockCategory(cat_s), desc, factory)

    # waveforms appear as modulator/demodulator pairs
    from r4w_tpu_torch.waveforms import create_waveform, list_waveforms

    for wname in list_waveforms():
        reg.register(
            f"mod_{wname.lower()}", C.MODULATOR, f"{wname} modulator",
            lambda wname=wname, **k: create_waveform(
                wname, k.get("sample_rate", 125_000.0), k.get("device")),
            ("sample_rate",),
        )


_REGISTRY: BlockRegistry | None = None


def default_registry() -> BlockRegistry:
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = BlockRegistry()
        _populate(_REGISTRY)
    return _REGISTRY


# --------------------------------------------------------------------------
# Plugin system (plugin/ re-design)
# --------------------------------------------------------------------------

PLUGIN_API_VERSION = 1
# No CWD-relative default: load_all() executes plugin .py files, so an
# implicit "./plugins" would run arbitrary code from whatever directory
# the process happens to start in. Opt in with an explicit path via
# PluginManager(search_paths=...) or the R4W_TPU_TORCH_PLUGIN_PATH env var.
PLUGIN_SEARCH_PATHS = ("~/.local/share/r4w_tpu_torch/plugins",)


@dataclasses.dataclass
class PluginInfo:
    """Descriptor a plugin module must export as `R4W_PLUGIN`
    (plugin/abi.rs:45 PluginInfo / WaveformDescriptor)."""

    name: str
    version: str
    api_version: int = PLUGIN_API_VERSION
    waveforms: tuple[str, ...] = ()


class PluginManager:
    """Discover + load Python waveform plugins (plugin/manager.rs:148).

    A plugin is a .py file exporting `R4W_PLUGIN: PluginInfo`-shaped
    metadata and a `register(register_waveform)` function that adds its
    waveforms to the factory.
    """

    def __init__(self, search_paths=None):
        if search_paths is None:
            search_paths = list(PLUGIN_SEARCH_PATHS)
            env = os.environ.get("R4W_TPU_TORCH_PLUGIN_PATH")
            if env:
                search_paths += env.split(os.pathsep)
        self.search_paths = [os.path.expanduser(p) for p in search_paths]
        self.loaded: dict[str, PluginInfo] = {}
        self.errors: dict[str, str] = {}

    def discover_plugins(self) -> list[str]:
        found = []
        for root in self.search_paths:
            if not os.path.isdir(root):
                continue
            for fn in sorted(os.listdir(root)):
                if fn.endswith(".py") and not fn.startswith("_"):
                    found.append(os.path.join(root, fn))
        return found

    def load_plugin(self, path: str) -> PluginInfo | None:
        name = os.path.splitext(os.path.basename(path))[0]
        try:
            spec = importlib.util.spec_from_file_location(
                f"r4w_tpu_torch_plugin_{name}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)  # type: ignore[union-attr]
            meta = getattr(mod, "R4W_PLUGIN", None)
            if meta is None:
                raise ValueError("missing R4W_PLUGIN metadata")
            api = getattr(meta, "api_version",
                          meta.get("api_version") if isinstance(meta, dict)
                          else None)
            if api != PLUGIN_API_VERSION:
                raise ValueError(
                    f"api_version {api} != {PLUGIN_API_VERSION}")
            from r4w_tpu_torch.waveforms.base import register_waveform

            mod.register(register_waveform)
            info = (meta if isinstance(meta, PluginInfo) else PluginInfo(
                name=meta.get("name", name),
                version=meta.get("version", "0"),
                api_version=api,
                waveforms=tuple(meta.get("waveforms", ())),
            ))
            self.loaded[info.name] = info
            return info
        except Exception as e:  # noqa: BLE001 - plugin isolation
            self.errors[name] = str(e)
            return None

    def load_all(self) -> list[PluginInfo]:
        return [info for p in self.discover_plugins()
                if (info := self.load_plugin(p)) is not None]

    # ------------------------------------------------- native (C ABI)

    def load_native_plugin(self, path: str) -> PluginInfo | None:
        """Load a C-ABI waveform plugin shared library
        (plugin/abi.rs PluginInfo/WaveformDescriptor; header:
        r4w_tpu_torch/native/r4w_plugin.h). Each exported waveform is
        registered in the factory behind a NativePluginWaveform
        adapter."""
        import ctypes

        name = os.path.splitext(os.path.basename(path))[0]
        try:
            lib = ctypes.CDLL(os.path.abspath(path))
            lib.r4w_plugin_api_version.restype = ctypes.c_uint32
            api = int(lib.r4w_plugin_api_version())
            if api != PLUGIN_API_VERSION:
                raise ValueError(
                    f"api_version {api} != {PLUGIN_API_VERSION}")

            class _CInfo(ctypes.Structure):
                _fields_ = [("name", ctypes.c_char_p),
                            ("version", ctypes.c_char_p),
                            ("description", ctypes.c_char_p),
                            ("author", ctypes.c_char_p),
                            ("waveform_count", ctypes.c_uint32)]

            class _CDesc(ctypes.Structure):
                _fields_ = [("id", ctypes.c_char_p),
                            ("name", ctypes.c_char_p),
                            ("description", ctypes.c_char_p),
                            ("min_sample_rate", ctypes.c_double),
                            ("max_sample_rate", ctypes.c_double),
                            ("capabilities", ctypes.c_uint32)]

            lib.r4w_plugin_info.restype = ctypes.POINTER(_CInfo)
            lib.r4w_list_waveforms.restype = ctypes.POINTER(_CDesc)
            f32p = ctypes.POINTER(ctypes.c_float)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i64 = ctypes.c_int64
            lib.r4w_modulate.restype = i64
            lib.r4w_modulate.argtypes = [ctypes.c_char_p, ctypes.c_double,
                                         u8p, i64, f32p, i64]
            lib.r4w_demodulate.restype = i64
            lib.r4w_demodulate.argtypes = [ctypes.c_char_p,
                                           ctypes.c_double, f32p, i64,
                                           u8p, i64]

            cinfo = lib.r4w_plugin_info().contents
            descs = lib.r4w_list_waveforms()
            from r4w_tpu_torch.waveforms.base import register_waveform
            from r4w_tpu_torch.waveforms.native_plugin import (
                NativePluginWaveform)

            ids = []
            for i in range(cinfo.waveform_count):
                d = descs[i]
                wid = d.id.decode()
                ids.append(wid)
                min_sr = d.min_sample_rate

                def builder(sample_rate: float, device, _lib=lib, _wid=wid,
                            _min=min_sr):
                    return NativePluginWaveform(
                        lib=_lib, waveform_id=_wid,
                        sample_rate=max(sample_rate, _min), device=device)

                register_waveform(wid)(builder)
            info = PluginInfo(name=cinfo.name.decode(),
                              version=cinfo.version.decode(),
                              api_version=api, waveforms=tuple(ids))
            self.loaded[info.name] = info
            return info
        except Exception as e:  # noqa: BLE001 - plugin isolation
            self.errors[name] = str(e)
            return None
