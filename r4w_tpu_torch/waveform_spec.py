"""Declarative waveform specs (specs/*.yaml and waveform-spec/schema.yaml).

PyTorch counterpart of ``r4w_tpu.waveform_spec``. It parses the unified
waveform-spec YAML (identity, modulation, constellation, pulse-shaping and
timing sections, specs/bpsk.yaml:1-60) and can (a) check a built-in
waveform's constellation against a spec and (b) build a linear-modulation
waveform straight from a spec (the GUI Waveform Wizard's path).

`WaveformSpec.load` keeps the reference's rule: its argument is read as a
file when a file has that path, and parsed as YAML text otherwise, so a
relative path that does not resolve from the working directory is parsed
as a one-line YAML string and fails there, as in the reference. PyYAML is
imported inside `load` only; `WaveformSpec._from_dict` reads an already
parsed document, so a caller without PyYAML builds a spec from a dict.
The spec's waveform modulates with the port's `ops.coding.bits_to_symbols`
and demodulates with `waveforms.linear_mod`, on its `device`.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from r4w_tpu_torch.core.types import CommonParams, resolve_device


@dataclasses.dataclass
class WaveformSpec:
    name: str
    full_name: str
    description: str
    scheme: str
    order: int
    bits_per_symbol: int
    constellation: np.ndarray  # complex points, bit-value order
    gray_coded: bool
    differential: bool
    pulse_type: str | None
    rolloff: float
    span_symbols: int
    symbol_rate: float
    sample_rate: float
    samples_per_symbol: int
    raw: dict

    @classmethod
    def load(cls, path_or_text: str) -> "WaveformSpec":
        import yaml

        text = (open(path_or_text).read() if os.path.exists(path_or_text)
                else path_or_text)
        docs = [d for d in yaml.safe_load_all(text) if d]
        return cls._from_dict(docs[0])

    @classmethod
    def _from_dict(cls, raw: dict) -> "WaveformSpec":
        """The spec of one parsed YAML document (what `load` reads)."""
        wf = raw.get("waveform", {})
        mod = raw.get("modulation", {})
        const_cfg = mod.get("constellation", {})
        points = np.asarray(
            [complex(p[0], p[1]) for p in const_cfg.get("points", [[1, 0]])],
            np.complex64,
        )
        rot = float(const_cfg.get("rotation_deg", 0.0))
        if rot:
            points = points * np.exp(1j * np.deg2rad(rot))
        ps = raw.get("pulse_shaping", {})
        ps_filter = ps.get("filter", {}) if ps.get("enabled") else {}
        timing = raw.get("timing", {})
        return cls(
            name=wf.get("name", "?"),
            full_name=wf.get("full_name", ""),
            description=wf.get("description", ""),
            scheme=mod.get("scheme", "?"),
            order=int(mod.get("order", len(points))),
            bits_per_symbol=int(mod.get("bits_per_symbol", 1)),
            constellation=points,
            gray_coded=bool(const_cfg.get("gray_coded", False)),
            differential=bool(
                mod.get("differential", {}).get("enabled", False)),
            pulse_type=ps_filter.get("type"),
            rolloff=float(ps_filter.get("rolloff", 0.35)),
            span_symbols=int(ps_filter.get("span_symbols", 8)),
            symbol_rate=float(timing.get("symbol_rate", 1000.0)),
            sample_rate=float(timing.get("sample_rate", 8000.0)),
            samples_per_symbol=int(timing.get("samples_per_symbol", 8)),
            raw=raw,
        )

    # -- validation against built-ins --------------------------------------
    def check_constellation(self, waveform) -> tuple[bool, float]:
        """Compare a built-in waveform's constellation to the spec's
        (decision-identity up to rotation/scale). Returns (match, err)."""
        pts = waveform.constellation_points()
        pts = np.asarray(pts.detach().cpu() if isinstance(pts, torch.Tensor) else pts)
        ref = self.constellation
        if len(pts) != len(ref):
            return False, float("inf")
        pts = pts / np.sqrt(np.mean(np.abs(pts) ** 2))
        ref_n = ref / np.sqrt(np.mean(np.abs(ref) ** 2))
        # common-phase alignment
        rot = np.sum(pts * np.conj(ref_n))
        rot = rot / max(abs(rot), 1e-12)
        err = float(np.max(np.abs(pts / rot - ref_n)))
        return err < 0.1, err

    # -- generic spec-driven waveform ---------------------------------------
    def build_waveform(self, device=None):
        """Instantiate a linear-mod waveform straight from the spec; it
        creates its tensors on `device` (default: the card)."""
        from r4w_tpu_torch.ops.coding import bits_to_symbols
        from r4w_tpu_torch.waveforms import linear_mod as lm
        from r4w_tpu_torch.waveforms.base import (DemodResult, Waveform, WaveformInfo, as_iq,
                                                  data_to_bits)

        spec = self
        home = resolve_device(device)

        @dataclasses.dataclass(frozen=True)
        class SpecWaveform(Waveform):
            common: CommonParams = CommonParams(
                sample_rate=spec.sample_rate)
            device: torch.device = home

            @property
            def common_params(self):
                return self.common

            def samples_per_symbol(self):
                return spec.samples_per_symbol

            def info(self):
                return WaveformInfo(
                    name=spec.name, full_name=spec.full_name,
                    description=spec.description.strip(),
                    bits_per_symbol=spec.bits_per_symbol,
                )

            def constellation_points(self):
                return torch.from_numpy(spec.constellation).to(self.device)

            def modulate(self, data):
                bits = data_to_bits(data)
                bps = spec.bits_per_symbol
                rem = bits.size % bps
                if rem:
                    bits = np.pad(bits, (0, bps - rem))
                values = bits_to_symbols(torch.from_numpy(bits).to(self.device), bps)
                pts = self.constellation_points()[values.long()]
                return pts.repeat_interleave(spec.samples_per_symbol, dim=-1)

            def demodulate(self, samples):
                samples = as_iq(samples, self.device)
                const = torch.from_numpy(spec.constellation).to(samples.device)
                idx, evm, snr = lm.linear_demodulate_symbols(
                    samples, const, spec.samples_per_symbol)
                bits = lm.indices_to_bits(
                    idx, torch.arange(spec.order, device=samples.device),
                    spec.bits_per_symbol)
                return DemodResult(bits=lm.pack_demod_bits(bits),
                                   symbols=idx, snr_estimate=float(snr))

        return SpecWaveform()


def load_spec_dir(path: str) -> dict[str, WaveformSpec]:
    out = {}
    for fn in sorted(os.listdir(path)):
        if fn.endswith((".yaml", ".yml")):
            try:
                spec = WaveformSpec.load(os.path.join(path, fn))
                out[spec.name] = spec
            except Exception:  # noqa: BLE001 - skip malformed specs
                continue
    return out
