"""SigMF recording read/write (hal/sigmf.rs + observe/capture.rs re-design).

PyTorch counterpart of ``r4w_tpu.io.sigmf``; the samples written may be a
tensor on any device (read to the host once). Minimal-but-compliant
SigMF: `<name>.sigmf-data` raw IQ + `<name>.sigmf-meta` JSON with
global/captures/annotations sections.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from r4w_tpu_torch.io import iqformat

SIGMF_VERSION = "1.0.0"


@dataclasses.dataclass
class SigmfMeta:
    sample_rate: float = 1e6
    datatype: str = "cf32_le"
    frequency: float = 0.0
    description: str = ""
    author: str = "r4w_tpu"
    hw: str = "simulation"
    captures: list = dataclasses.field(default_factory=list)
    annotations: list = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "global": {
                "core:datatype": self.datatype,
                "core:sample_rate": self.sample_rate,
                "core:version": SIGMF_VERSION,
                "core:description": self.description,
                "core:author": self.author,
                "core:hw": self.hw,
            },
            "captures": self.captures or [
                {"core:sample_start": 0, "core:frequency": self.frequency}
            ],
            "annotations": self.annotations,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "SigmfMeta":
        g = d.get("global", {})
        caps = d.get("captures", [])
        freq = caps[0].get("core:frequency", 0.0) if caps else 0.0
        return cls(
            sample_rate=g.get("core:sample_rate", 1e6),
            datatype=g.get("core:datatype", "cf32_le"),
            frequency=freq,
            description=g.get("core:description", ""),
            author=g.get("core:author", ""),
            hw=g.get("core:hw", ""),
            captures=caps,
            annotations=d.get("annotations", []),
        )


def _basename(path: str) -> str:
    for suffix in (".sigmf-data", ".sigmf-meta", ".sigmf"):
        if path.endswith(suffix):
            return path[: -len(suffix)]
    return path


def write_sigmf(path: str, samples, sample_rate: float,
                frequency: float = 0.0, fmt: str = "cf32",
                description: str = "", annotations: list | None = None):
    """Write <base>.sigmf-data + .sigmf-meta."""
    base = _basename(path)
    iqformat.write_iq_file(base + ".sigmf-data", samples, fmt)
    meta = SigmfMeta(
        sample_rate=sample_rate,
        datatype=iqformat.SIGMF_DATATYPES[fmt],
        frequency=frequency,
        description=description,
        annotations=annotations or [],
    )
    with open(base + ".sigmf-meta", "w") as f:
        json.dump(meta.to_dict(), f, indent=2)


def read_sigmf(path: str, max_samples: int | None = None):
    """Returns (samples complex64, SigmfMeta)."""
    base = _basename(path)
    with open(base + ".sigmf-meta") as f:
        meta = SigmfMeta.from_dict(json.load(f))
    fmt = iqformat.from_sigmf_datatype(meta.datatype)
    samples = iqformat.read_iq_file(base + ".sigmf-data", fmt, max_samples)
    return samples, meta


def sigmf_exists(path: str) -> bool:
    base = _basename(path)
    return (os.path.exists(base + ".sigmf-data")
            and os.path.exists(base + ".sigmf-meta"))
