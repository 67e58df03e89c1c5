"""LoRa parameter set.

A frozen, hashable dataclass, the same as ``r4w_tpu.waveforms.lora.params``:
all validation happens at construction on the host, and the derived
sizes key the per-device table caches.
"""

from __future__ import annotations

import dataclasses

from r4w_tpu_torch.core.types import InvalidParameter

_VALID_SF = range(5, 13)
_VALID_BW = (125_000, 250_000, 500_000)
_VALID_CR = range(1, 5)

# Regional center frequencies
REGION_FREQ = {
    "EU868": 868.1e6,
    "US915": 915.0e6,
    "AS923": 923.0e6,
    "AU915": 915.0e6,
    "IN865": 865.0625e6,
}


@dataclasses.dataclass(frozen=True)
class LoRaParams:
    """Validated LoRa PHY parameters."""

    sf: int = 7
    bw_hz: int = 125_000
    cr: int = 1  # coding rate 4/(4+cr)
    frequency: float = REGION_FREQ["EU868"]
    oversample: int = 1
    low_data_rate_optimize: bool = False
    implicit_header: bool = False
    crc_enabled: bool = True
    preamble_length: int = 8
    sync_word: int = 0x12

    def __post_init__(self):
        if self.sf not in _VALID_SF:
            raise InvalidParameter(f"SF must be 5-12, got {self.sf}")
        if self.bw_hz not in _VALID_BW:
            raise InvalidParameter(f"BW must be one of {_VALID_BW}, got {self.bw_hz}")
        if self.cr not in _VALID_CR:
            raise InvalidParameter(f"CR must be 1-4, got {self.cr}")
        if self.oversample < 1:
            raise InvalidParameter("oversample must be >= 1")

    # Derived quantities -----------------------------------------------------
    @property
    def chips_per_symbol(self) -> int:
        return 1 << self.sf

    @property
    def samples_per_symbol(self) -> int:
        return self.chips_per_symbol * self.oversample

    @property
    def sample_rate(self) -> float:
        return float(self.bw_hz * self.oversample)

    @property
    def symbol_duration(self) -> float:
        return self.chips_per_symbol / float(self.bw_hz)

    @property
    def chip_duration(self) -> float:
        return 1.0 / float(self.bw_hz)

    @property
    def sample_duration(self) -> float:
        return 1.0 / self.sample_rate

    @property
    def bits_per_symbol(self) -> int:
        return self.sf

    @property
    def codeword_bits(self) -> int:
        return 4 + self.cr

    def bit_rate(self) -> float:
        """Effective bit rate: SF * (4/(4+CR)) / Tsym."""
        return self.sf * (4.0 / (4 + self.cr)) / self.symbol_duration

    def snr_threshold(self) -> float:
        """Demodulation SNR floor in dB per SF."""
        return {5: -2.5, 6: -5.0, 7: -7.5, 8: -10.0, 9: -12.5, 10: -15.0,
                11: -17.5, 12: -20.0}[self.sf]

    def n_payload_symbols(self, payload_bytes: int) -> int:
        """Symbols produced for payload_bytes of data (pre-pad to SF blocks)."""
        nibbles = 2 * payload_bytes
        blocks = -(-nibbles // self.sf)  # ceil: whole interleaver blocks
        return blocks * self.codeword_bits

    def n_preamble_samples(self) -> int:
        """Preamble + 2 sync + 2.25 downchirps."""
        n = self.samples_per_symbol
        return (self.preamble_length + 2) * n + 2 * n + n // 4

    def time_on_air(self, payload_bytes: int) -> float:
        n_sym = self.n_payload_symbols(payload_bytes)
        n_pre = self.preamble_length + 4.25
        return (n_pre + n_sym) * self.symbol_duration


def sf7(**kw) -> LoRaParams:
    return LoRaParams(sf=7, **kw)


def sf12(**kw) -> LoRaParams:
    return LoRaParams(sf=12, **kw)
