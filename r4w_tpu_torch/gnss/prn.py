"""GNSS PRN spreading codes (waveform/gnss/prn.rs re-design).

GPS L1 C/A Gold codes (G1/G2 with per-PRN phase-selector taps, IS-GPS-200
public construction), GLONASS L1OF 511-chip m-sequence, GPS L5-style long
codes, and Galileo E1 memory-code bank.

NOTE on Galileo E1: the reference embeds the ICD hex memory-code tables
(galileo_e1_codes.rs, 3.5k LoC of constants). Those constants are not
reproduced here; `galileo_e1_code` deterministically synthesizes
4092-chip memory codes from a seeded PRBS with the correct length/balance
structure so every algorithm (CBOC modulation, PCPS, tracking, scenarios)
runs identically. Drop-in replacement with ICD tables is a data-file
swap (`set_galileo_e1_table`).
"""

from __future__ import annotations

import functools

import numpy as np

# Per-PRN G2 phase-selector taps (1-based positions), IS-GPS-200 Table 3-I
CA_PHASE_TAPS = {
    1: (2, 6), 2: (3, 7), 3: (4, 8), 4: (5, 9), 5: (1, 9), 6: (2, 10),
    7: (1, 8), 8: (2, 9), 9: (3, 10), 10: (2, 3), 11: (3, 4), 12: (5, 6),
    13: (6, 7), 14: (7, 8), 15: (8, 9), 16: (9, 10), 17: (1, 4),
    18: (2, 5), 19: (3, 6), 20: (4, 7), 21: (5, 8), 22: (6, 9),
    23: (1, 3), 24: (4, 6), 25: (5, 7), 26: (6, 8), 27: (7, 9),
    28: (8, 10), 29: (1, 6), 30: (2, 7), 31: (3, 8), 32: (4, 9),
}

CA_CODE_LENGTH = 1023
GLONASS_CODE_LENGTH = 511
L5_CODE_LENGTH = 10230
GALILEO_E1_CODE_LENGTH = 4092


@functools.lru_cache(maxsize=None)
def gps_ca_code(prn: int) -> np.ndarray:
    """GPS L1 C/A Gold code, 1023 chips of ±1 (prn.rs:74 GpsCaCodeGenerator).

    G1: x^10+x^3+1, G2: x^10+x^9+x^8+x^6+x^3+x^2+1, both seeded all-ones;
    chip = G1 output ⊕ (G2[tap_a] ⊕ G2[tap_b]).
    Mapping: bit 0 -> +1, bit 1 -> -1.
    """
    if prn not in CA_PHASE_TAPS:
        raise ValueError(f"PRN must be 1-32, got {prn}")
    ta, tb = CA_PHASE_TAPS[prn]
    g1 = np.ones(10, np.int8)
    g2 = np.ones(10, np.int8)
    out = np.empty(CA_CODE_LENGTH, np.int8)
    for i in range(CA_CODE_LENGTH):
        bit = g1[9] ^ (g2[ta - 1] ^ g2[tb - 1])
        out[i] = 1 if bit == 0 else -1
        fb1 = g1[2] ^ g1[9]
        fb2 = g2[1] ^ g2[2] ^ g2[5] ^ g2[7] ^ g2[8] ^ g2[9]
        g1 = np.roll(g1, 1); g1[0] = fb1
        g2 = np.roll(g2, 1); g2[0] = fb2
    return out


@functools.lru_cache(maxsize=None)
def glonass_l1of_code() -> np.ndarray:
    """GLONASS standard code: 511-chip m-sequence from x^9+x^5+1
    (prn.rs:170). All satellites share the code (FDMA system)."""
    reg = np.ones(9, np.int8)
    out = np.empty(GLONASS_CODE_LENGTH, np.int8)
    for i in range(GLONASS_CODE_LENGTH):
        out[i] = 1 if reg[6] == 0 else -1  # output from stage 7
        fb = reg[8] ^ reg[4]
        reg = np.roll(reg, 1); reg[0] = fb
    return out


@functools.lru_cache(maxsize=None)
def gps_l5_code(prn: int, component: str = "I") -> np.ndarray:
    """GPS L5-structure code: 10230 chips from XA ⊕ delayed XB.

    XA: x^13+x^12+x^10+x^9+1 (restarts at 8190), XB: x^13+x^12+x^8+x^4+
    x^3+x^1+1 free-running; per-PRN XB advance derived deterministically
    from the PRN (the IS-GPS-705 per-PRN initial states are a data-table
    swap, like Galileo above).
    """
    def lfsr13(taps: tuple[int, ...], length: int, restart: int | None):
        reg = np.ones(13, np.int8)
        out = np.empty(length, np.int8)
        count = 0
        for i in range(length):
            out[i] = reg[12]
            fb = 0
            for t in taps:
                fb ^= reg[t - 1]
            reg = np.roll(reg, 1); reg[0] = fb
            count += 1
            if restart and count == restart:
                reg = np.ones(13, np.int8)
                count = 0
        return out

    xa = lfsr13((9, 10, 12, 13), L5_CODE_LENGTH, 8190)
    # XB: 1+x+x^3+x^4+x^6+x^7+x^8+x^12+x^13 (IS-GPS-705)
    xb = lfsr13((1, 3, 4, 6, 7, 8, 12, 13), L5_CODE_LENGTH, None)
    advance = (prn * 1034 + (5001 if component == "Q" else 0)) % L5_CODE_LENGTH
    xb = np.roll(xb, -advance)
    bits = xa ^ xb
    return np.where(bits == 0, 1, -1).astype(np.int8)


_GALILEO_TABLE: dict[tuple[int, str], np.ndarray] = {}


def set_galileo_e1_table(prn: int, component: str, chips: np.ndarray):
    """Install real ICD memory-code chips (±1, 4092) for a PRN."""
    assert len(chips) == GALILEO_E1_CODE_LENGTH
    _GALILEO_TABLE[(prn, component)] = np.asarray(chips, np.int8)


@functools.lru_cache(maxsize=None)
def _galileo_synthetic(prn: int, component: str) -> np.ndarray:
    rng = np.random.default_rng(
        0xE1 * 1_000_003 + prn * 7919 + (ord(component[0]) << 16)
    )
    chips = rng.integers(0, 2, GALILEO_E1_CODE_LENGTH).astype(np.int8)
    # enforce near-balance like the ICD codes
    imbalance = int(chips.sum()) - GALILEO_E1_CODE_LENGTH // 2
    if imbalance > 0:
        ones = np.nonzero(chips == 1)[0]
        chips[ones[:imbalance]] = 0
    return np.where(chips == 0, 1, -1).astype(np.int8)


_warned_synthetic_galileo = False


def galileo_e1_code(prn: int, component: str = "C") -> np.ndarray:
    """Galileo E1B/E1C 4092-chip memory code (±1). Uses installed ICD
    table when available, else the deterministic synthetic bank (which
    will NOT correlate with real off-air Galileo recordings)."""
    if (prn, component) in _GALILEO_TABLE:
        return _GALILEO_TABLE[(prn, component)]
    icd = _load_galileo_icd(prn, component)
    if icd is not None:
        return icd
    global _warned_synthetic_galileo
    if not _warned_synthetic_galileo:
        _warned_synthetic_galileo = True
        import warnings

        warnings.warn(
            "galileo_e1_code: no ICD memory-code table installed; using "
            "deterministic synthetic codes (self-consistent for "
            "simulation, but acquisition of real Galileo E1 recordings "
            "will fail). Install real chips via set_galileo_e1_table().",
            RuntimeWarning,
            stacklevel=2,
        )
    return _galileo_synthetic(prn, component)


@functools.lru_cache(maxsize=None)
def _galileo_icd_arrays():
    """The shipped ICD memory-code tables (gnss/data/
    galileo_e1_codes.npz) or None.

    Chip DATA per the Galileo OS SIS ICD v2.1 §5.1.3 (bit-packed, 4092
    chips/PRN, bit 0 → +1), as published in the public GNSS-matlab
    tables; this is standards data, not derived code.
    """
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", "galileo_e1_codes.npz")
    if not os.path.exists(path):
        return None
    z = np.load(path)
    return z["e1b_packed"], z["e1c_packed"]


def _load_galileo_icd(prn: int, component: str) -> np.ndarray | None:
    arrays = _galileo_icd_arrays()
    if arrays is None or not (1 <= prn <= 50):
        return None
    packed = arrays[0 if component.upper() == "B" else 1][prn - 1]
    bits = np.unpackbits(packed)[:4092]
    return (1 - 2 * bits.astype(np.int32)).astype(np.int8)


def sample_code(chips: np.ndarray, sample_rate: float, chip_rate: float,
                n_samples: int, code_phase_chips: float = 0.0) -> np.ndarray:
    """Sample a chip sequence at sample_rate (nearest-chip gather).

    Vectorized equivalent of the per-sample code NCO in
    satellite_emitter.rs:218.
    """
    idx = (np.arange(n_samples) * chip_rate / sample_rate
           + code_phase_chips)
    return chips[(np.floor(idx).astype(np.int64)) % len(chips)]


def code_bank(prns, code_fn=gps_ca_code) -> np.ndarray:
    """(n_prn, L) stacked ±1 code matrix — the unit of batched PCPS."""
    return np.stack([code_fn(p) for p in prns]).astype(np.float32)
