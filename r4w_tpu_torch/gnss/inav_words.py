"""Galileo I/NAV word types 1-5: ephemeris + clock + GST field coding.

Galileo OS SIS ICD Issue 2.0 §5.1.9 (Tables 57-60, 63, 66-68): one
I/NAV *word* is 128 bits carried by one nominal page — 112 bits in the
even part's data field and 16 in the odd part's (gnss/inav.py
encode_page/decode_page). Word types:

  1  ephemeris 1/4: IODnav, t0e, M0, e, sqrt(A)
  2  ephemeris 2/4: IODnav, Omega0, i0, omega, iDot
  3  ephemeris 3/4: IODnav, OmegaDot, deltaN, Cuc/Cus/Crc/Crs, SISA
  4  ephemeris 4/4 + clock: IODnav, SVID, Cic/Cis, t0c, af0/af1/af2
  5  iono (ai0-ai2, storm flags), BGD, health, GST WN+TOW

Angles are SIGNED two's-complement semicircles at the tabulated scale
factors (same convention as GPS LNAV, gnss/nav_message.py); times are
unsigned with 60 s LSB (vs GPS's 16 s — circular_ephemeris_for_position
takes toe_quantum=60 for Galileo scenarios).

TOW convention: this loopback anchors word 5's WN/TOW to the leading
edge of the FIRST symbol of the nominal page carrying that word (both
the scenario overlay and tools/galileo_pvt.py use this anchor, so the
recovered transmit times are self-consistent; the ICD anchors TOW to
the same page boundary).

The reference carries Galileo E1 code/modulation only — it has no
I/NAV word layer at all (crates/r4w-core/src/waveform/gnss/boc.rs,
galileo_e1.rs stop at the symbol overlay) — so this module, like
gnss/inav.py, goes beyond reference parity.
"""

from __future__ import annotations

import dataclasses

import numpy as np

PI_GAL = 3.1415926535898  # ICD fixed pi, same value as IS-GPS-200
SEMI = PI_GAL


@dataclasses.dataclass(frozen=True)
class _F:
    name: str
    lo: int        # 1-based MSB-first bit positions within the 128
    hi: int
    scale: float = 1.0
    signed: bool = False

    @property
    def n_bits(self) -> int:
        return self.hi - self.lo + 1


def _layout(*fields):
    lay = {f.name: f for f in fields}
    used = sum(f.n_bits for f in fields)
    assert used == 128, f"layout covers {used} bits, want 128"
    return lay


# Word type field tables (ICD Tables 57-60, 63). Every word starts with
# Type (6 bits); reserved/spare ranges are explicit so the layouts
# provably tile all 128 bits.
WORD_LAYOUTS = {
    1: _layout(
        _F("type", 1, 6),
        _F("iodnav", 7, 16),
        _F("toe", 17, 30, 60.0),
        _F("m0", 31, 62, 2.0 ** -31, True),       # semicircles
        _F("e", 63, 94, 2.0 ** -33),
        _F("sqrt_a", 95, 126, 2.0 ** -19),
        _F("reserved", 127, 128),
    ),
    2: _layout(
        _F("type", 1, 6),
        _F("iodnav", 7, 16),
        _F("omega0", 17, 48, 2.0 ** -31, True),
        _F("i0", 49, 80, 2.0 ** -31, True),
        _F("omega", 81, 112, 2.0 ** -31, True),
        _F("idot", 113, 126, 2.0 ** -43, True),
        _F("reserved", 127, 128),
    ),
    3: _layout(
        _F("type", 1, 6),
        _F("iodnav", 7, 16),
        _F("omega_dot", 17, 40, 2.0 ** -43, True),
        _F("delta_n", 41, 56, 2.0 ** -43, True),
        _F("cuc", 57, 72, 2.0 ** -29, True),
        _F("cus", 73, 88, 2.0 ** -29, True),
        _F("crc", 89, 104, 2.0 ** -5, True),
        _F("crs", 105, 120, 2.0 ** -5, True),
        _F("sisa", 121, 128),
    ),
    4: _layout(
        _F("type", 1, 6),
        _F("iodnav", 7, 16),
        _F("svid", 17, 22),
        _F("cic", 23, 38, 2.0 ** -29, True),
        _F("cis", 39, 54, 2.0 ** -29, True),
        _F("toc", 55, 68, 60.0),
        _F("af0", 69, 99, 2.0 ** -34, True),
        _F("af1", 100, 120, 2.0 ** -46, True),
        _F("af2", 121, 126, 2.0 ** -59, True),
        _F("spare", 127, 128),
    ),
    5: _layout(
        _F("type", 1, 6),
        _F("ai0", 7, 17, 2.0 ** -2),
        _F("ai1", 18, 28, 2.0 ** -8, True),
        _F("ai2", 29, 42, 2.0 ** -15, True),
        _F("region_flags", 43, 47),
        _F("bgd_e1e5a", 48, 57, 2.0 ** -32, True),
        _F("bgd_e1e5b", 58, 67, 2.0 ** -32, True),
        _F("e5b_hs", 68, 69),
        _F("e1b_hs", 70, 71),
        _F("e5b_dvs", 72, 72),
        _F("e1b_dvs", 73, 73),
        _F("wn", 74, 85),
        _F("tow", 86, 105),
        _F("spare", 106, 128),
    ),
}


def encode_word(wtype: int, values: dict) -> tuple[np.ndarray, np.ndarray]:
    """(data112, data16) bit arrays for one I/NAV word. Missing fields
    encode as 0; 'type' is implied. Raises on field overflow."""
    lay = WORD_LAYOUTS[wtype]
    bits = np.zeros(128, np.int32)
    vals = dict(values)
    vals["type"] = wtype
    for name, value in vals.items():
        f = lay[name]
        n = f.n_bits
        q = int(round(float(value) / f.scale))
        lo = -(1 << (n - 1)) if f.signed else 0
        hi = (1 << (n - 1)) - 1 if f.signed else (1 << n) - 1
        if not lo <= q <= hi:
            raise ValueError(f"{name}={value} overflows {n}-bit field")
        u = q & ((1 << n) - 1)
        for i in range(n):
            bits[f.lo - 1 + i] = (u >> (n - 1 - i)) & 1
    return bits[:112], bits[112:]


def decode_word(data112, data16) -> dict:
    """Field dict (incl. 'type') from a word's 128 bits. Unknown word
    types return {'type': t} only."""
    bits = np.concatenate([np.asarray(data112, np.int32),
                           np.asarray(data16, np.int32)])
    assert bits.shape == (128,)
    wtype = 0
    for b in bits[:6]:
        wtype = (wtype << 1) | int(b)
    lay = WORD_LAYOUTS.get(wtype)
    out = {"type": wtype}
    if lay is None:
        return out
    for name, f in lay.items():
        if name in ("type", "reserved", "spare"):
            continue
        u = 0
        for i in range(f.n_bits):
            u = (u << 1) | int(bits[f.lo - 1 + i])
        if f.signed and (u >> (f.n_bits - 1)) & 1:
            u -= 1 << f.n_bits
        out[name] = u * f.scale
    return out


def words_for_ephemeris(eph, iodnav: int, svid: int, wn: int,
                        tow_word5: float) -> list[tuple]:
    """The five (data112, data16) words broadcasting a
    gnss.ephemeris.BroadcastEphemeris (angles in radians — converted
    to ICD semicircles here) plus GST time in word 5.

    tow_word5 anchors to the first symbol of the page carrying word 5
    (see module docstring)."""
    w1 = encode_word(1, {
        "iodnav": iodnav, "toe": eph.toe, "m0": eph.m0 / SEMI,
        "e": eph.e, "sqrt_a": eph.sqrt_a})
    w2 = encode_word(2, {
        "iodnav": iodnav, "omega0": eph.omega0 / SEMI,
        "i0": eph.i0 / SEMI, "omega": eph.omega / SEMI,
        "idot": eph.idot / SEMI})
    w3 = encode_word(3, {
        "iodnav": iodnav, "omega_dot": eph.omega_dot / SEMI,
        "delta_n": eph.delta_n / SEMI, "cuc": eph.cuc, "cus": eph.cus,
        "crc": eph.crc, "crs": eph.crs, "sisa": 107})
    w4 = encode_word(4, {
        "iodnav": iodnav, "svid": svid, "cic": eph.cic, "cis": eph.cis,
        "toc": getattr(eph, "toc", eph.toe), "af0": eph.af0,
        "af1": eph.af1, "af2": eph.af2})
    w5 = encode_word(5, {
        "wn": wn, "tow": tow_word5, "e1b_hs": 0, "e1b_dvs": 0})
    return [w1, w2, w3, w4, w5]


def ephemeris_from_words(words: dict[int, dict], prn: int):
    """BroadcastEphemeris from decoded word dicts {type: fields}.
    Needs types 1-4 with a CONSISTENT IODnav; raises KeyError /
    ValueError otherwise (the caller collects words until this
    succeeds, the LnavMessage-style accumulation role)."""
    from r4w_tpu_torch.gnss.ephemeris import BroadcastEphemeris

    w1, w2, w3, w4 = words[1], words[2], words[3], words[4]
    iods = {int(w["iodnav"]) for w in (w1, w2, w3, w4)}
    if len(iods) != 1:
        raise ValueError(f"inconsistent IODnav across words: {iods}")
    return BroadcastEphemeris(
        prn=prn, toe=w1["toe"], sqrt_a=w1["sqrt_a"], e=w1["e"],
        m0=w1["m0"] * SEMI,
        omega0=w2["omega0"] * SEMI, i0=w2["i0"] * SEMI,
        omega=w2["omega"] * SEMI, idot=w2["idot"] * SEMI,
        omega_dot=w3["omega_dot"] * SEMI, delta_n=w3["delta_n"] * SEMI,
        cuc=w3["cuc"], cus=w3["cus"], crc=w3["crc"], crs=w3["crs"],
        cic=w4["cic"], cis=w4["cis"],
        af0=w4["af0"], af1=w4["af1"], af2=w4["af2"],
    )
