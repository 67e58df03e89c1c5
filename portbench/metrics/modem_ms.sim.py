"""The waveform layer's time a call outside the demodulation: CUDA events
around ``modulate``, ``decode_symbols`` and the BER, summed, in a stepped
call."""

UNIT = "ms"
LAYER = "Waveform"
MOVES = "sim_mbps"
SOURCE = "program_span"


def compute(rec):
    ms = rec.get("stage_ms", {})
    if not all(k in ms for k in ("modulate", "decode_symbols", "ber")):
        return None
    return ms["modulate"] + ms["decode_symbols"] + ms["ber"]
