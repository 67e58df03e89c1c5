"""The waveform layer's time a block after the demodulation: CUDA events
around ``decode_symbols`` and the decoded bytes' copy to pinned host memory,
in a stepped block."""

UNIT = "ms"
LAYER = "Waveform"
MOVES = "block_p95_ms"
SOURCE = "program_span"


def compute(rec):
    return rec.get("stage_ms", {}).get("decode_readback")
