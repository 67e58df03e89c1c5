"""The channel layer's time a call: CUDA events around ``awgn`` on the
call's (lanes, SNRs) grid, with the harness's noise draw, in a stepped call."""

UNIT = "ms"
LAYER = "Channel"
MOVES = "sim_mbps"
SOURCE = "program_span"


def compute(rec):
    return rec.get("stage_ms", {}).get("awgn")
