"""The demodulation step's share of its roofline, in %: the least time of
its work on the call's rows (`portbench.roofline`: IQ read once, the
downchirp once, symbol, SNR and magnitude written once, over 3.35 TB/s;
operations over 67 TFLOP/s FP32; the larger) over the CUDA-event time of
`demodulate_symbols` on those rows in a stepped call."""

from portbench import roofline

UNIT = "%"
LAYER = "Kernels"
MOVES = "rx_msps"
SOURCE = "program_span"


def compute(rec):
    ms = rec.get("stage_ms", {}).get("demodulate_symbols")
    if not ms:
        return None
    return roofline.demod_share(rec["demod_rows"], rec["demod_k"], ms / 1e3)
