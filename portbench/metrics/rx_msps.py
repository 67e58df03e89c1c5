"""Received samples demodulated per second: the input samples of every block
whose decoded bytes reached the host in the window, over the window's host
time from the first hand-over to the last bytes read."""

UNIT = "Msamples/s"
LAYER = "Entry"
MOVES = "rx_msps"
SOURCE = "host_clock"


def compute(rec):
    if "samples" not in rec:
        return None
    return rec["samples"] / rec["window_s"] / 1e6
