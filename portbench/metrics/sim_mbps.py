"""Monte-Carlo payload bits simulated per second: the payload bits of every
packet of every call that completed in the window, over the window's host
time from the first dispatch to the last call done."""

UNIT = "Mbit/s"
LAYER = "Entry"
MOVES = "sim_mbps"
SOURCE = "host_clock"


def compute(rec):
    if "payload_bits" not in rec:
        return None
    return rec["payload_bits"] / rec["window_s"] / 1e6
