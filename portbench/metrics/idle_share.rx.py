"""The device's idle share over blocks of the receiver loop, run as in the window under
`torch.profiler` tracing the device alone (the host's tracing would slow
its launches): 100·(1 − busy/span), busy the union of the device
events' intervals, span from the first device event's start to the last
one's end."""

UNIT = "%"
LAYER = "Device"
MOVES = "rx_msps"
SOURCE = "device_trace"


def compute(rec):
    if not rec.get("span_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["span_s"])
