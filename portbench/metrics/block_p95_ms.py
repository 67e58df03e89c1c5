"""A receiver's deadline: the 95th percentile, over every block of the
window, of the host-clock time from handing a block to ``demodulate`` to its
decoded bytes on the host, with the traffic's blocks in flight."""

import math

UNIT = "ms"
LAYER = "Entry"
MOVES = "block_p95_ms"
SOURCE = "host_clock"


def compute(rec):
    lat = rec.get("latency_ms")
    if not lat:
        return None
    return sorted(lat)[math.ceil(0.95 * len(lat)) - 1]     # nearest rank
