"""Set-up: from the top of ``run.py``, before PyTorch is imported, to the
window's first call, with the program's imports, the card's start, the
kernel's build or load, the inputs made from the seed and the warm-up."""

UNIT = "s"
LAYER = "Entry"
MOVES = "setup_s"
SOURCE = "host_clock"


def compute(rec):
    return rec.get("setup_s")
