"""The control of `correct`: the plain reference put in the program's place,
computed a precision below the configurations' float32 (bfloat16 at every
tensor a receiver keeps in device memory). Its runs must come out not correct.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 --seconds 3

prints one JSON line a seed with the run's `correct` and its checks, each
number beside its limit. The benchmark's own runs never run this; it reads
the upper end of each limit, on the chip at the cell's own size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import NamedTuple

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402
from portbench.reference import lora as ref  # noqa: E402


class Demodulated(NamedTuple):
    payload: torch.Tensor
    symbols: torch.Tensor


class ReferenceProgram:
    """The reference behind the two entries the cells drive, at `precision`."""

    def __init__(self, precision: str = "bfloat16"):
        self.precision = precision

    @staticmethod
    def _phy(params) -> ref.Phy:
        return ref.Phy(sf=params.sf, bw_hz=params.bw_hz, cr=params.cr)

    def loopback_ber(self, params, payload, snr_db, *, noise):
        phy, n = self._phy(params), payload.shape[-1]
        tx = ref.modulate(phy, payload, self.precision)
        shape = (*torch.broadcast_shapes(tx.shape[:-1], snr_db.shape), tx.shape[-1])
        rx = ref.awgn(tx, snr_db, noise(shape, tx.device), self.precision)
        _, got = ref.demodulate(phy, rx, n, self.precision)
        return ref.bit_errors(got, payload).to(torch.float32) / (8 * n)

    def demodulate(self, params, block):
        phy = self._phy(params)
        n = block.shape[-1] // phy.chips // (4 + phy.cr) * phy.sf // 2
        symbols, got = ref.demodulate(phy, block, n, self.precision)
        return Demodulated(payload=got.to(torch.int32), symbols=symbols.to(torch.int32))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.find_cell(args.workload)
    program = ReferenceProgram()
    for seed in args.seeds:
        res = harness.run_cell(cell, seed, args.seconds, False, "cuda", time.perf_counter(),
                               program=program)
        print(json.dumps({"workload": args.workload, "seed": seed, "precision": program.precision,
                          "correct": res["correct"], "attempted": res["attempted"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
