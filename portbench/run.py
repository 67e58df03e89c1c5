"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <config>.<traffic> --seed <n> \
        --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json`` and the
``r4w_tpu_torch`` package, on a machine with as many CUDA cards as the cell
asks for. The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its limit;
the checks are also the last lines of standard error. Without the cards, or
with JAX or the JAX package loaded once the window has closed, it prints no
result and exits with a code other than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(CHECKOUT))
# Compiled bytecode of every module the run imports (PyTorch and its lazy
# imports included) goes to a fixed directory inside the checkout, beside the
# kernels' libraries, so that only a checkout's first run compiles it.
sys.pycache_prefix = str(CHECKOUT / "build" / "pycache")
sys.dont_write_bytecode = False

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.find_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), found {have}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    print(f"card: {harness.card_line()}", file=sys.stderr, flush=True)
    loaded = harness.loaded_forbidden()
    if loaded:
        print(f"portbench: forbidden modules loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
