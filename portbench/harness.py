"""The benchmark's general part: finds a cell's files by name, runs its
generator, reduces the records to metrics and prints the result line.

`BENCHMARK.json` names each cell (`workloads`), its configuration and its
traffic mix, and the metrics with the cells that report them. The harness
finds the rest by name:

- ``configs/<config>.json``: the deployment (sizes, precision, source);
- ``traffic/<traffic>.json``: the mix's parameters; its ``generator`` key
  names the general generator in ``generators/<name>.py`` that reads it,
  and ``warm``, ``profiled``, ``breakdown`` and ``stepped`` say how many of
  its units (calls, blocks) each phase of a run takes;
- ``metrics/<metric>.py``: one metric each, with its ``UNIT``, ``LAYER``,
  ``MOVES`` and ``SOURCE`` and a ``compute(records)`` that returns the
  number or None where the run has nothing for it to read.

Adding a cell, a mix or a metric is adding files and entries; no file here
changes. The program under test is imported only by the generators.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent          # portbench/
CHECKOUT = ROOT.parent                          # where BENCHMARK.json and the program live
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "r4w_tpu")


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: tuple      # metric names this cell reports with --trace 0
    per_layer: tuple       # metric names this cell reports with --trace 1
    chips: int


def load_benchmark(path: Path | None = None) -> dict:
    return json.loads((path or CHECKOUT / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json with its configuration and traffic
    files read, and the names of the metrics it reports."""
    bench = bench or load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    config = json.loads((root / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((root / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name=name, config=config, traffic=traffic, chips=int(w["chips"]),
                end_to_end=tuple(m["name"] for m in bench["end_to_end"] if _reports(m, name)),
                per_layer=tuple(m["name"] for m in bench["per_layer"] if _reports(m, name)))


def load_metric(name: str, root: Path = ROOT):
    """The module of ``metrics/<name>.py``, loaded from its path (a metric's
    name may hold dots)."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_generator(name: str):
    return importlib.import_module(f"portbench.generators.{name}")


def seed_of(seed: int, *tags: int) -> int:
    """A 63-bit seed for one draw, from the run's seed and the draw's tags
    (any whole numbers, negative ones as their 64-bit pattern)."""
    words = [int(x) & (2 ** 64 - 1) for x in (seed, *tags)]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def compute_metrics(names, records: dict, root: Path = ROOT) -> dict:
    """{name: {"value", "unit"}} of each metric whose reader finds something."""
    out = {}
    for name in names:
        module = load_metric(name, root)
        value = module.compute(records)
        if value is not None:
            out[name] = {"value": float(value), "unit": module.UNIT}
    return out


def loaded_forbidden() -> list[str]:
    """Top-level names in sys.modules that the benchmark must never load,
    compared whole: ``r4w_tpu_torch`` is not ``r4w_tpu``."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def card_line() -> str:
    """nvidia-smi's name and power limit of the card, or why it gave none."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi: {exc}"
    return out.stdout.strip() or out.stderr.strip()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             program=None) -> dict:
    """Drive one run of `cell` and return the result line's object. `program`
    stands in for the port's LoRa module (tests and the control pass one).

    Every cell runs the same sequence: its generator makes the inputs, warms
    up, measures the window; a traced run profiles segments of the loop and
    steps through the layers; then the device's peak is read, the program's
    state freed and the outputs judged."""
    import torch

    from portbench import trace as tracing
    from portbench.generators import check, device_facts, release

    device, tr = torch.device(device), cell.traffic
    t_generator = time.perf_counter()
    traffic = load_generator(tr["generator"]).Traffic(cell, seed, device, program)
    t_inputs = time.perf_counter()
    traffic.segment("warm", int(tr["warm"]))
    t_warm = time.perf_counter()
    records = {"setup_s": t_warm - t_start}
    info = {"setup_parts": {"start_to_generator_s": t_generator - t_start,
                            "program_and_inputs_s": t_inputs - t_generator,
                            "warm_up_s": t_warm - t_inputs}}
    window, window_info = traffic.window(seconds)
    records.update(window)
    info.update(window_info, window_s=window["window_s"])
    stepped_checks = {}
    if trace:
        records.update(tracing.profile_segments(lambda n: traffic.segment("profiled", n), device,
                                                int(tr["profiled"]), int(tr["breakdown"])))
        stepped, mismatch = traffic.stepped(int(tr["stepped"]))
        records.update(stepped)
        stepped_checks["stepped_mismatch"] = check(mismatch, 0)
    facts = device_facts(device)
    release(device)
    t_judge = time.perf_counter()
    checks, judge_info = traffic.judge()
    info.update(judge_info, judge_s=time.perf_counter() - t_judge)
    checks.update(stepped_checks)
    names = cell.per_layer if trace else cell.end_to_end
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": facts["device_kind"],
           "count": cell.chips, "memory_peak_bytes": int(facts["memory_peak_bytes"])}
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": int(records["attempted"]), "failed": int(records["failed"]),
              "metrics": compute_metrics(names, records), "device": dev}
    if trace:
        dev["busy_s"] = records["busy_s"]
        dev["window_s"] = records["span_s"]
        result["breakdown"] = records["breakdown"]
    result["info"] = info
    result["checks"] = checks
    return result


def print_result(result: dict) -> None:
    """The checks as the last lines of standard error, then the result as the
    last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr,
              flush=True)
    print(json.dumps(result), flush=True)
