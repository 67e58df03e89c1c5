"""The program's own spans (`r4w_tpu_torch.observe.spans`) read over two
more segments of a cell's loop, each the traffic's ``profiled`` phase.

- Segment A: the program's span recorder is on while ``torch.profiler``
  traces the device alone, which does not slow the host's launches. It
  gives each span's host time a unit, and puts each idle gap of the device
  down to the innermost recorded span covering the gap's midpoint, or to
  "outside the program" (the harness, or nothing the program ran). The
  recorder's clock is Kineto's (epoch nanoseconds), so the spans lie over
  the device's trace as recorded.
- Segment B: no recorder, ``torch.profiler`` traces the device and the
  host, so each span is a host range of the trace. Each device operation
  (kernel, memcpy, memset) is tied through its correlation id to the CUDA
  runtime call that launched it, and put down to the innermost span that
  covers that call; each blocking host wait (a synchronisation, a
  synchronous copy) to the span that covers it. Operations that no runtime
  call claims are listed apart, by name.

Units are the outermost program spans counted in a segment: a sweep call,
a received block. `profile_spans` gives the table: per span, host ms, self
host ms (less its child spans), the median host ms a call, device ms,
self device ms, launches, syncs and idle ms a unit, and its count
attributes a call. A program without spans gives a table with every gap
and operation outside the program. `span_metrics` reduces the table to the
per-layer numbers of the LoRa cells.

Run alone, it drives one cell's generator to the end of its warm-up and
prints one JSON line: the table, the numbers and, with ``--cost 1``, a unit's
host time with tracing off, with the recorder on, and under the profiler on
the device alone and on the device and the host::

    python3 portbench/spans.py --workload <cell> --seed <n> [--cost 1]
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import re
import statistics
import sys
import time
from collections import Counter, defaultdict, namedtuple
from pathlib import Path

Event = namedtuple("Event", "name start end corr")     # ns on Kineto's clock
OUTSIDE = "outside the program"
RUNTIME_CALL = re.compile(r"cu(da)?[A-Z]")             # CUDA runtime and driver API
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                        "cudaMemcpy", "cuStreamSynchronize", "cuCtxSynchronize",
                        "cuEventSynchronize"})
MEMORY_EVENTS = ("[memory]", "[OutOfMemory]")          # allocator records, not device work


def program_spans():
    """The program's span module, or None for a program that has none."""
    try:
        return importlib.import_module("r4w_tpu_torch.observe.spans")
    except ModuleNotFoundError:
        return None


def nest(ranges) -> list[int]:
    """Ranges sorted by (start, -end), properly nested -> each one's parent
    index, -1 for an outermost one."""
    parents, open_ = [], []
    for r in ranges:
        while open_ and ranges[open_[-1]].end <= r.start:
            open_.pop()
        parents.append(open_[-1] if open_ else -1)
        open_.append(len(parents) - 1)
    return parents


def innermost(ranges, starts, parents, t) -> int:
    """Index of the innermost range covering t, or -1. A range that starts
    before t but ends before it holds no range covering t except its
    ancestors, so the walk climbs."""
    k = bisect.bisect_right(starts, t) - 1
    while k >= 0 and ranges[k].end < t:
        k = parents[k]
    return k


class Tally:
    """Sums by span name of the ranges of one segment: a value goes to the
    innermost range (self) and to it and its ancestors (inclusive)."""

    def __init__(self, ranges, parents):
        self.ranges, self.parents = ranges, parents
        self.starts = [r.start for r in ranges]
        self.inclusive = defaultdict(Counter)
        self.own = defaultdict(Counter)

    def at(self, t) -> int:
        return innermost(self.ranges, self.starts, self.parents, t)

    def add(self, k: int, key: str, value: float) -> None:
        self.own[self.ranges[k].name if k >= 0 else OUTSIDE][key] += value
        while k >= 0:
            self.inclusive[self.ranges[k].name][key] += value
            k = self.parents[k]


def idle_gaps(device_ops):
    """(start, end) of each gap between the device's merged busy intervals."""
    from portbench.trace import merge

    busy = merge((op.start, op.end) for op in device_ops)
    return [(a[1], b[0]) for a, b in zip(busy, busy[1:])]


def tie(tally: Tally, host, device_ops) -> dict:
    """Put each device op, through the runtime call with its correlation id,
    under the innermost range covering that call (device ns, launches), and
    each runtime call under the range covering it (blocking waits as syncs).
    Returns the ops no runtime call claims, by name."""
    runtime = [e for e in host if RUNTIME_CALL.match(e.name)]
    by_corr = {e.corr: e for e in runtime}
    untied = Counter()
    for op in device_ops:
        call = by_corr.get(op.corr)
        if call is None:
            untied[op.name[:96]] += 1
            continue
        k = tally.at(call.start)
        tally.add(k, "device_ns", op.end - op.start)
        tally.add(k, "launches", 1)
    for call in runtime:
        if call.name in SYNC_CALLS:
            tally.add(tally.at(call.start), "syncs", 1)
    return dict(untied)


def reduce_recorded(recorded, device_ops, host) -> dict:
    """Segment A: the recorder's spans (in opening order, with their parent
    indices), the device's work and the host's runtime calls -> by span
    name, host ns, self host ns, each call's host ns, idle ns, launches
    (tied to the recorded spans over the shared clock) and summed count
    attributes; the units. A span's launches here and in segment B agree
    where the two clocks do."""
    ranges = [Event(s.name, s.start_ns, s.end_ns, 0) for s in recorded]
    parents = [s.parent for s in recorded]
    tally = Tally(ranges, parents)
    calls, counts, durations = Counter(), defaultdict(Counter), defaultdict(list)
    for r, s in zip(ranges, recorded):
        calls[r.name] += 1
        durations[r.name].append(r.end - r.start)
        tally.inclusive[r.name]["host_ns"] += r.end - r.start
        tally.own[r.name]["host_ns"] += r.end - r.start
        if s.parent >= 0:
            tally.own[ranges[s.parent].name]["host_ns"] -= r.end - r.start
        counts[r.name].update(s.counts)
    for start, end in idle_gaps(device_ops):
        tally.add(tally.at(0.5 * (start + end)), "idle_ns", end - start)
    tie(tally, host, device_ops)
    return {"units": sum(1 for p in parents if p < 0), "calls": calls, "counts": counts,
            "durations": durations, "tally": tally}


def reduce_traced(host, device_ops, names) -> dict:
    """Segment B: the host's events (program ranges among them) and the
    device's work -> by span name, device ns, launches and syncs, inclusive
    and self; the units; the device operations no runtime call claims."""
    ranges = sorted((e for e in host if e.name in names), key=lambda e: (e.start, -e.end))
    tally = Tally(ranges, nest(ranges))
    untied = tie(tally, host, device_ops)
    return {"units": sum(1 for p in tally.parents if p < 0), "tally": tally, "untied": untied}


def span_table(a: dict, b: dict) -> dict:
    """Segments A and B -> {"units_a", "units_b", "spans": {name: row},
    OUTSIDE: row, "untied": {...}}: values a unit (a segment's totals where
    it counted no unit), count attributes a call."""
    ua, ub = a["units"] or 1, b["units"] or 1
    ta, tb = a["tally"], b["tally"]
    rows = {}
    for name in sorted(set(a["calls"]) | set(tb.inclusive)):
        n = a["calls"].get(name, 0)
        rows[name] = {
            "calls": n / ua,
            "host_ms": ta.inclusive[name]["host_ns"] / ua / 1e6,
            "self_host_ms": ta.own[name]["host_ns"] / ua / 1e6,
            "host_ms_median": (statistics.median(a["durations"][name]) / 1e6
                               if a["durations"].get(name) else None),
            "idle_ms": ta.own[name]["idle_ns"] / ua / 1e6,
            "device_ms": tb.inclusive[name]["device_ns"] / ub / 1e6,
            "self_device_ms": tb.own[name]["device_ns"] / ub / 1e6,
            "launches": tb.inclusive[name]["launches"] / ub,
            "self_launches": tb.own[name]["launches"] / ub,
            "syncs": tb.inclusive[name]["syncs"] / ub,
            "launches_a": ta.inclusive[name]["launches"] / ua,
            "counts": {k: v / n for k, v in a["counts"][name].items()} if n else {},
        }
    outside = {"idle_ms": ta.own[OUTSIDE]["idle_ns"] / ua / 1e6,
               "device_ms": tb.own[OUTSIDE]["device_ns"] / ub / 1e6,
               "launches": tb.own[OUTSIDE]["launches"] / ub,
               "syncs": tb.own[OUTSIDE]["syncs"] / ub}
    return {"units_a": a["units"], "units_b": b["units"], "spans": rows, OUTSIDE: outside,
            "untied": b["untied"]}


def kineto_events(prof):
    """(device work, host events) of a finished profile as Events: device
    work leaves out allocator records and user annotations, which Kineto
    draws on the device over the kernels a ``record_function`` launched."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.name() in MEMORY_EVENTS or e.is_hidden_event():
            continue
        item = Event(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id())
        if e.device_type() != DeviceType.CUDA:
            host.append(item)
        elif not e.is_user_annotation():
            device.append(item)
    return device, host


def traced_segment(run_segment, units: int, device, host: bool):
    """Run a segment under ``torch.profiler`` (the device, and with `host`
    the CPU too), ending in a synchronisation -> its Events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=activities) as prof:
        run_segment(units)
        torch.cuda.synchronize(device)
    return kineto_events(prof)


def profile_spans(run_segment, device, units_a: int, units_b: int) -> dict:
    """Segment A over `units_a` units, segment B over `units_b` -> the table."""
    program = program_spans()
    with program.recording() if program else contextlib.nullcontext() as rec:
        dev_a, host_a = traced_segment(run_segment, units_a, device, host=False)
    if not dev_a:
        raise RuntimeError("the profiler recorded no device events")
    dev_b, host_b = traced_segment(run_segment, units_b, device, host=True)
    names = program.NAMES if program else frozenset()
    return span_table(reduce_recorded(rec.spans if rec else [], dev_a, host_a),
                      reduce_traced(host_b, dev_b, names))


def span_metrics(table: dict) -> dict:
    """The LoRa cells' per-layer numbers that the table holds: the receiver's
    (a unit is one `lora.demodulate`) with the suffix ``.rx``, the sweep's
    (a unit is one `lora.loopback_ber`) with ``.sim``."""
    from portbench import roofline

    rows = table["spans"]
    out = {}

    def demod_share(suffix):
        d = rows.get("lora.demodulate_symbols")
        if d and d["device_ms"] and d["counts"]:
            out[f"demod_span_roofline.{suffix}"] = roofline.demod_share(
                round(d["counts"]["rows"]), round(d["counts"]["k"]), d["device_ms"] / 1e3)

    rx, sim = rows.get("lora.demodulate"), rows.get("lora.loopback_ber")
    if sim:
        out["launches.sim"] = sim["launches"]
        out["syncs.sim"] = sim["syncs"]
        out["channel_span_ms.sim"] = rows["channel.awgn"]["device_ms"]
        out["modem_span_ms.sim"] = (rows["lora.modulate"]["device_ms"]
                                    + rows["lora.decode_symbols"]["device_ms"]
                                    + sim["self_device_ms"])
        demod_share("sim")
    elif rx:
        out["enqueue_ms.rx"] = rx["host_ms_median"]
        out["launches.rx"] = rx["launches"]
        out["syncs.rx"] = rx["syncs"]
        out["decode_span_ms.rx"] = rows["lora.decode_symbols"]["device_ms"]
        demod_share("rx")
    return out


def tracing_cost(run_segment, device, units: int) -> dict:
    """Host ms a unit of `run_segment(units)` with tracing off, with the
    recorder on, and under the profiler on the device alone and on the
    device and the host; off once more at the end."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    program = program_spans()
    modes = [("off", contextlib.nullcontext),
             ("recorder", program.recording if program else None),
             ("device_trace", lambda: profile(activities=[ProfilerActivity.CUDA])),
             ("device_and_host_trace", lambda: profile(activities=[ProfilerActivity.CUDA,
                                                                   ProfilerActivity.CPU]))]
    out = defaultdict(list)
    for mode, context in modes + modes[:1]:      # off once more at the end
        if context is None:
            continue
        with context():
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            run_segment(units)
            out[mode].append((time.perf_counter() - t0) / units * 1e3)
    return dict(out)


def main(argv=None) -> int:
    import argparse
    import json

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from portbench import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--cost", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.find_cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("portbench.spans: needs a CUDA card", file=sys.stderr)
        return 2
    device, tr = torch.device("cuda"), cell.traffic
    traffic = harness.load_generator(tr["generator"]).Traffic(cell, args.seed, device, None)
    traffic.segment("warm", int(tr["warm"]))
    segment = lambda n: traffic.segment("profiled", n)   # noqa: E731
    out = {"workload": cell.name, "seed": args.seed, "card": harness.card_line()}
    if args.cost:
        out["cost_ms_a_unit"] = tracing_cost(segment, device, int(tr["profiled"]))
    table = profile_spans(segment, device, int(tr["profiled"]), int(tr["breakdown"]))
    out["metrics"] = span_metrics(table)
    out["spans"] = table
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
