"""Reduction of a `torch.profiler` trace to the device's busy time, the
traced window, the device operations that took most time and the longest
idle gaps by what the host was doing.

The busy time is the union of the raw device events' intervals, the window
runs from the first device event's start to the last one's end, and the idle
share is one less their ratio: the arithmetic of the port's
``profiling.breakdown``, copied here so that the yardstick does not move with
the program. The raw Kineto events are read, not ``prof.events()``, whose
event trees take minutes to build at a step loop's launch counts.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

TOP = 10
NAME_CHARS = 96
MEMORY_EVENTS = ("[memory]", "[OutOfMemory]")   # allocator records, not device work


def merge(spans):
    """Sorted (start, end) intervals -> their union as disjoint intervals."""
    out = []
    for start, end in sorted(spans):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def reduce_events(device, host) -> dict:
    """Device and host events as (name, start_s, end_s) -> busy_s, span_s,
    and the breakdown: device seconds by operation name, and idle seconds by
    the innermost host operation under each gap's midpoint, ten of each,
    largest first."""
    if not device:
        raise RuntimeError("the profiler recorded no device events")
    busy = merge((s, e) for _, s, e in device)
    busy_s = sum(e - s for s, e in busy)
    span_s = busy[-1][1] - busy[0][0]
    ops = defaultdict(float)
    for name, s, e in device:
        ops[name[:NAME_CHARS]] += e - s
    host = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    gaps = defaultdict(float)
    for (_, prev_end), (next_start, _) in zip(busy, busy[1:]):
        mid = 0.5 * (prev_end + next_start)
        name = "no host operation"
        # innermost: the latest-starting host operation that covers the midpoint
        for h in reversed(host[:bisect.bisect_right(starts, mid)]):
            if h[2] >= mid:
                name = h[0][:NAME_CHARS]
                break
        gaps[name] += next_start - prev_end
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"busy_s": busy_s, "span_s": span_s,
            "breakdown": {"device_ops": top(ops), "idle_gaps": top(gaps)}}


@contextlib.contextmanager
def profiled(out: dict, device, host: bool = True):
    """Profile the block's CUDA activity, and with `host` the CPU's too; on
    exit, put `reduce_events` of what it recorded into `out`. The block ends
    in a device synchronisation. The CPU's tracing slows the host's launches,
    so a host-paced loop reads idler with it than without: take the busy time
    and the window from a run with `host` off. On the CPU (the tests' plain
    paths) the CPU's operations stand in for the device's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = ([ProfilerActivity.CUDA] if cuda else []) + (
        [ProfilerActivity.CPU] if host or not cuda else [])
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize(device)
    dev, cpu = [], []
    for e in prof.profiler.kineto_results.events():
        if e.name() in MEMORY_EVENTS or e.is_hidden_event():
            continue
        item = (e.name(), e.start_ns() / 1e9, (e.start_ns() + e.duration_ns()) / 1e9)
        if e.device_type() == DeviceType.CUDA or not cuda:
            dev.append(item)
        if e.device_type() != DeviceType.CUDA:
            cpu.append(item)
    out.update(reduce_events(dev, cpu))


def profile_segments(run_segment, device, idle_units: int, breakdown_units: int) -> dict:
    """busy_s and span_s from `run_segment(idle_units)` traced on the device
    alone, and the breakdown from `run_segment(breakdown_units)` traced on
    the device and the host."""
    idle, both = {}, {}
    with profiled(idle, device, host=False):
        run_segment(idle_units)
    with profiled(both, device, host=True):
        run_segment(breakdown_units)
    return {"busy_s": idle["busy_s"], "span_s": idle["span_s"], "breakdown": both["breakdown"]}
