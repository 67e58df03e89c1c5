"""General generators, one per kind of entry that a traffic mix drives.

A traffic file's ``generator`` key names a module here. Its
``Traffic(cell, seed, device, program)`` makes the inputs from the
configuration, the mix and the seed, and offers the harness, which runs the
same sequence for every cell (`portbench.harness.run_cell`):

- ``segment(phase, n)``: n units (calls, blocks) driven as in the window,
  untimed; the warm-up (``phase`` "warm") and the profiled segments of a
  traced run ("profiled");
- ``window(seconds)`` -> (records, info): the measured window. The records
  hold ``window_s``, ``attempted`` and ``failed`` and what the cell's
  end-to-end metrics read: a sweep's ``payload_bits``; a receiver's
  ``samples`` and ``latency_ms`` (each block's, host clock);
- ``stepped(n)`` -> (records, mismatch): n units stepped through the layers'
  public calls with CUDA events between them; the records hold
  ``stage_ms`` (mean ms a stage), ``demod_rows`` and ``demod_k``, and
  mismatch counts the outputs that differ from the whole call's on the same
  inputs;
- ``judge()`` -> (checks, info): the outputs against ``portbench.reference``
  once the window has closed; each check is a compared number beside its
  limit.

``info`` is passed through to the result line unchanged, for its reader.
"""

from __future__ import annotations

import math
import time

import torch


class Marker:
    """A point in the device's stream that the host can wait for (a CUDA
    event); on the CPU every call has finished when it returns."""

    def __init__(self, device: torch.device):
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


class StageTimer:
    """CUDA events between the stages of one stepped call; on the CPU, the
    host clock (the tests' plain paths run synchronously)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self, name: str) -> None:
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append((name, event))
        else:
            self.marks.append((name, time.perf_counter()))

    def ms(self) -> dict:
        """{stage: ms} from each mark to the next, after the device is done."""
        if self.cuda:
            torch.cuda.synchronize()
        out = {}
        for (name, a), (_, b) in zip(self.marks, self.marks[1:]):
            out[name] = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
        return out


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_facts(device: torch.device) -> dict:
    """The card's name and the process's peak of allocated device memory."""
    if device.type != "cuda":
        return {"device_kind": "cpu", "memory_peak_bytes": 0}
    return {"device_kind": torch.cuda.get_device_name(device),
            "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}


def release(device: torch.device) -> None:
    """Return the cached blocks of freed tensors before the reference runs."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def check(value: float, limit: float) -> dict:
    """A compared number beside its limit; a number that is not finite
    (the program gave no answer) is written as 1e30, which fails any limit."""
    value = float(value)
    return {"value": value if math.isfinite(value) else 1e30, "limit": float(limit)}


def thirds(done_at: list[float], window_s: float) -> list[int]:
    """Units of work done in each third of the window, from the host times
    at which each was seen done: a steady window reads three equal counts."""
    return [sum(1 for t in done_at if k * window_s / 3 <= t < (k + 1) * window_s / 3)
            for k in range(3)]


def mean_stage_ms(runs: list[dict]) -> dict:
    """{stage: mean ms} over stepped calls."""
    return {k: sum(r[k] for r in runs) / len(runs) for k in runs[0]}
