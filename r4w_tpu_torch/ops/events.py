"""Event-extraction primitives: threshold crossings with a refractory time
or a dead time, and fixed-capacity event lists.

PyTorch counterpart of ``r4w_tpu.ops.events``. The two state machines
(`refractory_trigger`, `deadtime_runs`) are step loops over the last axis,
as the reference's ``lax.scan`` is, batched over the leading axes, their
state a tensor on the mask's device (no host read inside the loop).
`masked_indices` ranks the True entries by a cumulative sum and scatters
their positions into a buffer of the requested size, so it never asks the
host how many there are (`torch.nonzero` would).

`latest_set` is the parallel form of a state machine in which the last
decisive step wins (a hysteresis comparator, a burst gate, a run counter):
the state at step t is the value set by the latest step at or before t
that sets one, found by a cumulative max of that step's index. It rounds
nothing, so it equals the step loop exactly.
"""

from __future__ import annotations

import torch

from r4w_tpu_torch.core.types import to_tensor


def _mask(mask) -> torch.Tensor:
    return to_tensor(mask).to(torch.bool)


def latest_set(sets: torch.Tensor, value: torch.Tensor, initial=0):
    """(state, last) along the last axis: `state[..., t]` is `value` at the
    latest step s <= t where `sets` is True, or `initial` where there is
    none; `last[..., t]` is that s, or -1."""
    steps = torch.arange(sets.shape[-1], device=sets.device)
    last = torch.cummax(torch.where(sets, steps, -1), dim=-1).values
    held = torch.gather(value, -1, last.clamp(min=0))
    return torch.where(last >= 0, held, torch.as_tensor(initial, dtype=value.dtype,
                                                        device=value.device)), last


def refractory_trigger(mask, refractory: int) -> torch.Tensor:
    """Boolean accept mask: True where `mask` is True and >= refractory
    samples have elapsed since the previous accepted trigger. Scans the
    last axis; leading axes are batched."""
    m = _mask(mask)
    refractory = int(refractory)
    # samples elapsed since the last accepted trigger as seen AT this
    # sample (so a fire at t allows the next at t+r)
    since = torch.full(m.shape[:-1], refractory, dtype=torch.int32, device=m.device)
    one = torch.ones_like(since)
    fires = []
    for t in range(m.shape[-1]):
        fire = m[..., t] & (since >= refractory)
        since = torch.where(fire, one, torch.clamp(since + 1, max=refractory))
        fires.append(fire)
    if not fires:
        return m.clone()
    return torch.stack(fires, dim=-1)


def deadtime_runs(mask, dead_time: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(start_mask, end_mask) of dead-time-extended runs.

    A run starts at a True sample (when idle) and continues while the
    mask is True OR fewer than `dead_time` samples have elapsed since
    the run began; `end_mask` marks the first sample AFTER each run.
    A run still open at the end of the stream emits NO end mark —
    callers append the stream length when counts differ (this keeps
    end positions unambiguous). Matches the reference AE hit loop
    (acoustic_emission_sensor.rs semantics)."""
    m = _mask(mask)
    dead_time = int(dead_time)
    in_run = torch.zeros(m.shape[:-1], dtype=torch.bool, device=m.device)
    age = torch.zeros(m.shape[:-1], dtype=torch.int32, device=m.device)
    one, zero = torch.ones_like(age), torch.zeros_like(age)
    starts, ends = [], []
    for t in range(m.shape[-1]):
        m_t = m[..., t]
        start = ~in_run & m_t
        stay = in_run & ((age < dead_time) | m_t)
        starts.append(start)
        ends.append(in_run & ~stay)
        in_run = start | stay
        age = torch.where(start, one, torch.where(stay, age + 1, zero))
    if not starts:
        return m.clone(), m.clone()
    return torch.stack(starts, dim=-1), torch.stack(ends, dim=-1)


def masked_indices(mask, size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-capacity event extraction: the positions of the first `size`
    True entries of a 1-D mask as `(idx int32[size], valid bool[size])`,
    padded with n = len(mask) past the last event. Callers gather with
    the padded index (pad their source by one) and mask results with
    `valid`. Each True entry's rank is its count of True entries before
    it; the positions of ranks below `size` are scattered into the buffer
    (every other entry into a spare slot that is cut off)."""
    m = _mask(mask)
    n = m.shape[-1]
    rank = torch.cumsum(m.to(torch.int64), dim=-1) - 1
    slot = torch.where(m & (rank < size), rank, torch.full_like(rank, size))
    buf = torch.full((size + 1,), n, dtype=torch.int64, device=m.device)
    buf.scatter_(0, slot, torch.arange(n, device=m.device))
    idx = buf[:size].to(torch.int32)
    return idx, idx < n
