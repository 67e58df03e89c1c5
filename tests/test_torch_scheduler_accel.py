"""The port's schedulers, accelerator seam and the pipeline's keyed blocks
against ``r4w_tpu.scheduler``, ``r4w_tpu.accel`` and ``r4w_tpu.pipeline``.

The reference's own cases of ``tests/test_rt_scheduler.py`` and
``tests/test_infra.py`` (scheduler) run on the port; `SampleSchedule.masks`
equals the reference's masks on the same events, overlapping ones
included (the paint order: ascending priority, insertion order within a
priority, the last painted wins); `TorchAccelerator` equals
`SimulatedAccelerator` and JAX's accelerator within the reference's 1e-3;
each registry block whose reference function takes a PRNG key first draws
the reference's randomness from the port pipeline's key
(`pipeline._call_block` on both sides with the same seed).
"""

import jax
import numpy as np
import pytest
import torch

from r4w_tpu import accel as ref_accel
from r4w_tpu import pipeline as ref_pipeline
from r4w_tpu import scheduler as ref_sched
from r4w_tpu.registry import default_registry as ref_registry
from r4w_tpu_torch import accel, pipeline, remote_gates, scheduler
from r4w_tpu_torch.channel import threefry
from r4w_tpu_torch.registry import default_registry
from torch_port_proxy import compare, run_reference_test

ACCEL_TOL = 1e-3  # tests/test_infra_fills.py:167-185
KEYED_DRAW_TOL = 1e-6      # max|port − reference| / max|reference|: normals within 3e-7


def _rebind(monkeypatch, module):
    """Bind the reference test module's scheduler names to the port's."""
    for name in dir(module):
        if getattr(module, name) is getattr(ref_sched, name, None):
            monkeypatch.setattr(module, name, getattr(scheduler, name))


RT_SCHEDULER_CASES = [
    "TestClocks.test_clock_sources", "TestClocks.test_source_selection",
    "TestRadioState.test_capability_predicates", "TestRadioState.test_valid_transitions",
    "TestRadioState.test_error_recovery_path", "TestRadioState.test_turnaround_timing_enforced",
    "TestEvents.test_priority_order_at_same_deadline",
    "TestEvents.test_guard_blocks_until_state_allows",
    "TestEvents.test_guard_passes_in_right_state", "TestEvents.test_repeat_events",
    "TestEvents.test_missed_deadline_accounting", "TestEvents.test_cancel_by_id_and_source",
    "TestEvents.test_schedule_in_relative"]


@pytest.mark.parametrize("name", RT_SCHEDULER_CASES)
def test_reference_rt_scheduler_cases(monkeypatch, name):
    """tests/test_rt_scheduler.py's own cases on the port's classes."""
    import test_rt_scheduler as ref_tests

    _rebind(monkeypatch, ref_tests)
    owner, method = name.split(".")
    getattr(getattr(ref_tests, owner)(), method)()


@pytest.mark.parametrize("name", ["test_tick_scheduler_ordering_and_periodic",
                                  "test_sample_schedule_masks_and_conflicts"])
def test_reference_infra_scheduler_cases(monkeypatch, name):
    """tests/test_infra.py's scheduler cases on the port (masks on the CPU)."""
    run_reference_test(monkeypatch, "test_infra", name, sched="r4w_tpu_torch.scheduler")


def _events(seed: int, n_events: int = 40, span: int = 5000):
    rng = np.random.default_rng(seed)
    kinds = ("tx", "rx", "hop", "guard", "beacon")
    return [dict(start_sample=int(rng.integers(-200, span)),
                 duration_samples=int(rng.integers(0, 900)), kind=kinds[rng.integers(5)],
                 channel=int(rng.integers(0, 64)), priority=int(rng.integers(0, 3)))
            for _ in range(n_events)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masks_equal_reference(seed):
    port, ref = scheduler.SampleSchedule(1e6), ref_sched.SampleSchedule(1e6)
    for ev in _events(seed):
        port.add(scheduler.ScheduledEvent(**ev))
        ref.add(ref_sched.ScheduledEvent(**ev))
    got = port.masks(5000, device="cpu")
    for g, w in zip(got, ref.masks(5000)):
        assert g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), w)
    assert [(a, b) for a, b in port.conflicts()] == [
        (scheduler.ScheduledEvent(**vars(a)), scheduler.ScheduledEvent(**vars(b)))
        for a, b in ref.conflicts()]


def test_overlapping_events_paint_in_priority_then_insertion_order():
    s = scheduler.SampleSchedule(1000.0)
    s.add(scheduler.ScheduledEvent(0, 100, kind="tx", channel=1, priority=2))  # wins 0-99
    s.add(scheduler.ScheduledEvent(50, 100, kind="rx", channel=2, priority=0))
    s.add(scheduler.ScheduledEvent(60, 100, kind="hop", channel=3, priority=0))  # later, same
    s.add(scheduler.ScheduledEvent(140, 20, kind="guard", channel=4, priority=1))
    active, channel, kind = s.masks(200, device="cpu")
    want_channel = np.full(200, -1, np.int32)
    want_channel[0:100] = 1
    want_channel[100:140] = 3
    want_channel[140:160] = 4
    np.testing.assert_array_equal(channel.numpy(), want_channel)
    np.testing.assert_array_equal(active.numpy(), want_channel >= 0)
    assert kind[99] == 0 and kind[100] == 2 and kind[150] == 3 and kind[170] == -1
    assert channel.dtype == torch.int32 and active.dtype == torch.bool


def test_hop_schedule_masks_at_small_size():
    """The chip run's hopping schedule, 8 hops, equals the reference's."""
    port = remote_gates.hop_schedule(8)
    ref = ref_sched.SampleSchedule(port.sample_rate)
    for ev in port.events:
        ref.add(ref_sched.ScheduledEvent(**vars(ev)))
    n = 8 * int(round(remote_gates.HOP_DWELL_S * remote_gates.HOP_RATE_HZ))
    for g, w in zip(port.masks(n, device="cpu"), ref.masks(n)):
        np.testing.assert_array_equal(g.numpy(), w)
    assert len(port.conflicts()) == 0 and port.masks(n, device="cpu")[2][n - 1] == 3


def _accel_inputs(n=256, seed=2):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    taps = rng.standard_normal(16).astype(np.complex64)
    chirp = np.exp(1j * np.pi * 0.01 * np.arange(n) ** 2).astype(np.complex64)
    return x, taps, chirp


@pytest.mark.parametrize("n", [256, 1000])
def test_torch_accelerator_equals_sim_and_reference(n):
    x, taps, chirp = _accel_inputs(n)
    port = accel.create_accelerator("torch", device="cpu")
    sim = accel.create_accelerator("sim")
    jx = ref_accel.create_accelerator("jax")
    cases = (("fft", (x,)), ("fir", (x, taps)), ("chirp_correlate", (x, chirp)))
    for name, args in cases:
        got = getattr(port, name)(*args)
        assert got.device.type == "cpu" and got.dtype == torch.complex64
        for want in (getattr(sim, name)(*args), np.asarray(getattr(jx, name)(*args))):
            assert got.shape == want.shape, name
            np.testing.assert_allclose(got.numpy(), want, atol=ACCEL_TOL, err_msg=name)


def test_accelerator_capabilities_and_factory():
    cap = accel.TorchAccelerator("cpu").capabilities()
    assert cap.name == "torch-cpu" and cap.max_fft == 1 << 24 and cap.supports_fir
    assert vars(accel.SimulatedAccelerator().capabilities()) == vars(
        ref_accel.SimulatedAccelerator().capabilities())
    assert accel.TorchAccelerator().device == torch.device("cuda")  # the card unless named
    with pytest.raises(ValueError, match="unknown accelerator"):
        accel.create_accelerator("jax")


def _x(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    return (0.7 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)


KEYED_CASES = {
    "awgn_channel": ([_x()], {"snr_db": 10}),
    "rayleigh_channel": ([_x()], {}),
    "phase_noise": ([_x()], {"linewidth_hz": 500.0, "sample_rate": 1e5}),
    "phase_noise_model": ([_x()], {"linewidth_hz": 50.0, "sample_rate": 1e6}),
    "tdl_channel": ([_x()], {"profile": "EPA", "doppler_hz": 30, "sample_rate": 30.72e6}),
    "tapped_delay_line": ([_x()], {"profile": "ETU", "doppler_hz": 300, "sample_rate": 30.72e6}),
    "random_source": ([], {"n": 257, "kind": "gaussian"}),
    "random_pdu_gen": ([], {"min_len": 4, "max_len": 40}),
    "quantum_key_distribution": ([], {"n_bits": 96, "error_rate": 0.1}),
}


@pytest.mark.parametrize("name", sorted(KEYED_CASES))
def test_keyed_block_draws_equal_reference(name):
    port, ref = default_registry(), ref_registry()
    ins, params = KEYED_CASES[name]
    seed = 7919 * 3 + 5
    want = ref_pipeline._call_block(ref.get(name).factory(), list(ins), params,
                                    jax.random.key(seed))
    got = pipeline._call_block(port.get(name).factory(), [torch.from_numpy(x) for x in ins],
                               params, threefry.key(seed), device="cpu")
    if isinstance(want, bytes):
        assert got == want
    else:
        compare(got, want, KEYED_DRAW_TOL, name)
