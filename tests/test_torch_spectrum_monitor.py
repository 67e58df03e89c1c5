"""The wideband spectrum monitor and the blocks gate (`monitor_gates`).

`spectrum_monitor_gate` runs on the CPU at rows=2 (two blocks of 2^20
samples, 68 ms of the 30.72 MS/s capture) and is held against the same
chain composed of the JAX package's own functions on the same capture
(`detect.spectrum_sense`, `stream_math.digital_down_convert`,
`detect.burst_detect`, and `stream_blocks.power_squelch`,
`envelope_detector` and `peak_hold` a channel at a time, as the
reference's scans take one stream): the groups equal, the burst decisions,
masks and squelch gates equal but at ties (`monitor_gates.TIE_REL`), the
channels, envelopes and peak holds within the card-against-CPU
tolerances, and every bar the same. At two blocks one emitter is on for
most of the capture, so the median floor the burst gate measures against
is its own level and the burst count misses there, in the reference as in
the port; the full-width gate (32 blocks) meets every bar on the card.
`dsp_blocks_gate` runs on the CPU, its recursion kinds at a small shape.
The kernel's own tests are `cuda`-marked and skip here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.ops import detect as ref_detect
from r4w_tpu.ops import stream_blocks as ref_sb
from r4w_tpu.ops import stream_math as ref_sm
from r4w_tpu_torch import entry, monitor_gates as mg
from r4w_tpu_torch.kernels import recurrence

ROWS = 2
BAR_TOL = 1e-5   # shares and medians of the two runs' bars


def _reference_chain(capture: np.ndarray) -> dict:
    """The monitor composed of the JAX package's functions, as tensors."""
    occupied, psd_db = ref_detect.spectrum_sense(jnp.asarray(capture.reshape(-1)),
                                                 nfft=mg.SENSE_NFFT,
                                                 threshold_db=mg.SENSE_THRESHOLD_DB)
    centres = mg._groups(np.asarray(occupied), np.asarray(psd_db))
    bin_hz = mg.MONITOR_RATE_HZ / mg.SENSE_NFFT
    ch = np.stack([np.asarray(ref_sm.digital_down_convert(
        jnp.asarray(capture), (k - mg.SENSE_NFFT // 2) * bin_hz, mg.MONITOR_RATE_HZ,
        mg.MONITOR_DECIMATION)).reshape(-1) for k in centres])
    per_row = {name: np.stack([np.asarray(fn(jnp.asarray(row))[0]) for row in ch])
               for name, fn in (("squelched", lambda r: ref_sb.power_squelch(
                   r, mg.SQUELCH_DB, alpha=mg.SQUELCH_ALPHA)),
                                ("envelope", ref_sb.envelope_detector),
                                ("peak", lambda r: ref_sb.peak_hold(r, decay=mg.PEAK_DECAY)))}
    t = {k: torch.from_numpy(np.array(v)) for k, v in per_row.items()}
    return {"centres": centres, "channels": torch.from_numpy(ch),
            "mask": torch.from_numpy(np.array(ref_detect.burst_detect(
                jnp.asarray(ch), mg.BURST_FRAME, mg.BURST_ON_DB, mg.BURST_OFF_DB))), **t}


@pytest.fixture(scope="module")
def runs():
    gate = entry.spectrum_monitor_gate("cpu", rows=ROWS)
    capture, planted = mg.monitor_capture(ROWS)
    return gate, _reference_chain(capture), planted


def test_monitor_matches_the_reference_chain(runs):
    gate, ref, _ = runs
    agreement = mg.monitor_agreement(gate["outputs"], ref)
    assert agreement["ok"], agreement


def test_monitor_bars_equal_the_reference_chains(runs):
    gate, ref, planted = runs
    bars, want = gate["bars"], mg.monitor_bars(ref, planted)
    for key in ("centre_bins", "planted_bins", "groups_ok", "bursts", "bursts_planted",
                "worst_edge_frames", "ok"):
        assert bars[key] == want[key], key
    for key in ("open", "closed", "env_in", "env_out"):
        np.testing.assert_allclose(bars[key], want[key], rtol=0, atol=BAR_TOL)
    assert abs(bars["peak_max"] - want["peak_max"]) <= BAR_TOL * want["peak_max"]
    # the bars that two blocks can show: every group, squelch, envelope and peak
    assert bars["groups_ok"] and min(bars["open"]) >= mg.SQUELCH_SHARE
    assert min(bars["closed"]) >= mg.SQUELCH_SHARE and max(bars["env_out"]) < mg.ENVELOPE_OUT
    assert all(mg.ENVELOPE_IN[0] <= v <= mg.ENVELOPE_IN[1] for v in bars["env_in"])
    assert mg.PEAK_RANGE[0] <= bars["peak_max"] <= mg.PEAK_RANGE[1]
    assert bars["worst_edge_frames"] <= mg.EDGE_TOL_FRAMES


def test_monitor_shapes_and_launches_on_the_cpu(runs):
    gate, _, planted = runs
    out = gate["outputs"]
    n = ROWS * mg.MONITOR_BLOCK // mg.MONITOR_DECIMATION
    assert out["channels"].shape == (4, n) and out["channels"].dtype == torch.complex64
    assert out["mask"].shape == (4, n // mg.BURST_FRAME)
    for key in ("squelched", "envelope", "peak"):
        assert out[key].shape[-1] == n and torch.isfinite(out[key]).all()
    assert set(gate["stage_ms"]) == {"spectrum_sense", "digital_down_convert", "burst_detect",
                                     "power_squelch", "envelope_detector", "peak_hold"}
    # the CPU runs the plain versions: no hand-written kernel launches
    assert not any(v for k, v in gate["launches"].items() if k != "first_order_iir_by_kind")
    assert len(planted) == len(mg.EMITTERS_HZ) and gate["samples"] == ROWS * mg.MONITOR_BLOCK


def test_capture_is_seeded():
    a, pa = mg.monitor_capture(1, seed=3)
    b, pb = mg.monitor_capture(1, seed=3)
    np.testing.assert_array_equal(a, b)
    assert pa == pb and a.dtype == np.complex64 and a.shape == (1, mg.MONITOR_BLOCK)
    assert abs(float(np.mean(np.abs(a) ** 2)) - 1.0 - np.mean([
        sum(s - t for t, s in p) for p in pa]) * len(pa) / a.size) < 0.02


def test_blocks_gate_on_the_cpu():
    gate = entry.dsp_blocks_gate("cpu", recursion_shape=(3, 500))
    assert gate["ok"], gate["failed"]
    assert set(gate["recursion_diffs"]) == set(recurrence.KINDS)
    assert len(gate["worst"]) >= 60


@pytest.mark.cuda
def test_monitor_card_equals_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = entry.spectrum_monitor_gate("cuda", rows=ROWS)
    cpu = entry.spectrum_monitor_gate("cpu", rows=ROWS)
    assert card["launches"]["nco_mix"] == 4 and card["launches"]["fir_decimate"] == 4
    assert card["launches"]["first_order_iir_by_kind"] == {
        **dict.fromkeys(recurrence.KINDS, 0), **mg.MONITOR_RECURSIONS}
    agreement = mg.monitor_agreement(card["outputs"], cpu["outputs"])
    assert agreement["ok"], agreement


@pytest.mark.cuda
def test_blocks_gate_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gate = entry.dsp_blocks_gate("cuda", recursion_shape=(4, 1 << 16))
    assert gate["ok"], (gate["failed"], gate["recursion_diffs"])
