"""The frequency-hopping 16-QAM link with DPD over TCP, and the blocks gate
(`hop_gates`).

`hopping_link_gate` runs on the CPU at HOPS hops in one block: through the
TCP link and the indexed recorder, every bar of the full gate but the
channel count (a fact of 250 hops). It is held against the same link
composed of the JAX package's functions on the same numpy scene
(`WaveformSpec.build_waveform`, `infra_fills.dpd_learn_polynomial`,
`dpd_apply`, `rotator_apply`, `impairments.rapp_pa`,
`filters.decimating_fir`, `linear_mod.linear_demodulate_symbols` and
`indices_to_bits`): the DPD coefficients within COEF_TOL of the reference's
(both float32 normal equations with a condition number near 2·10⁴, summed
in two orders; the composition then applies the port's coefficients, so
what follows compares like with like), the
transmitted capture within TOL of its peak, the 16 kS/s symbols (the JAX
receiver on the port's capture) within SYMBOL_TOL, the decisions and bits
equal at both noise levels, the transmit EVM within EVM_TOL_DB. The
demodulator's window starts WINDOW_START samples into the filtered dwell:
the filters' group delay is 4.117 samples at 16 kS/s, and the first window
that lies inside its symbol starts at ⌈4.117⌉ = 5. The blocks gate runs on
the CPU and covers every name it lists.
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import torch

from r4w_tpu.ops import filters as ref_filters
from r4w_tpu.ops import impairments as ref_imp
from r4w_tpu.ops import infra_fills as ref_inf
from r4w_tpu.waveform_spec import WaveformSpec as RefSpec
from r4w_tpu.waveforms import linear_mod as ref_lm
from r4w_tpu_torch import hop_gates as hg

HOPS = 3
TOL = 1e-5
SYMBOL_TOL = 1e-4
COEF_TOL = 2e-2
EVM_TOL_DB = 0.2
SPECS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "specs")


def _ref_evm(out, x) -> float:
    o, x = np.asarray(out).astype(np.complex128).ravel(), np.asarray(x).astype(
        np.complex128).ravel()
    gg = np.vdot(o, x) / np.vdot(o, o)
    return 10 * np.log10(np.mean(np.abs(gg * o - x) ** 2) / np.mean(np.abs(x) ** 2))


def _ref_receive(capture: np.ndarray, pattern: np.ndarray, const) -> dict:
    lp1 = ref_filters.design_lowpass(hg.DDC_TAPS, hg.DDC_CUTOFF_HZ, hg.CAPTURE_RATE_HZ)
    lp2 = ref_filters.design_lowpass(hg.SYM_TAPS, hg.SYM_CUTOFF_HZ,
                                     hg.CAPTURE_RATE_HZ / hg.DDC_DECIMATION)
    base = jnp.stack([ref_inf.rotator_apply(jnp.asarray(capture[h, :hg.DWELL]),
                                            -hg.channel_increment(int(c)))
                      for h, c in enumerate(pattern)])
    y1 = ref_filters.decimating_fir(lp1, base, hg.DDC_DECIMATION)[0]
    y2 = ref_filters.decimating_fir(lp2, y1, hg.SYM_DECIMATION)[0]
    win = y2[:, hg.WINDOW_START:hg.WINDOW_START + hg.SCORED_SYMBOLS * hg.SPS]
    win = win / jnp.sqrt(jnp.mean(win.real ** 2 + win.imag ** 2, axis=-1, keepdims=True))
    idx, _, _ = ref_lm.linear_demodulate_symbols(win, const, hg.SPS)
    bits = ref_lm.indices_to_bits(idx, jnp.arange(16), hg.BITS_PER_SYMBOL)
    return {"symbols": np.asarray(y2), "idx": np.asarray(idx), "bits": np.asarray(bits)}


def test_gate_against_jax_composition():
    gate = hg.hopping_link_gate("cpu", hops=HOPS)
    bars, run, scene = gate["bars"], gate["run"], gate["scene"]
    assert gate["ok"], bars
    assert bars["messages"] == HOPS and bars["bit_errors"] == 0
    assert bars["bits_scored"] == HOPS * hg.SCORED_BITS
    # the JAX composition of the transmitter on the same scene
    ref = RefSpec.load(os.path.join(SPECS, "qam16.yaml")).build_waveform()
    sym16 = np.asarray(ref.modulate(scene["bits"].reshape(-1))).reshape(HOPS, -1)
    x = hg.DRIVE * jnp.repeat(jnp.asarray(sym16), hg.UPSAMPLE, axis=-1)
    train = jnp.asarray(scene["train"])
    ref_coef, _ = ref_inf.dpd_learn_polynomial(train, ref_imp.rapp_pa(train, 1.0, 2.0), order=7)
    coef = run["tx"]["coef"].numpy()
    assert np.max(np.abs(coef - np.asarray(ref_coef))) <= COEF_TOL * np.max(np.abs(ref_coef))
    pre = ref_inf.dpd_apply(x, coef)
    mixed = jnp.stack([ref_inf.rotator_apply(pre[h], hg.channel_increment(int(c)))
                       for h, c in enumerate(scene["pattern"])])
    pa = np.asarray(ref_imp.rapp_pa(mixed, 1.0, 2.0))
    tx = np.zeros((HOPS, hg.PERIOD), np.complex64)
    tx[:, :hg.DWELL] = pa
    got_tx = run["tx"]["tx"].numpy()
    assert np.max(np.abs(got_tx - tx)) <= TOL * np.max(np.abs(tx))
    power = np.mean(np.abs(pa.astype(np.complex128)) ** 2)
    assert abs(float(run["tx"]["power"]) - power) <= TOL * power
    evm = {"without": _ref_evm(ref_imp.rapp_pa(x, 1.0, 2.0), x),
           "with": _ref_evm(ref_imp.rapp_pa(pre, 1.0, 2.0), x)}
    for k, v in evm.items():
        assert abs(bars["evm_db"][k] - v) <= EVM_TOL_DB, (k, bars["evm_db"], evm)
    # the JAX receiver on the port's captures
    const = jnp.asarray(hg.spec().constellation)
    for cap, out in ((run["capture"], run["link"]["out"]), (run["low"], run["ber_out"])):
        want = _ref_receive(cap.numpy(), scene["pattern"], const)
        sym = out["symbols"].numpy()
        assert np.max(np.abs(sym - want["symbols"])) <= SYMBOL_TOL * np.max(np.abs(
            want["symbols"]))
        np.testing.assert_array_equal(out["idx"].numpy(), want["idx"])
        np.testing.assert_array_equal(out["bits"].numpy(), want["bits"])
    # the recorder's file holds the bytes that crossed the link
    assert bars["file_bytes"] == HOPS * hg.PERIOD * 8 and bars["read_ok"] and bars["time_ok"]


def test_window_start_is_the_group_delay():
    assert math.isclose(hg.GROUP_DELAY, 31 / 128 + 31 / 8)
    assert hg.WINDOW_START == math.ceil(hg.GROUP_DELAY) == 5
    assert hg.WINDOW_START + hg.SCORED_SYMBOLS * hg.SPS <= hg.SYMBOLS * hg.SPS
    assert hg.WINDOW_START + hg.SYMBOLS * hg.SPS > hg.SYMBOLS * hg.SPS   # the last window spills
    assert hg.PERIOD == 81_920 and hg.DWELL == hg.SYMBOLS * hg.SPS * hg.UPSAMPLE
    # a hop every 40 ms; the capture 10.0 s and 164 MB of complex64
    assert hg.PERIOD / hg.CAPTURE_RATE_HZ == 0.04
    assert hg.HOPS * hg.PERIOD * 8 == 163_840_000


def test_scene_prefix_and_channels():
    small, big = hg.hop_scene(2), hg.hop_scene(5)
    for key in ("pattern", "bits", "noise"):
        np.testing.assert_array_equal(small[key], big[key][:2])
    np.testing.assert_array_equal(small["train"], big["train"])
    assert abs(np.std(big["train"].real) / hg.DPD_STD - 1.0) < 0.02
    freqs = hg.inf.hop_frequencies(torch.arange(64), hg.BASE_HZ, hg.SPACING_HZ).numpy()
    assert freqs[0] == -787.5e3 and freqs[-1] == 787.5e3 and not np.any(freqs == 0)
    assert len(np.unique(hg.hop_scene(hg.HOPS)["pattern"])) == hg.VISITED_CHANNELS[hg.HOPS]


def test_rotate_by_channel_groups_rows():
    x = torch.from_numpy((np.random.default_rng(4).standard_normal((6, 256, 2)).astype(
        np.float32).view(np.complex64)[..., 0]).copy())
    channels = np.int32([5, 2, 5, 9, 2, 5])
    got = hg.rotate_by_channel(x, channels, -1.0)
    for i, c in enumerate(channels):
        np.testing.assert_array_equal(got[i].numpy(), hg.inf.rotator_apply(
            x[i], -hg.channel_increment(int(c))).numpy())
    perm, inverse, groups = hg._groups(channels)
    assert [g[0] for g in groups] == [2, 5, 9] and np.array_equal(perm[inverse], np.arange(6))


def test_infra_blocks_gate_covers_the_slice():
    gate = hg.infra_blocks_gate("cpu")
    assert gate["ok"], (gate["failed"], gate["missing"])
    assert not set(hg.blocks_names()) - set(gate["worst"])
    assert len(hg.blocks_names()) == 7 + 8 + 18 + 9 + 4 + 2
    assert gate["dpd_coef_rel"] == 0.0
