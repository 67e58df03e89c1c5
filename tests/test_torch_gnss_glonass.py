"""The GLONASS L1OF FDMA receiver against the JAX package's on the same input.

``tools/glonass_track.py`` writes its mixdown, acquisition and tracking
inside ``main``; this file runs the same expressions through the JAX
package (the mixdown as a jitted vmap over channels, ``acquire`` per
channel, ``jax.vmap(track)`` over ``lax.dynamic_slice`` windows) and
holds the port's ``mixdown`` and ``glonass_receiver`` against them.

- The FDMA plan and the PRBS equal the reference's.
- The mixdown of numpy noise over six channels within 1e-5 of the peak
  (float32 sin/cos of the same float32 phase; the phase itself is exact
  int32 arithmetic on both sides, checked equal).
- Two channels (k = −3, −2) of a 0.12 s capture made by the JAX
  package's scenario engine: acquisition decisions, code phases and
  Doppler equal; about 100 tracking blocks with code phase within 1e-3
  chips (a float32 sum near 511 chips steps by 6e-5), carrier within
  0.1 Hz, prompts within 1e-3 of the channel's largest.
- The verdicts on synthetic prompts: bits recovered at either sign.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import r4w_tpu.gnss.acquisition as ref_acquisition
import r4w_tpu.gnss.scenario as ref_scenario
import r4w_tpu.gnss.tracking as ref_tracking
from r4w_tpu.core.hostio import cis as ref_cis
from r4w_tpu.gnss import prn as ref_prn
from r4w_tpu_torch.entry import glonass_track
from r4w_tpu_torch.gnss import glonass_track as glo
from tools import glonass_track as ref

MIX_TOL = 1e-5  # of max|x|
CODE_PHASE_TOL = 1e-3  # chips
FREQ_TOL = 0.1  # Hz
PROMPT_REL_TOL = 1e-3
CAPTURE_S = 0.12
REF_ACQ_CONFIG = ref_acquisition.PcpsConfig(  # tools/glonass_track.py:116-118
    doppler_max_hz=750.0, doppler_step_hz=250.0, coherent_periods=8, threshold=2.0,
    subsample_phases=1)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_mixdown(x: np.ndarray, nums, den):
    """tools/glonass_track.py:98-108."""
    n_total = x.shape[0]

    @jax.jit
    def mixdown(x, ms):
        q = jnp.mod(jnp.arange(n_total, dtype=jnp.int32), den)

        def one(m):
            ph = jnp.mod(q * m, den).astype(jnp.float32) / den
            return x * ref_cis(-2.0 * jnp.pi * ph)

        return jax.vmap(one)(ms)

    return np.asarray(mixdown(jnp.asarray(x), jnp.asarray(nums)))


def test_plan_and_prbs_equal_the_reference():
    nums, den = glo._fdma_plan(glo.KS)
    ref_nums, ref_den = ref._fdma_plan(list(glo.KS))
    np.testing.assert_array_equal(nums, ref_nums)
    assert den == ref_den == 4088 and nums.dtype == ref_nums.dtype
    assert (den - 1) ** 2 < 2 ** 31  # (n mod den)·m stays in int32
    for seed in (101, 106):
        np.testing.assert_array_equal(glo._prbs_bits(seed), ref._prbs_bits(seed))
    cfg, nav = glo.glonass_scenario()
    assert cfg.seed == 202 and cfg.sample_rate == ref.FS and len(nav) == 6
    assert [s.carrier_offset_hz for s in cfg.satellites] == [k * 562_500.0 for k in glo.KS]


def test_mixdown_equals_the_jax_expression():
    rng = np.random.default_rng(4)
    n = 3 * 4088 + 517
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    nums, den = glo._fdma_plan(glo.KS)
    got = glo.mixdown(torch.from_numpy(x), nums, den).numpy()
    want = _ref_mixdown(x, nums, den)
    assert got.shape == want.shape == (6, n) and got.dtype == np.complex64
    assert np.abs(got - want).max() <= MIX_TOL * np.abs(x).max()
    # the exact phase: each row's phasor repeats every den samples, bit for bit
    rot = glo.mixdown(torch.ones(n, dtype=torch.complex64), nums, den).numpy()
    np.testing.assert_array_equal(rot[:, :den], rot[:, den:2 * den])
    np.testing.assert_array_equal(rot[:, :den], rot[:, 2 * den:3 * den])
    with pytest.raises(ValueError, match="int32"):
        glo.mixdown(torch.from_numpy(x), nums, 46_342)  # 46341² > 2^31


def _capture(n_sats=2, duration_s=CAPTURE_S):
    cfg, _ = glo.glonass_scenario(duration_s)
    sats = tuple(ref_scenario.SatelliteConfig(**vars(s)) for s in cfg.satellites[:n_sats])
    ref_cfg = ref_scenario.ScenarioConfig(
        sample_rate=cfg.sample_rate, duration_s=duration_s, satellites=sats,
        receiver=ref_scenario.ReceiverConfig(lat_deg=45.0, lon_deg=7.0), seed=cfg.seed)
    return ref_scenario.GnssScenario(ref_cfg).generate(duration_s), [s.prn for s in sats]


def _ref_receiver(mixed, prns):
    """tools/glonass_track.py:111-158 on the JAX package."""
    code = ref_prn.glonass_l1of_code().astype(np.float32)
    code_os = np.repeat(code, ref.SPS)[None]
    det, tau, dop = [], [], []
    for i in range(len(prns)):
        res = ref_acquisition.acquire(jnp.asarray(mixed[i, :12 * ref.L]), jnp.asarray(code_os),
                                      [prns[i]], ref.FS, REF_ACQ_CONFIG)
        det.append(bool(np.asarray(res.detected)[0]))
        tau.append(float(np.asarray(res.code_phase)[0]))
        dop.append(float(np.asarray(res.doppler_hz)[0]))
    tau, dop = np.asarray(tau), np.asarray(dop)
    tcfg = ref_tracking.TrackingConfig(
        code_length=ref.CODE_LEN, sample_rate=ref.FS, chipping_rate=ref.CHIP_RATE,
        carrier_hz=ref.GLONASS_L1_HZ, costas=True, fll_gain=0.2)
    istart = np.floor(tau).astype(np.int64)
    phase0 = (ref.CODE_LEN - (tau - istart) * (ref.CHIP_RATE / ref.FS)) % ref.CODE_LEN
    bs = tcfg.block_size
    n_keep = ((mixed.shape[-1] - int(istart.max())) // bs) * bs
    st0 = ref_tracking.init_state(tcfg, jnp.asarray(phase0, jnp.float32),
                                  jnp.asarray(dop, jnp.float32))
    run = jax.jit(jax.vmap(
        lambda s, i0, x: ref_tracking.track(
            tcfg, s, jax.lax.dynamic_slice(x, (i0,), (n_keep,)), jnp.asarray(code)),
        in_axes=(0, 0, 0)))
    _, outs = run(st0, jnp.asarray(istart.astype(np.int32)), jnp.asarray(mixed))
    return {"det": np.asarray(det), "tau": tau, "dop": dop,
            **{k: np.asarray(getattr(outs, k), np.float64)
               for k in ("prompt_i", "prompt_q", "carrier_freq", "code_phase")}}


def test_receiver_on_the_same_iq():
    iq, prns = _capture()
    nums, den = glo._fdma_plan(glo.KS)
    mixed = glo.mixdown(torch.from_numpy(iq), nums[:2], den)
    ref_mixed = _ref_mixdown(iq, nums[:2], den)
    assert np.abs(mixed.numpy() - ref_mixed).max() <= MIX_TOL * np.abs(iq).max()
    got = glo.glonass_receiver(mixed, prns)
    want = _ref_receiver(ref_mixed, prns)
    for key in ("det", "tau", "dop"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["det"].all() and got["prompt_i"].shape == want["prompt_i"].shape
    assert got["prompt_i"].shape[1] >= 100
    dphase = np.abs(got["code_phase"] - want["code_phase"])
    assert np.minimum(dphase, ref.CODE_LEN - dphase).max() <= CODE_PHASE_TOL
    assert np.abs(got["carr_freq"] - want["carrier_freq"]).max() <= FREQ_TOL
    scale = np.abs(want["prompt_i"] + 1j * want["prompt_q"]).max(axis=-1, keepdims=True)
    for name in ("prompt_i", "prompt_q"):
        assert np.all(np.abs(got[name] - want[name]) <= PROMPT_REL_TOL * scale), name


def test_verdicts_recover_the_bits_at_either_sign():
    """Prompts of 20 blocks a bit, the PRBS from a cyclic shift, the bit
    edges 7 blocks in, one channel inverted (Costas), noise; the carrier at
    the truth Doppler plus 1.5 Hz."""
    _, nav = glo.glonass_scenario()
    rng = np.random.default_rng(2)
    n_blocks, n_ch = 4000, 2  # the gate: 4 s of 1 ms blocks, 100 bits in the second half
    prompt_i, carr = [], []
    for i in range(n_ch):
        bits = np.asarray(nav[i])[(37 * i + (np.arange(n_blocks) - 7) // 20) % 256]
        prompt_i.append((1 - 2 * i) * bits * 100.0 + 10.0 * rng.standard_normal(n_blocks))
        f_ch = glo.GLONASS_L1_HZ + glo.KS[i] * glo.FDMA_STEP_HZ
        carr.append(np.full(n_blocks, -glo.RANGE_RATES_MPS[i] * f_ch / glo.LIGHT + 1.5))
    rcv = {"det": np.ones(n_ch, bool), "metric": [20.0] * n_ch,
           "prompt_i": np.asarray(prompt_i),
           "prompt_q": 10.0 * rng.standard_normal((n_ch, n_blocks)),
           "carr_freq": np.asarray(carr), "cn0": np.full((n_ch, n_blocks), 45.0)}
    per_ch = glo.channel_verdicts(rcv, nav[:n_ch])
    assert [c["bit_match"] for c in per_ch] == [1.0, 1.0]
    assert all(c["ok"] and c["lock"] > 2.0 for c in per_ch)
    assert [c["dop_err_hz"] for c in per_ch] == pytest.approx([1.5, 1.5], abs=1e-9)
    rcv["carr_freq"] = rcv["carr_freq"] + 4.0  # 5.5 Hz off: over the 5 Hz bar
    assert not any(c["ok"] for c in glo.channel_verdicts(rcv, nav[:n_ch]))


def test_entry_point_runs_the_receiver_on_the_cpu():
    out = glonass_track("cpu", duration_s=0.2)
    assert out["of"] == 6 and all(c["acq"] for c in out["per_ch"]) and not out["pass"]
    assert out["device"] == "cpu" and all(out[k] > 0 for k in ("gen_s", "acquire_s", "track_s"))
    assert math.isfinite(sum(c["dop_err_hz"] for c in out["per_ch"]))
