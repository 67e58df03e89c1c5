"""The joint GPS + Galileo gate against the JAX package's, on the same input.

- The scenario (geometry, ephemeris-bearing LNAV and I/NAV streams) equals
  the one ``tools/dual_pvt.py`` builds.
- The back end on injected observables: both gates' ``main`` run with the
  capture stubbed and both front ends replaced by the same synthetic
  channels (prompt signs of each SV's own nav stream and code phases of
  its moving range, as the scenario delays it, 24.3 s). Everything after
  the front ends runs: LNAV and I/NAV decodes, transmit times, the joint,
  GPS-only and Galileo-only fixes, the velocity and the truth-position
  control. The solvers' inputs are equal bit for bit, the results equal
  the reference's to the digits it rounds them to, and the joint GDOP is
  the reference's: position and the FIRST system's clock only
  (``gnss/pvt.py:129``), below the GDOP of the whole 3 + 2 state block.
- ``l1ca_receiver`` at the joint gate's 5.115 MS/s (5 samples a chip) on
  a capture of its first two GPS satellites made by the JAX package:
  acquisitions and windows equal, code phase within 0.05 chips, carrier
  within 1 Hz, prompts within 5% of the channel's largest, nav bits
  equal (the tolerances of ``tests/test_torch_gnss_receiver.py``, whose
  reasons hold at this rate: code phases just under 1023 chips, where a
  float32 block update steps by 1.2e-4 chips).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import r4w_tpu.gnss.pvt as ref_pvt
import r4w_tpu.gnss.scenario as ref_scenario
from r4w_tpu.gnss.ephemeris import circular_ephemeris_for_position
from r4w_tpu_torch.entry import dual_pvt
from r4w_tpu_torch.gnss import dual_pvt as port
from r4w_tpu_torch.gnss import gps_pvt_fix as port_gps
from r4w_tpu_torch.gnss import galileo_pvt as port_gal
from r4w_tpu_torch.gnss import nav_message, pvt
from r4w_tpu_torch.gnss import scenario as port_scenario
from tools import dual_pvt as ref
from tools import galileo_pvt as ref_gal
from tools import gps_pvt_fix as ref_gps

C = pvt.SPEED_OF_LIGHT
RCV_CODE_PHASE_TOL = 0.05  # chips
RCV_FREQ_TOL = 1.0  # Hz
RCV_PROMPT_REL_TOL = 0.05


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_scenario_equals_the_reference():
    truth, gps_pos, gal_pos = port._geometry()
    for got, want in zip((truth, gps_pos, gal_pos), ref._geometry()):
        np.testing.assert_array_equal(got, want)
    cfg, _, _, _, t0 = port.dual_scenario()
    assert (cfg.seed, cfg.sample_rate, cfg.duration_s, len(cfg.satellites)) == (
        202, ref.FS, 24.3, 10)
    t_el = 24.3 - 0.3
    for i, sat in enumerate(cfg.satellites):
        gal = i >= 5
        pos = (gal_pos if gal else gps_pos)[i % 5]
        rdot = (port.GAL_RANGE_RATES_MPS if gal else port.GPS_RANGE_RATES_MPS)[i % 5]
        eph = circular_ephemeris_for_position(
            ref_gps.eval_pos(pos, truth, rdot, t_el), truth, t0 + t_el, prn=i % 5 + 1,
            range_rate_mps=rdot, **({"toe_quantum": 60.0} if gal else {}))
        bits = (ref_gal.build_sv_nav_symbols(eph, i % 5 + 1, t0 + 2250 * ref_gal.T_EP) if gal
                else ref_gps.build_sv_nav_bits(eph, port.TOW_SF4))
        assert sat.signal == ("GalileoE1B" if gal else "GpsL1Ca") and sat.range_rate_mps == rdot
        assert sat.nav_bits == tuple(int(v) for v in 1 - 2 * bits)


def _front(sat, pos0, truth, block_s, code_s, code_len, bit_s, n_blocks):
    """A tracked channel of `sat` seen from `truth`: block m starts at
    receive time m·block_s; the scenario delays the signal by
    (r0 + ṙ·t_rx)/c. Prompts are the nav signs at each block's centre, code
    phases the replica's at each block's start."""
    r0 = float(np.linalg.norm(pos0 - truth))
    rdot = sat.range_rate_mps

    def t_tx(t_rx):
        return t_rx - (r0 + rdot * t_rx) / C

    m = np.arange(n_blocks + 1)
    nav = np.asarray(sat.nav_bits, np.float64)
    prompt = nav[np.floor(t_tx((m[:-1] + 0.5) * block_s) / bit_s).astype(np.int64) % len(nav)]
    phase = np.mod(t_tx(m * block_s) / code_s, 1.0) * code_len
    return prompt, phase, -rdot / port.L1_WAVELENGTH_M


def _fronts():
    """The synthetic `l1ca_receiver` and `e1b_receiver` results of the gate.
    The E1B channels stop after 2790 blocks (11.16 s, the Galileo gate's
    length: words 1-5 once), which halves the reference's page decodes."""
    cfg, truth, gps_pos, gal_pos, _ = port.dual_scenario()
    fronts = []
    for sats, pos, block_s, code_len, bit_s, n_blocks, bs in (
            (cfg.satellites[:5], gps_pos, 1e-3, 1023.0, 0.02, 24_290, 5115),
            (cfg.satellites[5:], gal_pos, ref_gal.T_EP, 49104.0, ref_gal.T_EP, 2790, 20460)):
        chans = [_front(s, p, truth, block_s, block_s, code_len, bit_s, n_blocks)
                 for s, p in zip(sats, pos)]
        prompt = np.stack([c[0] for c in chans])
        phase = np.stack([c[1] for c in chans])
        fronts.append({
            "det": np.ones(5, bool), "istart": np.zeros(5, np.int64), "bs": bs,
            "code_len": code_len, "phase0": phase[:, 0], "phase_ref": phase[:, 0],
            "prompt_i": prompt, "code_ph": phase[:, 1:],
            "carr_freq": np.repeat(np.asarray([c[2] for c in chans])[:, None], n_blocks, 1),
            "cn0_est": 48.0, "acquire_s": 0.0, "track_s": 0.0})
    return fronts


def _stub(monkeypatch, owner, name, value):
    monkeypatch.setattr(owner, name, lambda *args, **kwargs: value)


def _spy(monkeypatch, owner, name, store):
    orig = getattr(owner, name)

    def spy(*args, **kwargs):
        store.setdefault(name, []).append((args, orig(*args, **kwargs)))
        return store[name][-1][1]

    monkeypatch.setattr(owner, name, spy)


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_back_end_on_injected_observables_equals_the_reference(monkeypatch):
    gps_front, gal_front = _fronts()
    _stub(monkeypatch, ref_scenario.GnssScenario, "generate_device", jnp.zeros(1, jnp.complex64))
    _stub(monkeypatch, ref_gps, "l1ca_receiver", gps_front)
    _stub(monkeypatch, ref_gal, "e1b_receiver", gal_front)
    _stub(monkeypatch, port_scenario.GnssScenario, "generate_device",
          torch.zeros(1, dtype=torch.complex64))
    _stub(monkeypatch, port_gps, "l1ca_receiver", gps_front)
    _stub(monkeypatch, port_gal, "e1b_receiver", gal_front)
    calls, ref_calls = {}, {}
    for name in ("solve_position", "solve_position_multi", "solve_velocity"):
        _spy(monkeypatch, pvt, name, calls)
        _spy(monkeypatch, ref_pvt, name, ref_calls)
    want = ref.main()
    got = port.main(device="cpu")

    assert got["decoded"] == want["decoded"] == 10 and got["pass"] and want["pass"]
    assert calls.keys() == ref_calls.keys()
    for name in calls:  # the observables reach the solvers bit for bit
        assert len(calls[name]) == len(ref_calls[name])
        for (args, _), (ref_args, _) in zip(calls[name], ref_calls[name]):
            _equal([a for a in args if not isinstance(a, pvt.PvtSolution)],
                   [a for a in ref_args if not isinstance(a, ref_pvt.PvtSolution)])
    for key, digits in (("joint", 1), ("gps_only", 1), ("galileo_only", 1),
                        ("truth_pos_control", 1), ("velocity", 3)):
        for k, w in want[key].items():
            g = got[key][k]
            if isinstance(w, dict):
                assert {kk: round(vv, digits) for kk, vv in g.items()} == w, (key, k)
            elif isinstance(w, float):
                assert round(g, digits) == w, (key, k, g, w)
            else:
                assert g == w, (key, k)
    for rec, ref_rec in zip(got["per_sv"], want["per_sv"]):
        assert round(rec.pop("rho_err_m"), 1) == ref_rec.pop("rho_err_m")
        assert round(rec.pop("rr_err_mps"), 2) == ref_rec.pop("rr_err_mps")
        assert rec == ref_rec

    # the joint GDOP: position and the first system's clock (pvt.py:129)
    (sats, rho, systems), sol = calls["solve_position_multi"][0]
    d = sats - sol.position_ecef
    ind = np.stack([np.asarray(systems) == s for s in ("gps", "gal")], axis=1).astype(float)
    q = np.linalg.inv(np.concatenate([-d / np.linalg.norm(d, axis=1)[:, None], ind], 1).T
                      @ np.concatenate([-d / np.linalg.norm(d, axis=1)[:, None], ind], 1))
    assert sol.gdop == pytest.approx(np.sqrt(np.trace(q[:4, :4])), rel=1e-9)
    assert sol.gdop < np.sqrt(np.trace(q))
    assert got["joint"]["gdop"] == sol.gdop


def _gps_capture(n_sats=2, duration_s=0.5):
    """The joint gate's first GPS satellites at 5.115 MS/s, made by the JAX package."""
    cfg, *_ = port.dual_scenario(duration_s)
    sats = tuple(ref_scenario.SatelliteConfig(**vars(s)) for s in cfg.satellites[:n_sats])
    ref_cfg = ref_scenario.ScenarioConfig(
        sample_rate=cfg.sample_rate, duration_s=duration_s, satellites=sats,
        receiver=ref_scenario.ReceiverConfig(lat_deg=45.0, lon_deg=7.0), seed=cfg.seed)
    return ref_scenario.GnssScenario(ref_cfg).generate(duration_s), [s.prn for s in sats]


def test_l1ca_receiver_at_5115_ksps_on_the_same_iq():
    iq, prns = _gps_capture()
    want = ref_gps.l1ca_receiver(jnp.asarray(iq), prns, fs=ref.FS)
    got = port_gps.l1ca_receiver(torch.from_numpy(iq), prns, fs=port.FS)
    for key in ("det", "istart", "phase0", "bs"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["bs"] == 5115 and got["det"].all()
    assert got["prompt_i"].shape == want["prompt_i"].shape == (2, 499)
    dphase = np.abs(got["code_ph"] - want["code_ph"])
    assert np.minimum(dphase, 1023.0 - dphase).max() <= RCV_CODE_PHASE_TOL
    assert np.abs(got["carr_freq"] - want["carr_freq"]).max() <= RCV_FREQ_TOL
    scale = np.abs(want["prompt_i"]).max(axis=-1, keepdims=True)
    assert np.all(np.abs(got["prompt_i"] - want["prompt_i"]) <= RCV_PROMPT_REL_TOL * scale)
    for g, w in zip(got["prompt_i"], want["prompt_i"]):
        edge = nav_message.find_bit_edge(g)
        assert edge == nav_message.find_bit_edge(w)
        bits = nav_message.bits_from_prompts(g, edge)
        assert len(bits) >= 20
        np.testing.assert_array_equal(bits, nav_message.bits_from_prompts(w, edge))


def test_entry_point_runs_both_receivers_on_the_cpu():
    """The whole chain at 0.3 s: every SV of both systems acquired and
    tracked, nothing decoded."""
    out = dual_pvt("cpu", duration_s=0.3)
    assert out["acquired"] == out["of"] == 10 and out["decoded"] == 0 and not out["pass"]
    assert out["device"] == "cpu" and out["joint"] is None
    assert [r["sys"] for r in out["per_sv"]] == ["gps"] * 5 + ["gal"] * 5
    assert all(v > 0 for k, v in out["stage_s"].items() if k != "decode_s")
