"""The port's numpy GNSS modules against ``r4w_tpu.gnss``'s, bit for bit.

`coordinates`, `environment`, `prn`, `boc`, `ephemeris`, `nav_message`,
`pvt` and `inav_words` are copies of the JAX package's numpy modules with
only their imports pointed at the port; `inav` copies every function of
the reference's but those that reach the FEC. Each test feeds both sides the inputs of the
JAX package's own tests (``tests/test_gnss.py``, ``test_pvt.py``,
``test_adsb_ephemeris.py``, ``test_gnss_pvt_decoded.py``) and requires
equal outputs (``assert_array_equal``, tolerance 0).
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from r4w_tpu.gnss import boc as ref_boc
from r4w_tpu.gnss import coordinates as ref_coordinates
from r4w_tpu.gnss import environment as ref_environment
from r4w_tpu.gnss import ephemeris as ref_ephemeris
from r4w_tpu.gnss import nav_message as ref_nav
from r4w_tpu.gnss import prn as ref_prn
from r4w_tpu.gnss import pvt as ref_pvt
from r4w_tpu_torch.gnss import boc, coordinates, environment, ephemeris, nav_message, prn, pvt
from r4w_tpu_torch.gnss import gps_pvt_fix as port_fix
from tools import gps_pvt_fix as ref_fix

REPO = Path(__file__).resolve().parents[1]
COPIES = ("coordinates", "environment", "prn", "boc", "ephemeris", "nav_message", "pvt",
          "inav_words")
# inav's functions that reach the FEC (the port's conv_encode and viterbi_decode)
INAV_FEC = {"_conv_encode_part", "decode_part", "decode_page", "decode_stream"}
TOW_SF4 = 57600
T0 = ref_nav.subframe_start_sow(TOW_SF4)
RINEX = (  # tests/test_adsb_ephemeris.py:76-97
    "     2.11           N: GPS NAV DATA                         RINEX VERSION / TYPE\n"
    "                                                            END OF HEADER\n"
    " 1 24  1  1  0  0  0.0 1.000000000000D-05 1.000000000000D-11 0.000000000000D+00\n"
    "    0.100000000000D+02 0.218750000000D+02 0.450000000000D-08 0.100000000000D+01\n"
    "    0.115297734737D-05 0.100000000000D-01 0.655651092529D-05 0.515365000000D+04\n"
    "    0.000000000000D+00 0.141561031342D-06 0.300000000000D+00 -0.111758708954D-07\n"
    "    0.959931088593D+00 0.287406250000D+03 0.500000000000D+00 -0.800000000000D-08\n"
    "    0.100000000000D-09 0.100000000000D+01 0.229800000000D+04 0.000000000000D+00\n"
    "    0.200000000000D+01 0.000000000000D+00 0.200000000000D-08 0.000000000000D+00\n"
    "    0.000000000000D+00 0.400000000000D+01 0.000000000000D+00 0.000000000000D+00\n")
SP3 = (  # tests/test_adsb_ephemeris.py:108-116
    "#cP2024  1  1  0  0  0.00000000      96 ORBIT IGS14 HLM  IGS\n"
    "*  2024  1  1  0  0  0.00000000\n"
    "PG01  12000.000000  18000.000000  14000.000000    123.456789\n"
    "*  2024  1  1  0 15  0.00000000\n"
    "PG01  12100.000000  17900.000000  14100.000000    123.456900\n"
    "*  2024  1  1  0 30  0.00000000\n"
    "PG01  12200.000000  17800.000000  14200.000000    123.457000\n")


def _equal(a, b):
    """Equal values of any nesting of tuples, lists, dicts, arrays and scalars."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", COPIES)
def test_copy_differs_only_in_its_imports(name):
    ref = (REPO / "r4w_tpu" / "gnss" / f"{name}.py").read_text()
    got = (REPO / "r4w_tpu_torch" / "gnss" / f"{name}.py").read_text()
    assert got == ref.replace("from r4w_tpu.gnss", "from r4w_tpu_torch.gnss")


def _top_level(path: Path) -> dict[str, str]:
    """Source of each top-level function and assignment, by name."""
    text = path.read_text()
    out = {}
    for node in ast.parse(text).body:
        if isinstance(node, ast.FunctionDef):
            out[node.name] = ast.get_source_segment(text, node)
        elif isinstance(node, ast.Assign):
            out[node.targets[0].id] = ast.get_source_segment(text, node)
    return out


def test_inav_copies_every_function_that_does_not_reach_the_fec():
    ref = _top_level(REPO / "r4w_tpu" / "gnss" / "inav.py")
    got = _top_level(REPO / "r4w_tpu_torch" / "gnss" / "inav.py")
    copied = ref.keys() - INAV_FEC
    assert copied == {"SYNC", "PAGE_SYMS", "PART_BITS", "CRC_POLY", "crc24q", "_int_bits",
                      "_interleave", "_deinterleave", "encode_page", "pages_to_symbols_pm",
                      "sync_search", "transmit_time_at_block"}
    for name in copied:
        assert got[name] == ref[name], name
    assert INAV_FEC < got.keys()


def test_galileo_table_is_the_ports_own_byte_copy():
    ref = (REPO / "r4w_tpu" / "gnss" / "data" / "galileo_e1_codes.npz").read_bytes()
    got = (REPO / "r4w_tpu_torch" / "gnss" / "data" / "galileo_e1_codes.npz").read_bytes()
    assert got == ref and len(got) == 51_704
    prn._galileo_icd_arrays.cache_clear()
    path = Path(prn.__file__).resolve().parent / "data" / "galileo_e1_codes.npz"
    assert path.is_file() and prn._galileo_icd_arrays() is not None


@pytest.mark.parametrize("prn_id", range(1, 33))
def test_gps_ca_codes(prn_id):
    _equal(prn.gps_ca_code(prn_id), ref_prn.gps_ca_code(prn_id))


@pytest.mark.parametrize("component", ["B", "C"])
def test_galileo_e1_codes_from_the_icd_table(component):
    for p in range(1, 51):
        _equal(prn.galileo_e1_code(p, component), ref_prn.galileo_e1_code(p, component))


def test_other_codes_and_sampling():
    _equal(prn.glonass_l1of_code(), ref_prn.glonass_l1of_code())
    for p in (1, 2, 30):
        for comp in ("I", "Q"):
            _equal(prn.gps_l5_code(p, comp), ref_prn.gps_l5_code(p, comp))
    chips = prn.gps_ca_code(5)
    _equal(prn.sample_code(chips, 4.092e6, 1.023e6, 5000, 17.25),
           ref_prn.sample_code(chips, 4.092e6, 1.023e6, 5000, 17.25))
    _equal(prn.code_bank([3, 9, 17]), ref_prn.code_bank([3, 9, 17]))


def test_boc():
    chips = ref_prn.galileo_e1_code(3, "C")
    _equal(boc.boc_subcarrier(1, 1, 12), ref_boc.boc_subcarrier(1, 1, 12))
    _equal(boc.boc_spread(chips[:64], 6, 1, 12), ref_boc.boc_spread(chips[:64], 6, 1, 12))
    for pilot in (True, False):
        _equal(boc.cboc_spread(chips, 12, pilot=pilot), ref_boc.cboc_spread(chips, 12, pilot=pilot))
    f = np.linspace(-5e6, 5e6, 101)
    _equal(boc.boc_psd(f, 1, 1), ref_boc.boc_psd(f, 1, 1))


def test_coordinates():
    lla = (41.07, -85.22, 263.6)  # tests/test_gnss.py:171
    ecef = coordinates.lla_to_ecef(*lla)
    _equal(ecef, ref_coordinates.lla_to_ecef(*lla))
    _equal(coordinates.ecef_to_lla(ecef), ref_coordinates.ecef_to_lla(ecef))
    sat = ref_coordinates.lla_to_ecef(0.0, 0.0, 20_200_000.0)
    _equal(coordinates.look_angles((0.0, 0.0, 0.0), sat),
           ref_coordinates.look_angles((0.0, 0.0, 0.0), sat))
    _equal(coordinates.ecef_to_enu_matrix(45.0, 7.0), ref_coordinates.ecef_to_enu_matrix(45.0, 7.0))
    vel = np.array([10.0, -3.0, 1.0])
    sat_vel = np.array([-2000.0, 3000.0, 500.0])
    _equal(coordinates.range_rate(ecef, vel, sat, sat_vel),
           ref_coordinates.range_rate(ecef, vel, sat, sat_vel))
    _equal(coordinates.doppler_from_range_rate(-412.5, 1.57542e9),
           ref_coordinates.doppler_from_range_rate(-412.5, 1.57542e9))
    _equal(coordinates.free_space_path_loss_db(2.2e7, 1.57542e9),
           ref_coordinates.free_space_path_loss_db(2.2e7, 1.57542e9))


def test_environment():
    t = np.array([0.0, 1000.0, 43_200.0])
    for ecc in (0.0, 0.01):
        orb, ref_orb = (m.KeplerianOrbit(eccentricity=ecc, raan_deg=120.0, mean_anomaly_deg=45.0)
                        for m in (environment, ref_environment))
        _equal(orb.propagate(t), ref_orb.propagate(t))
        _equal(orb.period(), ref_orb.period())
    _equal(environment.klobuchar_delay(40.0, -85.0, 180.0, 45.0, 43200.0),
           ref_environment.klobuchar_delay(40.0, -85.0, 180.0, 45.0, 43200.0))
    _equal(environment.saastamoinen_delay(45.0), ref_environment.saastamoinen_delay(45.0))
    for pattern in ("patch", "isotropic", "hemispherical"):
        el = np.array([-5.0, 0.0, 10.0, 45.0, 90.0])
        _equal(environment.antenna_gain_db(el, pattern), ref_environment.antenna_gain_db(el, pattern))


def test_ephemeris():
    ephs, ref_ephs = ephemeris.parse_rinex_nav(RINEX), ref_ephemeris.parse_rinex_nav(RINEX)
    e, ref_e = ephs[1][0], ref_ephs[1][0]
    for t in (e.toe, e.toe + 100.0, e.toe - 3600.0):
        _equal(e.position(t), ref_e.position(t))
        _equal(e.clock_bias(t), ref_e.clock_bias(t))
    (epochs, recs), (ref_epochs, ref_recs) = ephemeris.parse_sp3(SP3), ref_ephemeris.parse_sp3(SP3)
    _equal(ephemeris.sp3_interpolate(epochs, recs, "G01", 450.0, order=2),
           ref_ephemeris.sp3_interpolate(ref_epochs, ref_recs, "G01", 450.0, order=2))
    truth, sats = ref_fix._geometry()
    for i in range(3):
        got = ephemeris.circular_ephemeris_for_position(sats[i], truth, T0 + 24.0, prn=i + 1,
                                                        range_rate_mps=15.0 * i)
        want = ref_ephemeris.circular_ephemeris_for_position(sats[i], truth, T0 + 24.0,
                                                             prn=i + 1, range_rate_mps=15.0 * i)
        _equal(got.position(T0 + 24.0), want.position(T0 + 24.0))
        _equal(vars(got), vars(want))


def test_nav_message_subframes_and_frames():
    sf = nav_message.build_subframe(3, tow_count=12345)  # tests/test_gnss.py:206
    _equal(sf, ref_nav.build_subframe(3, tow_count=12345))
    bad = sf.copy()
    bad[35] ^= 1
    for bits in (sf, bad):
        _equal(nav_message.parse_subframe(bits), ref_nav.parse_subframe(bits))
    truth, sats = ref_fix._geometry()
    eph = ref_ephemeris.circular_ephemeris_for_position(sats[0], truth, T0 + 24.0)
    bits = port_fix.build_sv_nav_bits(eph, TOW_SF4)
    _equal(bits, ref_fix.build_sv_nav_bits(eph, TOW_SF4))
    frames, ref_frames = nav_message.frame_sync(bits), ref_nav.frame_sync(bits)
    assert [(f.subframe_id, f.tow_count, f.parity_ok) for f in frames] == [
        (f.subframe_id, f.tow_count, f.parity_ok) for f in ref_frames]
    for f, rf in zip(frames[1:], ref_frames[1:]):  # SF1-3 carry fields
        _equal(nav_message.decode_subframe_fields(f.bits), ref_nav.decode_subframe_fields(rf.bits))
    _equal(nav_message.subframe_start_sow(TOW_SF4), T0)


def test_nav_message_ephemeris_from_subframes():
    """The lazy import inside ephemeris_from_subframes reaches the port's
    BroadcastEphemeris."""
    truth, sats = ref_fix._geometry()
    eph = ref_ephemeris.circular_ephemeris_for_position(sats[1], truth, T0 + 24.0, prn=2)
    frames = nav_message.frame_sync(ref_fix.build_sv_nav_bits(eph, TOW_SF4))
    by_sid = {f.subframe_id: nav_message.decode_subframe_fields(f.bits) for f in frames[1:]}
    got = nav_message.ephemeris_from_subframes(by_sid[1], by_sid[2], by_sid[3], 2)
    want = ref_nav.ephemeris_from_subframes(by_sid[1], by_sid[2], by_sid[3], 2)
    assert type(got) is ephemeris.BroadcastEphemeris
    _equal(vars(got), vars(want))


def _synthetic_channel(nav_bits, delay_s, n_blocks):
    """tests/test_gnss_pvt_decoded.py:47-63: prompts sampled at the block
    centre, code phase of a static delay."""
    m = np.arange(n_blocks)
    t_tx_rel = m * 1e-3 - delay_s
    bit_idx = np.floor((t_tx_rel + 5e-4) / 0.020).astype(int)
    wrapped = nav_bits[np.mod(bit_idx, len(nav_bits))]
    return np.where(wrapped == 0, 1.0, -1.0), np.mod(t_tx_rel * 1e3, 1.0) * 1023.0


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_decoded_back_end_and_pvt(sign):
    """tests/test_gnss_pvt_decoded.py's six-SV decode, through both
    packages' back ends and solvers; the inverted stream too."""
    truth, sats = ref_fix._geometry()
    ranges = np.linalg.norm(sats - truth, axis=1)
    n_blocks, m_star = 24_300, 24_290
    got, want = [], []
    for i in range(len(sats)):
        eph = ref_ephemeris.circular_ephemeris_for_position(sats[i], truth, T0 + 24.0, prn=i + 1)
        prompts, cp = _synthetic_channel(ref_fix.build_sv_nav_bits(eph, TOW_SF4),
                                         ranges[i] / pvt.SPEED_OF_LIGHT, n_blocks)
        args = (sign * prompts, cp[1:], float(cp[0]), m_star, i + 1)
        got.append(port_fix.decode_sv_channel(*args))
        want.append(ref_fix.decode_sv_channel(*args))
    for (rec, eph, t_tx), (ref_rec, ref_eph, ref_t_tx) in zip(got, want):
        assert rec == ref_rec and rec["iode_ok"]
        _equal(vars(eph), vars(ref_eph))
        _equal(t_tx, ref_t_tx)
    sat_ps = np.stack([eph.position(t) for _, eph, t in got])
    rho = pvt.SPEED_OF_LIGHT * (T0 + m_star * 1e-3 - np.asarray([t for _, _, t in got]))
    sol, ref_sol = pvt.solve_position(sat_ps, rho), ref_pvt.solve_position(sat_ps, rho)
    _equal(vars(sol), vars(ref_sol))
    assert np.linalg.norm(sol.position_ecef - truth) < 1.0


def test_pvt_solvers():
    truth = np.asarray(ref_coordinates.lla_to_ecef(45.0, 7.0, 250.0))
    _, sats = ref_fix._geometry(n_sats=10, seed=10)
    rng = np.random.default_rng(3)
    rho = np.linalg.norm(sats - truth, axis=1) + 8_500.0 + rng.normal(0, 3.0, len(sats))
    sol, ref_sol = pvt.solve_position(sats, rho), ref_pvt.solve_position(sats, rho)
    _equal(vars(sol), vars(ref_sol))
    systems = ["gps"] * 5 + ["gal"] * 5
    _equal(vars(pvt.solve_position_multi(sats, rho, systems)),
           vars(ref_pvt.solve_position_multi(sats, rho, systems)))
    sat_vel = rng.normal(0, 3000.0, sats.shape)
    los = (sats - truth) / np.linalg.norm(sats - truth, axis=1)[:, None]
    rr = np.sum(sat_vel * los, axis=1) + 12.0
    _equal(vars(pvt.solve_velocity(sol, sats, sat_vel, rr)),
           vars(ref_pvt.solve_velocity(ref_sol, sats, sat_vel, rr)))
    phases = rng.uniform(0, 1023, 6)
    int_ms = np.array([67.0, 70.0, 72.0, 75.0, 68.0, 80.0])
    _equal(pvt.pseudoranges_from_code_phase(phases, 1.023e6, int_ms),
           ref_pvt.pseudoranges_from_code_phase(phases, 1.023e6, int_ms))


def test_lazy_imports_leave_jax_out():
    """Calls the paths that import lazily, then checks that no JAX module
    and no module of the JAX package was loaded."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from r4w_tpu_torch.gnss import gps_pvt_fix as g, nav_message as nm, prn\n"
        "from r4w_tpu_torch.gnss.ephemeris import circular_ephemeris_for_position\n"
        "from r4w_tpu_torch.gnss.scenario import GnssScenario, SatelliteConfig, ScenarioConfig\n"
        "truth, sats = g._geometry()\n"
        "eph = circular_ephemeris_for_position(sats[0], truth, 345624.0)\n"
        "frames = nm.frame_sync(g.build_sv_nav_bits(eph, 57600))\n"
        "sf = {f.subframe_id: nm.decode_subframe_fields(f.bits) for f in frames[1:]}\n"
        "e = nm.ephemeris_from_subframes(sf[1], sf[2], sf[3], 1)\n"
        "cfg = ScenarioConfig(satellites=(SatelliteConfig(orbital_dynamics=True, cn0_dbhz=None),),\n"
        "                     sample_rate=1e6)\n"
        "sc = GnssScenario(cfg, device='cpu')\n"
        "sc.status(0.5); sc.generate_block(1000); st = sc.state()\n"
        "prn._galileo_icd_arrays.cache_clear(); code = prn.galileo_e1_code(7, 'B')\n"
        "assert len(code) == 4092 and e.prn == 1 and len(st['generator_state']) > 0\n"
        "from r4w_tpu_torch.gnss import galileo_pvt as gal, inav, inav_words\n"
        "syms = gal.build_sv_nav_symbols(eph, 1, 345609.0)\n"
        "pages = inav.decode_stream(1.0 - 2.0 * syms, device='cpu')\n"
        "words = {w['type']: w for w in (inav_words.decode_word(p['data112'], p['data16'])\n"
        "                                for p in pages)}\n"
        "assert inav_words.ephemeris_from_words(words, 1).prn == 1 and len(pages) == 5\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'r4w_tpu' or m.startswith('r4w_tpu.') or m == 'tools'\n"
        "             or m.startswith('tools.'))\n"
        "print(bad)\n"
        "raise SystemExit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
