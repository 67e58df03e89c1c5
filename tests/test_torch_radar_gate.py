"""The digital-array pulse-Doppler radar gate (`radar_gates`) against the
same chain composed of the JAX package's functions, on the CPU at 4
elements × 32 pulses × 512 range samples over 3 CPIs.

The MVDR weights equal JAX's within WEIGHTS_TOL (the port solves in
float64, the reference in float32, and a 30 dB jammer makes the weights
sensitive to that), and the rest of the JAX composition runs on the port's
weights, one beam and one element at a time (its matched filter and Doppler map take one 2-D cube): MVDR
weights per beam, MTI and the matched filter per element, the beamformer,
the pulse-Doppler map and the 2-D CFAR per beam; the host's clustering,
MUSIC peak pick and tracker are the gate's own numpy (`cluster_detections`,
`music_peak`) and the reference's `RadarTracker`. The CFAR masks equal
JAX's but at cells within `radar_gates.TIE_REL` of its threshold, the
cluster lists are equal, each cluster's MUSIC angle is within
`radar_gates.MUSIC_TOL_DEG`, and the confirmed tracks are the same, their
ranges within TRACK_TOL. The gate's own bars need the full 16-element
array and run on the card.
"""

import inspect
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from r4w_tpu.ops import radar as ref_radar
from r4w_tpu.ops import radar_adv as ref_ra
from r4w_tpu.ops import radar_sonar as ref_rs
from r4w_tpu_torch import entry, radar_gates as rg

SHAPE = (4, 32, 512)
CPIS = 3
TRACK_TOL = 1e-3   # metres: float32 Kalman updates in another order
WEIGHTS_TOL = 1e-3  # JAX's float32 MVDR solve against the port's float64 one


def _reference_weights(listen):
    return np.stack([np.asarray(ref_radar.mvdr_weights(jnp.asarray(listen), float(a)))
                     for a in rg.beam_angles_deg(listen.shape[0])])


def _reference_cpi(cube, w, replica, tracker):
    m = cube.shape[0]
    looks = rg.beam_angles_deg(m)
    el = np.stack([np.asarray(ref_rs.matched_filter_pulses(
        ref_radar.mti_filter(jnp.asarray(cube[e]), rg.MTI_ORDER), jnp.asarray(replica)))
        for e in range(m)])
    rd, det, thr = [], [], []
    for b in range(m):
        beam = np.asarray(ref_radar.beamform(jnp.asarray(el.reshape(m, -1)), jnp.asarray(w[b])))
        rd_b = np.asarray(ref_rs.pulse_doppler_process(jnp.asarray(beam.reshape(el.shape[1:]))))
        det_b, thr_b = ref_radar.cfar_2d(jnp.asarray(rd_b) ** 2, rg.GUARD, rg.TRAIN, rg.PFA)
        rd.append(rd_b)
        det.append(np.asarray(det_b))
        thr.append(np.asarray(thr_b))
    rd, det, thr = np.stack(rd), np.stack(det), np.stack(thr)
    cells = np.argwhere(det)
    seeds = rg.cluster_detections(cells, rd[det])
    scan = rg.music_scan()
    music = []
    for d, r, b in seeds:
        _, spec = ref_radar.music_spectrum(jnp.asarray(el[:, :, r]), rg.MUSIC_SOURCES, 0.5, scan)
        music.append(rg.music_peak(scan, np.asarray(spec), looks[b]))
    confirmed = tracker.step(np.asarray([r for _, r, _ in seeds], np.float64) * rg.RANGE_BIN_M)
    return {"rd": rd, "det": det, "threshold": thr, "clusters": seeds, "music_deg": music,
            "tracks": [(t.track_id, float(t.x[0])) for t in confirmed]}


@pytest.fixture(scope="module")
def runs():
    gate = entry.array_radar_gate("cpu", cpis=CPIS, elements=SHAPE[0], pulses=SHAPE[1],
                                  range_bins=SHAPE[2])
    scene = rg.RadarScene(*SHAPE, seed=0)
    listen = scene.listen()
    tracker = ref_ra.RadarTracker(dt=scene.cpi_s)
    w = gate["last"]["run"]["weights"].numpy()   # the port's weights drive both chains
    ref = {"weights": _reference_weights(listen), "cpis": []}
    for k in range(CPIS):
        ref["cpis"].append(_reference_cpi(scene.cube(k), w, scene.replica, tracker))
    port = []   # the gate's per-CPI outputs, re-run on the same cubes for their tensors
    scene = rg.RadarScene(*SHAPE, seed=0)
    listen_p = scene.listen()
    np.testing.assert_array_equal(listen_p, listen)
    tracker_p = rg.radar_adv.RadarTracker(dt=scene.cpi_s, device="cpu")
    for k in range(CPIS):
        port.append(rg.radar_cpi(*rg._on([scene.cube(k), listen_p, scene.replica], "cpu"),
                                 tracker_p, rg._Stages(rg.torch.device("cpu"))))
    return gate, port, ref


def test_gate_runs_on_the_cpu_and_reports(runs):
    gate, _, _ = runs
    assert gate["shape"] == list(SHAPE) and len(gate["cpis"]) == CPIS
    assert set(gate["stage_ms"][0]) == {"upload", "weights", "mti_matched_filter", "beamform",
                                        "doppler", "cfar", "clustering", "music", "tracker"}
    assert all(v == 0 for v in gate["launches"].values())   # no hand kernel on this path
    assert gate["tracks"] == [[(i, x, v) for i, x, v in run["tracks"]] for run in runs[1]]


@pytest.mark.parametrize("k", range(CPIS))
def test_detections_and_clusters_equal_jax(runs, k):
    _, port, ref = runs
    got, want = port[k], ref["cpis"][k]
    p = want["rd"] ** 2
    tie = np.abs(p - want["threshold"]) <= rg.TIE_REL * np.abs(want["threshold"])
    diff = got["det"].numpy() != want["det"]
    assert not np.any(diff & ~tie)
    np.testing.assert_allclose(got["rd"].numpy(), want["rd"], rtol=0,
                               atol=rg.MAP_TOL * float(np.max(want["rd"])))
    assert got["clusters"] == want["clusters"] and want["clusters"]


@pytest.mark.parametrize("k", range(CPIS))
def test_music_and_tracks_equal_jax(runs, k):
    _, port, ref = runs
    got, want = port[k], ref["cpis"][k]
    np.testing.assert_allclose(got["music_deg"], want["music_deg"], atol=rg.MUSIC_TOL_DEG)
    assert [t[0] for t in got["tracks"]] == [t[0] for t in want["tracks"]]
    np.testing.assert_allclose([t[1] for t in got["tracks"]], [t[1] for t in want["tracks"]],
                               atol=TRACK_TOL)


def test_mvdr_weights_equal_jax(runs):
    """The port solves in float64; JAX's float32 weights lie within
    WEIGHTS_TOL of them. The chains above share the port's weights, so that
    the jammer's sensitivity to them does not hide the rest of the chain."""
    gate, _, ref = runs
    got = gate["last"]["run"]["weights"].numpy()
    assert np.max(np.abs(got - ref["weights"])) <= WEIGHTS_TOL * np.max(np.abs(ref["weights"]))


def test_cpu_agreement_helper_on_itself(runs):
    _, port, _ = runs
    res = rg.radar_agreement(port[0], port[0])
    assert res["ok"] and res["mask_differs"] == 0 and res["clusters_equal"]


def test_array_blocks_gate_on_the_cpu():
    gate = entry.array_blocks_gate("cpu")
    assert gate["ok"], gate["failed"]
    assert len(gate["worst"]) >= 50


def test_new_entry_points_default_to_the_card():
    """Read without a card: the slice's entry points, and the designs that
    create tensors, default to CUDA (``None`` is `DEFAULT_DEVICE`)."""
    cuda = rg.torch.device("cuda")
    for fn in (entry.array_radar_gate, entry.array_blocks_gate, entry.two_ray_fde_case):
        assert rg.torch.device(inspect.signature(fn).parameters["device"].default) == cuda, fn
    for fn in (rg.radar_adv.RadarTracker, rg.radar_adv.space_time_steering,
               rg.bf.null_steer_weights, rg.bf.oam_beam, rg.bf.beam_steering_phases):
        assert inspect.signature(fn).parameters["device"].default is None, fn


def test_radar_gates_import_neither_jax_nor_the_reference():
    code = ("import sys, r4w_tpu_torch.radar_gates, r4w_tpu_torch.entry; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'r4w_tpu' or m.startswith('r4w_tpu.')]; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
