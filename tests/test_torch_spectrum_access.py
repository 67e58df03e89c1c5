"""The DSA sensing-cycle gate and the blocks gate (`cognitive_gates`).

`spectrum_access_gate` runs on the CPU at 2 blocks of 2^16 samples and is
held against the same cycle composed of the JAX package's functions on the
same numpy scene, a block at a time where the reference takes one stream
(`cognitive.channel_occupancy`, `coexistence_report`, `CognitiveEngine`,
`analysis.Waterfall` with `spectral2.waterfall_enhance` and
`spectrogram_anomaly_score`, `stream_math.digital_down_convert`,
`spectral2.cyclic_autocorrelation` averaged over the blocks,
`spectral_entropy`, `interference_classify`, the reference's
`SpectrumBroker` and `link_adapt`, `interference_excise`, and the
self-check's `pulse`, `spur_scan`, `vector_signal_analyze`,
`power_meter_dbm`, `lpi_metrics`, `SpectrumAnalyzer` and
`mask_compliance`): every decision equal (busy masks, candidates, feature
flags, labels, leases, grants, MCS, the spur scan, the mask verdict),
floats within the stated tolerances. The bars need the full width (32
blocks of 2^20) and hold on the card; at this size the features average
over too few samples. `sensing_blocks_gate` runs on the CPU and covers
every `BLOCKS` entry of the slice.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from r4w_tpu import analysis as ref_analysis
from r4w_tpu.ops import cognitive as ref_cg
from r4w_tpu.ops import instruments as ref_inst
from r4w_tpu.ops import mapping as ref_mapping
from r4w_tpu.ops import pulse as ref_pulse
from r4w_tpu.ops import spectral2 as ref_sp2
from r4w_tpu.ops import stream_math as ref_sm
from r4w_tpu_torch import cognitive_gates as cgg, entry
from torch_port_proxy import compare

ROWS, BLOCK = 2, 1 << 16
TOL = 1e-5            # occupancy dB, duty, entropies, the waterfall as power: sums in another order
FEATURE_TOL = 1e-4    # R_α(τ): means of products, a matrix product against JAX's reduction
CHANNEL_TOL = 1e-5    # the down-converted channels
EVM_TOL = 1e-4


def _reference_cycle(capture: np.ndarray, fs: float = cgg.DSA_RATE_HZ) -> dict:
    rows = capture.shape[0]
    occ = [ref_cg.channel_occupancy(jnp.asarray(b), cgg.N_CHANNELS, cgg.OCCUPANCY_NFFT,
                                    cgg.OCCUPANCY_DB) for b in capture]
    busy = np.stack([np.asarray(b) for b, _ in occ])
    ch_db = np.stack([np.asarray(d) for _, d in occ])
    duty = np.stack([np.asarray(ref_cg.coexistence_report(jnp.asarray(b), cgg.N_CHANNELS)[0])
                     for b in capture])
    engine = ref_cg.CognitiveEngine(cgg.N_CHANNELS)
    picks = [engine.step(jnp.asarray(b), cgg.ENGINE_SNR_DB)["channel"] for b in capture]
    wf = ref_analysis.Waterfall(fs, cgg.WATERFALL_NFFT, cgg.WATERFALL_NFFT).compute(
        capture.reshape(-1))
    enhanced = np.asarray(ref_sp2.waterfall_enhance(jnp.asarray(wf)))
    anomaly = np.asarray(ref_sp2.spectrogram_anomaly_score(jnp.asarray(wf), cgg.ANOMALY_TRAIN))
    candidates = [c for c in range(cgg.N_CHANNELS) if not busy[:, c].any()]
    chans = np.stack([np.stack([np.asarray(ref_sm.digital_down_convert(
        jnp.asarray(b), cgg.channel_centre_hz(c), fs, cgg.DDC_DECIMATION)) for b in capture])
        for c in candidates])
    caf = np.stack([np.stack([np.asarray(ref_sp2.cyclic_autocorrelation(
        jnp.asarray(chans[i, r]), [cgg.FEATURE_ALPHA, cgg.OFF_ALPHA], cgg.FEATURE_LAGS))
        for r in range(rows)]) for i in range(len(candidates))])
    stat = np.abs(caf.mean(axis=1))[:, 0].max(-1)
    entropy = np.asarray([ref_sp2.spectral_entropy(jnp.asarray(ch.reshape(-1)),
                                                   cgg.ENTROPY_NFFT) for ch in chans])
    labels = [ref_cg.interference_classify(chans[i, 0], fs / cgg.DDC_DECIMATION)
              for i in range(len(candidates))]
    flagged = [c for c, s in zip(candidates, stat) if s > cgg.FEATURE_THRESHOLD]
    broker = ref_cg.SpectrumBroker(cgg.N_CHANNELS)
    for c in sorted(set(np.flatnonzero(busy.any(axis=0)).tolist()) | set(flagged)):
        broker.leases[c] = "incumbent"
    mean_db = ch_db.mean(axis=0)
    floor = float(np.median(mean_db))
    grants, mcs = {}, {}
    for user in cgg.USERS:
        c = broker.request(user, mean_db)
        grants[user] = c
        mcs[user] = None if c is None else ref_cg.link_adapt(
            cgg.LINK_MARGIN_DB - (float(mean_db[c]) - floor))
    excised = {c: np.stack([np.asarray(ref_cg.interference_excise(
        jnp.asarray(chans[candidates.index(c), r]), cgg.EXCISE_SIGMA, cgg.EXCISE_NFFT))
        for r in range(rows)]) for c, lab in zip(candidates, labels) if lab == "tone"}
    return {"busy": busy, "ch_db": ch_db, "duty": duty, "picks": picks, "wf": wf,
            "enhanced": enhanced, "anomaly": anomaly, "candidates": candidates, "channels": chans,
            "caf": caf, "entropy": entropy, "labels": labels, "flagged": flagged,
            "leases": dict(broker.leases), "grants": grants, "mcs": mcs, "excised": excised}


def _reference_self_check(mcs_index: int) -> dict:
    """`cognitive_gates.self_check`'s burst and measurements with the
    reference's functions on the same draws."""
    rng = np.random.default_rng(cgg.SELF_SEED)
    table = ref_mapping.constellation_table("qpsk")
    idx = rng.integers(0, 4, cgg.SELF_SYMBOLS)
    taps = ref_pulse.root_raised_cosine_taps(cgg.SELF_SPS, cgg.SELF_SPAN, cgg.SELF_ROLLOFF)
    burst = np.asarray(ref_pulse.shape_symbols(table[jnp.asarray(idx)], taps, cgg.SELF_SPS))
    burst = burst * np.float32(np.sqrt(cgg.SELF_SPS))
    n = burst.shape[-1]
    t = np.arange(n) / cgg.SELF_RATE_HZ
    impair = (10.0 ** (cgg.SPUR_DBC / 20.0) * np.exp(2j * np.pi * cgg.SPUR_HZ * t)
              + 10.0 ** (-cgg.SELF_SNR_DB / 20.0) * cgg._cn(rng, n)).astype(np.complex64)
    burst = (burst + impair).astype(np.complex64)
    scan = ref_inst.spur_scan(jnp.asarray(burst), cgg.SELF_RATE_HZ, 0.0,
                              exclude_hz=cgg.SPUR_EXCLUDE_HZ, threshold_dbc=-70.0, max_spurs=4)
    pgram = np.abs(np.fft.fft(burst * np.hanning(n))) ** 2
    k = int(round(float(scan[0][0]) * n / cgg.SELF_RATE_HZ))
    band = pgram[np.arange(k - cgg.SPUR_BAND_BINS, k + cgg.SPUR_BAND_BINS + 1) % n]
    level = 10.0 * np.log10(band.sum() / pgram.sum())
    delay = (len(taps) - 1) // 2
    rx = np.asarray(ref_pulse.matched_filter(jnp.asarray(burst), taps))[
        delay::cgg.SELF_SPS][:cgg.SELF_SYMBOLS] / np.float32(np.sqrt(cgg.SELF_SPS))
    vsa = ref_inst.vector_signal_analyze(jnp.asarray(rx), table, 1)
    power = ref_inst.power_meter_dbm(jnp.asarray(burst))
    lpi = ref_cg.lpi_metrics(jnp.asarray(burst))
    spec = ref_analysis.SpectrumAnalyzer(cgg.SELF_RATE_HZ, cgg.SELF_PSD_NFFT).compute(
        burst, n_peaks=1)
    ok, margin = ref_cg.mask_compliance(spec.psd_db - np.max(spec.psd_db), spec.freqs_hz,
                                        cgg.SELF_MASK)
    return {"scan": scan, "spur_level_dbc": level, "vsa": vsa, "power": power, "lpi": lpi,
            "psd_db": spec.psd_db, "mask_ok": bool(ok), "burst": burst}


@pytest.fixture(scope="module")
def runs():
    gate = entry.spectrum_access_gate("cpu", rows=ROWS, block=BLOCK)
    capture, _ = cgg.dsa_scene(ROWS, BLOCK)
    return gate, _reference_cycle(capture), _reference_self_check(
        gate["outputs"]["mcs"][cgg.USERS[0]])


def test_decisions_equal_the_reference(runs):
    gate, ref, _ = runs
    out = gate["outputs"]
    np.testing.assert_array_equal(out["busy"].numpy(), ref["busy"])
    for key in ("picks", "candidates", "labels", "flagged", "leases", "grants", "mcs"):
        assert out[key] == ref[key], key
    assert out["candidates"] and set(out["excision"]) == set(ref["excised"])


def test_floats_within_tolerance(runs):
    gate, ref, _ = runs
    out = gate["outputs"]
    compare(out["ch_db"], ref["ch_db"], label="ch_db", tol=TOL)
    compare(out["duty"], ref["duty"], label="duty", tol=TOL)
    compare(out["channels"], ref["channels"], label="channels", tol=CHANNEL_TOL)
    compare(out["caf"], ref["caf"], label="caf", tol=FEATURE_TOL)
    compare(out["entropy"], ref["entropy"], label="entropy", tol=TOL)
    compare(out["anomaly"], ref["anomaly"], label="anomaly", tol=TOL)
    # the enhanced waterfall squared (its gamma of 0.5 undone): the root
    # magnifies ulps of a pixel just above its row's median
    compare(out["enhanced"] ** 2, ref["enhanced"] ** 2, TOL, "enhanced")
    for c, clean in ref["excised"].items():
        compare(out["excision"][c]["clean"], clean, CHANNEL_TOL)


def test_self_check_equals_the_reference(runs):
    gate, _, ref = runs
    sc = gate["self_check"]
    compare(sc["burst"], ref["burst"], TOL)
    np.testing.assert_array_equal(sc["scan_valid"].numpy(), np.asarray(ref["scan"][2]))
    compare([sc["scan_hz"], sc["scan_dbc"]], list(ref["scan"][:2]), TOL)
    compare(sc["spur_level_dbc"], ref["spur_level_dbc"], TOL)
    compare([sc["vsa"][k] for k in ("evm_rms", "decision_margin", "mag_error", "papr_db")],
            [ref["vsa"][k] for k in ("evm_rms", "decision_margin", "mag_error", "papr_db")],
            EVM_TOL)
    compare(list(sc["power_dbm"]), list(ref["power"]), TOL)
    compare([sc["lpi"][k] for k in sorted(sc["lpi"])], [ref["lpi"][k] for k in sorted(ref["lpi"])],
            TOL)
    compare(10.0 ** (sc["psd_db"] / 10.0), 10.0 ** (ref["psd_db"] / 10.0), TOL)
    assert sc["mask_ok"] == ref["mask_ok"]
    bars = cgg.self_check_bars(sc)
    assert bars["ok"], bars     # the self-check's bars do not depend on the band's width


def test_agreement_of_a_run_with_itself(runs):
    """`access_agreement` accepts a run against itself and refuses another
    decision."""
    gate, _, _ = runs
    out = gate["outputs"]
    same = cgg.access_agreement(out, out, gate["self_check"], gate["self_check"])
    assert same["ok"], same
    other = dict(out, labels=list(reversed(out["labels"])) + ["extra"])
    assert not cgg.access_agreement(other, out)["ok"]


def test_blocks_gate_covers_the_slice():
    gate = cgg.sensing_blocks_gate("cpu")
    assert gate["ok"], (gate["failed"], gate["missing"])
    assert len(cgg.blocks_names()) == 97 + 2
    assert set(gate["worst"]) == set(cgg.blocks_names())
