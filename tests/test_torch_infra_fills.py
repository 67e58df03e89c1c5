"""`ops.infra_fills` against the JAX package.

TestFileIo, TestHopping and TestSpeechDpdSimd of tests/test_infra_fills.py
and the rotator, SIMD and DPD cases of the known-answer files (r4n, r4p)
run on the port through `torch_port_proxy` (TestAliases and
TestPreludeAccel read the reference's registry, prelude and accelerator
seam, the host layer, which the port does not have yet). Parity cases hold
the array functions against the reference on the same numpy inputs.

The trap tests: `rotator_apply` takes ω = float32(Δ) straight to the NCO
(no f/fs division that could round ω to another float32), and its phase
at a long row is the reference's float32 φ₀ + Δ·n (the product rounded,
then the sum), so the samples agree within ROT_TOL at 2^20 samples and at
the hopping gate's channel increments; the DPD fit's float32 normal
equations (a condition number near 2·10⁴ at order 7) agree with numpy's
float64 solve of the same ridge-regularised equations within COEF64_TOL
and with the reference's float32 solve within COEF_TOL, and the transmit
EVM that follows within EVM_TOL_DB of the reference's (at order 7, the
hopping gate's, at least DPD_GAIN_DB better than without); the TCP link
and the
indexed recorder carry a capture's bytes unchanged over loopback and a
temp file; sources put their samples on the default device and sinks take
tensors from any device (meta stands in for the card).
"""

import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.ops import impairments as ref_imp
from r4w_tpu.ops import infra_fills as ref_inf
from r4w_tpu_torch.core import types
from r4w_tpu_torch.kernels import nco
from r4w_tpu_torch.ops import infra_fills as inf
from r4w_tpu_torch.ops.impairments import rapp_pa
from torch_port_proxy import check_parity, run_reference_test

TOL = 1e-5
ROT_TOL = 1e-6          # |Δ| of unit-magnitude samples: float32 sin/cos of one float32 phase
COEF_TOL = 2e-2         # max|Δc| / max|c| against the reference's float32 normal equations
COEF64_TOL = 1e-3       # against numpy's float64 solve of the same equations
EVM_TOL_DB = 0.2
DPD_GAIN_DB = 8.0

INF = "r4w_tpu_torch.ops.infra_fills"
KA = {"r4w_tpu.ops.infra_fills": INF, "r4w_tpu.ops.impairments": "r4w_tpu_torch.ops.impairments"}

REFERENCE_TESTS = [
    *[("test_infra_fills", f"TestFileIo.{n}", {}, {"inf": INF}) for n in (
        "test_fd_roundtrip", "test_tcp_link", "test_socket_pdu", "test_stream_control_gate")],
    *[("test_infra_fills", f"TestHopping.{n}", {}, {"inf": INF}) for n in (
        "test_hop_pattern_coverage", "test_hop_controller_timing")],
    *[("test_infra_fills", f"TestSpeechDpdSimd.{n}", KA, {"inf": INF}) for n in (
        "test_speech_enhance_beamform_runs", "test_dpd_linearizes_rapp_pa", "test_simd_ops")],
    *[("test_known_answers_r4n", f"TestSimdMath.{n}", KA, {}) for n in (
        "test_rotator_exact", "test_cmul_cmac_exact")],
    ("test_known_answers_r4p", "TestDpd.test_predistortion_suppresses_cubic_distortion", KA, {}),
]


@pytest.mark.parametrize("module,name,modules,swaps", REFERENCE_TESTS,
                         ids=[f"{t[0]}::{t[1]}" for t in REFERENCE_TESTS])
def test_reference_test_on_port(monkeypatch, module, name, modules, swaps):
    run_reference_test(monkeypatch, module, name, modules, **swaps)


@pytest.mark.parametrize("name", ["TestFileIo.test_file_roundtrip",
                                  "TestFileIo.test_indexed_recorder"])
def test_reference_file_test_on_port(monkeypatch, tmp_path, name):
    run_reference_test(monkeypatch, "test_infra_fills", name, params={"tmp_path": tmp_path},
                       inf=INF)


_R = np.random.default_rng(18)
_IQ = (_R.standard_normal((3, 4096)) + 1j * _R.standard_normal((3, 4096))).astype(np.complex64)
_PAT = np.int32([0, 5, 63, 17, 17, 40])
_FS = 8000.0
_T = np.arange(8000) / _FS
_SPEECH = np.sin(2 * np.pi * 400 * _T)
_SPEECH[:1500] = 0.0
_MICS = np.stack([_SPEECH + 0.5 * _R.standard_normal(8000),
                  np.roll(_SPEECH, 2) + 0.5 * _R.standard_normal(8000)]).astype(np.float32)
_COEF = np.complex64([0.96 + 0.01j, -0.39 + 0.002j, 0.61 - 0.001j])

PARITY = [
    ("hop_frequencies", lambda p: inf.hop_frequencies(p, -787.5e3, 25e3),
     lambda p: ref_inf.hop_frequencies(p, -787.5e3, 25e3), (_PAT,), 0),
    ("cmul", inf.cmul, ref_inf.cmul, (_IQ[0], _IQ[1]), TOL),
    ("cmac", inf.cmac, ref_inf.cmac, (_IQ[2], _IQ[0], _IQ[1]), TOL),
    ("dpd_apply", lambda x: inf.dpd_apply(x, _COEF), lambda x: ref_inf.dpd_apply(x, _COEF),
     (_IQ[0],), TOL),
    ("rotator_apply", lambda x: inf.rotator_apply(x, 0.013, 0.4),
     lambda x: ref_inf.rotator_apply(x, 0.013, 0.4), (_IQ[1],), TOL),
    ("speech_enhance_beamform", lambda m: inf.speech_enhance_beamform(m, [0, -2], _FS),
     lambda m: ref_inf.speech_enhance_beamform(m, [0, -2], _FS), (_MICS,), TOL),
]


@pytest.mark.parametrize("name,port,ref,args,tol", PARITY, ids=[p[0] for p in PARITY])
def test_parity(name, port, ref, args, tol):
    check_parity(port, ref, args, tol=tol, label=name)


@pytest.mark.parametrize("n_channels,n_hops,seed", [(64, 250, 0x5A), (50, 500, 0x5A),
                                                    (5, 33, 0x1234)])
def test_hop_pattern_equals_reference(n_channels, n_hops, seed):
    got = inf.hop_pattern_lfsr(n_channels, n_hops, seed, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_inf.hop_pattern_lfsr(
        n_channels, n_hops, seed)))


@pytest.mark.parametrize("n,inc", [(1 << 20, 0.013), (77_824, 2 * np.pi * -787.5e3 / 2.048e6),
                                   (77_824, 2 * np.pi * (-787.5e3 + 40 * 25e3) / 2.048e6),
                                   (200_003, -2.9)])
def test_rotator_omega_path_at_long_rows(n, inc):
    x = np.ones(n, np.complex64)
    got = inf.rotator_apply(torch.from_numpy(x), inc, 0.4).numpy()
    want = np.asarray(ref_inf.rotator_apply(jnp.asarray(x), inc, 0.4))
    assert np.max(np.abs(got - want)) <= ROT_TOL
    # the phase is float32(0.4) + float32(Δ)·n, the product and the sum rounded
    ph = nco.rotor_phase(n, inc, 0.4, device="cpu").numpy()
    want_ph = np.float32(0.4) + np.float32(inc) * np.arange(n, dtype=np.float32)
    np.testing.assert_array_equal(ph, want_ph)
    # ω goes to the NCO as float32(Δ), not through a frequency over a rate
    assert nco.nco_rotate(torch.from_numpy(x[:16]), inc, 0.4).numpy().tolist() == \
        got[:16].tolist()


def test_rotator_rows_each_start_at_phase0():
    rows = torch.from_numpy(_IQ)
    got = inf.rotator_apply(rows, 0.3, 1.1)
    for i in range(rows.shape[0]):
        np.testing.assert_array_equal(got[i].numpy(), inf.rotator_apply(rows[i], 0.3,
                                                                        1.1).numpy())


def _dpd_data(order: int):
    rng = np.random.default_rng(1)
    x = (0.5625 * (rng.standard_normal(1 << 14) + 1j * rng.standard_normal(1 << 14))).astype(
        np.complex64)
    y = rapp_pa(torch.from_numpy(x), 1.0, 2.0).numpy()
    return x, y


def _evm_db(out: np.ndarray, x: np.ndarray) -> float:
    out, x = out.astype(np.complex128), x.astype(np.complex128)
    gg = np.vdot(out, x) / np.vdot(out, out)
    return 10 * np.log10(np.mean(np.abs(gg * out - x) ** 2) / np.mean(np.abs(x) ** 2))


@pytest.mark.parametrize("order", [5, 7])
def test_dpd_coefficients_and_evm(order):
    x, y = _dpd_data(order)
    coef, g = inf.dpd_learn_polynomial(torch.from_numpy(x), torch.from_numpy(y), order=order)
    ref_coef, ref_g = ref_inf.dpd_learn_polynomial(x, y, order=order)
    coef, ref_coef = coef.numpy(), np.asarray(ref_coef)
    assert abs(complex(g) - complex(ref_g)) <= TOL * abs(complex(ref_g))
    # the float64 ridge normal equations on the port's float32 columns
    yy = torch.from_numpy(y) * g
    cols = np.stack([(yy if p is None else yy * p).numpy()
                     for p in inf._envelope_powers(yy, (order + 1) // 2)], -1).astype(
        np.complex128)
    m = cols.conj().T @ cols
    m += 1e-9 * np.trace(m).real / m.shape[0] * np.eye(m.shape[0])
    exact = np.linalg.solve(m, cols.conj().T @ x.astype(np.complex128))
    assert np.max(np.abs(coef - exact)) <= COEF64_TOL * np.max(np.abs(exact))
    assert np.max(np.abs(coef - ref_coef)) <= COEF_TOL * np.max(np.abs(ref_coef))
    # the EVM that follows, on 16-QAM at the hopping gate's drive
    q = np.asarray([complex(a, b) for a in (-0.9487, -0.3162, 0.9487, 0.3162)
                    for b in (-0.9487, -0.3162, 0.9487, 0.3162)], np.complex64)
    s = (0.75 * q[np.random.default_rng(2).integers(0, 16, 8000)]).astype(np.complex64)
    got = _evm_db(rapp_pa(inf.dpd_apply(torch.from_numpy(s), coef), 1.0, 2.0).numpy(), s)
    want = _evm_db(np.asarray(ref_imp.rapp_pa(ref_inf.dpd_apply(jnp.asarray(s), ref_coef),
                                              1.0, 2.0)), s)
    assert abs(got - want) <= EVM_TOL_DB
    if order == 7:
        assert got < _evm_db(rapp_pa(torch.from_numpy(s), 1.0, 2.0).numpy(), s) - DPD_GAIN_DB


def test_tcp_link_and_recorder_carry_bytes(tmp_path):
    hops = (np.random.default_rng(3).standard_normal((5, 8192, 2)).astype(np.float32)
            .view(np.complex64)[..., 0])
    src = inf.TcpSource(0)

    def send():
        sink = inf.TcpSink("127.0.0.1", src.port)
        for h in hops:
            sink.send(torch.from_numpy(h))
        sink.close()

    th = threading.Thread(target=send)
    th.start()
    src.accept()
    rec = inf.IndexedRecorder(str(tmp_path / "hops.iq"))
    for i in range(len(hops)):
        hop = src.recv(device="cpu")
        assert hop.view(torch.int32).numpy().tobytes() == hops[i].tobytes()
        rec.record(hop, hop=i, channel=i % 2)
    th.join(timeout=10)
    src.close()
    assert os.path.getsize(rec.path) == hops.nbytes
    assert rec.find(channel=1) == [1, 3]
    for i in (0, 4, 2):
        back, meta = rec.read(i, device="cpu")
        assert back.numpy().tobytes() == hops[i].tobytes() and meta["hop"] == i
    assert inf.file_source(rec.path, count=8192, offset_items=3 * 8192,
                           device="cpu").numpy().tobytes() == hops[3].tobytes()


def test_sources_use_the_default_device_and_sinks_take_any(monkeypatch, tmp_path):
    monkeypatch.setattr(types, "DEFAULT_DEVICE", torch.device("meta"))
    data = np.arange(8).astype(np.complex64)
    p = str(tmp_path / "x.iq")
    inf.file_sink(p, torch.from_numpy(data))
    assert inf.file_source(p).device.type == "meta"
    r, w = os.pipe()
    inf.fd_sink(w, data)
    os.close(w)
    assert inf.fd_source(r, 8).device.type == "meta"
    os.close(r)
    rec = inf.IndexedRecorder(str(tmp_path / "r.iq"))
    rec.record(torch.from_numpy(data))
    assert rec.read(0)[0].device.type == "meta"
    assert inf.hop_pattern_lfsr(16, 8).device.type == "meta"
    ctl = inf.FrequencyHoppingController([3, 7], 10, 2)
    assert {ctl.channel_at(5).device.type, ctl.in_guard(11).device.type,
            ctl.hop_boundaries(40).device.type} == {"meta"}
    paused = inf.StreamControl()
    paused.pause()
    empty = paused.process(torch.from_numpy(data))
    assert empty.shape == (0,) and empty.dtype == torch.complex64 and empty.device.type == "cpu"
    assert paused.process(data).device.type == "meta"
    # a sink copies a tensor from its device to the host; a meta tensor has no data
    with pytest.raises(Exception):
        inf.file_sink(p, torch.zeros(4, dtype=torch.complex64, device="meta"))


def test_alias_blocks_resolve_to_the_port():
    from r4w_tpu_torch.channel import tdl
    from r4w_tpu_torch.ops import applied, equalizers, ew, impairments
    aliases = inf.alias_blocks()
    assert sorted(aliases) == sorted(ref_inf.alias_blocks())
    assert aliases["cross_ambiguity_function"][0]() is ew.cross_ambiguity
    assert aliases["iq_balance"][0]() is impairments.iq_imbalance_correct
    assert aliases["linear_equalizer"][0]() is equalizers.lms_equalize
    assert aliases["ml_sequence_detector"][0]() is equalizers.mlse_equalize
    assert aliases["noise_reduction"][0]() is applied.spectral_subtraction
    assert aliases["phase_noise_model"][0]() is impairments.phase_noise
    assert aliases["power_amplifier_dpd"][0]() == (inf.dpd_learn_polynomial, inf.dpd_apply)
    assert aliases["tapped_delay_line"][0]() is tdl.tdl_channel
    wf = aliases["fmcw_radar"][0](sample_rate=2e6, device="cpu")
    assert wf.info().name == "FMCW" and wf.common_params.sample_rate == 2e6
    for name, (_, cat, desc) in aliases.items():
        assert (cat, ".rs" in desc) == (ref_inf.alias_blocks()[name][1], True)


def test_blocks_tables_equal_reference():
    from r4w_tpu.ops import biomedical as ref_bio
    from r4w_tpu.ops import navigation as ref_nav
    from r4w_tpu_torch.ops import biomedical as bio
    from r4w_tpu_torch.ops import navigation as nav
    for port, ref in ((inf, ref_inf), (bio, ref_bio), (nav, ref_nav)):
        assert port.BLOCKS == ref.BLOCKS
        public = {n for n in vars(ref) if not n.startswith("_") and callable(getattr(ref, n))
                  and getattr(getattr(ref, n), "__module__", "") == ref.__name__}
        assert public <= set(vars(port)), public - set(vars(port))
