"""The port's LoRa loopback slice, end to end, against ``r4w_tpu``.

The loopback BER grid must equal JAX's exactly when JAX's own noise is
injected; the Waveform factory, the Monte-Carlo helpers and the entry
points run on the CPU at small sizes. The full-size sweep runs only on a
card, through chip_smoke.py.
"""

import functools
import inspect
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.channel import channel as ref_channel
from r4w_tpu.waveforms import create_waveform as ref_create_waveform
from r4w_tpu.waveforms import lora as ref_lora
from r4w_tpu_torch import WaveformFactory, create_waveform, list_waveforms
from r4w_tpu_torch.channel import awgn
from r4w_tpu_torch.core import types
from r4w_tpu_torch import arq, ber
from r4w_tpu_torch.channel import (flat_doppler_shift, gaussian_doppler_fading, jakes_fading,
                                   theoretical_ber_awgn)
from r4w_tpu_torch.entry import (ber_gate, channel_bench, coded_link_gate, composed_receiver_gate,
                                 ddc_bench,
                                 device_sweep, dual_pvt, dvb_s2x_bench, dvb_s2x_frames, entry,
                                 fading_case, fading_gate, fleet_noisy_gate, galileo_pvt,
                                 glonass_track, gps_pvt_fix, lora_packet_roundtrip, lora_sweep,
                                 packet_capture, pcps_bench, pcps_gcorr_bench,
                                 sincgars_data_roundtrip, sweep_lanes, sweep_round, viterbi_bench,
                                 waterfall_snr_db)
from r4w_tpu_torch.fec.tcm import tcm_coding_gain_demo
from r4w_tpu_torch.gnss import GnssScenario, dual_pvt as dual, galileo_pvt as gal
from r4w_tpu_torch.gnss import glonass_track as glo, init_state, inav
from r4w_tpu_torch.gnss.gps_pvt_fix import main_code_phase, main_decoded
from r4w_tpu_torch.ops.equalizers import turbo_equalizer_tx
from r4w_tpu_torch.ops.measure import channel_capacity_awgn
from r4w_tpu_torch.ops.sync2 import golay_complementary_pair, irig_b_encode, preamble_gen
from r4w_tpu_torch.parallel import batch_demodulate, batch_modulate, ber_sweep, monte_carlo_ber
from r4w_tpu_torch.waveforms import lora
from r4w_tpu_torch.waveforms.lora_waveform import LoRaWaveform
from r4w_tpu_torch.waveforms.milstd188110 import MilStd188110
from torch_fleet_parity import ref_own_waveforms

REPO = Path(__file__).resolve().parents[1]
SNRS_DB = np.array([-12.0, -8.0, -4.0, 0.0], np.float32)


def test_loopback_ber_matches_reference_with_its_noise():
    """SF7, 8 keys × 4 SNRs. JAX's grid reuses each key's noise at every
    SNR, so the port gets that noise broadcast over the SNR axis."""
    params, rparams = lora.LoRaParams(sf=7), ref_lora.LoRaParams(sf=7)
    payload = np.random.default_rng(0).integers(0, 256, 16).astype(np.int32)
    keys = jax.random.split(jax.random.key(42), 8)
    grid = jax.jit(jax.vmap(lambda k: jax.vmap(
        lambda s: ref_lora.loopback_ber(rparams, jnp.asarray(payload), k, s))(
            jnp.asarray(SNRS_DB))))
    want = np.asarray(grid(keys))
    n = params.n_payload_symbols(16) * params.samples_per_symbol
    noise = np.stack([np.asarray(ref_channel._complex_normal(k, (n,), 1.0)) for k in keys])
    got = lora.loopback_ber(params, torch.from_numpy(payload),
                            torch.from_numpy(SNRS_DB).expand(8, -1),
                            noise=torch.from_numpy(noise)[:, None, :])
    assert got.shape == (8, 4) and got.dtype == torch.float32
    assert 0.0 < want.mean() < 1.0  # the grid spans errors and clean decodes
    np.testing.assert_array_equal(got.numpy(), want)


def test_quick_start_roundtrip():
    wf = create_waveform("LoRa-SF7", 125_000.0, device="cpu")
    tx = wf.modulate(b"hello")
    np.testing.assert_array_equal(
        tx.numpy(), np.asarray(ref_create_waveform("LoRa-SF7", 125_000.0).modulate(b"hello")))
    rx = awgn(tx, -2.0, generator=torch.Generator().manual_seed(0))
    res = wf.demodulate(rx)
    assert bytes(res.bits[:5].numpy().astype(np.uint8)) == b"hello"
    assert res.snr_estimate > 10.0 and np.isfinite(res.metadata["rssi"])
    assert wf.samples_per_symbol() == 128 and wf.info().bits_per_symbol == 7


def test_factory_names_aliases_and_unknowns():
    assert list_waveforms() == ref_own_waveforms()  # all 50, in the reference's order
    assert len(list_waveforms()) == 50
    assert WaveformFactory.list() == list_waveforms()
    assert WaveformFactory.create("css").params.sf == 7
    assert create_waveform("lora_sf12").params.sf == 12
    assert create_waveform("LoRa", device="cpu").device == torch.device("cpu")
    assert create_waveform("QPSK").info().name == "QPSK"
    assert create_waveform("FSK").info().name == "BFSK"
    assert create_waveform("FSK8") is None
    assert create_waveform("GPS-L1CA-PRN5", device="cpu").prn == 5
    assert create_waveform("GPS-L1CA-PRN33") is None


def test_waveform_educational_defaults():
    wf = create_waveform("LoRa", device="cpu")
    stages = wf.get_modulation_stages(b"\x01")
    assert [name for name, _ in stages] == ["input bits", "modulated IQ"]
    assert wf.get_visualization(b"\x01")["constellation"].numel() == 0
    assert wf.generate_demo(duration_ms=2.0).shape == (250,)
    steps = wf.get_demodulation_steps(wf.modulate(b"\x5a"))
    assert int(steps[2][1][0]) == 0x5A


def test_batch_helpers_equal_single_calls():
    params = lora.LoRaParams(sf=8)
    payloads = torch.tensor([[1, 2, 3], [200, 100, 50]], dtype=torch.int32)
    tx = batch_modulate(functools.partial(lora.modulate, params, include_preamble=False,
                                          device="cpu"),
                        payloads)
    for row, payload in zip(tx, payloads):
        assert torch.equal(row, lora.modulate(params, payload, include_preamble=False,
                                                device="cpu"))
    res = batch_demodulate(functools.partial(lora.demodulate, params), tx)
    assert torch.equal(res.payload[:, :3], payloads)


def test_monte_carlo_grid_and_ber_sweep():
    params = lora.LoRaParams(sf=7)
    payload = torch.arange(16, dtype=torch.int32)
    ber_fn = functools.partial(lora.loopback_ber, params)
    grid = monte_carlo_ber(lambda snr, gen: ber_fn(payload, snr, generator=gen), 6,
                           [-20.0, 0.0], generator=torch.Generator().manual_seed(1))
    assert grid.shape == (6, 2)
    assert float(grid[:, 1].max()) == 0.0 and float(grid[:, 0].mean()) > 0.1
    a = ber_sweep(ber_fn, payload, [-20.0, -10.0, 0.0], n_lanes=6, seed=3)
    b = ber_sweep(ber_fn, payload, [-20.0, -10.0, 0.0], n_lanes=6, seed=3)
    assert a.shape == (3,) and torch.equal(a, b)
    assert float(a[0]) > float(a[2]) == 0.0


def test_entry_forward_on_cpu():
    forward, args = entry("cpu")
    payload, snr_db, generator = args
    assert payload.tolist() == list(range(16)) and float(snr_db) == 0.0
    ber = forward(*args)
    assert ber.shape == () and float(ber) == 0.0


def test_sweep_grid_and_waterfall_helpers():
    assert [sweep_lanes(sf) for sf in range(7, 13)] == [512, 256, 128, 64, 32, 16]
    snrs = np.arange(-26.0, -2.0, 2.0)
    ber = np.where(snrs < -8.0, 0.3, 0.001)
    assert waterfall_snr_db(snrs, ber) == -8.0
    assert waterfall_snr_db(snrs, np.full(12, 0.5)) is None
    with pytest.raises(ValueError, match="CUDA"):
        lora_sweep("cpu")
    with pytest.raises(ValueError, match="CUDA"):
        viterbi_bench("cpu")


def test_entry_points_default_to_the_card():
    """Read without a card: every entry point that creates tensors defaults
    to CUDA, and None resolves to it with no fallback to the CPU."""
    cuda = torch.device("cuda")
    for fn in (create_waveform, entry, lora_sweep, viterbi_bench, ddc_bench, lora.modulate,
               gps_pvt_fix, pcps_bench, galileo_pvt, dual_pvt, glonass_track, ber_gate,
               lora_packet_roundtrip, packet_capture, pcps_gcorr_bench, device_sweep, sweep_round,
               fleet_noisy_gate, sincgars_data_roundtrip, channel_bench, fading_case,
               fading_gate, coded_link_gate, dvb_s2x_frames, dvb_s2x_bench,
               composed_receiver_gate):
        assert torch.device(inspect.signature(fn).parameters["device"].default) == cuda, fn
    for fn in (GnssScenario, init_state, main_decoded, main_code_phase, gal.main, dual.main,
               glo.main, gal.decode_sv_channel, inav.decode_stream, inav.decode_part,
               inav.decode_page, ber.linear_ber_monte_carlo, ber.waveform_ber_monte_carlo,
               ber.ber_acceptance_report, arq.HarqSender, arq.HarqReceiver,
               arq.harq_roundtrip_demo, jakes_fading, gaussian_doppler_fading,
               flat_doppler_shift, theoretical_ber_awgn,
               tcm_coding_gain_demo, channel_capacity_awgn, turbo_equalizer_tx,
               golay_complementary_pair, preamble_gen, irig_b_encode):  # None: DEFAULT_DEVICE
        assert inspect.signature(fn).parameters["device"].default is None, fn
    assert LoRaWaveform().device == cuda and MilStd188110().device == cuda
    assert create_waveform("LoRa").device == cuda
    assert arq.HarqSender().device == cuda and arq.HarqReceiver().device == cuda
    for name in list_waveforms():
        assert create_waveform(name).device == cuda, name
    assert types.resolve_device(None) == cuda and types.resolve_device("cpu").type == "cpu"
    assert types.to_tensor(torch.ones(2)).device.type == "cpu"  # a tensor keeps its device


def test_import_leaves_jax_out():
    code = ("import sys\n"
            "import r4w_tpu_torch, r4w_tpu_torch.entry, r4w_tpu_torch.convert\n"
            "import r4w_tpu_torch.parallel, r4w_tpu_torch.kernels, r4w_tpu_torch.fec\n"
            "import r4w_tpu_torch.ops.modem, r4w_tpu_torch.ops.spreading, r4w_tpu_torch.profiling\n"
            "import r4w_tpu_torch.ops.filters, r4w_tpu_torch.ops.resample\n"
            "import r4w_tpu_torch.ops.stream_math, r4w_tpu_torch.ops.filters2\n"
            "import r4w_tpu_torch.kernels.fir, r4w_tpu_torch.kernels.nco, r4w_tpu_torch.core.windows\n"
            "import r4w_tpu_torch.gnss, r4w_tpu_torch.gnss.gps_pvt_fix, r4w_tpu_torch.gnss.tracking\n"
            "import r4w_tpu_torch.gnss.acquisition, r4w_tpu_torch.gnss.scenario\n"
            "import r4w_tpu_torch.gnss.coordinates, r4w_tpu_torch.gnss.environment\n"
            "import r4w_tpu_torch.gnss.prn, r4w_tpu_torch.gnss.boc, r4w_tpu_torch.gnss.ephemeris\n"
            "import r4w_tpu_torch.gnss.nav_message, r4w_tpu_torch.gnss.pvt\n"
            "import r4w_tpu_torch.gnss.inav, r4w_tpu_torch.gnss.inav_words\n"
            "import r4w_tpu_torch.gnss.galileo_pvt, r4w_tpu_torch.gnss.glonass_track\n"
            "import r4w_tpu_torch.gnss.dual_pvt\n"
            "import r4w_tpu_torch.waveforms.gnss_waveforms\n"
            "import r4w_tpu_torch.fec.crc, r4w_tpu_torch.core.fftops, r4w_tpu_torch.ops.measure\n"
            "import r4w_tpu_torch.waveforms.lora.packet, r4w_tpu_torch.waveforms.lora.sync\n"
            "import r4w_tpu_torch.waveforms.linear_mod, r4w_tpu_torch.waveforms.psk\n"
            "import r4w_tpu_torch.waveforms.qam, r4w_tpu_torch.waveforms.stanag4285\n"
            "import r4w_tpu_torch.ber, r4w_tpu_torch.arq\n"
            "import r4w_tpu_torch.waveforms, r4w_tpu_torch.fec.galois, r4w_tpu_torch.fec.block\n"
            "import r4w_tpu_torch.ops.ofdm, r4w_tpu_torch.channel.threefry\n"
            "import r4w_tpu_torch.waveforms.milfh_waveforms, r4w_tpu_torch.waveforms.link16\n"
            "import r4w_tpu_torch.channel, r4w_tpu_torch.channel.doppler\n"
            "import r4w_tpu_torch.channel.tdl, r4w_tpu_torch.ops, r4w_tpu_torch.ops.impairments\n"
            "import r4w_tpu_torch.fec.interleave, r4w_tpu_torch.fec.ldpc\n"
            "import r4w_tpu_torch.fec.dvb_s2x, r4w_tpu_torch.fec.turbo, r4w_tpu_torch.fec.polar\n"
            "import r4w_tpu_torch.fec.tcm, r4w_tpu_torch.fec.fountain\n"
            "import r4w_tpu_torch.ops.pulse, r4w_tpu_torch.ops.sync, r4w_tpu_torch.ops.sync2\n"
            "import r4w_tpu_torch.ops.equalizers, r4w_tpu_torch.ops.agc, r4w_tpu_torch.core.hostio\n"
            "import r4w_tpu_torch.ops.events, r4w_tpu_torch.ops.mapping, r4w_tpu_torch.ops.scramblers\n"
            "import r4w_tpu_torch.ops.exotic_modems, r4w_tpu_torch.kernels.recurrence\n"
            "import r4w_tpu_torch.modem_gates, r4w_tpu_torch.monitor_gates\n"
            "import r4w_tpu_torch.ops.stream_blocks, r4w_tpu_torch.ops.detect\n"
            "import r4w_tpu_torch.ops.adaptive, r4w_tpu_torch.ops.kalman\n"
            "import r4w_tpu_torch.ops.spectral2, r4w_tpu_torch.ops.cognitive\n"
            "import r4w_tpu_torch.ops.instruments, r4w_tpu_torch.ops.sensing\n"
            "import r4w_tpu_torch.analysis, r4w_tpu_torch.cognitive_gates\n"
            "import r4w_tpu_torch.ops.protocols, r4w_tpu_torch.ops.packets\n"
            "import r4w_tpu_torch.ops.audio, r4w_tpu_torch.ops.applied, r4w_tpu_torch.adsb\n"
            "import r4w_tpu_torch.dispatch_gates\n"
            "import r4w_tpu_torch.ops.navigation, r4w_tpu_torch.ops.biomedical\n"
            "import r4w_tpu_torch.ops.infra_fills, r4w_tpu_torch.timing\n"
            "import r4w_tpu_torch.waveform_spec, r4w_tpu_torch.hop_gates\n"
            "import r4w_tpu_torch.gnss.e1c_common, r4w_tpu_torch.gnss.e1c_tracking\n"
            "import r4w_tpu_torch.io, r4w_tpu_torch.io.iqformat, r4w_tpu_torch.io.sigmf\n"
            "import r4w_tpu_torch.observe, r4w_tpu_torch.observe.logging\n"
            "import r4w_tpu_torch.observe.metrics, r4w_tpu_torch.observe.capture\n"
            "import r4w_tpu_torch.config, r4w_tpu_torch.streams, r4w_tpu_torch.sim\n"
            "import r4w_tpu_torch.sim.scenario, r4w_tpu_torch.sim.hal\n"
            "import r4w_tpu_torch.scene_gates\n"
            "import r4w_tpu_torch.native, r4w_tpu_torch.rt, r4w_tpu_torch.net\n"
            "import r4w_tpu_torch.benchmark, r4w_tpu_torch.agent, r4w_tpu_torch.scheduler\n"
            "import r4w_tpu_torch.accel, r4w_tpu_torch.block_schema, r4w_tpu_torch.registry\n"
            "import r4w_tpu_torch.waveforms.native_plugin, r4w_tpu_torch.prelude\n"
            "import r4w_tpu_torch.pipeline, r4w_tpu_torch.remote_gates\n"
            "assert len(r4w_tpu_torch.registry.default_registry().list()) == 523\n"
            "assert 'yaml' not in sys.modules\n"
            "assert len(r4w_tpu_torch.waveforms.list_waveforms()) == 50\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'r4w_tpu' or m.startswith('r4w_tpu.') or m == 'triton')\n"
            "print(bad)\n"
            "raise SystemExit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


class TestAliases:
    """tests/test_infra_fills.py's TestAliases on the port's registry."""

    def test_all_alias_blocks_resolve(self):
        from r4w_tpu_torch.registry import default_registry

        reg = default_registry()
        for name in ("cross_ambiguity_function", "iq_balance", "linear_equalizer",
                     "ml_sequence_detector", "noise_reduction", "phase_noise_model",
                     "power_amplifier_dpd", "tapped_delay_line", "fmcw_radar"):
            info = reg.get(name)
            assert info is not None, name
            assert ".rs" in info.description
            assert info.factory(device="cpu") is not None


class TestPreludeAccel:
    """tests/test_infra_fills.py's TestPreludeAccel on the port."""

    def test_prelude_star_import(self):
        ns = {}
        exec("from r4w_tpu_torch.prelude import *", ns)
        assert "create_waveform" in ns and "awgn" in ns
        assert ns["create_waveform"]("bpsk", 48000.0, "cpu") is not None
        x = ns["to_device"](np.arange(4, dtype=np.float32), "cpu")
        assert x.device.type == "cpu" and np.array_equal(ns["to_host"](x), np.arange(4))
        import r4w_tpu.prelude as ref_prelude
        assert sorted(ns) == sorted(["__builtins__", *ref_prelude.__all__])

    def test_accelerator_backends_agree(self):
        from r4w_tpu_torch.accel import create_accelerator

        rng = np.random.default_rng(2)
        x = (rng.standard_normal(256) + 1j * rng.standard_normal(256)).astype(np.complex64)
        taps = (rng.standard_normal(16)).astype(np.complex64)
        sim = create_accelerator("sim")
        tx = create_accelerator("torch", device="cpu")
        assert sim.capabilities().name == "sim"
        assert tx.capabilities().supports_fft
        np.testing.assert_allclose(tx.fft(x).numpy(), sim.fft(x), atol=1e-3)
        np.testing.assert_allclose(tx.fir(x, taps).numpy()[:64], sim.fir(x, taps)[:64],
                                   atol=1e-3)
        chirp = np.exp(1j * np.pi * 0.01 * np.arange(256) ** 2).astype(np.complex64)
        np.testing.assert_allclose(tx.chirp_correlate(x, chirp).numpy(),
                                   sim.chirp_correlate(x, chirp), atol=1e-3)
