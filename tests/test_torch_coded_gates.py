"""The port's channel and coded-link entry points on the CPU, held to the
JAX package's gates.

`fading_gate` puts OFDM, LoRa-SF7, DSSS and BFSK through the TDL fading
channels on the reference's own threefry draws
(tests/test_waveform_fleet.py:103-116, tests/test_fleet_fading.py:20-33):
the port's channel output is held to JAX's `apply_channel` for the same
key, the port decodes the reference's own faded IQ as the reference does,
and the gate meets every bar. `coded_link_gate` runs the JAX FEC tests'
own numpy inputs through the port's codecs, each to its test's bar, its
decisions equal to the reference's on the same inputs; TCM's gain runs
at 12,000 bits here (the plain Viterbi loop), the full 100,000 on the
card. The benches need the card; their inputs are checked here at a few
frames. ``cuda``-marked tests run the gates and benches on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.channel import channel as ref_channel
from r4w_tpu.fec import convolutional as ref_conv
from r4w_tpu.fec import dvb_s2x as ref_dvb
from r4w_tpu.fec import ldpc as ref_ldpc
from r4w_tpu.fec import tcm as ref_tcm
from r4w_tpu.waveforms import create_waveform as ref_create_waveform
from r4w_tpu_torch import entry
from r4w_tpu_torch.channel import ChannelConfig, apply_channel, threefry
from r4w_tpu_torch.waveforms import create_waveform

CPU = torch.device("cpu")
MOD_TOL = 1e-5      # tests/torch_fleet_parity.py: float32 cos/sin of equal phases
CHANNEL_TOL = 2e-6  # tests/test_torch_channel.py: the reference's draws, float32 sums
CPU_TCM_BITS = 12_000


@pytest.fixture(scope="module")
def coded_gate():
    return entry.coded_link_gate(CPU, tcm_bits=CPU_TCM_BITS)


@pytest.mark.parametrize("case", entry.FADING_CASES, ids=lambda c: f"{c[0]}-{c[2]}-{c[3]}")
def test_fading_case_on_the_references_draws(case):
    name, rate, model, profile, snr, doppler, data, key = case
    ref_wf = ref_create_waveform(name, rate)
    tx = np.array(ref_wf.modulate(data))
    cfg = ChannelConfig(model=model, snr_db=snr, sample_rate=rate, doppler_hz=doppler,
                        tdl_profile=profile)
    rx = np.array(ref_channel.apply_channel(jax.random.key(key), tx, ref_channel.ChannelConfig(
        model=model, snr_db=snr, sample_rate=rate, doppler_hz=doppler, tdl_profile=profile)))
    assert np.asarray(ref_wf.demodulate(rx).bits)[: len(data)].tolist() == list(data)

    wf = create_waveform(name, rate, CPU)
    port_tx = wf.modulate(data)
    assert np.max(np.abs(port_tx.numpy() - tx)) <= MOD_TOL * np.max(np.abs(tx))
    port_rx = apply_channel(torch.from_numpy(tx), cfg, key=threefry.key(key))
    assert np.max(np.abs(port_rx.numpy() - rx)) <= CHANNEL_TOL * np.max(np.abs(rx))
    got = wf.demodulate(torch.from_numpy(rx)).bits[: len(data)].numpy()
    assert got.tolist() == list(data)
    assert entry.fading_case(case, CPU) == {"ok": True, "bytes": data.hex()}


def test_fading_gate_meets_every_bar_on_the_cpu():
    gate = entry.fading_gate(CPU, seeds=range(2))
    assert gate["ok"] and len(gate["results"]) == len(entry.FADING_CASES) + 1  # + the 2-ray case
    assert set(gate["pass_rates"]) == set(gate["results"])
    assert all(r in (0.0, 0.5, 1.0) for r in gate["pass_rates"].values())


def test_coded_link_gate_meets_every_bar(coded_gate):
    res = coded_gate["results"]
    assert coded_gate["ok"], {k: {a: b for a, b in v.items() if a != "decisions"}
                              for k, v in res.items() if not v["ok"]}
    assert set(res) == {"ldpc", "turbo", "polar", "conv", "tcm", "dvb_s2x 1/4", "dvb_s2x 1/2",
                        "dvb_s2x 3/4", "dvb_s2x 9/10", "lt overhead", "lt erasures", "map"}
    assert res["turbo"]["raw_errors"] > 0 and res["turbo"]["errors"] == 0
    assert res["tcm"]["bits"] == CPU_TCM_BITS and res["tcm"]["qpsk_ber"] > 1e-3


def test_coded_gate_decisions_equal_the_references(coded_gate):
    """The cases whose decoders are cheap to run in JAX, on the tests' own
    inputs: LDPC, the convolutional gate, MAP and the four DVB-S2X frames."""
    res = coded_gate["results"]
    hg = ref_ldpc.make_regular_ldpc(96, 3, 6)
    rng = np.random.default_rng(6)
    u = rng.integers(0, 2, (4, hg[2]))
    c = np.asarray(ref_ldpc.ldpc_encode(jnp.asarray(u), hg))
    sigma = np.sqrt(1 / (2 * 10 ** (2.0 / 10)))
    llr = 2 * ((1 - 2.0 * c) + rng.normal(0, sigma, c.shape)) / sigma ** 2
    hard, _ = ref_ldpc.ldpc_decode(jnp.asarray(llr, jnp.float32), hg)
    np.testing.assert_array_equal(res["ldpc"]["decisions"], np.asarray(hard))

    rng = np.random.default_rng(9)
    bits = rng.integers(0, 2, 2000)
    coded = np.asarray(ref_conv.conv_encode(jnp.asarray(bits)))
    noisy = (1 - 2.0 * coded) + rng.normal(0, np.sqrt(1 / 2), len(coded))
    np.testing.assert_array_equal(res["conv"]["decisions"], np.asarray(ref_conv.viterbi_decode(
        jnp.asarray(noisy.astype(np.float32)), soft=True)))

    rng = np.random.default_rng(11)
    rep = np.repeat(rng.integers(0, 2, 256).astype(np.int32), 2)
    soft = (1.0 - 2.0 * np.asarray(ref_conv.conv_encode(jnp.asarray(rep)))).astype(np.float32)
    soft += 0.8 * rng.standard_normal(len(soft)).astype(np.float32)
    llr, _ = ref_conv.map_decode(jnp.asarray(soft))
    np.testing.assert_array_equal(res["map"]["llr"], np.asarray(llr)[: len(rep)])

    rng = np.random.default_rng(42)  # tests/test_named_blocks.py's module RNG, in file order
    rng.integers(0, 2, ref_dvb.parity_structure("2/3", "short")["k"])
    for rate, ebn0 in entry.DVB_GATE_POINTS:
        u = rng.integers(0, 2, ref_dvb.parity_structure(rate, "short")["k"]).astype(np.int32)
        c = np.asarray(ref_dvb.encode(u, rate, "short"))
        esn0 = 10 ** (ebn0 / 10) * ref_dvb.CODE_RATES[rate]
        y = (1 - 2 * c) + rng.normal(0, np.sqrt(1 / (2 * esn0)), len(c))
        hard, _ = ref_dvb.decode(jnp.asarray(4 * esn0 * y, jnp.float32), rate, "short", iters=40)
        np.testing.assert_array_equal(res[f"dvb_s2x {rate}"]["decisions"], np.asarray(hard))


def test_coded_gate_tcm_decisions_equal_the_references(coded_gate):
    """TCM's case at the CPU's size: its received symbols are the
    reference demo's (tests/test_fec.py:270, seed 2), exactly, and its
    decisions are JAX `tcm_decode`'s on them."""
    res = coded_gate["results"]["tcm"]
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, CPU_TCM_BITS).astype(np.int32)
    _, tx = ref_tcm.tcm_encode(bits)
    sigma = np.sqrt(1.0 / (2.0 * 10.0 ** (entry.TCM_GATE_EBN0_DB / 10.0) * 2.0))
    noise = (rng.standard_normal(tx.shape[-1]) + 1j * rng.standard_normal(tx.shape[-1])) * sigma
    rx = np.asarray(tx + noise.astype(np.complex64))
    np.testing.assert_array_equal(res["symbols"], rx)
    want = np.asarray(ref_tcm.tcm_decode(rx))[:CPU_TCM_BITS]
    np.testing.assert_array_equal(res["decisions"], want)
    assert res["tcm_ber"] == float(np.mean(want != bits))


def test_dvb_s2x_bench_frames_decode_on_the_cpu():
    """`dvb_s2x_bench`'s inputs at two frames: every frame parity-ok and
    equal to the bits sent after the bench's 40 iterations."""
    bits, llr = entry.dvb_s2x_frames(CPU, frames=2)
    assert bits.shape == (2, 32_400) and llr.shape == (2, 64_800) and llr.dtype == torch.float32
    hard, ok = entry.dvb_s2x.decode(llr, entry.DVB_BENCH_RATE, "normal",
                                    iters=entry.DVB_GATE_ITERS)
    assert bool(ok.all()) and torch.equal(hard, bits)


def test_benches_need_the_card():
    with pytest.raises(ValueError, match="needs a CUDA device"):
        entry.channel_bench(CPU)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        entry.dvb_s2x_bench(CPU)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Viterbi kernels have no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_coded_link_gate_on_card_equals_cpu(coded_gate):
    card = entry.coded_link_gate(_card(), tcm_bits=CPU_TCM_BITS)
    assert card["ok"]
    for name, res in coded_gate["results"].items():
        for key, value in res.items():
            np.testing.assert_array_equal(card["results"][name][key], value, err_msg=name)


@pytest.mark.cuda
def test_fading_gate_on_card():
    gate = entry.fading_gate(_card(), seeds=range(2))
    assert gate["ok"]


@pytest.mark.cuda
def test_benches_on_card():
    dev = _card()
    bench = entry.channel_bench(dev, iters=64)
    assert bench["msamples_per_s"] > 0 and np.isfinite(bench["mean_power"])
    assert entry.dvb_s2x_bench(dev, frames=4)["ok"]
