"""The port's fleet entry points and factory against the JAX package.

The factory lists the reference's 50 names in its order and resolves every
alias to the same canonical name. On the CPU: `device_sweep` is 50/50 and
returns its bytes for exactly the 40 names the reference does at 48 kHz;
`fleet_noisy_gate` passes on the reference's noise (`channel.threefry`,
whose draws equal `jax.random`'s: bits exactly, normals within 3e-7
relative); `sincgars_data_roundtrip` returns 29/29 frames of a 2,048-byte
file. Card runs are marked ``cuda``: the card's sweep decisions equal the
CPU's, and the SINCGARS decode launches each Viterbi kernel once.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.channel import awgn as ref_awgn
from r4w_tpu.channel import channel as ref_channel
from r4w_tpu.waveforms import base as ref_base
from r4w_tpu_torch import entry
from r4w_tpu_torch.channel import channel, threefry
from r4w_tpu_torch.waveforms import base, create_waveform, list_waveforms
from torch_fleet_parity import ref_own_registry, ref_own_waveforms

CPU = torch.device("cpu")
# The names whose bytes the reference's probe (tools/device_sweep.py) gets
# back at 48 kHz: all but CW, ADS-B, the analog, radar and beacon names.
NO_BYTES_AT_48K = {"CW", "ADS-B", "AM-Broadcast", "FM-Broadcast", "NBFM", "FMCW", "ELT-121.5",
                   "EPIRB-121.5", "PLB-121.5", "Beacon-243"}
NORMAL_RTOL = 3e-7  # measured 2.4e-7 over 1e6 draws: one or two float32 ulps


def test_factory_order_and_aliases_equal_reference():
    assert list_waveforms() == ref_own_waveforms() and len(list_waveforms()) == 50
    assert set(base._REGISTRY) == set(ref_own_registry())
    ref_canonical = {ref_base._REGISTRY[ref_base._norm(n)]: n for n in ref_own_waveforms()}
    canonical = {base._REGISTRY[base._norm(n)]: n for n in list_waveforms()}
    for alias, builder in ref_own_registry().items():
        assert canonical[base._REGISTRY[alias]] == ref_canonical[builder], alias
    for name in list_waveforms():
        wf, ref = create_waveform(name, device=CPU), ref_base.create_waveform(name)
        assert wf.info().name == ref.info().name, name
    assert create_waveform("GPS-L1CA-PRN7", device=CPU).prn == 7


def test_factory_comparison_ignores_a_name_registered_by_a_plugin():
    """A plugin's name in the reference's process-global registry (as
    tests/test_mesh_registry.py leaves one) does not enter the comparison:
    the port still lists the reference's own 50 names in its order."""
    def build(sample_rate):  # the module of a plugin that registers a name
        raise AssertionError("never built")

    build.__module__ = "r4w_tpu_plugin_throwaway"
    before = ref_base.list_waveforms()
    ref_base.register_waveform("THROWAWAY-WAVE", ("throwaway_alias",))(build)
    try:
        assert ref_base.list_waveforms() == before + ["THROWAWAY-WAVE"]
        assert ref_own_waveforms() == list_waveforms() and len(ref_own_waveforms()) == 50
        assert set(ref_own_registry()) == set(base._REGISTRY)
        assert "THROWAWAYWAVE" not in ref_own_registry()
    finally:
        ref_base._CANONICAL.remove("THROWAWAY-WAVE")
        for alias in ("THROWAWAYWAVE", "THROWAWAYALIAS"):
            del ref_base._REGISTRY[alias]
    assert ref_base.list_waveforms() == before


def _reference_gate_tables() -> dict:
    """tests/test_fleet_noisy.py's DATA, DIGITAL_SNR and FUNCTIONAL, read
    from its source (a slow-lane test module)."""
    src = (Path(__file__).parent / "test_fleet_noisy.py").read_text()
    tables = {}
    for node in ast.parse(src).body:
        target = getattr(node, "target", None) or (node.targets[0] if isinstance(node, ast.Assign)
                                                   else None)
        if isinstance(target, ast.Name) and target.id in ("DATA", "DIGITAL_SNR", "FUNCTIONAL"):
            value = node.value
            if target.id == "DATA":  # bytes([...])
                value = value.args[0]
            tables[target.id] = ast.literal_eval(value)
    return tables


def test_noisy_matrix_copies_reference():
    tables = _reference_gate_tables()
    assert entry.NOISY_DATA == bytes(tables["DATA"])
    assert entry.DIGITAL_SNR == tables["DIGITAL_SNR"]
    assert entry.FUNCTIONAL == tables["FUNCTIONAL"]
    assert set(entry.DIGITAL_SNR) | entry.FUNCTIONAL == set(list_waveforms())


@pytest.mark.parametrize("seed,n", [(0, 5), (3, 4097), (42, 100_000), (2**31 - 1, 33)])
def test_threefry_draws_equal_jax(seed, n):
    k = threefry.key(seed)
    assert k == tuple(int(v) for v in jax.random.key_data(jax.random.key(seed)))
    want_split = np.asarray(jax.random.key_data(jax.random.split(jax.random.key(seed))))
    assert [list(x) for x in threefry.split(k)] == want_split.tolist()
    want_bits = jax.random.bits(jax.random.key(seed), (n,), jnp.uint32)
    np.testing.assert_array_equal(threefry.random_bits(k, n), np.asarray(want_bits))
    want = np.asarray(jax.random.normal(jax.random.key(seed), (n,), jnp.float32))
    got = threefry.normal(k, (n,))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=NORMAL_RTOL, atol=0)
    noise = channel._complex_normal((n,), 1.0, key=k, device=CPU).numpy()
    want = np.asarray(ref_channel._complex_normal(jax.random.key(seed), (n,), 1.0))
    np.testing.assert_allclose(noise.real, want.real, rtol=NORMAL_RTOL, atol=0)
    np.testing.assert_allclose(noise.imag, want.imag, rtol=NORMAL_RTOL, atol=0)


def test_threefry_erfinv_edges_and_shapes():
    x = np.array([-1.0, -0.999999, -0.5, 0.0, 0.5, 0.999999, 1.0], np.float32)
    np.testing.assert_array_max_ulp(threefry.erfinv(x)[1:-1],
                                    np.asarray(jax.lax.erf_inv(jnp.asarray(x)))[1:-1], maxulp=4)
    assert threefry.erfinv(x)[0] == -np.inf and threefry.erfinv(x)[-1] == np.inf
    assert threefry.normal(threefry.key(1), (3, 5)).shape == (3, 5)


def test_reference_awgn_equals_jax_awgn():
    tx = np.exp(1j * np.linspace(0, 40, 3000)).astype(np.complex64)
    got = entry.reference_awgn(torch.from_numpy(tx), 5.0, 3).numpy()
    want = np.asarray(ref_awgn(jax.random.key(3), tx, 5.0))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_device_sweep_on_cpu():
    out = entry.device_sweep("cpu")
    assert (out["ok"], out["attempted"], out["total"], out["failures"]) == (50, 50, 50, [])
    assert list(out["warm_ms"]) == list_waveforms()
    carrying = [n for n in list_waveforms() if create_waveform(n, device=CPU).info().carries_data]
    assert list(out["bytes_back"]) == carrying
    back = {n for n, ok in out["bytes_back"].items() if ok}
    assert back == set(list_waveforms()) - NO_BYTES_AT_48K
    assert out["samples"]["OFDM"] == 160 and out["samples"]["Link-16"] == 78125


def test_fleet_noisy_gate_on_cpu():
    out = entry.fleet_noisy_gate("cpu")
    assert out["covered"] and out["failures"] == [] and out["ok"]
    assert set(out["results"]) == set(list_waveforms())
    assert out["results"]["FMCW"]["range_m"] == pytest.approx(1498.96229, abs=1e-3)


def test_sincgars_data_roundtrip_on_cpu():
    out = entry.sincgars_data_roundtrip("cpu")
    assert (out["frames"], out["crc_ok"], out["payload_equal"]) == (29, 29, True)
    assert out["sequences"] == list(range(29))
    assert (out["frame_bits"], out["samples"]) == (1276, 1_160_000)
    assert out["launches"] == {"viterbi_forward": 0, "viterbi_traceback": 0}


def test_sweep_round_is_the_reference_probe():
    iq, res = entry.sweep_round("4-FSK", "cpu")
    assert iq.dtype == np.complex64 and res.bits.device == CPU
    assert bytes(res.bits[:12].numpy().astype(np.uint8)) == entry.SWEEP_MESSAGE


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Viterbi and dechirp kernels have no CPU or "
                    "interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ref_own_waveforms())
def test_sweep_decisions_on_card_equal_cpu(name):
    dev = _card()
    iq, res = entry.sweep_round(name, dev)
    cpu = create_waveform(name, entry.SWEEP_RATE_HZ, CPU).demodulate(torch.from_numpy(iq))
    diff = res.bits.cpu() - cpu.bits
    if name in ("AM-Broadcast", "FM-Broadcast", "NBFM"):  # truncated float32 audio
        assert bool(torch.all(torch.abs((diff + 128) % 256 - 128) <= 1))
    else:
        assert torch.equal(res.bits.cpu(), cpu.bits) and torch.equal(res.symbols.cpu(), cpu.symbols)


@pytest.mark.cuda
def test_sincgars_decode_on_card_launches_once():
    dev = _card()
    out = entry.sincgars_data_roundtrip(dev, n_bytes=300)
    assert out["crc_ok"] == out["frames"] == 5 and out["payload_equal"]
    assert out["launches"] == {"viterbi_forward": 1, "viterbi_traceback": 1}


@pytest.mark.cuda
def test_fleet_noisy_gate_on_card():
    assert entry.fleet_noisy_gate(_card())["ok"]


def test_noisy_pass_rates_cover_the_matrix():
    rates = entry.noisy_pass_rates("cpu", seeds=range(2))
    assert set(rates) == set(entry.DIGITAL_SNR) | set(entry.ANALOG_BARS)
    assert all(r in (0.0, 0.5, 1.0) for r in rates.values())
    assert rates["BPSK"] == rates["Link-16"] == 1.0
