"""The broadcast FM stereo + RDS gate (`entry.fm_broadcast_gate`) against the
same chain composed from the JAX package's functions on the same station,
and the launches of the gate's path.

The station is `modem_gates.fm_station` (numpy, from a seed). The port's
RDS decisions must equal the reference's bit for bit, and its L, R and mono
audio agree within AUDIO_TOL of the reference's peak (FIRs of up to 301
taps in another order, and a de-emphasis recursion that the reference's
scan may fuse). The path must call the FIR dispatcher 9 times and the
recursion dispatcher once, each on the whole row, whatever the length: no
loop over samples. The `cuda`-marked tests run the gate and the family gate
on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.ops import mapping as ref_mapping
from r4w_tpu.ops import modem as ref_modem
from r4w_tpu_torch import entry, modem_gates
from r4w_tpu_torch.ops import filters

AUDIO_TOL = 1e-4  # the gate's bar for the audio against the reference (measured 8.4e-7)


def _rel(got, want) -> float:
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) or 1.0))


def _reference_chain(iq: np.ndarray, fs: float) -> dict:
    mpx = ref_modem.quadrature_demod(jnp.asarray(iq), gain=fs / (2.0 * np.pi * 75e3))
    left, right, present = ref_mapping.fm_stereo_decode(mpx, fs)
    bits, _ = ref_mapping.rds_subcarrier_demod(mpx, fs)
    audio = ref_mapping.fm_receiver(jnp.asarray(iq), fs, 75e3, audio_rate=48e3)
    return {"mpx": mpx, "left": left, "right": right, "present": present, "rds_bits": bits,
            "audio": audio}


def test_gate_against_the_reference_chain():
    fs, seconds = modem_gates.FM_RATE_HZ, 0.25
    gate = entry.fm_broadcast_gate("cpu", seconds)
    assert gate["ok"], gate["bars"]
    np.testing.assert_array_equal(gate["iq"].numpy(), modem_gates.fm_station(seconds, fs)[0])
    out, ref = gate["outputs"], _reference_chain(gate["iq"].numpy(), fs)
    np.testing.assert_array_equal(out["rds_bits"].numpy(), np.asarray(ref["rds_bits"]))
    assert bool(out["present"]) == bool(ref["present"])
    for key in ("mpx", "left", "right", "audio"):
        assert _rel(out[key], ref[key]) < AUDIO_TOL, key
    bars = gate["bars"]
    assert bars["rds_match"] >= modem_gates.RDS_MATCH
    assert min(bars["separation_left_db"], bars["separation_right_db"]) >= 40.0
    assert set(gate["stage_ms"]) == {"quadrature_demod", "fm_stereo_decode",
                                     "rds_subcarrier_demod", "fm_receiver"}
    assert gate["launches"] == dict.fromkeys(gate["launches"], 0)  # the CPU runs no kernel


def test_station_is_seeded_and_its_bits_are_the_rds_data():
    iq, bits = modem_gates.fm_station(0.05, 240e3, seed=3)
    iq2, bits2 = modem_gates.fm_station(0.05, 240e3, seed=3)
    np.testing.assert_array_equal(iq, iq2)
    np.testing.assert_array_equal(bits, bits2)
    assert iq.dtype == np.complex64 and iq.shape == (12_000,)
    np.testing.assert_allclose(np.abs(iq), 1.0, atol=1e-6)


@pytest.mark.parametrize("seconds", [0.1, 0.25])
def test_the_path_calls_each_dispatcher_once_a_row(monkeypatch, seconds):
    """9 FIR calls and 1 recursion call on the whole row at either length."""
    calls = {"fir": [], "recursion": []}
    fir_orig = filters.fir_decimate_dispatch
    rec_orig = filters.first_order_recurrence_dispatch

    def fir_spy(x, *args, **kwargs):
        calls["fir"].append(tuple(x.shape))
        return fir_orig(x, *args, **kwargs)

    def rec_spy(u, *args, **kwargs):
        calls["recursion"].append(tuple(u.shape))
        return rec_orig(u, *args, **kwargs)

    monkeypatch.setattr(filters, "fir_decimate_dispatch", fir_spy)
    monkeypatch.setattr(filters, "first_order_recurrence_dispatch", rec_spy)
    n = int(seconds * modem_gates.FM_RATE_HZ)
    iq = torch.from_numpy(modem_gates.fm_station(seconds)[0])
    modem_gates.fm_broadcast_chain(iq, modem_gates.FM_RATE_HZ)
    assert calls["fir"] == [(n,)] * modem_gates.FM_FIR_LAUNCHES
    assert calls["recursion"] == [(n,)] * modem_gates.FM_RECURSION_LAUNCHES


def test_family_gate_on_the_cpu():
    gate = entry.modem_family_gate("cpu")
    assert gate["ok"], gate["failed"]
    assert gate["conv_packet"]["ok"] and gate["conv_packet"]["bits"] == 12_000
    assert gate["lte"]["papr_sc_fdma_db"] < gate["lte"]["papr_ofdm_db"]
    assert "scramblers.aes_ctr_keystream_xor" in gate["left_out"]


def test_compare_holds_decisions_exactly():
    a = (torch.tensor([1, 2, 3], dtype=torch.int32), torch.tensor([1.0, 2.0]))
    assert modem_gates.compare(a, a) == 0.0
    b = (torch.tensor([1, 2, 4], dtype=torch.int32), torch.tensor([1.0, 2.0]))
    assert modem_gates.compare(b, a) == float("inf")
    c = (torch.tensor([1, 2, 3], dtype=torch.int32), torch.tensor([1.0, 2.002]))
    assert abs(modem_gates.compare(c, a) - 0.001) < 1e-6


@pytest.mark.cuda
def test_gate_on_the_card_launches_the_same_at_two_lengths():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    counts = []
    for seconds in (1.0, 4.0):
        gate = entry.fm_broadcast_gate("cuda", seconds)
        assert gate["ok"], gate["bars"]
        counts.append(gate["launches"])
    want = dict.fromkeys(counts[0], 0)
    want.update(fir_decimate=modem_gates.FM_FIR_LAUNCHES,
                first_order_iir=modem_gates.FM_RECURSION_LAUNCHES)
    assert counts == [want, want]


@pytest.mark.cuda
def test_gate_on_the_card_equals_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = entry.fm_broadcast_gate("cuda", 2.0)["outputs"]
    cpu = entry.fm_broadcast_gate("cpu", 2.0)["outputs"]
    assert torch.equal(card["rds_bits"].cpu(), cpu["rds_bits"])
    for key in ("left", "right", "audio"):
        assert _rel(card[key], cpu[key]) < AUDIO_TOL, key


@pytest.mark.cuda
def test_family_gate_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gate = entry.modem_family_gate("cuda")
    assert gate["ok"], {k: gate["worst"][k] for k in gate["failed"]}
    assert gate["conv_packet"]["launches"] == {"viterbi_forward": 1, "viterbi_traceback": 1}
