"""The port's composed receiver (`entry.composed_receiver_gate`) against the
JAX package's chain of ``tests/test_e2e_receiver.py`` on the same inputs.

Case 1 feeds the reference's own transmit chain and receive chain
(imported from that file) the same bits; the reference tries the
(offset, rotation) hypotheses one at a time and stops at the first whose
bits equal the payload, the port decodes them all as the lanes of one
Viterbi call and takes the first in the same order: the chosen hypothesis
and its bits must be equal. Cases 2 and 4 rebuild the reference tests'
numpy inputs with their seeds and run the JAX package's sounding, MLSE and
DFE on them: the MLSE decisions, the DFE's outputs (bit for bit) and
sliced decisions, and the sounded taps (within `CIR_TOL`) must agree.
Both at the reference's sizes (where every bar of the reference's tests
is also checked) and at full width, a 1,500-byte packet (12,000 info
bits, 12,032 symbols in cases 2 and 4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.ops import equalizers as ref_eq
from r4w_tpu.ops import measure as ref_measure
from r4w_tpu.ops.spreading import m_sequence as ref_m_sequence
from r4w_tpu_torch import entry
from r4w_tpu_torch.kernels import fir, viterbi

# max|port - reference| of the sounded taps: a 255-point FFT correlation in
# float32 (pocketfft against XLA's FFT; measured ~1e-7)
CIR_TOL = 1e-5


def _jax_link(n_bits: int):
    """(offset, rotation, bits) of the reference's first decoding hypothesis."""
    import jax

    from r4w_tpu.channel import awgn
    from test_e2e_receiver import _rx_chain, _tx_chain

    bits = np.random.default_rng(7).integers(0, 2, n_bits).astype(np.int32)
    tx, coded, n_info, taps = _tx_chain(bits)
    rx = awgn(jax.random.key(entry.RECEIVER_KEY), jnp.asarray(tx), entry.RECEIVER_SNR_DB)
    for off, rot, dec in _rx_chain(np.asarray(rx), taps, len(coded), n_info):
        if np.array_equal(dec, bits):
            return off, rot, dec
    return None


def _jax_isi(n_sym: int) -> dict:
    """tests/test_e2e_receiver.py:102-136 on the JAX package."""
    rng = np.random.default_rng(9)
    idx = rng.integers(0, 4, n_sym)
    syms = entry.QPSK_POINTS[idx]
    h_true = np.asarray([1.0, 0.55 * np.exp(1j * 0.5), 0.28 * np.exp(-1j * 1.1)], np.complex64)
    probe = ref_m_sequence(8).astype(np.complex64)
    frame = np.concatenate([np.tile(probe, 2), syms])
    rx = np.convolve(frame, h_true)[: len(frame)]
    rx += 0.06 * (rng.standard_normal(len(rx)) + 1j * rng.standard_normal(len(rx)))
    cir = np.asarray(ref_measure.channel_sound(jnp.asarray(rx[255:510].astype(np.complex64)),
                                               jnp.asarray(probe), n_taps=8))
    data = rx[510:510 + n_sym].astype(np.complex64)
    dec = np.asarray(ref_eq.mlse_equalize(jnp.asarray(data), cir[:3],
                                          jnp.asarray(entry.QPSK_POINTS)))
    return {"cir": cir, "decisions": dec}


def _jax_null(n_sym: int) -> dict:
    """tests/test_e2e_receiver.py:163-186 on the JAX package."""
    rng = np.random.default_rng(13)
    idx = rng.integers(0, 4, n_sym)
    s = entry.QPSK_POINTS[idx]
    h = np.asarray([0.71, 0.0, 0.7], np.complex64)
    y = np.convolve(s, h)[: len(s)].astype(np.complex64)
    y += 0.07 * (rng.standard_normal(len(y))
                 + 1j * rng.standard_normal(len(y))).astype(np.complex64)
    mlse = np.asarray(ref_eq.mlse_equalize(jnp.asarray(y), h, jnp.asarray(entry.QPSK_POINTS)))
    ydfe = np.asarray(ref_eq.dfe_equalize(jnp.asarray(y), n_ff=9, n_fb=4, mu=0.005).y)
    skip = entry.RECEIVER_DFE_SKIP
    dfe_idx = np.argmin(np.abs(ydfe[skip:, None] - entry.QPSK_POINTS), axis=1)
    return {"decisions": mlse, "dfe_decisions": dfe_idx, "dfe_y": ydfe}


def _gate(n_bits: int) -> dict:
    """The gate on the CPU with one torch thread (its step loops are small ops)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return entry.composed_receiver_gate("cpu", n_bits)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("n_bits", [entry.RECEIVER_INFO_BITS, entry.PACKET_INFO_BITS])
def test_gate_decisions_equal_the_reference(n_bits):
    gate = _gate(n_bits)
    link, isi, null = (gate["cases"][k] for k in ("qpsk_link", "isi_mlse", "mlse_vs_dfe"))
    assert gate["ok"] and link["ok"]
    assert link["hypotheses"] == 88  # offsets 0-21 × 4 rotations at both sizes
    want = _jax_link(n_bits)
    assert want is not None
    assert (link["offset"], link["rotation"]) == want[:2]
    np.testing.assert_array_equal(link["bits"], want[2])

    n_sym = (entry.RECEIVER_ISI_SYMBOLS if n_bits == entry.RECEIVER_INFO_BITS
             else entry._receiver_symbols(2 * (n_bits + 6)))
    ref = _jax_isi(n_sym)
    assert np.abs(isi["cir"] - ref["cir"]).max() < CIR_TOL
    np.testing.assert_array_equal(isi["decisions"], ref["decisions"])

    n_sym = (entry.RECEIVER_NULL_SYMBOLS if n_bits == entry.RECEIVER_INFO_BITS
             else entry._receiver_symbols(2 * (n_bits + 6)))
    ref = _jax_null(n_sym)
    np.testing.assert_array_equal(null["decisions"], ref["decisions"])
    np.testing.assert_array_equal(null["dfe_decisions"], ref["dfe_decisions"])
    np.testing.assert_array_equal(null["dfe_y"], ref["dfe_y"])  # the DFE rounds as XLA's step


def test_gate_meets_every_reference_bar():
    """tests/test_e2e_receiver.py's four bars at its sizes, on the port."""
    gate = _gate(entry.RECEIVER_INFO_BITS)
    c = gate["cases"]
    assert gate["reference_size"] and gate["ok"]
    assert c["qpsk_link"]["ok"]
    assert c["isi_mlse"]["tap_err"] < 0.08 and c["isi_mlse"]["ghost"] < 0.05
    assert c["isi_mlse"]["ser_mlse"] == 0.0 and c["isi_mlse"]["ser_naive"] > 0.03
    assert c["map_soft"]["errors_soft"] <= c["map_soft"]["errors_hard"]
    assert c["map_soft"]["errors_soft"] < 0.05 * 256
    assert c["mlse_vs_dfe"]["ser_mlse"] < 0.002
    assert c["mlse_vs_dfe"]["ser_mlse"] < c["mlse_vs_dfe"]["ser_dfe"]
    shares = gate["seconds"]["share"]
    assert set(shares) == {"pfb_clock_sync", "mlse", "dfe"} and sum(shares.values()) < 1.0


def test_gate_launches_no_kernel_on_the_cpu():
    """On CPU tensors every FIR and Viterbi call takes the plain version."""
    before = (fir.fir_decimate.launches, viterbi.viterbi_forward.launches,
              viterbi.viterbi_traceback.launches)
    _gate(entry.RECEIVER_INFO_BITS)
    assert (fir.fir_decimate.launches, viterbi.viterbi_forward.launches,
            viterbi.viterbi_traceback.launches) == before


@pytest.mark.cuda
def test_gate_on_the_card_equals_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for n_bits in (entry.RECEIVER_INFO_BITS, entry.PACKET_INFO_BITS):
        card = entry.composed_receiver_gate("cuda", n_bits)
        cpu = entry.composed_receiver_gate("cpu", n_bits)
        assert card["ok"] and cpu["ok"]
        for name in ("qpsk_link", "isi_mlse", "mlse_vs_dfe"):
            for key in ("offset", "rotation", "bits", "decisions", "dfe_decisions", "dfe_y"):
                if key in card["cases"][name]:
                    np.testing.assert_array_equal(card["cases"][name][key],
                                                  cpu["cases"][name][key])
