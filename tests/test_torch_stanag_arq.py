"""The port's STANAG 4285 modem and ARQ/HARQ against the JAX package.

STANAG 4285: the tables, frame grid and IQ must equal the reference's;
on IQ made by the JAX package with JAX's own noise, the receiver must
return the reference's symbols and bytes, with soft values before the
Viterbi decoder within 1e-4, at every mode, with long interleave and
through a static channel the probe equaliser removes. The AWGN pairs are
the reference's (tests/test_hf_modems.py:95-101). ARQ: the same events
give the same window and statistics; HARQ: the same LLRs give the same
decodes. Card runs are marked ``cuda``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu import arq as ref_arq
from r4w_tpu.channel import awgn as ref_awgn
from r4w_tpu.waveforms import stanag4285 as ref
from r4w_tpu_torch import arq, create_waveform
from r4w_tpu_torch.kernels import viterbi
from r4w_tpu_torch.waveforms import stanag4285 as st

DATA = bytes([0xA7, 0x1B, 0x3C, 0xD2, 0x55, 0x00, 0xFF, 0x42])  # tests/test_hf_modems.py:23
CPU = torch.device("cpu")
MOD_TOL = 1e-5   # modulate, absolute: float32 cos/sin of the same phases
SOFT_TOL = 1e-4  # soft values before Viterbi, absolute
AWGN_CASES = [(2400, 14.0), (1200, 8.0), (600, 5.0), (75, -2.0)]


def _modem(**kw) -> st.Stanag4285:
    return st.Stanag4285(device=CPU, **kw)


def test_tables_match_reference():
    np.testing.assert_array_equal(st.preamble_indices(), ref.preamble_indices())
    np.testing.assert_array_equal(st.frame_scrambler(), ref.frame_scrambler())
    for a, b in zip(st._frame_layout(), ref._frame_layout()):
        np.testing.assert_array_equal(a, b)
    assert st.MODES == ref.MODES
    for mode in st.MODES:
        for long in (False, True):
            shape = st.interleaver_shape(mode, long)
            assert shape == ref.interleaver_shape(mode, long)
            np.testing.assert_array_equal(st.interleave_permutation(*shape),
                                          ref.interleave_permutation(*shape))
    assert st.preamble_indices()[:16].tolist() == [4, 4, 4, 4, 4, 0, 0, 4, 4, 0, 4, 0, 0, 4, 0, 0]
    assert st.frame_scrambler()[:16].tolist() == [7, 7, 7, 0, 3, 6, 7, 0, 2, 6, 3, 3, 3, 6, 4, 1]


@pytest.mark.parametrize("mode,long", [(m, False) for m in st.MODES] + [(1200, True)])
def test_modulate_matches_reference(mode, long):
    want = ref.Stanag4285(mode_bps=mode, long_interleave=long)
    got = _modem(mode_bps=mode, long_interleave=long)
    syms = got.frame_symbols(DATA)
    assert syms.shape[1] == 256 and syms.dtype == torch.int32
    np.testing.assert_array_equal(syms.numpy(), np.asarray(want.frame_symbols(DATA)))
    tx = got.modulate(DATA)
    assert tx.dtype == torch.complex64 and tx.device == CPU
    np.testing.assert_allclose(tx.numpy(), np.asarray(want.modulate(DATA)), rtol=0, atol=MOD_TOL)
    assert got.info() == dataclasses.replace(got).info()
    assert got.info().characteristics == want.info().characteristics


def _capture_soft(monkeypatch, module):
    """Record the soft values `module` hands its Viterbi decoder."""
    seen = []
    original = module.viterbi_decode

    def spy(received, *args, **kwargs):
        seen.append(np.array(received))
        return original(received, *args, **kwargs)

    monkeypatch.setattr(module, "viterbi_decode", spy)
    return seen


def _check_reference_iq(monkeypatch, mode, long, rx):
    ref_soft = _capture_soft(monkeypatch, ref)
    port_soft = _capture_soft(monkeypatch, st)
    want = ref.Stanag4285(mode_bps=mode, long_interleave=long).demodulate(jnp.asarray(rx))
    got = _modem(mode_bps=mode, long_interleave=long).demodulate(torch.from_numpy(rx))
    np.testing.assert_array_equal(got.symbols.numpy(), np.asarray(want.symbols))
    np.testing.assert_array_equal(got.bits.numpy(), np.asarray(want.bits))
    assert bytes(got.bits[: len(DATA)].numpy().astype(np.uint8)) == DATA
    assert len(port_soft) == len(ref_soft)
    for p, r in zip(port_soft, ref_soft):
        assert p.shape == r.shape
        np.testing.assert_allclose(p, r, rtol=0, atol=SOFT_TOL)


@pytest.mark.parametrize("mode,snr", AWGN_CASES)
def test_demodulate_reference_iq_with_its_noise(monkeypatch, mode, snr):
    tx = ref.Stanag4285(mode_bps=mode).modulate(DATA)
    rx = np.array(ref_awgn(jax.random.key(11), tx, snr))
    _check_reference_iq(monkeypatch, mode, False, rx)


@pytest.mark.parametrize("mode,long", [(150, False), (300, False), (3600, False), (1200, True)])
def test_demodulate_reference_iq_other_modes(monkeypatch, mode, long):
    """The modes the AWGN pairs leave out, and long interleave, on the
    reference's IQ with its noise at 12 dB."""
    tx = ref.Stanag4285(mode_bps=mode, long_interleave=long).modulate(DATA)
    rx = np.array(ref_awgn(jax.random.key(mode), tx, 12.0))
    _check_reference_iq(monkeypatch, mode, long, rx)


def test_probe_equalization_static_channel(monkeypatch):
    """A static complex gain (0.4, 2.2 rad) is removed by the probe and
    preamble estimator, as in the reference."""
    tx = np.asarray(ref.Stanag4285(mode_bps=2400).modulate(DATA))
    gain = 0.4 * np.exp(1j * 2.2).astype(np.complex64)
    rx = np.array(ref_awgn(jax.random.key(5), tx * gain, 18.0))
    _check_reference_iq(monkeypatch, 2400, False, rx)
    frames = torch.from_numpy(rx)
    stream = _modem()._symbol_stream(frames)
    eq = _modem()._equalize_frames(stream[: 256 * (stream.shape[-1] // 256)].reshape(-1, 256))
    want = ref.Stanag4285()._equalize_frames(jnp.asarray(
        ref.Stanag4285()._symbol_stream(jnp.asarray(rx))[: eq.shape[0] * 256].reshape(-1, 256)))
    np.testing.assert_allclose(eq.numpy(), np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", sorted(st.MODES))
def test_clean_roundtrip_every_mode(mode):
    wf = _modem(mode_bps=mode)
    res = wf.demodulate(wf.modulate(DATA))
    assert bytes(res.bits[: len(DATA)].numpy().astype(np.uint8)) == DATA


def test_factory_short_input_and_stages():
    wf = create_waveform("STANAG-4285", device=CPU)
    assert isinstance(wf, st.Stanag4285) and wf.info().bits_per_symbol == 3
    assert wf.common.sample_rate == 125_000.0 and wf.samples_per_symbol() == 52
    assert create_waveform("stanag", 8000.0, device=CPU).common.sample_rate == 9600.0
    assert create_waveform("STANAG").device == torch.device("cuda")  # the card unless named
    empty = _modem().demodulate(torch.zeros(100, dtype=torch.complex64))
    assert empty.bits.numel() == 0 and empty.symbols.numel() == 0
    stages = _modem().get_modulation_stages(DATA)
    want = ref.Stanag4285().get_modulation_stages(DATA)
    assert [name for name, _ in stages] == [name for name, _ in want]
    np.testing.assert_array_equal(stages[1][1].numpy(), np.asarray(want[1][1]))


def test_selective_repeat_arq_matches_reference():
    """The reference test's events, then a random run of sends, ACKs and
    NACKs: the same returns, window and statistics at every step."""
    a, b = arq.SelectiveRepeatArq(4, 2), ref_arq.SelectiveRepeatArq(4, 2)
    seqs = [a.send(bytes([i])) for i in range(6)]
    assert seqs == [b.send(bytes([i])) for i in range(6)]
    assert a.pending() == b.pending() == seqs[:4]
    rng = np.random.default_rng(0)
    for _ in range(200):
        op, seq = rng.integers(0, 3), int(rng.integers(0, max(a.next_seq, 1)))
        if op == 0:
            assert a.send(b"x") == b.send(b"x")
        elif op == 1:
            a.on_ack(seq)
            b.on_ack(seq)
        else:
            assert a.on_nack(seq) == b.on_nack(seq)
        assert a.pending() == b.pending() and a.tx_queue == b.tx_queue
        assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats)
    assert [s.value for s in arq.ArqState] == [s.value for s in ref_arq.ArqState]


def test_selective_repeat_budget():
    a = arq.SelectiveRepeatArq(window=4, max_retries=2)
    seqs = [a.send(bytes([i])) for i in range(6)]
    a.on_ack(seqs[0])
    assert a.on_nack(seqs[1]) and a.on_nack(seqs[1]) and not a.on_nack(seqs[1])
    assert (a.stats.delivered, a.stats.failed, a.stats.retransmissions) == (1, 1, 2)
    assert not a.on_nack(99)


@pytest.mark.parametrize("noise_std", [0.6, 0.95, 1.3])
def test_harq_decodes_match_reference_on_the_same_llrs(noise_std):
    rng = np.random.default_rng(int(noise_std * 10))
    bits = rng.integers(0, 2, 96)
    tx, ref_tx = arq.HarqSender(CPU), ref_arq.HarqSender()
    rx, ref_rx = arq.HarqReceiver(CPU), ref_arq.HarqReceiver()
    seq, p1 = tx.first_transmission(bits)
    ref_seq, ref_p1 = ref_tx.first_transmission(bits)
    assert seq == ref_seq == 0
    np.testing.assert_array_equal(p1, ref_p1)
    np.testing.assert_array_equal(tx.retransmission(seq), ref_tx.retransmission(seq))
    for which, p in ((1, p1), (2, tx.retransmission(seq))):
        llr = 2 * ((1 - 2.0 * p) + rng.normal(0, noise_std, len(p))) / noise_std ** 2
        got = rx.receive(seq, llr, len(bits), which=which)
        want = ref_rx.receive(seq, llr, len(bits), which=which)
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(rx._llr[seq].numpy(), np.asarray(ref_rx._llr[seq]))


def test_harq_roundtrip_demo_matches_reference():
    """The reference test's six trials (seed 5), each package drawing from
    its own numpy generator of the same seed."""
    rng, ref_rng = np.random.default_rng(5), np.random.default_rng(5)
    wins = 0
    for _ in range(6):
        bits = rng.integers(0, 2, 96)
        assert np.array_equal(bits, ref_rng.integers(0, 2, 96))
        ok = arq.harq_roundtrip_demo(bits, 0.95, rng, device=CPU)
        assert ok == ref_arq.harq_roundtrip_demo(bits, 0.95, ref_rng)
        wins += (ok[1] and not ok[0]) - 2 * (ok[0] and not ok[1])
    assert wins >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("mode,snr", AWGN_CASES)
def test_stanag_on_card_equals_cpu(mode, snr):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Viterbi kernels have no CPU or interpret mode")
    wf = st.Stanag4285(mode_bps=mode)
    tx = wf.modulate(DATA)
    rng = np.random.default_rng(mode)
    noise = torch.from_numpy((rng.standard_normal(tx.shape) + 1j * rng.standard_normal(tx.shape))
                             .astype(np.complex64))
    from r4w_tpu_torch.channel import awgn
    rx = awgn(tx, snr, noise=noise.cuda())
    before = viterbi.viterbi_forward.launches
    got = wf.demodulate(rx)
    assert viterbi.viterbi_forward.launches == before + 1
    want = _modem(mode_bps=mode).demodulate(rx.cpu())
    assert torch.equal(got.bits.cpu(), want.bits) and torch.equal(got.symbols.cpu(), want.symbols)
    assert bytes(got.bits[: len(DATA)].cpu().numpy().astype(np.uint8)) == DATA


@pytest.mark.cuda
def test_harq_on_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Viterbi kernels have no CPU or interpret mode")
    for seed in range(4):
        bits = np.random.default_rng(seed).integers(0, 2, 96)
        assert (arq.harq_roundtrip_demo(bits, 0.95, np.random.default_rng(seed))
                == arq.harq_roundtrip_demo(bits, 0.95, np.random.default_rng(seed), device=CPU))
