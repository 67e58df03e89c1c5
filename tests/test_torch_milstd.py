"""The port's MIL-STD-188-110 modem against ``r4w_tpu.waveforms.milstd188110``.

Tables and transmit paths must equal the reference on the same inputs;
the receiver takes IQ made by the JAX package, with JAX's own noise, and
must return the same rate, interleave, symbols and bytes, with soft values
before the Viterbi decoder within 1e-4. Round trips use numpy noise
injected into the port's AWGN. The rate/SNR pairs are the reference's
(tests/test_hf_modems.py:186-193).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.channel import awgn as ref_awgn
from r4w_tpu.waveforms import milstd188110 as ref
from r4w_tpu_torch import create_waveform
from r4w_tpu_torch.channel import awgn
from r4w_tpu_torch.ops import modem, spreading
from r4w_tpu_torch.waveforms import linear_mod
from r4w_tpu_torch.waveforms import milstd188110 as ms

DATA = bytes([0xA7, 0x1B, 0x3C, 0xD2, 0x55, 0x00, 0xFF, 0x42])  # tests/test_hf_modems.py:23
CPU = torch.device("cpu")
MOD_TOL = 1e-5   # modulate, absolute: float32 cos/sin of the same phases
SOFT_TOL = 1e-4  # soft values before Viterbi, absolute


def _modem(**kw) -> ms.MilStd188110:
    return ms.MilStd188110(device=CPU, **kw)


def test_tables_equal_reference():
    np.testing.assert_array_equal(ms.base_block(), ref.base_block())
    np.testing.assert_array_equal(ms.scrambler_sequence(), ref.scrambler_sequence())
    np.testing.assert_array_equal(ms.walsh_blocks(), ref.walsh_blocks())
    np.testing.assert_array_equal(spreading.lfsr_bits(7, 0x41), ref.lfsr_bits(7, 0x41))
    for rate in ms.RATES:
        for interleave in ("zero", "short", "long"):
            shape = ms.interleaver_shape(rate, interleave)
            assert shape == ref.interleaver_shape(rate, interleave)
            if shape[0] > 1:
                np.testing.assert_array_equal(ms.interleave_permutation(*shape),
                                              ref.interleave_permutation(*shape))
    for interleave in ("zero", "short", "long"):
        np.testing.assert_array_equal(_modem(rate=600, interleave=interleave).preamble_symbols(),
                                      ref.MilStd188110(rate=600, interleave=interleave)
                                      .preamble_symbols())


@pytest.mark.parametrize("rate,interleave", [(1200, "short"), (75, "zero"), (2400, "short"),
                                             (150, "short")])
def test_modulate_matches_reference(rate, interleave):
    want = ref.MilStd188110(rate=rate, interleave=interleave)
    got = _modem(rate=rate, interleave=interleave)
    np.testing.assert_array_equal(got.frame_symbols(DATA).numpy(),
                                  np.asarray(want.frame_symbols(DATA)))
    tx = got.modulate(DATA)
    assert tx.dtype == torch.complex64 and tx.device == CPU
    np.testing.assert_allclose(tx.numpy(), np.asarray(want.modulate(DATA)), rtol=0, atol=MOD_TOL)


def _capture_soft(monkeypatch, module, name="viterbi_decode"):
    """Record the soft values `module` hands its Viterbi decoder."""
    seen = []
    original = getattr(module, name)

    def spy(received, *args, **kwargs):
        seen.append(np.array(received))
        return original(received, *args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return seen


@pytest.mark.parametrize("rate,snr", [(1200, 8.0), (75, -4.0)])
def test_demodulate_reference_iq_matches(monkeypatch, rate, snr):
    tx = ref.MilStd188110(rate=rate, interleave="short").modulate(DATA)
    rx = np.array(ref_awgn(jax.random.key(7), tx, snr))
    ref_soft = _capture_soft(monkeypatch, ref)
    port_soft = _capture_soft(monkeypatch, ms)
    want = ref.MilStd188110().demodulate(jnp.asarray(rx))
    got = _modem().demodulate(torch.from_numpy(rx))
    assert got.metadata == want.metadata == {"rate": rate, "interleave": "short"}
    np.testing.assert_array_equal(got.symbols.numpy(), np.asarray(want.symbols))
    np.testing.assert_array_equal(got.bits.numpy(), np.asarray(want.bits))
    assert bytes(got.bits[: len(DATA)].numpy().astype(np.uint8)) == DATA
    assert port_soft[0].shape == ref_soft[0].shape
    np.testing.assert_allclose(port_soft[0], ref_soft[0], rtol=0, atol=SOFT_TOL)


@pytest.mark.parametrize("rate,snr", [(2400, 14.0), (600, 5.0), (75, -4.0)])
def test_roundtrip_with_injected_noise(rate, snr):
    tx = _modem(rate=rate, interleave="short").modulate(DATA)
    rng = np.random.default_rng(rate)
    noise = (rng.standard_normal(tx.shape) + 1j * rng.standard_normal(tx.shape)).astype(np.complex64)
    res = _modem().demodulate(awgn(tx, snr, noise=torch.from_numpy(noise)))
    assert res.metadata == {"rate": rate, "interleave": "short"}
    assert bytes(res.bits[: len(DATA)].numpy().astype(np.uint8)) == DATA


def test_long_interleave_and_fixed_rate_roundtrips():
    tx = _modem(rate=300, interleave="long").modulate(DATA)
    assert _modem().demodulate(tx).metadata == {"rate": 300, "interleave": "long"}
    fixed = _modem(rate=300, interleave="long").demodulate(tx, autobaud=False)
    assert bytes(fixed.bits[: len(DATA)].numpy().astype(np.uint8)) == DATA


def test_sync_rejection_raises():
    with pytest.raises(ValueError, match="sync pattern"):
        _modem().demodulate(torch.zeros(4 * ms.SEGMENT_SYMS, dtype=torch.complex64))
    with pytest.raises(ValueError, match="sync pattern"):
        _modem().demodulate(torch.from_numpy(np.exp(2j * np.pi * np.random.default_rng(0)
                                                    .random(8 * ms.SEGMENT_SYMS))
                                             .astype(np.complex64)))
    with pytest.raises(ValueError, match="needs 480 symbols"):
        _modem().demodulate(torch.ones(100, dtype=torch.complex64))


def test_factory_and_educational_stages():
    wf = create_waveform("MIL-STD-188-110", 1000.0, device="cpu")  # raised to 9600 S/s
    assert isinstance(wf, ms.MilStd188110) and wf.device == CPU
    assert wf.common.sample_rate == 9600.0 and wf.samples_per_symbol() == 4
    assert create_waveform("188110", 48_000.0, device="cpu").samples_per_symbol() == 20
    assert isinstance(create_waveform("mil188110", device="cpu"), ms.MilStd188110)
    assert wf.info().bits_per_symbol == 2
    stages = dataclasses.replace(wf, rate=2400).get_modulation_stages(b"\x5a")
    assert [name for name, _ in stages] == ["input bits", "coded bits", "channel symbols",
                                            "modulated IQ"]
    np.testing.assert_array_equal(stages[1][1].numpy(), np.asarray(
        ref.MilStd188110(rate=2400)._coded_bits(stages[0][1])))


def test_interp_matches_numpy_inside_and_clamps_outside():
    xp = np.array([-16.0, 30.0, 70.0, 110.0, 150.0], np.float32)
    fp = np.array([0.3, -1.2, 0.8, 2.5, 2.4], np.float32)
    x = np.linspace(-40.0, 190.0, 301).astype(np.float32)
    got = ms.interp(torch.from_numpy(x), torch.from_numpy(xp), torch.from_numpy(fp)).numpy()
    # float32 rounding of the same formula: within a few ulps of 2.5
    np.testing.assert_allclose(got, np.interp(x, xp, fp), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jnp.interp(x, xp, fp)), rtol=0, atol=1e-6)
    assert got[0] == fp[0] and got[-1] == fp[-1]


def test_soft_demapper_and_packing_match_reference():
    from r4w_tpu.ops import modem as ref_modem
    from r4w_tpu.waveforms import linear_mod as ref_linear_mod

    rng = np.random.default_rng(4)
    sym = (rng.standard_normal(64) + 1j * rng.standard_normal(64)).astype(np.complex64)
    con = np.exp(2j * np.pi * np.arange(8) / 8).astype(np.complex64)
    want = np.asarray(ref_modem.soft_demap_llr(jnp.asarray(sym), jnp.asarray(con), 0.5))
    got = modem.soft_demap_llr(torch.from_numpy(sym), torch.from_numpy(con), 0.5)
    assert got.shape == (64, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(modem.hard_from_llr(torch.from_numpy(want.copy())).numpy(),
                                  np.asarray(ref_modem.hard_from_llr(jnp.asarray(want))))
    bits = rng.integers(0, 2, 21).astype(np.int32)
    np.testing.assert_array_equal(linear_mod.pack_demod_bits(torch.from_numpy(bits)).numpy(),
                                  np.asarray(ref_linear_mod.pack_demod_bits(jnp.asarray(bits))))
