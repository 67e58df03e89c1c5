"""The port's LoRa params, chirps and modem against ``r4w_tpu``'s.

Same numpy inputs through both packages; the JAX side runs on the CPU.
Hard decisions must be identical; floats agree within the stated bars.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.channel import awgn as ref_awgn
from r4w_tpu.ops import coding as ref_coding
from r4w_tpu.waveforms import lora as ref_lora
from r4w_tpu.waveforms.lora import chirp as ref_chirp
from r4w_tpu_torch.convert import WHITENING_BYTES, params_from_reference, tables_numpy
from r4w_tpu_torch.core.types import InvalidParameter
from r4w_tpu_torch.waveforms import lora
from r4w_tpu_torch.waveforms.lora import chirp

CONFIGS = [dict(sf=5), dict(sf=7), dict(sf=9, cr=3), dict(sf=12, cr=4),
           dict(sf=7, oversample=4), dict(sf=8, bw_hz=500_000, preamble_length=12)]


def _params(**kw):
    return lora.LoRaParams(**kw), ref_lora.LoRaParams(**kw)


def _demod_agrees(port, reference, rx_np, params):
    """Identical decisions; where a decision differs, the top two powers of
    that symbol must be a near tie (< 1e-5 relative)."""
    syms, ref_syms = port.symbols.numpy(), np.asarray(reference.symbols)
    diff = np.argwhere(syms != ref_syms)
    if diff.size:
        n = params.samples_per_symbol
        frames = rx_np.reshape(*rx_np.shape[:-1], -1, n)
        down = np.asarray(ref_chirp.base_downchirp(
            ref_lora.LoRaParams(sf=params.sf, oversample=params.oversample)))
        for idx in map(tuple, diff):
            mixed = (frames[idx] * down)[:: params.oversample]
            top2 = np.sort(np.abs(np.fft.fft(mixed.astype(np.complex128))) ** 2)[-2:]
            assert (top2[1] - top2[0]) / top2[1] < 1e-5, idx
    else:
        np.testing.assert_array_equal(port.payload.numpy(), np.asarray(reference.payload))


@pytest.mark.parametrize("kw", CONFIGS)
def test_params_and_derived_values_equal_reference(kw):
    p, rp = _params(**kw)
    assert dataclasses.asdict(p) == dataclasses.asdict(rp)
    assert params_from_reference(rp) == p
    for name in ("chips_per_symbol", "samples_per_symbol", "sample_rate", "symbol_duration",
                 "chip_duration", "sample_duration", "bits_per_symbol", "codeword_bits"):
        assert getattr(p, name) == getattr(rp, name), name
    assert p.bit_rate() == rp.bit_rate()
    assert p.snr_threshold() == rp.snr_threshold()
    assert p.n_preamble_samples() == rp.n_preamble_samples()
    for n_bytes in (1, 5, 16, 255):
        assert p.n_payload_symbols(n_bytes) == rp.n_payload_symbols(n_bytes)
        assert p.time_on_air(n_bytes) == rp.time_on_air(n_bytes)


@pytest.mark.parametrize("kw", [dict(sf=4), dict(sf=13), dict(bw_hz=200_000), dict(cr=0),
                                dict(oversample=0)])
def test_invalid_params_raise(kw):
    with pytest.raises(InvalidParameter):
        lora.LoRaParams(**kw)


@pytest.mark.parametrize("kw", CONFIGS)
def test_tables_equal_reference(kw):
    p, _ = _params(**kw)
    up, down = ref_chirp._base_chirps_np(p.sf, p.bw_hz, p.oversample)
    tables = tables_numpy(p)
    np.testing.assert_array_equal(tables["upchirp"], up)
    np.testing.assert_array_equal(tables["downchirp"], down)
    enc, dec = ref_coding._hamming_tables(p.cr)
    np.testing.assert_array_equal(tables["hamming_encode"], enc)
    np.testing.assert_array_equal(tables["hamming_decode"], dec)
    np.testing.assert_array_equal(tables["whitening"],
                                  ref_coding._whitening_sequence(WHITENING_BYTES))
    np.testing.assert_array_equal(chirp.base_upchirp(p, device="cpu").numpy(), up)
    np.testing.assert_array_equal(chirp.base_downchirp(p, device="cpu").numpy(), down)


@pytest.mark.parametrize("kw", [dict(sf=7), dict(sf=9), dict(sf=12), dict(sf=7, oversample=2)])
def test_symbol_chirps_match_reference_gather(kw):
    p, rp = _params(**kw)
    syms = np.random.default_rng(p.sf).integers(0, p.chips_per_symbol, (2, 5)).astype(np.int32)
    got = chirp.symbol_chirps(p, torch.from_numpy(syms)).numpy()
    want = np.asarray(ref_chirp.symbol_chirps(rp, jnp.asarray(syms), method="gather"))
    assert got.shape == want.shape == (2, 5, p.samples_per_symbol)
    assert np.max(np.abs(got - want)) <= 1e-6


@pytest.mark.parametrize("kw", [dict(sf=7), dict(sf=5), dict(sf=8, oversample=2)])
def test_preamble_and_instantaneous_frequency_match_reference(kw):
    p, rp = _params(**kw)
    pre = chirp.preamble(p, device="cpu")
    np.testing.assert_array_equal(pre.numpy(), np.asarray(ref_chirp.preamble(rp)))
    freq = chirp.instantaneous_frequency(p, pre[: 4 * p.samples_per_symbol]).numpy()
    ref_freq = np.asarray(ref_chirp.instantaneous_frequency(
        rp, jnp.asarray(pre[: 4 * p.samples_per_symbol].numpy())))
    np.testing.assert_allclose(freq, ref_freq, rtol=0, atol=0.05)  # Hz, f32 angle noise


@pytest.mark.parametrize("cr", range(1, 5))
@pytest.mark.parametrize("sf", range(7, 13))
def test_encode_decode_symbols_equal_reference(sf, cr):
    p, rp = _params(sf=sf, cr=cr)
    rng = np.random.default_rng(sf * 10 + cr)
    payload = rng.integers(0, 256, (2, 11)).astype(np.int32)
    syms = lora.encode_symbols(p, torch.from_numpy(payload))
    np.testing.assert_array_equal(syms.numpy(),
                                  np.asarray(ref_lora.encode_symbols(rp, jnp.asarray(payload))))
    noisy = rng.integers(0, p.chips_per_symbol, syms.shape).astype(np.int32)
    for s in (syms.numpy(), noisy):
        got = lora.decode_symbols(p, torch.from_numpy(s))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(ref_lora.decode_symbols(rp, jnp.asarray(s))))


@pytest.mark.parametrize("cr", range(1, 5))
@pytest.mark.parametrize("sf", range(7, 13))
def test_clean_roundtrip(sf, cr):
    p = lora.LoRaParams(sf=sf, cr=cr)
    payload = torch.tensor([0xAB, 0xCD, 0xEF, 0x12, 0x34], dtype=torch.int32)
    tx = lora.modulate(p, payload, include_preamble=False, device="cpu")
    assert tx.dtype == torch.complex64
    assert tx.shape == (p.n_payload_symbols(5) * p.samples_per_symbol,)
    result = lora.demodulate(p, tx)
    assert torch.equal(result.payload[:5], payload)


@pytest.mark.parametrize("kw", [dict(sf=7), dict(sf=12, cr=2), dict(sf=7, oversample=4)])
def test_modulate_equals_reference(kw):
    p, rp = _params(**kw)
    payload = np.arange(7, dtype=np.int32) * 37 % 256
    for pre in (True, False):
        np.testing.assert_array_equal(
            lora.modulate(p, torch.from_numpy(payload), include_preamble=pre,
                          device="cpu").numpy(),
            np.asarray(ref_lora.modulate(rp, jnp.asarray(payload), include_preamble=pre)))
    batch = np.stack([payload, payload[::-1]])
    tx = lora.modulate(p, torch.from_numpy(batch), device="cpu")
    for row, single in zip(tx, batch):
        np.testing.assert_array_equal(row.numpy(),
                                      np.asarray(ref_lora.modulate(rp, jnp.asarray(single))))


@pytest.mark.parametrize("kw,snr_db", [(dict(sf=7), -6.0), (dict(sf=9), -12.0),
                                       (dict(sf=12), -20.0), (dict(sf=7, oversample=2), -8.0),
                                       (dict(sf=8, cr=4), -9.0)])
def test_demodulate_reference_iq_identical(kw, snr_db):
    """JAX-modulated, JAX-noised IQ: identical symbols and payload, SNR to 1e-3 dB."""
    p, rp = _params(**kw)
    payload = jnp.asarray(np.random.default_rng(p.sf).integers(0, 256, 12), jnp.int32)
    tx = ref_lora.modulate(rp, payload, include_preamble=False)
    keys = jax.random.split(jax.random.key(p.sf), 3)
    rx = np.stack([np.asarray(ref_awgn(k, tx, snr_db)) for k in keys])  # (3, S·N)
    reference = ref_lora.demodulate(rp, jnp.asarray(rx))
    port = lora.demodulate(p, torch.from_numpy(rx))
    assert port.symbols.shape == reference.symbols.shape
    _demod_agrees(port, reference, rx, p)
    np.testing.assert_allclose(port.snr_db.numpy(), np.asarray(reference.snr_db),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(port.magnitude.numpy(), np.asarray(reference.magnitude),
                               rtol=1e-4)
