"""The port's LoRa coding chain against ``r4w_tpu.ops.coding``: exactly equal.

Inputs come from numpy with a fixed seed and go through both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.ops import coding as ref
from r4w_tpu_torch.ops import coding

SFS = range(5, 13)
CRS = range(1, 5)


def _same(port: torch.Tensor, reference) -> None:
    assert port.dtype == torch.int32
    np.testing.assert_array_equal(port.numpy(), np.asarray(reference))


@pytest.mark.parametrize("cr", CRS)
def test_hamming_tables_equal_reference(cr):
    enc, dec = coding._hamming_tables(cr)
    ref_enc, ref_dec = ref._hamming_tables(cr)
    np.testing.assert_array_equal(enc, ref_enc)
    np.testing.assert_array_equal(dec, ref_dec)
    lut_enc, lut_dec = coding._hamming_luts(cr, torch.device("cpu"))
    np.testing.assert_array_equal(lut_enc.numpy(), ref_enc)
    np.testing.assert_array_equal(lut_dec.numpy(), ref_dec)


@pytest.mark.parametrize("n_bytes", [1, 16, 255])
def test_whitening_sequence_equal_reference(n_bytes):
    np.testing.assert_array_equal(coding._whitening_sequence(n_bytes),
                                  ref._whitening_sequence(n_bytes))
    _same(coding.whitening_sequence(n_bytes, device="cpu"), ref.whitening_sequence(n_bytes))


def test_gray_equal_reference():
    x = np.random.default_rng(0).integers(0, 1 << 12, size=(3, 50)).astype(np.int32)
    _same(coding.gray_encode(torch.from_numpy(x)), ref.gray_encode(jnp.asarray(x)))
    _same(coding.gray_decode(torch.from_numpy(x)), ref.gray_decode(jnp.asarray(x)))
    _same(coding.gray_decode(coding.gray_encode(torch.from_numpy(x))), x)


@pytest.mark.parametrize("cr", CRS)
def test_hamming_encode_decode_equal_reference(cr):
    nibbles = np.arange(16, dtype=np.int32).reshape(2, 8)
    _same(coding.hamming_encode(torch.from_numpy(nibbles), cr),
          ref.hamming_encode(jnp.asarray(nibbles), cr))
    # every received word, corrupted ones included
    words = np.arange(1 << (4 + cr), dtype=np.int32)
    _same(coding.hamming_decode(torch.from_numpy(words), cr),
          ref.hamming_decode(jnp.asarray(words), cr))


def test_whiten_equal_reference():
    data = np.random.default_rng(1).integers(0, 256, size=(2, 37)).astype(np.int32)
    _same(coding.whiten(torch.from_numpy(data)), ref.whiten(jnp.asarray(data)))
    _same(coding.dewhiten(coding.whiten(torch.from_numpy(data))), data)


@pytest.mark.parametrize("cr", CRS)
@pytest.mark.parametrize("sf", SFS)
def test_interleave_equal_reference(sf, cr):
    rng = np.random.default_rng(sf * 10 + cr)
    cw = rng.integers(0, 1 << (4 + cr), size=(3, 2, sf)).astype(np.int32)
    got = coding.interleave(torch.from_numpy(cw), sf, cr)
    _same(got, ref.interleave(jnp.asarray(cw), sf, cr))
    syms = rng.integers(0, 1 << sf, size=(3, 2, 4 + cr)).astype(np.int32)
    _same(coding.deinterleave(torch.from_numpy(syms), sf, cr),
          ref.deinterleave(jnp.asarray(syms), sf, cr))
    _same(coding.deinterleave(got, sf, cr), cw)


@pytest.mark.parametrize("bits_per_symbol", [1, 2, 7, 12])
def test_packers_equal_reference(bits_per_symbol):
    rng = np.random.default_rng(bits_per_symbol)
    data = rng.integers(0, 256, size=(2, 6)).astype(np.int32)
    t, j = torch.from_numpy(data), jnp.asarray(data)
    _same(coding.bytes_to_nibbles(t), ref.bytes_to_nibbles(j))
    _same(coding.nibbles_to_bytes(coding.bytes_to_nibbles(t)),
          ref.nibbles_to_bytes(ref.bytes_to_nibbles(j)))
    bits = coding.bytes_to_bits(t)
    _same(bits, ref.bytes_to_bits(j))
    _same(coding.bits_to_bytes(bits), data)
    sym_bits = rng.integers(0, 2, size=(2, 3 * bits_per_symbol)).astype(np.int32)
    symbols = coding.bits_to_symbols(torch.from_numpy(sym_bits), bits_per_symbol)
    _same(symbols, ref.bits_to_symbols(jnp.asarray(sym_bits), bits_per_symbol))
    _same(coding.symbols_to_bits(symbols, bits_per_symbol),
          ref.symbols_to_bits(jnp.asarray(np.asarray(symbols)), bits_per_symbol))
