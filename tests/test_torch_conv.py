"""The port's convolutional codec against ``r4w_tpu.fec.convolutional``.

The same numpy-seeded inputs go through both packages. Encoder outputs,
decoded bits and the Viterbi kernels' plain versions must equal the
reference exactly: the reference's Pallas kernels run in interpret mode,
and its own bar is bit-exactness against the scan decoder
(tests/test_fec.py:279-337).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.fec import convolutional as ref
from r4w_tpu.kernels import pallas_kernels
from r4w_tpu_torch.convert import viterbi_tables_numpy
from r4w_tpu_torch.fec import convolutional
from r4w_tpu_torch.kernels import viterbi

CODES = {5: (0o23, 0o35), 7: (0o171, 0o133)}
RATE_THIRD = (0o171, 0o133, 0o165)  # K = 7, rate 1/3


def _noisy_soft(lanes, n_info, constraint=7, seed=7, sigma=0.4, polys=None):
    """Info bits and their soft values 1 - 2·coded + sigma·N(0, 1), float32."""
    rng = np.random.default_rng(seed)
    shape = (lanes, n_info) if lanes else (n_info,)
    bits = rng.integers(0, 2, shape).astype(np.int32)
    polys = CODES[constraint] if polys is None else polys
    coded = np.asarray(ref.conv_encode(jnp.asarray(bits), constraint, polys))
    soft = (1.0 - 2.0 * coded + sigma * rng.standard_normal(coded.shape)).astype(np.float32)
    return bits, soft


def _bm(soft: np.ndarray, constraint: int) -> np.ndarray:
    """The reference's (T, C, L) branch metrics of (L, T·2) soft values."""
    rx = jnp.asarray(soft).reshape(soft.shape[0], -1, 2)
    expected = jnp.asarray([[1.0, 1.0], [-1.0, 1.0], [1.0, -1.0], [-1.0, -1.0]])
    return np.array(jnp.einsum("ltr,cr->tcl", rx, expected))  # a writable copy


@pytest.mark.parametrize("constraint,polys", [(3, (0o7, 0o5)), (5, CODES[5]), (7, CODES[7]),
                                              (7, (0o171, 0o133, 0o165)), (8, (0o247, 0o371))])
def test_trellis_tables_equal_reference(constraint, polys):
    outputs, next_state = ref._trellis(constraint, polys)
    got = convolutional._trellis(constraint, polys)
    np.testing.assert_array_equal(got[0], outputs)
    np.testing.assert_array_equal(got[1], next_state)
    assert got[0].dtype == outputs.dtype and got[1].dtype == next_state.dtype
    tables = viterbi_tables_numpy(constraint, polys)
    np.testing.assert_array_equal(tables["outputs"], outputs)
    np.testing.assert_array_equal(tables["next_state"], next_state)
    masks, *_, w, _, _, _ = pallas_kernels._viterbi_consts(constraint, polys)
    np.testing.assert_array_equal(tables["code_index"], np.argmax(masks, axis=-1).T)
    assert tables["word_width"] == w


@pytest.mark.parametrize("terminate", [True, False])
@pytest.mark.parametrize("shape", [(57,), (4, 33)])
@pytest.mark.parametrize("constraint", [5, 7])
def test_conv_encode_equals_reference(constraint, shape, terminate):
    bits = np.random.default_rng(constraint).integers(0, 2, shape).astype(np.int32)
    want = np.asarray(ref.conv_encode(jnp.asarray(bits), constraint, CODES[constraint], terminate))
    got = convolutional.conv_encode(torch.from_numpy(bits), constraint, CODES[constraint],
                                    terminate)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_conv_encode_uses_no_integer_matmul(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("conv_encode must not reach a matrix product")

    bits = np.random.default_rng(1).integers(0, 2, (3, 40)).astype(np.int32)
    want = np.asarray(ref.conv_encode(jnp.asarray(bits)))
    monkeypatch.setattr(torch, "einsum", refuse)
    monkeypatch.setattr(torch, "matmul", refuse)
    monkeypatch.setattr(torch.Tensor, "__matmul__", refuse)
    np.testing.assert_array_equal(convolutional.conv_encode(torch.from_numpy(bits)).numpy(), want)


@pytest.mark.parametrize("steps,lanes", [(64, 128), (128, 256)])
@pytest.mark.parametrize("constraint", [5, 7])
def test_plain_kernels_equal_pallas_interpret(constraint, steps, lanes):
    polys = CODES[constraint]
    _, soft = _noisy_soft(lanes, steps - (constraint - 1), constraint, seed=steps + constraint)
    bm = _bm(soft, constraint)
    assert bm.shape == (steps, 4, lanes)
    want_dec, want_final = pallas_kernels.viterbi_forward(jnp.asarray(bm), constraint, polys,
                                                          interpret=True)
    want_dec, want_final = np.asarray(want_dec), np.asarray(want_final)
    dec, final = viterbi.viterbi_forward(torch.from_numpy(bm), constraint, polys)
    assert dec.dtype == torch.int32 and final.dtype == torch.float32
    np.testing.assert_array_equal(dec.numpy(), want_dec)
    reached = want_final > -1e8
    np.testing.assert_array_equal(final.numpy()[reached], want_final[reached])
    want_bits = np.asarray(pallas_kernels.viterbi_traceback(jnp.asarray(want_dec), constraint,
                                                            polys, interpret=True))
    bits = viterbi.viterbi_traceback(torch.from_numpy(want_dec.copy()), constraint, polys)
    np.testing.assert_array_equal(bits.numpy(), want_bits)


def test_branch_metrics_equal_reference_bit_for_bit():
    _, soft = _noisy_soft(6, 50)
    got = convolutional._branch_metrics(torch.from_numpy(soft).reshape(6, -1, 2))
    np.testing.assert_array_equal(got.numpy(), _bm(soft, 7))


def test_branch_metrics_equal_reference_bit_for_bit_at_rate_one_third():
    """Three products summed in generator order equal the reference decoder's
    einsum (r4w_tpu/fec/convolutional.py:130) bit for bit, on 64 × 4096
    soft triples."""
    _, soft = _noisy_soft(64, 4096 - 6, polys=RATE_THIRD, seed=31)
    rx = soft.reshape(64, -1, 3)
    assert rx.shape == (64, 4096, 3)
    code_bits = (np.arange(8)[:, None] >> np.arange(3)[None, :]) & 1
    expected = jnp.asarray((1.0 - 2.0 * code_bits).astype(np.float32))
    want = np.asarray(jnp.einsum("...tr,cr->...tc", jnp.asarray(rx), expected))  # (L, T, C)
    got = convolutional._branch_metrics(torch.from_numpy(rx))  # (T, C, L)
    np.testing.assert_array_equal(got.numpy(), want.transpose(1, 2, 0))


@pytest.mark.parametrize("sigma,terminated", [(0.4, True), (1.0, False)])
def test_rate_one_third_decode_equals_reference(sigma, terminated):
    """K = 7 (0o171, 0o133, 0o165) soft decodes of 256 frames × 500 bits, the
    noisier one from the best final state, equal the reference's bit for bit."""
    bits, soft = _noisy_soft(256, 500, seed=33, sigma=sigma, polys=RATE_THIRD)
    want = np.asarray(ref.viterbi_decode(jnp.asarray(soft), 7, RATE_THIRD, soft=True,
                                         terminated=terminated))
    got = convolutional.viterbi_decode(torch.from_numpy(soft), 7, RATE_THIRD, soft=True,
                                       terminated=terminated)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if terminated:
        np.testing.assert_array_equal(got.numpy(), bits)  # mild noise: every bit corrected


@pytest.mark.parametrize("lanes,n_info", [(3, 250), (130, 505)])
def test_viterbi_decode_equals_reference(lanes, n_info):
    bits, soft = _noisy_soft(lanes, n_info)
    hard = (soft < 0).astype(np.int32)
    for received, is_soft in ((soft, True), (hard, False)):
        for terminated in (True, False):
            want = np.asarray(ref.viterbi_decode(jnp.asarray(received), soft=is_soft,
                                                 terminated=terminated))
            got = convolutional.viterbi_decode(torch.from_numpy(received), soft=is_soft,
                                               terminated=terminated)
            assert got.dtype == torch.int32 and got.shape == want.shape
            np.testing.assert_array_equal(got.numpy(), want)
    got = convolutional.viterbi_decode_mxu(torch.from_numpy(soft), soft=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.viterbi_decode(jnp.asarray(soft),
                                                                             soft=True)))
    np.testing.assert_array_equal(got.numpy(), bits)  # noise mild enough to fully correct


def test_viterbi_decode_other_trellis_and_1d():
    bits, soft = _noisy_soft(0, 180, constraint=5, seed=8, sigma=0.0)
    coded = (soft < 0).astype(np.int32)
    want = np.asarray(ref.viterbi_decode_mxu(jnp.asarray(coded), 5, CODES[5]))
    got = convolutional.viterbi_decode_mxu(torch.from_numpy(coded), 5, CODES[5])
    assert got.shape == (180,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), bits)
    _, noisy = _noisy_soft(0, 180, constraint=5, seed=9)
    np.testing.assert_array_equal(
        convolutional.viterbi_decode(torch.from_numpy(noisy), 5, CODES[5], soft=True).numpy(),
        np.asarray(ref.viterbi_decode(jnp.asarray(noisy), 5, CODES[5], soft=True)))


@pytest.mark.parametrize("pattern", [[1, 1, 0, 1], [1, 0], [1, 1, 1, 0, 0, 1]])
def test_puncture_and_depuncture_equal_reference(pattern):
    coded = np.random.default_rng(2).integers(0, 2, (3, 48)).astype(np.int32)
    want = np.asarray(ref.puncture(jnp.asarray(coded), pattern))
    got = convolutional.puncture(torch.from_numpy(coded), pattern)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    soft = (1.0 - 2.0 * want).astype(np.float32)
    for fill in (0.0, 0.5):
        np.testing.assert_array_equal(
            convolutional.depuncture(torch.from_numpy(soft), pattern, 48, fill).numpy(),
            np.asarray(ref.depuncture(jnp.asarray(soft), pattern, 48, fill)))
