"""The port's AWGN against ``r4w_tpu.channel.awgn``.

JAX's threefry and torch's Philox give different noise, so parity injects
JAX's own noise; the generator path is checked for reproducibility and
for its variance.
"""

import jax
import numpy as np
import pytest
import torch

from r4w_tpu.channel import channel as ref
from r4w_tpu.core import types as ref_types
from r4w_tpu_torch.channel import awgn
from r4w_tpu_torch.core import types

REL_TOL = 1e-5


def _samples(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    return float(np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("kw", [dict(), dict(path_loss_db=6.0), dict(measured_power=2.5)])
@pytest.mark.parametrize("snr_db", [-10.0, 0.0, 12.5])
def test_awgn_with_injected_noise_matches_reference(snr_db, kw):
    x = _samples((3, 256))
    key = jax.random.key(7)
    noise = np.array(ref._complex_normal(key, x.shape, 1.0))
    want = ref.awgn(key, x, snr_db, **kw)
    got = awgn(torch.from_numpy(x), snr_db, noise=torch.from_numpy(noise), **kw)
    assert got.dtype == torch.complex64 and got.shape == x.shape
    assert _rel(got, want) < REL_TOL


def test_awgn_batched_snr_matches_reference():
    x = _samples((4, 512), seed=1)
    snrs = np.array([-20.0, -5.0, 0.0, 30.0], np.float32)[:, None]  # broadcasts to (4, 1)
    key = jax.random.key(3)
    noise = np.array(ref._complex_normal(key, x.shape, 1.0))
    want = ref.awgn(key, x, snrs)
    got = awgn(torch.from_numpy(x), torch.from_numpy(snrs), noise=torch.from_numpy(noise))
    assert _rel(got, want) < REL_TOL


def test_awgn_lanes_by_snrs_grid_broadcasts_noise():
    """(lanes, 1, N) noise and (SNRs, 1) SNRs serve a (lanes, SNRs, N) grid in one call."""
    x = _samples((64,), seed=2)
    keys = jax.random.split(jax.random.key(5), 3)
    snrs = np.array([-4.0, 0.0], np.float32)
    noise = np.stack([np.asarray(ref._complex_normal(k, x.shape, 1.0)) for k in keys])
    got = awgn(torch.from_numpy(x).expand(3, 2, 64), torch.from_numpy(snrs)[:, None],
               noise=torch.from_numpy(noise)[:, None, :])
    assert got.shape == (3, 2, 64)
    for lane, k in enumerate(keys):
        for j, s in enumerate(snrs):
            assert _rel(got[lane, j], ref.awgn(k, x, s)) < REL_TOL


def test_awgn_generator_is_reproducible():
    x = torch.from_numpy(_samples((2, 1024)))
    a = awgn(x, 3.0, generator=torch.Generator().manual_seed(11))
    b = awgn(x, 3.0, generator=torch.Generator().manual_seed(11))
    c = awgn(x, 3.0, generator=torch.Generator().manual_seed(12))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_awgn_generator_noise_variance_within_three_sigma():
    x = torch.ones((64, 4096), dtype=torch.complex64)
    snr_db = 3.0
    noise = awgn(x, snr_db, generator=torch.Generator().manual_seed(0)) - x
    target = 10.0 ** (-snr_db / 10.0) / 2.0  # per component, signal power 1
    parts = torch.cat([noise.real.reshape(-1), noise.imag.reshape(-1)]).double()
    var = float(parts.var())
    assert abs(var - target) < 3.0 * target * np.sqrt(2.0 / parts.numel())
    assert abs(float(parts.mean())) < 3.0 * np.sqrt(target / parts.numel())


def test_awgn_needs_exactly_one_noise_source():
    x = torch.ones(8, dtype=torch.complex64)
    with pytest.raises(ValueError, match="exactly one"):
        awgn(x, 0.0)
    with pytest.raises(ValueError, match="exactly one"):
        awgn(x, 0.0, generator=torch.Generator(), noise=torch.zeros(8, dtype=torch.complex64))


def test_db_helpers_and_core_types_match_reference():
    db = np.array([-20.0, -3.0, 0.0, 7.5], np.float32)
    for name in ("db_to_linear_power", "db_to_linear_amplitude"):
        np.testing.assert_allclose(getattr(types, name)(db, device="cpu").numpy(),
                                   np.asarray(getattr(ref_types, name)(db)), rtol=1e-6)
    lin = np.array([1e-3, 0.5, 1.0, 1e4], np.float32)
    np.testing.assert_allclose(types.linear_power_to_db(lin, device="cpu").numpy(),
                               np.asarray(ref_types.linear_power_to_db(lin)), rtol=1e-6, atol=1e-5)
    sizes = (0, 1, 2, 3, 1000, 4096)
    assert [types.next_pow2(n) for n in sizes] == [ref_types.next_pow2(n) for n in sizes]
    assert (types.IQ_DTYPE, types.REAL_DTYPE, types.SYMBOL_DTYPE) == (
        torch.complex64, torch.float32, torch.int32)
    assert types.CommonParams() == types.CommonParams(**vars(ref_types.CommonParams()))
    err = types.BufferTooShort(4, 2)
    assert isinstance(err, types.DspError) and (err.expected, err.actual) == (4, 2)
    assert str(err) == str(ref_types.BufferTooShort(4, 2))
