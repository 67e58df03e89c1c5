"""The big-grid PCPS bench's inputs and iteration against ``bench.py``'s.

`bench.py:bench_pcps_gcorr` builds its inputs and loop body inside the
function; this test rebuilds them from the same lines with ``jnp`` and
holds `entry.gcorr_inputs` and `entry.gcorr_step` to them: the carriers
and code transforms within float32 rounding, and the (50, 41, 1023)
correlation surface within 1e-4 of its peak over three chained
iterations. The bench itself times on a card (``cuda``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.gnss import prn as ref_prn
from r4w_tpu_torch.entry import (GCORR_DOPPLER_BINS, GCORR_LAGS, GCORR_NFFT, GCORR_SLOTS,
                                 gcorr_inputs, gcorr_step, pcps_gcorr_bench)

REL_TOL = 1e-4  # surface, max|Δ| / max(reference)


def _reference_inputs():
    """bench.py:731-766's inputs, line for line."""
    fs, n = 1.023e6, 1023
    prns = [1 + (p % 32) for p in range(50)]
    codes = np.stack([np.asarray(ref_prn.gps_ca_code(p)) for p in prns]).astype(np.float32)
    rng = np.random.default_rng(0)
    re = rng.standard_normal((2 * n,), dtype=np.float32)
    im = rng.standard_normal((2 * n,), dtype=np.float32)
    dops = jnp.arange(41, dtype=jnp.float32) * 250.0 - 5000.0
    t = jnp.arange(2 * n, dtype=jnp.float32) / fs
    ang = -2.0 * np.pi * dops[:, None] * t[None, :]
    carriers = jnp.cos(ang) + 1j * jnp.sin(ang)
    code_fft = jnp.conj(jnp.fft.fft(jnp.asarray(codes).astype(jnp.complex64), 4096, axis=-1))
    return re + 1j * im, carriers.astype(jnp.complex64), code_fft


def _reference_step(x, carriers, code_fft):
    """bench.py's loop body, returning the surface beside the next x."""
    mixed = x[None, :] * carriers
    mf = jnp.fft.fft(mixed, 4096, axis=-1)
    surf = jnp.fft.ifft(mf[None] * code_fft[:, None, :], axis=-1)[..., :1023]
    pw = surf.real ** 2 + surf.imag ** 2
    return x * (1.0 + 1e-12 * jnp.max(pw)), pw


def test_inputs_match_the_reference():
    x, carriers, code_fft = gcorr_inputs("cpu")
    rx, rcar, rfft = _reference_inputs()
    assert (GCORR_SLOTS, GCORR_DOPPLER_BINS, GCORR_LAGS, GCORR_NFFT) == (50, 41, 1023, 4096)
    assert x.shape == (2046,) and carriers.shape == (41, 2046) and code_fft.shape == (50, 4096)
    np.testing.assert_array_equal(x.numpy(), rx.astype(np.complex64))
    np.testing.assert_allclose(carriers.numpy(), np.asarray(rcar), rtol=0, atol=1e-6)
    rfft = np.asarray(rfft)
    assert float(np.max(np.abs(code_fft.numpy() - rfft))) <= 1e-6 * float(np.max(np.abs(rfft)))
    assert abs(float(code_fft[0, 0].real)) == 1.0  # PRN 1's chips sum to -1


def test_three_chained_iterations_match_jnp_fft():
    x, carriers, code_fft = gcorr_inputs("cpu")
    rx, rcar, rfft = _reference_inputs()
    rx = jnp.asarray(rx.astype(np.complex64))
    for _ in range(3):
        x, power = gcorr_step(x, carriers, code_fft)
        rx, rpower = _reference_step(rx, rcar, rfft)
        rpower = np.asarray(rpower)
        assert power.shape == rpower.shape == (50, 41, 1023) and power.dtype == torch.float32
        assert float(np.max(np.abs(power.numpy() - rpower))) / rpower.max() < REL_TOL
    np.testing.assert_allclose(x.numpy(), np.asarray(rx), rtol=1e-6, atol=1e-6)
    # the surface is a correlation: the peak lag of slot 0 at the zero-Doppler bin
    # is where the code best matches the noise, the same in both
    assert int(power[0, 20].argmax()) == int(rpower[0, 20].argmax())


def test_bench_needs_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        pcps_gcorr_bench("cpu")


@pytest.mark.cuda
def test_bench_on_card_few_iterations():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the bench times with CUDA events")
    out = pcps_gcorr_bench(iters=8)
    assert out["gcorr_per_s"] > 0 and out["iters"] == 8 and np.isfinite(out["energy"])
    x, carriers, code_fft = gcorr_inputs("cuda")
    _, power = gcorr_step(x, carriers, code_fft)
    _, want = gcorr_step(*(t.cpu() for t in (x, carriers, code_fft)))
    assert float((power.cpu() - want).abs().max() / want.max()) < REL_TOL
