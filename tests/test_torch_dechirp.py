"""The port's dechirp-power kernel module against ``pallas_kernels.dechirp_power_mxu``.

On the CPU the module runs its plain PyTorch version, held here against
the Pallas kernel in interpret mode. The CUDA kernel itself runs only on
a card: its test is marked ``cuda`` and skips elsewhere.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.kernels import pallas_kernels
from r4w_tpu_torch.convert import tables_numpy
from r4w_tpu_torch.kernels import dechirp
from r4w_tpu_torch.waveforms import lora
from r4w_tpu_torch.waveforms.lora import chirp

REPO = Path(__file__).resolve().parents[1]
REL_TOL = 1e-4  # the bar of tests/test_kernels_sync_arq.py::test_dechirp_kernel_matches_fft


def _rows(sf: int, n_clean: int = 16, n_noise: int = 8):
    """Clean symbol chirps then complex Gaussian rows, (n_clean + n_noise, K)."""
    p = lora.LoRaParams(sf=sf)
    k = p.chips_per_symbol
    rng = np.random.default_rng(sf)
    syms = rng.integers(0, k, n_clean).astype(np.int32)
    clean = chirp.symbol_chirps(p, torch.from_numpy(syms)).numpy()
    noise = (rng.standard_normal((n_noise, k))
             + 1j * rng.standard_normal((n_noise, k))).astype(np.complex64)
    return p, syms, np.concatenate([clean, noise]), chirp.base_downchirp(p, device="cpu").numpy()


@pytest.mark.parametrize("sf", range(5, 10))
def test_plain_matches_pallas_interpret(sf):
    p, syms, x, down = _rows(sf)
    want = np.asarray(pallas_kernels.dechirp_power_mxu(jnp.asarray(x), jnp.asarray(down),
                                                       interpret=True))
    got = dechirp.dechirp_power(torch.from_numpy(x), torch.from_numpy(down)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    n = len(syms)
    for part in (slice(0, n), slice(n, None)):
        assert np.max(np.abs(got[part] - want[part])) / want[part].max() < REL_TOL
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_array_equal(got[:n].argmax(-1), syms)


@pytest.mark.parametrize("sf", [5, 9, 12])
def test_twiddle_table_matches_dft_mats(sf):
    """Entry (n·b) mod K of the kernel's twiddle table is _dft_mats(K)[n, b]."""
    k = 1 << sf
    twiddle = tables_numpy(lora.LoRaParams(sf=sf))["twiddle"]
    assert twiddle.dtype == np.complex64 and twiddle.shape == (k,)
    n = np.arange(0, k, max(1, k // 64))
    wr, wi = pallas_kernels._dft_mats(k)
    idx = np.outer(n, n) % k
    np.testing.assert_allclose(twiddle[idx].real, wr[np.ix_(n, n)], rtol=0, atol=1e-6)
    np.testing.assert_allclose(twiddle[idx].imag, wi[np.ix_(n, n)], rtol=0, atol=1e-6)


def test_cpu_tensor_runs_plain_version_and_launches_nothing():
    p, _, x, down = _rows(7)
    before = dechirp.dechirp_power.launches
    xt, dt = torch.from_numpy(x), torch.from_numpy(down)
    torch.testing.assert_close(dechirp.dechirp_power_dispatch(xt, dt),
                               dechirp.dechirp_power(xt, dt), rtol=0, atol=0)
    lora.demodulate_symbols(p, xt)
    assert dechirp.dechirp_power.launches == before


def test_demodulate_decimates_before_the_product_at_oversample():
    """x[::osf] · d[::osf] takes the same products as the reference's (x · d)[::osf]."""
    p = lora.LoRaParams(sf=7, oversample=4)
    x = chirp.symbol_chirps(p, torch.tensor([3, 77, 120], dtype=torch.int32))
    down = chirp.base_downchirp(p, device="cpu")
    # vectorised and strided complex products may round apart by one ulp
    torch.testing.assert_close(x[..., ::4] * down[::4], (x * down)[..., ::4], rtol=0, atol=2e-7)
    syms, _, _ = lora.demodulate_symbols(p, x)
    assert syms.tolist() == [3, 77, 120]


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    _, _, x, down = _rows(7)
    xt, dt = torch.from_numpy(x), torch.from_numpy(down)
    before = dechirp.dechirp_power.launches
    with pytest.raises(ValueError, match="CUDA"):
        dechirp.dechirp_power_cuda(xt, dt)
    with pytest.raises(ValueError, match="no dechirp_power path"):
        dechirp.dechirp_power_dispatch(xt.to("meta"), dt.to("meta"))
    assert dechirp.dechirp_power.launches == before


def test_module_imports_without_nvcc():
    code = ("import sys\n"
            "import r4w_tpu_torch.kernels.dechirp as d\n"
            "from r4w_tpu_torch.kernels import _build\n"
            "assert _build.load_library.cache_info().currsize == 0\n"
            "assert 'triton' not in sys.modules\n"
            "try:\n"
            "    _build._nvcc()\n"
            "except RuntimeError as e:\n"
            "    print('no nvcc:', e)\n"
            "else:\n"
            "    raise SystemExit('nvcc was found')\n")
    env = {**os.environ, "PATH": os.path.dirname(sys.executable), "CUDA_HOME": str(REPO / "absent"),
           "CUDA_PATH": str(REPO / "absent")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "no nvcc" in proc.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("sf", range(5, 13))
def test_kernel_matches_plain_on_card(sf):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    p, syms, x, down = _rows(sf)
    xt, dt = torch.from_numpy(x).cuda(), torch.from_numpy(down).cuda()
    before = dechirp.dechirp_power.launches
    got = dechirp.dechirp_power_cuda(xt, dt)
    want = dechirp.dechirp_power(xt, dt)
    torch.cuda.synchronize()
    assert dechirp.dechirp_power.launches == before + 1
    n = len(syms)
    for part in (slice(0, n), slice(n, None)):
        assert float((got[part] - want[part]).abs().max() / want[part].max()) < REL_TOL
    assert got[:n].argmax(-1).cpu().numpy().tolist() == syms.tolist()
