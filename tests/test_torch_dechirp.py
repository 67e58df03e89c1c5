"""The port's dechirp-power kernel module against ``pallas_kernels.dechirp_power_mxu``.

On the CPU the module runs its plain PyTorch version, held here against
the Pallas kernel in interpret mode; the kernel's launch plan and a numpy
model of its Stockham FFT (the plan's passes, index maps and twiddles)
are checked here too. The CUDA kernel itself runs only on a card: its
tests are marked ``cuda`` and skip elsewhere.
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
MAX_THREADS, STATIC_SHARED_BYTES = 1024, 48 * 1024  # a Hopper block without opting in


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


@pytest.mark.parametrize("sf", range(5, 13))
def test_launch_plan_fits_a_hopper_block(sf):
    k = 1 << sf
    plan = dechirp.launch_plan(k)
    assert plan.rows_per_block >= 1
    assert plan.threads % 32 == 0 and plan.threads <= MAX_THREADS
    assert plan.threads * dechirp.POINTS == plan.rows_per_block * k  # 16 points a thread
    assert plan.smem_bytes <= STATIC_SHARED_BYTES
    assert np.prod(plan.radices) == k and max(plan.radices) <= dechirp.POINTS


def _dif_in_registers(v: np.ndarray, tw: np.ndarray) -> np.ndarray:
    """The kernel's radix-R DIF on axis 1 of v, complex64: v[:, s] ends as X[bit_reverse(s)]."""
    r, k = v.shape[1], tw.shape[0]
    v = v.copy()
    span = r // 2
    while span >= 1:
        for start in range(0, r, 2 * span):
            for t in range(span):
                a, b = v[:, start + t].copy(), v[:, start + t + span].copy()
                v[:, start + t] = a + b
                v[:, start + t + span] = (a - b) * (tw[t * (k // (2 * span))] if t else 1)
        span //= 2
    return v


def _stockham_model(x: np.ndarray, down: np.ndarray) -> np.ndarray:
    """numpy model of csrc/dechirp_power.cu: the plan's Stockham passes in complex64."""
    rows, k = x.shape
    tw = dechirp._twiddle_np(k)
    data = (x * down).astype(np.complex64)
    ns = 1
    for r in dechirp.launch_plan(k).radices:
        j = np.arange(k // r)
        v = data[:, j[None, :] + (k // r) * np.arange(r)[:, None]]  # (rows, r, butterflies)
        if ns > 1:
            w = tw[(j % ns) * (k // (ns * r))]
            power = w.copy()
            for i in range(1, r):
                v[:, i] *= power
                power = (power * w).astype(np.complex64)
        v = _dif_in_registers(v, tw)
        bits = r.bit_length() - 1
        out = np.empty_like(data)
        first = (j // ns) * ns * r + j % ns
        for s_ in range(r):
            q = int(format(s_, f"0{bits}b")[::-1], 2) if bits else 0
            out[:, first + q * ns] = v[:, s_]
        data, ns = out, ns * r
    return (data.real ** 2 + data.imag ** 2).astype(np.float32)


@pytest.mark.parametrize("sf", range(5, 13))
def test_stockham_model_matches_plain_version(sf):
    """The kernel's algorithm, run in numpy, within the kernel's bar of the plain version."""
    p, syms, x, down = _rows(sf, n_clean=8, n_noise=4)
    got = _stockham_model(x, down)
    want = dechirp.dechirp_power(torch.from_numpy(x), torch.from_numpy(down)).numpy()
    n = len(syms)
    for part in (slice(0, n), slice(n, None)):
        assert np.max(np.abs(got[part] - want[part])) / want[part].max() < REL_TOL
    np.testing.assert_array_equal(got[:n].argmax(-1), syms)


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


def _ragged_counts(sf: int):
    """Row counts that leave the kernel's last block ragged at this SF."""
    per_block = dechirp.launch_plan(1 << sf).rows_per_block
    return sorted({1, 3, 5, 5 * per_block + 3} | ({100_003} if sf == 7 else set()))


@pytest.mark.cuda
@pytest.mark.parametrize("sf", range(5, 13))
def test_kernel_on_ragged_blocks_on_card(sf):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    p = lora.LoRaParams(sf=sf)
    k = p.chips_per_symbol
    down = chirp.base_downchirp(p, device="cuda")
    rng = np.random.default_rng(100 + sf)
    for rows in _ragged_counts(sf):
        syms = torch.from_numpy(rng.integers(0, k, rows).astype(np.int32)).cuda()
        clean = chirp.symbol_chirps(p, syms)
        noise = rng.standard_normal((rows, k)) + 1j * rng.standard_normal((rows, k))
        noise = torch.from_numpy(noise.astype(np.complex64)).cuda()
        for x in (clean, noise):
            got, want = dechirp.dechirp_power_cuda(x, down), dechirp.dechirp_power(x, down)
            assert float((got - want).abs().max() / want.max()) < REL_TOL
        assert torch.equal(dechirp.dechirp_power_cuda(clean, down).argmax(-1).int(), syms)


@pytest.mark.cuda
def test_kernel_takes_a_view_off_16_byte_alignment_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    p, _, x, down = _rows(7)
    flat = torch.from_numpy(x).cuda().reshape(-1)
    rows, k = x.shape[0] - 1, x.shape[1]
    view = flat[1: 1 + rows * k].view(rows, k)  # starts 8 bytes past an allocation
    assert view.data_ptr() % 16 == 8
    dt = torch.from_numpy(down).cuda()
    got, want = dechirp.dechirp_power_dispatch(view, dt), dechirp.dechirp_power(view, dt)
    assert float((got - want).abs().max() / want.max()) < REL_TOL
