"""The port's FIR-decimate and NCO kernel modules against ``pallas_kernels``.

On the CPU each module runs its plain PyTorch version, held here against
the Pallas kernels in interpret mode (1-D, real for the FIR, as the
reference's kernels take) and against float64 numpy for what the port's
kernels add: complex input, a batch axis, K = 1, N < K and a filter's
state read before x. Both kernels' launch plans and numpy models of their
designs are checked here too: the FIR's register-blocked window slid
along polyphase planes staged from the state and x (two pointers), the
NCO's one carrier per column for a tile of rows. The CUDA
kernels run only on a card: their tests are marked ``cuda`` and skip
elsewhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.kernels import pallas_kernels
from r4w_tpu_torch.kernels import fir, nco

ABS_TOL_FIR = 1e-4  # tests/test_kernels_sync_arq.py::test_fir_decimate_kernel_matches_numpy
ABS_TOL_NCO = 1e-3  # tests/test_kernels_sync_arq.py::test_nco_mix_kernel
REL_TOL = 1e-5      # of max|y|: float32 sums of up to 64 terms against float64
MODEL_TOL = 2e-7    # of gain·max|x|: float32 products in another order, sin/cos within an ulp
MAX_GRID_Y = 65535


def _correlate(x: np.ndarray, taps: np.ndarray, factor: int) -> np.ndarray:
    """float64 reference: np.correlate(row, taps, 'valid')[::factor] per row."""
    rows = x.reshape(-1, x.shape[-1]).astype(np.complex128)
    out = [np.correlate(r, taps.astype(np.float64), "valid")[::factor] if len(r) >= len(taps)
           else np.zeros(0) for r in rows]
    return np.stack(out).reshape(*x.shape[:-1], -1)


def _noise(rng, shape, complex_: bool) -> np.ndarray:
    x = rng.standard_normal(shape)
    if complex_:
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(np.complex64 if complex_ else np.float32)


@pytest.mark.parametrize("n,k,factor", [(997, 31, 1), (997, 31, 4), (4096, 63, 8)])
def test_plain_fir_matches_pallas_interpret(n, k, factor):
    rng = np.random.default_rng(1)
    taps = rng.standard_normal(k).astype(np.float32)
    sig = rng.standard_normal(n).astype(np.float32)
    want = np.asarray(pallas_kernels.fir_decimate(jnp.asarray(sig), jnp.asarray(taps),
                                                  factor=factor, interpret=True))
    got = fir.fir_decimate(torch.from_numpy(sig), torch.from_numpy(taps), factor).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == ((n - k) // factor + 1,)
    assert np.max(np.abs(got - want)) < ABS_TOL_FIR
    assert np.max(np.abs(got - _correlate(sig, taps, factor).real)) < ABS_TOL_FIR


@pytest.mark.parametrize("shape,k,factor,complex_", [
    ((3, 500), 17, 3, True),      # complex, batched, ragged
    ((3, 1001), 64, 8, True),
    ((2, 2, 257), 9, 5, False),   # two batch axes
    ((1, 50), 1, 2, True),        # K = 1
    ((2, 31), 31, 4, True),       # N = K: one output
    ((2, 10), 31, 1, True),       # N < K: no outputs
    ((4, 300), 300, 1, False),
    ((2, 3000), 1025, 7, True),   # more taps than one staged chunk
])
def test_plain_fir_complex_batched_and_edges(shape, k, factor, complex_):
    rng = np.random.default_rng(k * factor)
    x = _noise(rng, shape, complex_)
    taps = rng.standard_normal(k).astype(np.float32)
    got = fir.fir_decimate(torch.from_numpy(x), torch.from_numpy(taps), factor).numpy()
    want = _correlate(x, taps, factor)
    assert got.dtype == x.dtype
    assert got.shape == shape[:-1] + (fir.n_outputs(shape[-1], k, factor),) == want.shape
    if want.size:
        assert np.max(np.abs(got - want)) <= REL_TOL * np.max(np.abs(want))


@pytest.mark.parametrize("n,k,factor,complex_,zero_state", [
    (500, 17, 3, True, False), (10, 31, 1, True, False),   # N < K - 1: the window is mostly state
    (300, 63, 8, False, True), (50, 1, 2, True, True)])    # zeros; K = 1: no state at all
def test_plain_fir_reads_the_state_before_x(n, k, factor, complex_, zero_state):
    rng = np.random.default_rng(n + k)
    x = _noise(rng, (2, n), complex_)
    taps = rng.standard_normal(k).astype(np.float32)
    state = np.zeros((2, k - 1), x.dtype) if zero_state else _noise(rng, (2, k - 1), complex_)
    got = fir.fir_decimate(torch.from_numpy(x), torch.from_numpy(taps), factor,
                           None if zero_state else torch.from_numpy(state),
                           zero_state=zero_state).numpy()
    want = _correlate(np.concatenate([state, x], axis=-1), taps, factor)
    assert got.shape == (2, fir.n_outputs(n + k - 1, k, factor)) == want.shape
    assert np.max(np.abs(got - want)) <= REL_TOL * np.max(np.abs(want))


def test_fir_state_must_match_the_block():
    x, taps = torch.zeros(2, 64, dtype=torch.complex64), torch.ones(5)
    for bad in (torch.zeros(2, 3, dtype=torch.complex64), torch.zeros(1, 4, dtype=torch.complex64),
                torch.zeros(2, 4)):
        with pytest.raises(ValueError, match="state must be"):
            fir.fir_decimate(x, taps, 2, bad)
        with pytest.raises(ValueError, match="state must be"):
            fir.fir_decimate_dispatch(x, taps, 2, bad)
    with pytest.raises(ValueError, match="not both"):
        fir.fir_decimate(x, taps, 2, torch.zeros(2, 4, dtype=torch.complex64), zero_state=True)


@pytest.mark.parametrize("n_out,k,factor,sample_bytes", [
    (1 << 17, 63, 8, 8), (1 << 20, 63, 1, 8),   # the DDC's FIR and the dense filter
    (1 << 20, 63, 1, 4), (1000, 4, 8, 8),       # real samples; K < f
    (10, 4, 32, 4), (3, 1025, 7, 8),            # K < f; K > one chunk of taps
    (1, 300, 2, 4), (5, 1, 1, 8), (0, 31, 1, 8),
    (1 << 16, 4096, 64, 8), (7, 257, 1, 8)])
def test_fir_plan_fits_and_covers_every_output_once(n_out, k, factor, sample_bytes):
    plan = fir.fir_plan(k, factor, sample_bytes)
    r = fir.REGISTER_BLOCK
    assert r % 2 == 1  # odd: the lanes' loads at a stride of r hit distinct banks
    assert plan.threads in fir.THREADS and plan.threads % 32 == 0
    assert 1 <= plan.chunk <= min(k, fir.MAX_CHUNK)
    q = -(-plan.chunk // factor)
    block_out = plan.threads * r
    # a plane holds every entry a thread's window reads, and the block's outputs
    assert plan.entries == block_out + q - 1 >= block_out
    assert _smem_layout(plan.chunk, factor, plan.entries, sample_bytes)[2] == plan.smem
    assert plan.smem <= fir.SMEM_BUDGET
    # the kernel's tiles of block_out outputs cover the outputs, none but the last ragged
    tiles = max(1, -(-n_out // block_out))
    assert (tiles - 1) * block_out < max(n_out, 1) <= tiles * block_out and tiles < 2 ** 31
    # the largest block that fits: the next size up would not (or there is none)
    bigger = [t for t in fir.THREADS if t > plan.threads]
    if bigger and plan.chunk == min(k, fir.MAX_CHUNK):
        entries = min(bigger) * r + q - 1
        assert _smem_layout(plan.chunk, factor, entries, sample_bytes)[2] > fir.SMEM_BUDGET


def test_fir_plan_at_the_ddc_shapes():
    """37 KB blocks of 64 threads at f = 8 and 19 KB blocks of 256 at f = 1
    (several resident on an SM hide each other's loads); one pass over the
    63 taps in both."""
    assert fir.fir_plan(63, 8, 8) == (64, 63, 583, 37568)
    assert fir.fir_plan(63, 1, 8) == (256, 63, 2366, 19184)


def _smem_layout(chunk: int, factor: int, entries: int, sample_bytes: int):
    """csrc/fir_decimate.cu's shared memory for a chunk of taps: per
    polyphase plane, its taps padded to a multiple of STEP, then `entries`
    window samples. Returns (planes, the taps' stride, bytes)."""
    planes, q = min(factor, chunk), -(-chunk // factor)
    stride = -(-q // fir.STEP) * fir.STEP
    return planes, stride, planes * (4 * stride + sample_bytes * entries)


def _first_entry(d: int, f: int, planes: int, total: int) -> int:
    """csrc/fir_decimate.cu first_entry: the first window entry g = e·planes + p
    whose stream offset e·f + p is at least d, or `total`."""
    if d <= 0:
        return 0
    e, rem = divmod(d, f)
    return min(e * planes + rem if rem < planes else (e + 1) * planes, total)


def _stage_walk(nt: int, g_lo: int, g_hi: int, planes: int, f: int, entries: int, first: int):
    """csrc/fir_decimate.cu stage: every thread's walk over its entries of
    [g_lo, g_hi), (e, p) and both addresses stepped with one carry. Returns
    the shared-memory index and the source index of each entry staged."""
    dsts, ats = [], []
    de, dp = divmod(nt, planes)
    for tid in range(nt):
        g = g_lo + (tid - g_lo % nt + nt) % nt
        if g >= g_hi:
            continue
        e, p = divmod(g, planes)
        dst, at = p * entries + e, first + e * f + p
        while g < g_hi:
            assert (dst, at) == ((g % planes) * entries + g // planes,
                                 first + (g // planes) * f + g % planes)
            dsts.append(dst)
            ats.append(at)
            dst, at, p = dst + dp * entries + de, at + de * f + dp, p + dp
            if p >= planes:
                p, dst, at = p - planes, dst + 1 - planes * entries, at + f - planes
            g += nt
    return np.asarray(dsts, np.int64), np.asarray(ats, np.int64)


def _fir_model(x: np.ndarray, taps: np.ndarray, factor: int, state=None,
               zero_state=False) -> np.ndarray:
    """numpy model of csrc/fir_decimate.cu under `fir.fir_plan`, in float32.

    Per tile of threads · r outputs (r = REGISTER_BLOCK) and per chunk of
    taps, in the shared memory the plan gives: stage the window's
    polyphase planes (plane stride `entries`, every other entry NaN, so a
    read of one never staged poisons the result) in the kernel's three
    segments of stream order, each by the kernel's per-thread walk: the
    state (zeros for a null state pointer), x, zeros past the end; and the
    chunk's taps per plane padded to the step. Then each thread slides its
    register window of r + STEP - 1 entries along each plane, STEP taps a
    step, the last step cut to the plane's taps. Checks that every entry is
    staged once from inside its source and every output written once.
    """
    rows, n = x.shape
    k = len(taps)
    s = k - 1 if state is not None or zero_state else 0
    n_out = fir.n_outputs(s + n, k, factor)
    plan = fir.fir_plan(k, factor, x.itemsize)
    r, nt, step = fir.REGISTER_BLOCK, plan.threads, fir.STEP
    block_out = nt * r
    _, tap_stride, smem = _smem_layout(plan.chunk, factor, plan.entries, x.itemsize)
    assert smem <= plan.smem
    out = np.zeros((rows, n_out), x.dtype)
    writes = np.zeros((rows, n_out), np.int64)
    lanes = np.arange(nt) * r
    chunks = -(-k // plan.chunk)
    items = [(row, tile, c) for row in range(rows) for tile in range(-(-n_out // block_out))
             for c in range(chunks)]
    for row, tile, c in items:
        j0, t0 = tile * block_out, c * plan.chunk
        if c == 0:
            acc = np.zeros((nt, r), x.dtype)
        tn = min(plan.chunk, k - t0)
        planes = min(factor, tn)
        total = planes * (block_out + -(-tn // factor) - 1)
        assert total <= planes * plan.entries
        tap_s = np.zeros((planes, tap_stride), np.float32)
        for p in range(planes):
            q = np.arange(-(-(tn - p) // factor))
            tap_s[p, q] = taps[t0 + q * factor + p]
        base = j0 * factor + t0
        g_x = _first_entry(s - base, factor, planes, total)
        g_end = _first_entry(s + n - base, factor, planes, total)
        win = np.full(planes * plan.entries, np.nan, x.dtype)
        staged = np.zeros(planes * plan.entries, np.int64)
        for lo, hi, src, first in ((0, g_x, state, base), (g_x, g_end, x, base - s),
                                   (g_end, total, None, 0)):
            dst, at = _stage_walk(nt, lo, hi, planes, factor, plan.entries, first)
            staged[dst] += 1
            if src is None:
                win[dst] = 0
            else:
                assert ((0 <= at) & (at < src.shape[1])).all()
                win[dst] = src[row, at]
        assert staged.sum() == total and staged.max() == 1
        for p in range(planes):
            qn = -(-(tn - p) // factor)
            plane = win[p * plan.entries:]
            buf = [plane[lanes + i] for i in range(r - 1)] + [None] * step
            for q0 in range(0, qn, step):
                un = min(step, qn - q0)
                for u in range(un):
                    buf[r - 1 + u] = plane[lanes + r - 1 + q0 + u]
                for u in range(un):
                    for i in range(r):
                        acc[:, i] = acc[:, i] + tap_s[p, q0 + u] * buf[i + u]
                if un == step:
                    buf[:r - 1] = buf[step:step + r - 1]
        if c == chunks - 1:
            j = j0 + np.arange(block_out)
            keep = j < n_out
            out[row, j[keep]] = acc.reshape(block_out)[keep]
            writes[row, j[keep]] += 1
    assert (writes == 1).all()
    return out


@pytest.mark.parametrize("d,f,planes,total", [
    (0, 8, 8, 100), (-5, 8, 8, 100), (13, 8, 8, 100), (13, 8, 3, 100), (15, 8, 3, 100),
    (16, 8, 3, 100), (10 ** 12, 1, 1, 50), (7, 1, 1, 50), (62, 1, 1, 10)])
def test_first_entry_finds_the_segment_boundary(d, f, planes, total):
    """The smallest window entry (stream offset e·f + p, p < planes) at or past
    d, by brute force over the window."""
    offsets = [(g // planes) * f + g % planes for g in range(total)]
    want = next((g for g, o in enumerate(offsets) if o >= d), total)
    assert _first_entry(d, f, planes, total) == want


@pytest.mark.parametrize("rows,n,k,factor,complex_,state_kind", [
    (3, 997, 31, 1, True, "state"),      # tile 0's window straddles state and x
    (2, 4000, 63, 8, True, "zeros"),     # the DDC's filter, several tiles
    (2, 500, 17, 3, False, "none"),
    (2, 1000, 4, 8, True, "state"),      # K < f: planes with no taps are not staged
    (1, 1500, 300, 2, False, "state"),   # K > one chunk: two passes
    (1, 700, 1025, 7, True, "zeros"),    # five chunks
    (2, 10, 31, 1, True, "state"),       # N < K - 1
    (2, 50, 1, 2, True, "zeros"),        # K = 1: s = 0
    (2, 2100, 63, 1, True, "state"),
    (2, 2100, 63, 8, False, "zeros")])
def test_fir_model_equals_plain_version(rows, n, k, factor, complex_, state_kind):
    rng = np.random.default_rng(rows * n + k)
    x = _noise(rng, (rows, n), complex_)
    taps = rng.standard_normal(k).astype(np.float32)
    state = _noise(rng, (rows, k - 1), complex_) if state_kind == "state" else None
    got = _fir_model(x, taps, factor, state, state_kind == "zeros")
    want = fir.fir_decimate(torch.from_numpy(x), torch.from_numpy(taps), factor,
                            None if state is None else torch.from_numpy(state),
                            zero_state=state_kind == "zeros").numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if want.size:
        assert np.max(np.abs(got - want)) <= REL_TOL * np.max(np.abs(want))


@pytest.mark.parametrize("block,factor", [(512, 8), (24, 1), (10, 2)])
def test_fir_model_streams_blocks_with_carried_state(block, factor):
    """Blocks of x through the model, each with the state the filters carry
    (`_next_state`, from zeros; blocks shorter than K - 1 included), equal
    the plain version over the whole stream at once."""
    from r4w_tpu_torch.ops.filters import _next_state
    rng = np.random.default_rng(block)
    k = 31
    x = _noise(rng, (2, 4 * block), True)
    taps = rng.standard_normal(k).astype(np.float32)
    parts, state = [], None
    for chunk in np.split(x, 4, axis=-1):
        parts.append(_fir_model(chunk, taps, factor, state, zero_state=state is None))
        state = _next_state(None if state is None else torch.from_numpy(state),
                            torch.from_numpy(chunk), k).numpy()
    want = fir.fir_decimate(torch.from_numpy(x), torch.from_numpy(taps), factor,
                            zero_state=True).numpy()
    got = np.concatenate(parts, axis=-1)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= REL_TOL * np.max(np.abs(want))


@pytest.mark.parametrize("n,freq_hz,rate,phase0,gain", [
    (3000, 2500.0, 1e6, 1.0, 2.0),         # the reference test's case
    (1 << 16, -1e6 / 8, 1e6, 0.0, 1.0),    # f = -fs/8 at 2^16 samples
])
def test_plain_nco_matches_pallas_interpret(n, freq_hz, rate, phase0, gain):
    rng = np.random.default_rng(2)
    x = _noise(rng, (n,), True)
    want = np.asarray(pallas_kernels.nco_mix(jnp.asarray(x), freq_hz, rate, phase0=phase0,
                                             gain=gain, interpret=True))
    got = nco.nco_mix(torch.from_numpy(x), freq_hz, rate, phase0, gain).numpy()
    assert got.dtype == np.complex64 and got.shape == want.shape
    assert np.max(np.abs(got - want)) < ABS_TOL_NCO
    t = np.arange(n)
    exact = x * gain * np.exp(1j * (phase0 + 2 * np.pi * freq_hz / rate * t))
    if n <= 3000:  # float32 phase stays within 1e-3 rad of the exact one
        assert np.max(np.abs(got - exact)) < ABS_TOL_NCO


@pytest.mark.parametrize("freq_hz,rate,phase0", [
    (2500.0, 1e6, 1.0), (-30.72e6 / 8, 30.72e6, 0.0), (30.72e6 / 4, 30.72e6, 1.0),
    (-7.68e6, 30.72e6, 0.3)])
def test_nco_phase_takes_the_reference_roundings(freq_hz, rate, phase0):
    """ph = round(round(ω·float(n)) + φ₀) in float32, bit for bit, at 2^20
    samples, where a fused multiply-add would move it at some indices."""
    n = 1 << 20
    got = nco.nco_phase(n, freq_hz, rate, phase0, device="cpu").numpy()
    w, p0 = np.float32(2 * np.pi * freq_hz / rate), np.float32(phase0)
    want = np.arange(n, dtype=np.float32) * w + p0
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # the reference's own eager ops give the same bits
    ref = np.asarray(jnp.float32(p0) + jnp.float32(w) * jnp.arange(n, dtype=jnp.float32))
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    assert nco.omega(freq_hz, rate) == float(w)


@pytest.mark.parametrize("rows,n,aligned", [
    (1, 1 << 20, True), (64, 1 << 20, True), (17, 4097, True), (3, 4096, False), (1, 1, True),
    (5, 2, True), (16, 256, True), (17, 512, True), (2 ** 21, 4, True), (40, 6, False)])
def test_nco_plan_covers_every_sample_once(rows, n, aligned):
    plan = nco.nco_plan(rows, n, aligned)
    assert plan.pairs == (aligned and n % 2 == 0)  # pairs only when n is even and aligned
    assert nco.THREADS % 32 == 0 and plan.row_tile == nco.ROW_TILE
    per = 2 if plan.pairs else 1
    # the column blocks cover n, and none is empty
    assert (plan.blocks_x - 1) * nco.THREADS * per < n <= plan.blocks_x * nco.THREADS * per
    assert 1 <= plan.blocks_y <= MAX_GRID_Y and plan.blocks_x < 2 ** 31
    tiles = -(-rows // plan.row_tile)
    assert plan.blocks_y == min(tiles, MAX_GRID_Y)  # past it, the tiles are walked with a stride


def _nco_model(x: np.ndarray, freq_hz: float, rate: float, phase0: float, gain: float,
               aligned: bool) -> np.ndarray:
    """numpy model of csrc/nco_mix.cu under `nco.nco_plan`: each thread owns a
    column (or a column pair), computes its carrier once with the reference's
    float32 roundings, and applies it to the rows of every tile it walks
    (blockIdx.y, then strides of gridDim.y), the ragged tile masked. Checks
    that every sample is written exactly once."""
    rows, n = x.shape
    plan = nco.nco_plan(rows, n, aligned)
    per = 2 if plan.pairs else 1
    w, p0, g = np.float32(nco.omega(freq_hz, rate)), np.float32(phase0), np.float32(gain)
    out = np.zeros(x.shape, np.complex64)
    writes = np.zeros(x.shape, np.int64)
    item = np.arange(plan.blocks_x * nco.THREADS)
    cols = (item[:, None] * per + np.arange(per)[None, :]).reshape(-1)
    cols = cols[cols < n]
    ph = w * cols.astype(np.float32) + p0  # float32: the product rounded, then the sum
    c = np.cos(ph.astype(np.float64)).astype(np.float32)
    s = np.sin(ph.astype(np.float64)).astype(np.float32)
    for by in range(plan.blocks_y):
        for r0 in range(by * plan.row_tile, rows, plan.blocks_y * plan.row_tile):
            r = np.arange(r0, min(r0 + plan.row_tile, rows))
            v = x[np.ix_(r, cols)]
            out[np.ix_(r, cols)] = (g * (v.real * c - v.imag * s)
                                    + 1j * (g * (v.real * s + v.imag * c)))
            writes[np.ix_(r, cols)] += 1
    assert (writes == 1).all()
    return out


@pytest.mark.parametrize("rows,n,aligned,freq_hz,rate,phase0,gain", [
    (1, 3000, True, 2500.0, 1e6, 1.0, 2.0),          # one row: nothing to share
    (3, 4097, True, 0.25e6, 1e6, 1.0, 1.0),          # odd n: one column a thread
    (17, 1 << 12, True, -30.72e6 / 8, 30.72e6, 0.0, 1.0),  # a ragged tile of one row
    (17, 1 << 12, False, 30.72e6 / 4, 30.72e6, 0.3, 2.0),  # misaligned: one column a thread
    (16, 1 << 14, True, -7.68e6, 30.72e6, 0.0, 1.0),       # whole tiles, phases to 2.5e4
    (33, 999, True, 2500.0, 1e6, 0.5, 1.0),
    (2, 1 << 17, True, 30.72e6 / 4, 30.72e6, 1.0, 1.0),    # phases past 105,615 rad
])
def test_nco_model_equals_plain_version(rows, n, aligned, freq_hz, rate, phase0, gain):
    rng = np.random.default_rng(rows * n)
    x = _noise(rng, (rows, n), True)
    got = _nco_model(x, freq_hz, rate, phase0, gain, aligned)
    want = nco.nco_mix(torch.from_numpy(x), freq_hz, rate, phase0, gain).numpy()
    assert np.max(np.abs(got - want)) <= MODEL_TOL * gain * np.max(np.abs(x))


def test_nco_model_walks_row_tiles_past_the_grid(monkeypatch):
    """More row tiles than the grid holds: each block row walks every
    blocks_y-th tile (here 2 block rows for 9 tiles, the last one ragged)."""
    monkeypatch.setattr(nco, "MAX_GRID_Y", 2)
    rng = np.random.default_rng(5)
    x = _noise(rng, (70, 300), True)
    assert nco.nco_plan(70, 300, True).blocks_y == 2
    got = _nco_model(x, 1e3, 1e5, 0.25, 1.0, True)
    want = nco.nco_mix(torch.from_numpy(x), 1e3, 1e5, 0.25, 1.0).numpy()
    assert np.max(np.abs(got - want)) <= MODEL_TOL * np.max(np.abs(x))


def test_cpu_tensors_run_plain_versions_and_launch_nothing():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_noise(rng, (2, 400), True))
    taps = torch.from_numpy(rng.standard_normal(15).astype(np.float32))
    before = (fir.fir_decimate.launches, nco.nco_mix.launches)
    torch.testing.assert_close(fir.fir_decimate_dispatch(x, taps, 3),
                               fir.fir_decimate(x, taps, 3), rtol=0, atol=0)
    torch.testing.assert_close(nco.nco_mix_dispatch(x, 1e3, 1e5, 0.5, 2.0),
                               nco.nco_mix(x, 1e3, 1e5, 0.5, 2.0), rtol=0, atol=0)
    assert (fir.fir_decimate.launches, nco.nco_mix.launches) == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(2, 64, dtype=torch.complex64)
    taps = torch.ones(5)
    before = (fir.fir_decimate.launches, nco.nco_mix.launches)
    with pytest.raises(ValueError, match="CUDA"):
        fir.fir_decimate_cuda(x, taps, 2)
    with pytest.raises(ValueError, match="CUDA"):
        nco.nco_mix_cuda(x, 1e3, 1e5)
    with pytest.raises(ValueError, match="no fir_decimate path"):
        fir.fir_decimate_dispatch(x.to("meta"), taps.to("meta"), 2)
    with pytest.raises(ValueError, match="no nco_mix path"):
        nco.nco_mix_dispatch(x.to("meta"), 1e3, 1e5)
    with pytest.raises(ValueError, match="factor >= 1"):
        fir.fir_decimate(x, taps, 0)
    with pytest.raises(ValueError, match="K >= 1"):
        fir.fir_decimate(x, taps[:0], 1)
    assert (fir.fir_decimate.launches, nco.nco_mix.launches) == before


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,k,factor,complex_", [
    (1, 997, 31, 1, False), (3, 997, 31, 4, True), (64, 4109, 63, 8, True),
    (2, 4109, 1025, 2, False), (5, 3000, 4, 32, True), (1, 10, 31, 1, True)])
def test_fir_kernel_matches_plain_on_card(rows, n, k, factor, complex_):
    dev = _card()
    rng = np.random.default_rng(n + k)
    x = torch.from_numpy(_noise(rng, (rows, n), complex_)).to(dev)
    taps = torch.from_numpy(rng.standard_normal(k).astype(np.float32)).to(dev)
    before = fir.fir_decimate.launches
    got = fir.fir_decimate_cuda(x, taps, factor)
    want = fir.fir_decimate(x, taps, factor)
    torch.cuda.synchronize()
    n_out = fir.n_outputs(n, k, factor)
    assert fir.fir_decimate.launches == before + (1 if n_out else 0)
    assert got.shape == want.shape == (rows, n_out) and got.dtype == x.dtype
    if n_out:
        assert float((got - want).abs().max()) <= REL_TOL * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,k,factor,complex_", [
    (1, 997, 31, 1, False), (3, 997, 63, 8, True), (64, 4109, 63, 8, True),
    (2, 4109, 1025, 2, False), (5, 3000, 4, 32, True), (2, 10, 31, 1, True), (2, 30, 31, 3, True)])
@pytest.mark.parametrize("state_kind", ["state", "zeros", "offset"])
def test_fir_kernel_reads_the_state_beside_x_on_card(rows, n, k, factor, complex_, state_kind):
    """The state as a second pointer (also one 8 bytes off 16-byte alignment)
    or a null pointer read as zeros, against the plain version's concatenation;
    N < K - 1 included."""
    dev = _card()
    rng = np.random.default_rng(n + k + factor)
    x = torch.from_numpy(_noise(rng, (rows, n), complex_)).to(dev)
    taps = torch.from_numpy(rng.standard_normal(k).astype(np.float32)).to(dev)
    flat = torch.from_numpy(_noise(rng, (rows * (k - 1) + 1,), complex_)).to(dev)
    state = {"state": flat[:-1].view(rows, k - 1), "zeros": None,
             "offset": flat[1:].view(rows, k - 1)}[state_kind]
    before = fir.fir_decimate.launches
    got = fir.fir_decimate_cuda(x, taps, factor, state, zero_state=state is None)
    want = fir.fir_decimate(x, taps, factor, state, zero_state=state is None)
    torch.cuda.synchronize()
    assert fir.fir_decimate.launches == before + 1
    assert got.shape == want.shape == (rows, fir.n_outputs(n + k - 1, k, factor))
    assert float((got - want).abs().max()) <= REL_TOL * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,freq_hz,phase0,gain", [
    (1, 3000, 2500.0, 1.0, 2.0), (4, 1 << 20, -0.125e6, 0.0, 1.0), (3, 4097, 0.25e6, 1.0, 1.0)])
def test_nco_kernel_matches_plain_on_card(rows, n, freq_hz, phase0, gain):
    dev = _card()
    rng = np.random.default_rng(n)
    x = torch.from_numpy(_noise(rng, (rows, n), True)).to(dev)
    before = nco.nco_mix.launches
    got = nco.nco_mix_cuda(x, freq_hz, 1e6, phase0, gain)
    want = nco.nco_mix(x, freq_hz, 1e6, phase0, gain)
    odd = nco.nco_mix_cuda(x.reshape(-1)[1:].reshape(1, -1), freq_hz, 1e6)  # 8-byte aligned
    torch.cuda.synchronize()
    assert nco.nco_mix.launches == before + 2
    assert float((got - want).abs().max()) <= REL_TOL * gain * float(x.abs().max())
    want_odd = nco.nco_mix(x.reshape(-1)[1:].reshape(1, -1), freq_hz, 1e6)
    assert float((odd - want_odd).abs().max()) <= REL_TOL * float(x.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 4097])
@pytest.mark.parametrize("rows", [1, 3, 17, 64])
def test_nco_kernel_row_tiles_on_card(rows, n):
    """Row counts that are and are not a multiple of the tile, even n (column
    pairs) and odd n (one column a thread), and a view 8 bytes off 16-byte
    alignment, at phases past the slow-path threshold."""
    dev = _card()
    rng = np.random.default_rng(rows * n)
    base = torch.from_numpy(_noise(rng, (rows * n + 1,), True)).to(dev)
    freq, rate = 30.72e6 / 4, 30.72e6
    for x in (base[:-1].reshape(rows, n), base[1:].reshape(rows, n)):
        before = nco.nco_mix.launches
        got = nco.nco_mix_cuda(x, freq, rate, 1.0, 2.0)
        want = nco.nco_mix(x, freq, rate, 1.0, 2.0)
        torch.cuda.synchronize()
        assert nco.nco_mix.launches == before + 1
        assert float((got - want).abs().max()) <= REL_TOL * 2.0 * float(x.abs().max())
