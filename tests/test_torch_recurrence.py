"""The first-order recursions (`kernels.recurrence`) and the filters and
blocks that run on them (`filters.single_pole_iir`, `filters.dc_blocker`,
`filters2.de_emphasis`, `filters2.fm_deemphasis`, the stream probes, the
envelope followers, the peak hold, the IIR comb) against the JAX package's
``lax.scan`` versions on the same numpy inputs, made from seeds.

Each step rounds as the reference's compiled scan body, which contracts a
multiply and an add into one fused multiply-add, so on real float32 rows
the port equals JAX bit for bit (two coefficients each, several thousand
samples). Complex rows are two real recursions in the port; there the
tolerance is RECURSION_TOL of the largest reference magnitude. Within the
port, the plain step loop and a numpy model of the kernel's rounding are
equal bit for bit, and so are the kernel and the plain loop on the card
(`cuda`-marked).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.ops import filters as ref_filters
from r4w_tpu.ops import filters2 as ref_filters2
from r4w_tpu_torch.kernels import recurrence
from r4w_tpu_torch.ops import filters, filters2

RECURSION_TOL = 1e-5  # complex rows: XLA's complex arithmetic against two real recursions


def _rel(got, want) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) or 1.0))


def _signal(rng, shape, complex_: bool) -> np.ndarray:
    x = rng.standard_normal(shape)
    if complex_:
        x = x + 1j * rng.standard_normal(shape)
        return np.asarray(x, np.complex64)
    return np.asarray(x, np.float32)


CASES = [((700,), False), ((700,), True), ((3, 500), False), ((2, 3, 300), True)]


@pytest.mark.parametrize("shape,complex_", CASES)
@pytest.mark.parametrize("with_state", [False, True])
def test_single_pole_iir_against_jax(shape, complex_, with_state):
    rng = np.random.default_rng(len(shape) + 10 * complex_)
    x = _signal(rng, shape, complex_)
    state = _signal(rng, shape[:-1], complex_) if with_state else None
    y, yf = filters.single_pole_iir(0.1, torch.from_numpy(x),
                                    None if state is None else torch.from_numpy(state))
    ry, ryf = ref_filters.single_pole_iir(0.1, jnp.asarray(x),
                                          None if state is None else jnp.asarray(state))
    assert _rel(y, ry) < RECURSION_TOL
    assert _rel(yf, ryf) < RECURSION_TOL
    assert y.dtype == (torch.complex64 if complex_ else torch.float32)


@pytest.mark.parametrize("shape,complex_", CASES)
def test_dc_blocker_against_jax_and_streams(shape, complex_):
    rng = np.random.default_rng(20 + len(shape))
    x = _signal(rng, shape, complex_) + 3.0
    y, (xf, yf) = filters.dc_blocker(torch.from_numpy(x), 0.99)
    ry, (rxf, ryf) = ref_filters.dc_blocker(jnp.asarray(x), 0.99)
    assert _rel(y, ry) < RECURSION_TOL
    assert _rel(yf, ryf) < RECURSION_TOL
    np.testing.assert_array_equal(xf.numpy(), np.asarray(rxf))
    # two blocks with the carried state are the one block
    cut = shape[-1] // 3
    y1, s1 = filters.dc_blocker(torch.from_numpy(x[..., :cut]), 0.99)
    y2, _ = filters.dc_blocker(torch.from_numpy(x[..., cut:]), 0.99, s1)
    np.testing.assert_array_equal(torch.cat([y1, y2], dim=-1).numpy(), y.numpy())


@pytest.mark.parametrize("n", [1, 257, 4096])
def test_emphasis_against_jax(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32)
    assert _rel(filters2.pre_emphasis(torch.from_numpy(x)),
                ref_filters2.pre_emphasis(jnp.asarray(x))) < 1e-6
    assert _rel(filters2.de_emphasis(torch.from_numpy(x), 0.9),
                ref_filters2.de_emphasis(jnp.asarray(x), 0.9)) < RECURSION_TOL
    assert _rel(filters2.fm_deemphasis(torch.from_numpy(x), 240e3),
                ref_filters2.fm_deemphasis(jnp.asarray(x), 240e3)) < RECURSION_TOL
    # de-emphasis inverts pre-emphasis
    back = filters2.de_emphasis(filters2.pre_emphasis(torch.from_numpy(x), 0.9), 0.9)
    assert _rel(back, x) < 1e-4


BIT_N = 5000  # samples of the bit-for-bit cases


@pytest.mark.parametrize("alpha", [0.05, 0.3])
def test_single_pole_iir_equals_jax_bit_for_bit(alpha):
    """fma(α, x[n], round((1−α)·y)), as XLA contracts the scan's step."""
    x = np.random.default_rng(31).standard_normal(BIT_N).astype(np.float32)
    y, yf = filters.single_pole_iir(alpha, torch.from_numpy(x), torch.tensor(0.7))
    ry, ryf = ref_filters.single_pole_iir(alpha, jnp.asarray(x), jnp.float32(0.7))
    np.testing.assert_array_equal(y.numpy(), np.asarray(ry))
    np.testing.assert_array_equal(yf.numpy(), np.asarray(ryf))


@pytest.mark.parametrize("alpha", [0.995, 0.9])
def test_dc_blocker_equals_jax_bit_for_bit(alpha):
    """fma(α, y, x[n] − x[n−1])."""
    x = np.random.default_rng(32).standard_normal(BIT_N).astype(np.float32) + 2.0
    y, (xf, yf) = filters.dc_blocker(torch.from_numpy(x), alpha)
    ry, (rxf, ryf) = ref_filters.dc_blocker(jnp.asarray(x), alpha)
    np.testing.assert_array_equal(y.numpy(), np.asarray(ry))
    np.testing.assert_array_equal(yf.numpy(), np.asarray(ryf))


@pytest.mark.parametrize("alpha", [0.95, 0.5])
def test_de_emphasis_equals_jax_bit_for_bit(alpha):
    """fma(α, y, x[n])."""
    x = np.random.default_rng(33).standard_normal(BIT_N).astype(np.float32)
    np.testing.assert_array_equal(filters2.de_emphasis(torch.from_numpy(x), alpha).numpy(),
                                  np.asarray(ref_filters2.de_emphasis(jnp.asarray(x), alpha)))


@pytest.mark.parametrize("rate,tau_us", [(240e3, 75.0), (48e3, 50.0)])
def test_fm_deemphasis_equals_jax_bit_for_bit(rate, tau_us):
    x = np.random.default_rng(34).standard_normal(BIT_N).astype(np.float32)
    np.testing.assert_array_equal(
        filters2.fm_deemphasis(torch.from_numpy(x), rate, tau_us).numpy(),
        np.asarray(ref_filters2.fm_deemphasis(jnp.asarray(x), rate, tau_us)))


def test_emphasis_batches_rows():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 300)).astype(np.float32)
    batched = filters2.fm_deemphasis(torch.from_numpy(x), 48e3)
    for row in range(4):
        np.testing.assert_array_equal(batched[row].numpy(),
                                      filters2.fm_deemphasis(torch.from_numpy(x[row]), 48e3).numpy())


def _fma(a, b, c) -> np.float32:
    """fma(a, b, c) of float32 values: the float64 product is exact, the sum
    rounds once there and once to float32."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _step(kind: str, c0: np.float32, c1: np.float32, y: np.float32, u: np.float32):
    if kind == "linear":
        return _fma(c0, y, u)
    if kind == "one_pole":
        return _fma(c0, u, np.float32(c1 * y))
    if kind == "peak_hold":
        return max(u, np.float32(c0 * y))
    a = c0 if kind == "ema" or u > y else c1
    return _fma(a, np.float32(u - y), y)


def _kernel_model(u: np.ndarray, kind: str, c0: float, c1: float = 0.0, state=None) -> np.ndarray:
    """The kernel's arithmetic in numpy float32 scalars, per component, one
    step a sample."""
    planes = u.view(np.float32).reshape(u.shape + ((2,) if np.iscomplexobj(u) else (1,)))
    rows = planes.reshape(-1, planes.shape[-2], planes.shape[-1])
    y0 = (np.zeros((rows.shape[0], rows.shape[2]), np.float32) if state is None
          else np.asarray(state).view(np.float32).reshape(rows.shape[0], rows.shape[2]))
    a, b = np.float32(c0), np.float32(c1)
    out = np.empty_like(rows)
    for r in range(rows.shape[0]):
        for c in range(rows.shape[2]):
            y = y0[r, c]
            for t in range(rows.shape[1]):
                y = _step(kind, a, b, y, rows[r, t, c])
                out[r, t, c] = y
    return out.reshape(-1).view(u.dtype).reshape(u.shape)


KIND_COEFS = {"linear": (1.0 - 0.0123, 0.0), "one_pole": (0.0123, 1.0 - 0.0123),
              "ema": (0.05, 0.0), "attack_release": (0.3, 0.002), "peak_hold": (0.97, 0.0)}


@pytest.mark.parametrize("shape,complex_", [((1, 2048), False), ((5, 300), False),
                                            ((3, 400), True)])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("kind", recurrence.KINDS)
def test_plain_loop_equals_the_kernels_rounding(shape, complex_, with_state, kind):
    rng = np.random.default_rng(7)
    u = _signal(rng, shape, complex_)
    if kind in ("attack_release", "peak_hold"):
        u = np.abs(u).astype(np.float32) if not complex_ else u
    state = _signal(rng, shape[:-1], complex_) if with_state else None
    c0, c1 = KIND_COEFS[kind]
    got = recurrence.first_order_recurrence(torch.from_numpy(u), kind, c0, c1,
                                            None if state is None else torch.from_numpy(state))
    np.testing.assert_array_equal(got.numpy(), _kernel_model(u, kind, c0, c1, state))


@pytest.mark.parametrize("kind", recurrence.KINDS)
def test_the_smoke_scripts_probe_value_is_the_kernel_models(kind):
    """`chip_smoke.probe_chain_value` checks the chain probe's last y on the
    card: the plain loop over the probe's inputs, as the kernel model."""
    import chip_smoke

    c0, c1 = KIND_COEFS[kind]
    u = np.tile(np.float32([0.5, -0.25, -0.5, 0.25]), 64)
    assert chip_smoke.probe_chain_value(256, kind, c0, c1) == _kernel_model(u, kind, c0, c1)[-1]


def test_dispatcher_uses_the_plain_loop_on_the_cpu_and_refuses_other_devices():
    u = torch.randn(2, 64)
    before = recurrence.first_order_recurrence.launches
    for kind in recurrence.KINDS:
        np.testing.assert_array_equal(
            recurrence.first_order_recurrence_dispatch(u, kind, 0.5, 0.25).numpy(),
            recurrence.first_order_recurrence(u, kind, 0.5, 0.25).numpy())
    assert recurrence.first_order_recurrence.launches == before
    with pytest.raises(ValueError):
        recurrence.first_order_recurrence_dispatch(u.to("meta"), "linear", 0.5)
    with pytest.raises(ValueError):
        recurrence.first_order_recurrence_cuda(u, "linear", 0.5)
    with pytest.raises(ValueError):
        recurrence.first_order_recurrence(u, "cubic", 0.5)


def test_empty_and_single_sample_rows():
    x = torch.zeros(3, 0)
    y, yf = filters.single_pole_iir(0.2, x, torch.ones(3))
    assert y.shape == (3, 0) and torch.equal(yf, torch.ones(3))
    y, (xf, yf) = filters.dc_blocker(torch.ones(2, 1))
    np.testing.assert_array_equal(y.numpy(), np.ones((2, 1), np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [((1, 1 << 15), torch.float32),
                                         ((64, 4096), torch.float32),
                                         ((8, 4096), torch.complex64)])
@pytest.mark.parametrize("kind", recurrence.KINDS)
def test_kernel_equals_the_plain_loop_on_the_card(shape, dtype, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(5)
    u = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
    state = torch.randn(shape[:1], generator=gen, device="cuda", dtype=dtype)
    c0, c1 = KIND_COEFS[kind]
    for st in (None, state):
        got = recurrence.first_order_recurrence_cuda(u, kind, c0, c1, st)
        want = recurrence.first_order_recurrence(u.cpu(), kind, c0, c1,
                                                 None if st is None else st.cpu())
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_launches_do_not_grow_with_the_length():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    counts = []
    for n in (1000, 100_000):
        x = torch.randn(2, n, device="cuda")
        before = recurrence.first_order_recurrence.launches
        filters.single_pole_iir(0.1, x)
        filters.dc_blocker(x)
        filters2.de_emphasis(x[0])
        counts.append(recurrence.first_order_recurrence.launches - before)
    assert counts == [3, 3]
