"""The linear first-order recursion (`kernels.recurrence`) and the one-pole
filters that run on it (`filters.single_pole_iir`, `filters.dc_blocker`,
`filters2.de_emphasis`, `filters2.fm_deemphasis`) against the JAX
package's ``lax.scan`` versions on the same numpy inputs, made from seeds.

Against JAX the tolerance is RECURSION_TOL of the largest reference
magnitude: the reference's compiled scan may contract a step's product and
sum into one fused multiply-add, where the port rounds both. Within the
port, the plain step loop and a numpy model of the kernel's rounding
(float32 product, then float32 sum) are equal bit for bit, and so are the
kernel and the plain loop on the card (`cuda`-marked).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.ops import filters as ref_filters
from r4w_tpu.ops import filters2 as ref_filters2
from r4w_tpu_torch.kernels import recurrence
from r4w_tpu_torch.ops import filters, filters2

RECURSION_TOL = 1e-5  # a scan that may fuse multiply-adds against per-op rounding (measured 3.5e-7)


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


def test_emphasis_batches_rows():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 300)).astype(np.float32)
    batched = filters2.fm_deemphasis(torch.from_numpy(x), 48e3)
    for row in range(4):
        np.testing.assert_array_equal(batched[row].numpy(),
                                      filters2.fm_deemphasis(torch.from_numpy(x[row]), 48e3).numpy())


def _kernel_model(u: np.ndarray, b: float, state=None) -> np.ndarray:
    """The kernel's arithmetic in numpy: per component, y = fl(u + fl(b·y))
    in float32, one step a sample."""
    planes = u.view(np.float32).reshape(u.shape + ((2,) if np.iscomplexobj(u) else (1,)))
    y = np.zeros(planes.shape[:-2] + planes.shape[-1:], np.float32)
    if state is not None:
        y = np.asarray(state).view(np.float32).reshape(y.shape).copy()
    coef = np.float32(b)
    out = np.empty_like(planes)
    for t in range(planes.shape[-2]):
        y = (planes[..., t, :] + coef * y).astype(np.float32)
        out[..., t, :] = y
    return out.reshape(-1).view(u.dtype).reshape(u.shape)


@pytest.mark.parametrize("shape,complex_", [((1, 2048), False), ((5, 300), False),
                                            ((3, 400), True)])
@pytest.mark.parametrize("with_state", [False, True])
def test_plain_loop_equals_the_kernels_rounding(shape, complex_, with_state):
    rng = np.random.default_rng(7)
    u = _signal(rng, shape, complex_)
    state = _signal(rng, shape[:-1], complex_) if with_state else None
    b = 1.0 - 0.0123
    got = recurrence.first_order_recurrence(torch.from_numpy(u), b,
                                            None if state is None else torch.from_numpy(state))
    np.testing.assert_array_equal(got.numpy(), _kernel_model(u, b, state))


@pytest.mark.parametrize("y0", [0.0, -1.7])
def test_the_smoke_scripts_step_loop_equals_the_plain_loop(y0):
    """`chip_smoke.step_loop` holds the kernel to the plain loop's rounding
    at the FM path's 14.4 M steps on the card, where the loop itself is
    too slow."""
    import chip_smoke

    u = np.random.default_rng(11).standard_normal(5000).astype(np.float32)
    b = 1.0 - 1.0 / 9.0
    want = recurrence.first_order_recurrence(torch.from_numpy(u[None]), b, torch.tensor([y0]))
    np.testing.assert_array_equal(chip_smoke.step_loop(u, b, y0), want[0].numpy())


def test_dispatcher_uses_the_plain_loop_on_the_cpu_and_refuses_other_devices():
    u = torch.randn(2, 64)
    before = recurrence.first_order_recurrence.launches
    np.testing.assert_array_equal(recurrence.first_order_recurrence_dispatch(u, 0.5).numpy(),
                                  recurrence.first_order_recurrence(u, 0.5).numpy())
    assert recurrence.first_order_recurrence.launches == before
    with pytest.raises(ValueError):
        recurrence.first_order_recurrence_dispatch(u.to("meta"), 0.5)
    with pytest.raises(ValueError):
        recurrence.first_order_recurrence_cuda(u, 0.5)


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
def test_kernel_equals_the_plain_loop_on_the_card(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(5)
    u = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
    state = torch.randn(shape[:1], generator=gen, device="cuda", dtype=dtype)
    for st in (None, state):
        got = recurrence.first_order_recurrence_cuda(u, 0.995, st)
        assert torch.equal(got, recurrence.first_order_recurrence(u, 0.995, st))


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
