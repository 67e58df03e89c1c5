"""Run the JAX package's own test functions against the port's modules.

`run_reference_test(monkeypatch, module, name, modules, **swaps)` swaps
each of the reference test module's module-level names (``sync2``,
``filters``, ...) for a `PortModule` over the port's module of that name
(and each entry of `modules`, a module a test imports from by its dotted
name inside its body, in ``sys.modules``), puts the port's
default device on the CPU, and calls the test function (``"Class.method"``
for a test in a class). A `PortModule` calls the port's function with
JAX arrays and numpy arrays as CPU tensors of the dtype JAX would give
them with 64-bit types off (float64 → float32, int64 → int32, complex128 →
complex64), a JAX threefry key as the port's (`channel.threefry`) key
tuple, and returns tensors as numpy arrays, inside tuples, named
tuples, lists and dicts too, so that the reference test's own assertions
read the port's outputs unchanged.

`check_parity(port_fn, ref_fn, args, kwargs, tol)` calls a port function
with numpy inputs as CPU tensors and the reference's with the same inputs
as JAX arrays, and compares every array of the two results in order:
integer and boolean arrays equal, float and complex arrays within `tol` of
the largest reference magnitude (0: bit for bit), their infinities and NaNs
in the same places.
"""

from __future__ import annotations

import functools
import importlib
import inspect
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from r4w_tpu_torch.core import types

_CANONICAL = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
              np.dtype(np.complex128): np.complex64}


def to_port(value):
    if isinstance(value, jax.Array) and jax.dtypes.issubdtype(value.dtype, jax.dtypes.prng_key):
        return tuple(int(v) for v in np.asarray(jax.random.key_data(value)))  # a threefry key
    if isinstance(value, jax.Array):
        value = np.asarray(value)
    if isinstance(value, np.ndarray):
        return torch.from_numpy(np.array(value, dtype=_CANONICAL.get(value.dtype, value.dtype)))
    return value


def to_numpy(value):
    if isinstance(value, torch.Tensor):
        return value.numpy()
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return type(value)(*map(to_numpy, value))
    if isinstance(value, (tuple, list)):
        return type(value)(map(to_numpy, value))
    if isinstance(value, dict):
        return {k: to_numpy(v) for k, v in value.items()}
    return value


class PortModule:
    """The port's module seen through numpy, as the reference's tests read it."""

    def __init__(self, module):
        self._module = module

    def __getattr__(self, name):
        value = getattr(self._module, name)
        if inspect.isclass(value) or not callable(value):
            return value

        @functools.wraps(value)
        def call(*args, **kwargs):
            return to_numpy(value(*map(to_port, args),
                                  **{k: to_port(v) for k, v in kwargs.items()}))
        return call


def run_reference_test(monkeypatch, module: str, name: str, modules: dict | None = None,
                       params: dict | None = None, **swaps: str) -> None:
    """Run test `name` of the reference test module `module` (a file of
    tests/) with each name in `swaps` bound to a PortModule of the port's
    module at the dotted path it maps to, and each reference module named in
    `modules` (``{"r4w_tpu.ops.radar": "r4w_tpu_torch.ops.radar"}``) replaced
    in ``sys.modules`` for ``from r4w_tpu.ops.radar import cfar_1d`` in a
    test's body; `params` are the arguments of a parametrised test."""
    ref = importlib.import_module(module)
    monkeypatch.setattr(types, "DEFAULT_DEVICE", torch.device("cpu"))
    for path, port_path in (modules or {}).items():
        monkeypatch.setitem(sys.modules, path, PortModule(importlib.import_module(port_path)))
    for attr, path in swaps.items():
        proxy = PortModule(importlib.import_module(path))
        if "." in attr:  # a package attribute that a test imports inside its body
            package, sub = attr.rsplit(".", 1)
            monkeypatch.setattr(importlib.import_module(package), sub, proxy)
        else:
            monkeypatch.setattr(ref, attr, proxy)
    owner, _, method = name.partition(".")
    fn = getattr(getattr(ref, owner)(), method) if method else getattr(ref, owner)
    fn(**(params or {}))


def _flat(value) -> list:
    if isinstance(value, torch.Tensor):
        return [value.detach().cpu().numpy()]
    if isinstance(value, (jax.Array, np.ndarray, np.generic, bool, int, float, complex)):
        return [np.asarray(value)]
    if isinstance(value, (tuple, list)):
        return [a for v in value for a in _flat(v)]
    return []


def _to_jax(value):
    if isinstance(value, np.ndarray):
        return jnp.asarray(value)
    if isinstance(value, (tuple, list)) and value and isinstance(value[0], np.ndarray):
        return type(value)(_to_jax(v) for v in value)
    return value


def _to_torch(value):
    if isinstance(value, (tuple, list)) and value and isinstance(value[0], np.ndarray):
        return type(value)(_to_torch(v) for v in value)
    return to_port(value)


def compare(got, want, tol: float, label: str = "") -> float:
    """The worst relative difference of `got` from `want`; asserts the
    integer arrays equal and the float arrays within `tol`."""
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want), (label, len(got), len(want))
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (label, i, g.shape, w.shape)
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64),
                                          err_msg=f"{label}[{i}]")
            continue
        finite = np.isfinite(w)
        np.testing.assert_array_equal(g[~finite], w[~finite], err_msg=f"{label}[{i}]")
        g, w = g[finite], w[finite]
        if not w.size:
            continue
        scale = float(np.max(np.abs(w))) or 1.0
        err = float(np.max(np.abs(g.astype(np.complex128) - w.astype(np.complex128)))) / scale
        assert err <= tol, (label, i, err, tol)
        worst = max(worst, err)
    return worst


def check_parity(port_fn, ref_fn, args=(), kwargs=None, tol: float = 1e-5, label: str = ""):
    kwargs = kwargs or {}
    got = port_fn(*[_to_torch(a) for a in args], **kwargs)
    want = ref_fn(*[_to_jax(a) for a in args], **kwargs)
    return compare(got, want, tol, label)
