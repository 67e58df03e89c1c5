"""The sandbox's port (`r4w_tpu_torch.sandbox`) against the reference's.

The sandbox cases of ``tests/test_timing_sandbox.py`` run with their module
swapped for the port's: the isolation ladder, exception containment, a
crashing child, L3's memory limit, timeout and seccomp denylist, the
namespace attempt, L7's CPU pinning, L8's air-gap policy, the command
levels. Every forked child runs under its test's own timeout.

The port's one departure on purpose: L3's ``RLIMIT_AS`` is the child's
address space at fork plus ``memory_limit_mb``. This process (PyTorch and
JAX imported) already maps far more than 256 MB, so under the reference's
absolute limit a 16 MB allocation fails; under the port's it succeeds, and
a 2 GB one still fails.
"""

from __future__ import annotations

import importlib

import pytest

from r4w_tpu import sandbox as ref_sb
from r4w_tpu_torch import sandbox

LIMIT_MB = 256          # the reference test's L3 limit
SANDBOX_TESTS = [
    "test_available_levels", "test_l1_exception_containment", "test_l2_survives_child_crash",
    "test_l3_memory_limit", "test_l3_timeout", "test_l3_seccomp_denies_network",
    "test_l2_namespace_attempt_recorded", "test_l7_cpu_pinning", "test_l8_air_gap_policy",
    "test_container_level_availability_matches_probe", "test_vm_levels_probe",
    "test_describe_ladder", "test_run_command_process_level",
]


@pytest.mark.parametrize("name", SANDBOX_TESTS)
def test_reference_sandbox_tests_on_the_port(monkeypatch, name):
    ref = importlib.import_module("test_timing_sandbox")
    monkeypatch.setattr(ref, "sb", sandbox)
    getattr(ref, name)()


def _alloc_16mb():
    """16 MB in a new anonymous mapping (a heap allocation might reuse a free
    chunk of the parent's heap and need no new mapping at all)."""
    import mmap

    with mmap.mmap(-1, 16 << 20) as m:
        m[::4096] = b"\x01" * (16 << 8)
        return float(sum(m[::4096]))


def test_seccomp_program_is_the_references():
    assert sandbox._seccomp_program() == ref_sb._seccomp_program()
    assert sandbox.available_levels() == ref_sb.available_levels()


def test_l3_memory_limit_bounds_what_the_child_adds():
    """A 16 MB allocation succeeds under the 256 MB limit in a process whose
    address space is already larger than 256 MB; the reference's absolute
    limit refuses it, and a 2 GB allocation fails under both."""
    assert sandbox._address_space() > 4 * LIMIT_MB * 1024 * 1024
    box = sandbox.Sandbox(sandbox.IsolationLevel.L3_RESOURCE, timeout_s=20,
                          memory_limit_mb=LIMIT_MB)
    res = box.run(_alloc_16mb)
    assert res.ok and res.value == float(16 << 8), res.error
    assert f"rlimit-as:+{LIMIT_MB}MB" in res.isolation
    big = box.run(lambda: len(bytearray(1 << 31)))
    assert not big.ok and "MemoryError" in big.error
    ref = ref_sb.Sandbox(ref_sb.IsolationLevel.L3_RESOURCE, timeout_s=20,
                         memory_limit_mb=LIMIT_MB).run(_alloc_16mb)
    assert not ref.ok


def _raise():
    raise RuntimeError("Cannot re-initialize CUDA in forked subprocess")


def test_child_exception_comes_back_as_an_error():
    """What a forked child raises (such as torch's refusal of CUDA in a
    child forked from a process that initialised it) returns as
    SandboxResult(False, error) within the timeout, at every forking level."""
    for level in (2, 3, 7):
        res = sandbox.Sandbox(sandbox.IsolationLevel(level), timeout_s=20,
                              memory_limit_mb=LIMIT_MB).run(_raise)
        assert not res.ok and "Cannot re-initialize CUDA" in res.error
        assert res.exit_code == 0
