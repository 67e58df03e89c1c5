"""Batched Monte-Carlo runs, on one device or sharded over a device mesh.

PyTorch counterpart of ``r4w_tpu.parallel``. Where the JAX package vmaps a
per-item function, the port's modem functions take leading batch
dimensions themselves, so a batch or a (lanes, SNRs) grid is one call.
Across devices the JAX package's ``Mesh`` and ``shard_map`` with ``psum``
become a ``torch.distributed`` `DeviceMesh`, one process per rank, and
all-reduces or all-gathers over the mesh dimensions' groups: NCCL on the
card, gloo only where the caller names the CPU.
"""

from __future__ import annotations

import datetime
import socket
from typing import Sequence

import torch
import torch.distributed as dist

from r4w_tpu_torch.core.types import REAL_DTYPE, resolve_device, to_tensor

COLLECTIVE_TIMEOUT_S = 300.0  # a rank that waits longer on its peers raises


def backend_for(device) -> str:
    """The collective backend of a device type: NCCL for the card, gloo for
    the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return "nccl"
    if dev.type == "cpu":
        return "gloo"
    raise ValueError(f"no collective backend for device type {dev.type!r}")


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_group(rank: int, world_size: int, port: int, device) -> None:
    """Join the default process group at tcp://127.0.0.1:`port` with the
    backend of `device`'s type and a timeout; on the card, rank r uses
    cuda:r."""
    backend = backend_for(device)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))


def make_mesh(axis_names: Sequence[str] = ("dp",), shape: Sequence[int] | None = None,
              device=None):
    """Device mesh over the process group's ranks (default: a 1-D data axis
    over all of them), as a `torch.distributed.device_mesh.DeviceMesh` of
    `device`'s type (the card unless named).

    Every rank calls it. Without a process group, it starts one of world
    size 1 on a free loopback port, so one process has a mesh of one
    device. An existing group must use `device`'s backend: there is no
    fallback from NCCL to gloo.
    """
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    backend = backend_for(dev)
    if not dist.is_initialized():
        init_group(0, 1, free_port(), dev)
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group uses {dist.get_backend()}, a {dev.type} mesh "
                         f"needs {backend}")
    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or torch.Size(shape).numel() != world:
        raise ValueError(f"mesh shape {shape} over axes {tuple(axis_names)} does not cover "
                         f"{world} ranks")
    return init_device_mesh(dev.type, shape, mesh_dim_names=tuple(axis_names))


def shard_map_sum(fn, mesh):
    """`fn` on this rank's shards, its result all-reduced (summed) over every
    mesh dimension's group in the mesh's axis order; the JAX package's
    ``shard_map`` with a ``psum`` over each axis. Each rank passes its own
    shards to the returned function and gets the sum back."""

    def body(*args):
        val = fn(*args).clone()
        for name in mesh.mesh_dim_names:
            dist.all_reduce(val, op=dist.ReduceOp.SUM, group=mesh.get_group(name))
        return val

    return body


def all_gather_rows(local: torch.Tensor, group) -> torch.Tensor:
    """Concatenate every rank's `local` (equal shapes) along dim 0, in rank
    order within `group`."""
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local.contiguous(), group=group)
    return torch.cat(parts)


def batch_modulate(modulate_fn, payloads) -> torch.Tensor:
    """Modulate a batch of equal-length payloads, (B, n) -> (B, ...).

    `modulate_fn` takes the batch dimension, as the port's modulators do.
    """
    return modulate_fn(to_tensor(payloads))


def batch_demodulate(demodulate_fn, bursts):
    """Demodulate (B, N) IQ bursts with a batch-aware `demodulate_fn`."""
    return demodulate_fn(to_tensor(bursts))


def monte_carlo_ber(trial_ber, n_lanes: int, snrs_db, *, generator: torch.Generator,
                    mesh=None, axis: str = "dp") -> torch.Tensor:
    """(lanes × SNRs) BER matrix from one batched call.

    trial_ber(snr_db, source) -> BER of `snr_db`'s shape; it receives the
    SNRs as a (lanes, len(snrs_db)) grid on the generator's device. Without
    a mesh, `source` is `generator` itself and every lane's noise comes
    from it. With a mesh, the lanes are sharded along `axis` (`n_lanes` a
    multiple of its size): each rank gets its lanes' grid and, as `source`,
    a noise function for `channel.awgn(noise=)` that draws the whole grid's
    noise from `generator` as the unsharded call would and returns this
    rank's lanes of it. The ranks' rows are gathered, so every rank returns
    the full matrix, equal to the unsharded one.
    """
    snrs = torch.as_tensor(snrs_db, dtype=REAL_DTYPE, device=generator.device)
    if mesh is None:
        return trial_ber(snrs.expand(n_lanes, -1), generator)
    from r4w_tpu_torch.channel.channel import _complex_normal

    group = mesh.get_group(axis)
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if n_lanes % size:
        raise ValueError(f"{n_lanes} lanes do not split over {size} ranks of {axis!r}")
    per = n_lanes // size
    lanes = slice(rank * per, (rank + 1) * per)

    def lane_noise(shape, device):
        whole = _complex_normal((n_lanes, *shape[1:]), 1.0, generator=generator, device=device)
        return whole[lanes]

    return all_gather_rows(trial_ber(snrs.expand(per, -1), lane_noise), group)


def ber_sweep(ber_fn, payload, snrs_db, n_lanes: int = 128, seed: int = 0,
              mesh=None) -> torch.Tensor:
    """Mean BER per SNR over n_lanes Monte-Carlo channels.

    ber_fn(payload, snr_db, *, generator=None, noise=None) -> BER of
    `snr_db`'s shape (e.g. `lora.loopback_ber` with its params bound). The
    noise comes from a generator seeded with `seed` on the payload's
    device; with a `mesh`, the lanes are sharded along its "dp" axis on the
    same draws (`monte_carlo_ber`), so the result equals the unsharded one.
    """
    payload = to_tensor(payload)
    generator = torch.Generator(device=payload.device).manual_seed(seed)

    def trial(snr, source):
        if isinstance(source, torch.Generator):
            return ber_fn(payload, snr, generator=source)
        return ber_fn(payload, snr, noise=source)

    grid = monte_carlo_ber(trial, n_lanes, snrs_db, generator=generator, mesh=mesh)
    return torch.mean(grid, dim=0)
