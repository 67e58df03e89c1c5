"""The five sharded patterns of the multi-device dry run.

PyTorch counterpart of ``__graft_entry__.dryrun_multichip``: one process
per rank, joined by ``torch.distributed`` over a free loopback port (NCCL
on the card, rank r on cuda:r; gloo where the caller names the CPU), each
pattern on a `DeviceMesh` of its own axes:

- dp×sp: LoRa SF7 loopback BERs over (lanes × SNRs), lanes sharded along
  dp and SNRs along sp, summed over dp then sp (two all-reduces);
- ep: the PRN bank of a PCPS search sharded over the ranks, the peaks
  gathered, PRN index 3 the strongest;
- tp: the Doppler bins of one PRN's PCPS grid sharded, the powers gathered
  and the global argmax taken;
- pp: two pipeline stages, modulate on one rank and demodulate on the next
  over a ring; the ring's hop is an all-to-all whose only non-empty chunk
  goes to the next rank, a form that also runs at world size 1 (NCCL's
  send to oneself can hang);
- sv: the satellites of a GNSS scenario sharded, each rank's composite
  block summed over the ranks and held against the single-rank
  `composite_block`.

The lanes draw the reference's noise: `threefry.split(key(1), dp·2)` keys
and `hostio.linspace(-20, 0, sp·2)` SNRs, so the dp×sp mean BER is the JAX
package's own. `dryrun_multichip(n, device)` raises if `device` has fewer
than n ranks to give; it never falls back to gloo or to the CPU.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from r4w_tpu_torch.core.types import DEFAULT_DEVICE, IQ_DTYPE, SYMBOL_DTYPE, resolve_device

DRYRUN_TIMEOUT_S = 600.0
LANES_PER_RANK = 2
SNRS_PER_RANK = 2
MIN_PRNS = 4  # the true PRN is index 3 of the bank
BINS_PER_RANK = 2
TRUE_DOPPLER_HZ = 750.0
CA_RATE_HZ = 1_023_000.0
COMPOSITE_SAMPLES = 2048
COMPOSITE_REL_TOL = 1e-4  # __graft_entry__.py:312, max|Δ| <= 1e-4 · max(scale, 1)
_REPO = Path(__file__).resolve().parents[2]


def ranks_available(device) -> int:
    """Ranks `device`'s type can give: its card count, or the CPU's cores."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    return os.cpu_count() or 1


def _dp_sp(world: int) -> tuple[int, int]:
    sp = 2 if world % 2 == 0 else 1
    return world // sp, sp


def _ber_step(dev: torch.device) -> float:
    from r4w_tpu_torch.channel import threefry
    from r4w_tpu_torch.channel.channel import _complex_normal
    from r4w_tpu_torch.core.hostio import linspace
    from r4w_tpu_torch.parallel import make_mesh, shard_map_sum
    from r4w_tpu_torch.waveforms import lora

    params = lora.LoRaParams(sf=7)
    payload = torch.arange(8, dtype=SYMBOL_DTYPE, device=dev) % 256
    dp, sp = _dp_sp(dist.get_world_size())
    mesh = make_mesh(("dp", "sp"), (dp, sp), device=dev)
    d, s = mesh.get_local_rank("dp"), mesh.get_local_rank("sp")
    keys = threefry.split(threefry.key(1), dp * LANES_PER_RANK)
    snrs = linspace(-20.0, 0.0, sp * SNRS_PER_RANK, device=dev)
    local_keys = keys[d * LANES_PER_RANK:(d + 1) * LANES_PER_RANK]
    local_snrs = snrs[s * SNRS_PER_RANK:(s + 1) * SNRS_PER_RANK]
    n = lora.modulate(params, payload, include_preamble=False, device=dev).shape[-1]
    # one lane's noise is its key's, whatever the SNR (the reference vmaps keys × SNRs)
    noise = torch.stack([_complex_normal((n,), 1.0, key=k, device=dev) for k in local_keys])
    ber = lora.loopback_ber(params, payload, local_snrs.expand(len(local_keys), -1),
                            noise=noise[:, None, :])
    total = shard_map_sum(torch.sum, mesh)(ber)
    mean = total / (ber.numel() * dp * sp)
    if not torch.isfinite(mean):
        raise AssertionError("the dp×sp BER step produced a non-finite mean")
    return float(mean)


def prns_per_rank(world: int) -> int:
    """2 a rank, as the reference, or more where fewer ranks would hold no
    PRN index 3 (4 at world size 1)."""
    return max(2, -(-MIN_PRNS // world))


def _prn_codes(world: int, dev: torch.device) -> tuple[list[int], torch.Tensor]:
    from r4w_tpu_torch.gnss import prn

    prn_ids = [(i % 32) + 1 for i in range(world * prns_per_rank(world))]
    return prn_ids, torch.from_numpy(prn.code_bank(prn_ids)).to(dev)


def _pcps_config():
    from r4w_tpu_torch.gnss import acquisition

    return acquisition.PcpsConfig(doppler_max_hz=1000.0, doppler_step_hz=500.0)


def _prn_step(dev: torch.device) -> list[float]:
    from r4w_tpu_torch.gnss import acquisition, prn
    from r4w_tpu_torch.parallel import all_gather_rows, make_mesh

    mesh = make_mesh(("prn",), device=dev)
    rank = mesh.get_local_rank("prn")
    prn_ids, codes = _prn_codes(mesh.size(), dev)
    rx = torch.from_numpy(prn.gps_ca_code(prn_ids[3]).astype(np.complex64)).to(dev)
    per = prns_per_rank(mesh.size())
    local = codes[rank * per:(rank + 1) * per]
    grid = acquisition.pcps_grid(rx, local, CA_RATE_HZ, _pcps_config())
    peaks = all_gather_rows(torch.amax(grid.reshape(grid.shape[0], -1), dim=-1),
                            mesh.get_group("prn"))
    if int(torch.argmax(peaks)) != 3:
        raise AssertionError(f"the PRN-sharded PCPS missed the true PRN: {peaks.tolist()}")
    return peaks.cpu().tolist()


def _doppler_input() -> np.ndarray:
    from r4w_tpu_torch.gnss import prn

    code = prn.gps_ca_code(4).astype(np.float32)  # prn_ids[3]
    t = np.arange(code.size, dtype=np.float64) / CA_RATE_HZ
    return (code * np.exp(2j * np.pi * TRUE_DOPPLER_HZ * t)).astype(np.complex64)


def _doppler_step(dev: torch.device) -> dict:
    from r4w_tpu_torch.core.hostio import linspace
    from r4w_tpu_torch.gnss import acquisition
    from r4w_tpu_torch.parallel import all_gather_rows, make_mesh

    mesh = make_mesh(("tp",), device=dev)
    world, rank = mesh.size(), mesh.get_local_rank("tp")
    all_dops = linspace(-1500.0, 1500.0, world * BINS_PER_RANK, device=dev)
    code_one = _prn_codes(world, dev)[1][3:4]
    local_dops = all_dops[rank * BINS_PER_RANK:(rank + 1) * BINS_PER_RANK]
    grid = acquisition.pcps_grid(torch.from_numpy(_doppler_input()).to(dev), code_one,
                                 CA_RATE_HZ, _pcps_config(), dop_subset=local_dops)
    powers = all_gather_rows(torch.amax(grid.reshape(grid.shape[1], -1), dim=-1),
                             mesh.get_group("tp"))
    dops = all_dops.cpu()
    best = float(dops[int(torch.argmax(powers))])
    step = float(dops[1] - dops[0])
    if abs(best - TRUE_DOPPLER_HZ) > step:
        raise AssertionError(f"the Doppler-sharded search found {best}, want ~{TRUE_DOPPLER_HZ}")
    return {"powers": powers.cpu().tolist(), "dopplers": dops.tolist(), "best": best}


def ring_shift(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ring permute: this rank's `x` goes to rank + 1 and the previous
    rank's comes back, as one all-to-all whose only non-empty chunks are
    those two (so world size 1 copies to itself). Complex tensors travel
    as their real view."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    flat = torch.view_as_real(x).reshape(-1) if x.is_complex() else x.reshape(-1)
    n = flat.numel()
    out = torch.empty_like(flat)
    dist.all_to_all_single(out, flat,
                           output_split_sizes=[n if r == (rank - 1) % world else 0
                                               for r in range(world)],
                           input_split_sizes=[n if r == (rank + 1) % world else 0
                                              for r in range(world)],
                           group=group)
    if x.is_complex():
        return torch.view_as_complex(out.reshape(*x.shape, 2))
    return out.reshape(x.shape)


def _pipeline_step(dev: torch.device) -> list[int]:
    from r4w_tpu_torch.parallel import all_gather_rows, make_mesh
    from r4w_tpu_torch.waveforms import lora

    mesh = make_mesh(("pp",), device=dev)
    rank, group = mesh.get_local_rank("pp"), mesh.get_group("pp")
    params = lora.LoRaParams(sf=7)
    payload = torch.arange(4, dtype=SYMBOL_DTYPE, device=dev) % 256
    # stage 0: this rank's microbatch, its gain marked by the rank
    gain = 1.0 + 0.01 * torch.tensor(float(rank), device=dev)
    iq = lora.modulate(params, payload, include_preamble=False, device=dev) * gain
    # the hop to the next stage, then stage 1 on the neighbour's block
    iq = ring_shift(iq[None, :].to(IQ_DTYPE), group)
    syms, _, _ = lora.demodulate_symbols(params, iq)
    want = lora.encode_symbols(params, payload)
    errs = torch.sum((syms[0, :want.shape[-1]] != want).to(torch.int32), dtype=torch.int32)
    gathered = all_gather_rows(errs[None], group)
    if int(torch.sum(gathered)) != 0:
        raise AssertionError(f"the pipeline stage handoff corrupted symbols: {gathered.tolist()}")
    return gathered.cpu().tolist()


def scenario_config(world: int):
    """The SV pattern's scenario: one GPS L1 C/A satellite a rank."""
    from r4w_tpu_torch.gnss import scenario as sc

    return sc.ScenarioConfig(
        sample_rate=CA_RATE_HZ * 2,
        satellites=tuple(sc.SatelliteConfig(signal="GpsL1Ca", prn=p + 1, cn0_dbhz=45.0,
                                            doppler_hz=250.0 * p - 800.0,
                                            range_m=2.1e7 + 3.0e5 * p)
                         for p in range(world)),
        seed=5)


def _scenario_step(dev: torch.device) -> dict:
    from r4w_tpu_torch.gnss import scenario as sc
    from r4w_tpu_torch.parallel import make_mesh, shard_map_sum

    mesh = make_mesh(("sv",), device=dev)
    world, rank = mesh.size(), mesh.get_local_rank("sv")
    cfg = scenario_config(world)
    gen = sc.GnssScenario(cfg, device=dev)
    banks = gen.sv_banks()
    args, _ = gen.block_inputs(COMPOSITE_SAMPLES)
    ref = sc.composite_block(*banks, *args, 0.0, n=COMPOSITE_SAMPLES, fs=cfg.sample_rate)
    per = len(cfg.satellites) // world
    mine = slice(rank * per, (rank + 1) * per)
    local = sc.composite_block(*(t[mine] for t in banks), *(t[mine] for t in args), 0.0,
                               n=COMPOSITE_SAMPLES, fs=cfg.sample_rate)
    composite = shard_map_sum(lambda v: v, mesh)(local)
    err = float(torch.max(torch.abs(composite - ref)))
    scale = float(torch.max(torch.abs(ref)))
    if not err <= COMPOSITE_REL_TOL * max(scale, 1.0):
        raise AssertionError(f"the SV-sharded composite diverged: max|Δ| {err} at scale {scale}")
    host = composite.cpu().numpy()
    return {"max_err": err, "scale": scale, "re": host.real.tolist(), "im": host.imag.tolist()}


def run_patterns(dev: torch.device) -> dict:
    """The five patterns on this rank (the process group already joined);
    every rank returns the same gathered results."""
    seconds = {}
    out = {"world": dist.get_world_size(), "device": dev.type}
    for name, step in (("mean_ber", _ber_step), ("prn_peaks", _prn_step),
                       ("doppler", _doppler_step), ("pp_errs", _pipeline_step),
                       ("composite", _scenario_step)):
        t0 = time.perf_counter()
        out[name] = step(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds[name] = time.perf_counter() - t0
    out["seconds"] = seconds
    out["summary"] = (
        f"dryrun_multichip({out['world']}): ok (dp×sp mean_ber={out['mean_ber']:.4f}, ep "
        f"prn_peak=3, tp doppler={out['doppler']['best']:+.0f} Hz, pp errs=0, sv scenario "
        f"max|Δ|={out['composite']['max_err']:.2e} @ scale {out['composite']['scale']:.1f})")
    return out


def _child_main(argv=None) -> None:
    """One rank: python -c '...dryrun import _child_main; _child_main()' RANK
    WORLD PORT DEVICE_TYPE OUT_PATH."""
    from r4w_tpu_torch.parallel import init_group

    rank, world, port, dev_type, out_path = (argv if argv is not None else sys.argv[1:])
    rank, world = int(rank), int(world)
    if dev_type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    init_group(rank, world, int(port), dev_type)
    try:
        dev = torch.device(f"cuda:{rank}") if dev_type == "cuda" else torch.device("cpu")
        result = run_patterns(dev)
        if rank == 0:
            Path(out_path).write_text(json.dumps(result))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=DEFAULT_DEVICE,
                     timeout_s: float = DRYRUN_TIMEOUT_S) -> dict:
    """Run the five patterns over `n_devices` ranks of `device`'s type, one
    process a rank on a free loopback port, killed after `timeout_s`.

    Prints the reference's one-line summary and returns rank 0's results
    ("summary", "mean_ber", "prn_peaks", "doppler", "pp_errs", "composite",
    "seconds"). Raises if the device type has fewer than `n_devices` ranks
    or a rank fails.
    """
    from r4w_tpu_torch.parallel import backend_for, free_port

    dev = resolve_device(device)
    backend_for(dev)
    have = ranks_available(dev)
    if not 1 <= n_devices <= have:
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} {dev.type} "
                           f"ranks, {dev.type} has {have}")
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(_REPO), env.get("PYTHONPATH")) if p)
    code = "from r4w_tpu_torch.parallel.dryrun import _child_main; _child_main()"
    with tempfile.TemporaryDirectory(prefix="r4w_dryrun_") as tmp, \
            contextlib.ExitStack() as stack:
        out_path = os.path.join(tmp, "result.json")
        logs = [stack.enter_context(open(os.path.join(tmp, f"rank{r}.log"), "w+"))
                for r in range(n_devices)]
        procs = []
        try:
            for r in range(n_devices):
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", code, str(r), str(n_devices), str(port), dev.type,
                     out_path], stdout=logs[r], stderr=subprocess.STDOUT, env=env,
                    cwd=str(_REPO)))
            deadline = time.monotonic() + timeout_s
            for p in procs:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            timed_out = [r for r, p in enumerate(procs) if p.poll() is None]
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if timed_out or failed:
            tails = []
            for r in failed:
                logs[r].seek(0)
                tails.append(f"rank {r} (exit {procs[r].returncode}):\n{logs[r].read()[-3000:]}")
            raise RuntimeError(f"dryrun_multichip({n_devices}) on {dev.type}: ranks timed out "
                               f"{timed_out} after {timeout_s} s, failed {failed}\n"
                               + "\n".join(tails))
        result = json.loads(Path(out_path).read_text())
    print(result["summary"], flush=True)
    return result
