"""The port's multi-device layer (``r4w_tpu_torch.parallel``) on gloo.

`dryrun_multichip` runs its five sharded patterns at world sizes 2 and 4,
one process a rank on the CPU, and each is held against the JAX package's
unsharded computation on the same inputs (``__graft_entry__.py:104-322``
run without a mesh): the dp×sp mean BER equal, the PRN bank's argmax 3
with its peaks within `PEAK_REL_TOL`, the same Doppler bin, no pipeline
errors, the composite within `COMPOSITE_TOL` of JAX's `composite_block`.
A second set of ranks holds `ber_sweep(mesh=)` equal to `ber_sweep()`,
`shard_map_sum` summed over every axis, the ring permute and the backend
check. Every spawn has a free port and a timeout of its own.
"""

import functools
import json
import os
import subprocess
import sys
import typing
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.channel import channel as ref_channel
from r4w_tpu_torch import parallel
from r4w_tpu_torch.channel.channel import ChannelModelName
from r4w_tpu_torch.parallel import dryrun
from r4w_tpu_torch.waveforms import lora

REPO = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 180.0
PEAK_REL_TOL = 1e-5        # PCPS peaks: float32 FFT sums in another order
COMPOSITE_TOL = 1e-4       # __graft_entry__.py:312, against JAX's composite_block
SWEEP_SNRS = (-12.0, -9.0, -6.0)
SWEEP_LANES = 8


@pytest.fixture(scope="module", params=[2, 4])
def dry(request):
    world = request.param
    return world, dryrun.dryrun_multichip(world, "cpu", timeout_s=SPAWN_TIMEOUT_S)


@functools.lru_cache(maxsize=None)
def jax_unsharded(world: int) -> dict:
    """The five patterns' results computed by the JAX package without a mesh."""
    from r4w_tpu.gnss import acquisition, prn
    from r4w_tpu.gnss import scenario as sc
    from r4w_tpu.waveforms import lora as ref_lora

    params = ref_lora.LoRaParams(sf=7)
    payload = jnp.asarray(np.arange(8) % 256, jnp.int32)
    sp = 2 if world % 2 == 0 else 1
    dp = world // sp
    keys = jax.random.split(jax.random.key(1), dp * 2)
    snrs = jnp.linspace(-20.0, 0.0, sp * 2)
    grid = jax.jit(jax.vmap(lambda k: jax.vmap(
        lambda s: ref_lora.loopback_ber(params, payload, k, s))(snrs)))(keys)
    mean_ber = float(jnp.sum(grid) / grid.size)

    per = dryrun.prns_per_rank(world)
    prn_ids = [(i % 32) + 1 for i in range(world * per)]
    codes = jnp.asarray(prn.code_bank(prn_ids))
    cfg = acquisition.PcpsConfig(doppler_max_hz=1000.0, doppler_step_hz=500.0)
    rx = jnp.asarray(prn.gps_ca_code(prn_ids[3]).astype(np.complex64))
    surface = acquisition.pcps_grid(rx, codes, 1_023_000.0, cfg)
    peaks = np.asarray(jnp.max(surface.reshape(surface.shape[0], -1), axis=-1))

    dops = jnp.linspace(-1500.0, 1500.0, world * 2)
    grid_d = acquisition.pcps_grid(jnp.asarray(dryrun._doppler_input()), codes[3:4],
                                   1_023_000.0, cfg, dop_subset=dops)
    powers = np.asarray(jnp.max(grid_d.reshape(grid_d.shape[1], -1), axis=-1))

    cfg_sv = dryrun.scenario_config(world)
    ref_cfg = sc.ScenarioConfig(
        sample_rate=cfg_sv.sample_rate, seed=cfg_sv.seed,
        satellites=tuple(sc.SatelliteConfig(signal=s.signal, prn=s.prn, cn0_dbhz=s.cn0_dbhz,
                                            doppler_hz=s.doppler_hz, range_m=s.range_m)
                         for s in cfg_sv.satellites))
    gen = sc.GnssScenario(ref_cfg)
    args, key = gen.block_inputs(dryrun.COMPOSITE_SAMPLES)
    composite = np.asarray(sc.composite_block(*gen.sv_banks(), *args,
                                              jnp.asarray(0.0, jnp.float32), key,
                                              n=dryrun.COMPOSITE_SAMPLES,
                                              fs=ref_cfg.sample_rate))
    return {"mean_ber": mean_ber, "peaks": peaks, "powers": powers,
            "dops": np.asarray(dops), "composite": composite}


def test_mean_ber_equals_jax(dry):
    world, got = dry
    assert got["mean_ber"] == jax_unsharded(world)["mean_ber"]
    assert got["summary"].startswith(f"dryrun_multichip({world}): ok (dp×sp mean_ber=")


def test_prn_bank_peaks(dry):
    world, got = dry
    want = jax_unsharded(world)["peaks"]
    peaks = np.asarray(got["prn_peaks"])
    assert int(np.argmax(peaks)) == int(np.argmax(want)) == 3
    assert peaks.shape == want.shape == (world * dryrun.prns_per_rank(world),)
    assert float(np.max(np.abs(peaks - want))) <= PEAK_REL_TOL * float(np.max(want))


def test_doppler_bin(dry):
    world, got = dry
    want = jax_unsharded(world)
    powers = np.asarray(got["doppler"]["powers"])
    np.testing.assert_array_equal(np.asarray(got["doppler"]["dopplers"], np.float32),
                                  want["dops"])
    assert int(np.argmax(powers)) == int(np.argmax(want["powers"]))
    assert got["doppler"]["best"] == float(want["dops"][int(np.argmax(want["powers"]))])
    assert float(np.max(np.abs(powers - want["powers"]))) \
        <= PEAK_REL_TOL * float(np.max(want["powers"]))


def test_pipeline_has_no_errors(dry):
    world, got = dry
    assert got["pp_errs"] == [0] * world


def test_composite_within_tolerance_of_jax(dry):
    world, got = dry
    want = jax_unsharded(world)["composite"]
    composite = np.asarray(got["composite"]["re"]) + 1j * np.asarray(got["composite"]["im"])
    scale = float(np.max(np.abs(want)))
    assert composite.shape == want.shape == (dryrun.COMPOSITE_SAMPLES,)
    assert float(np.max(np.abs(composite - want))) <= COMPOSITE_TOL * max(scale, 1.0)
    assert got["composite"]["max_err"] <= dryrun.COMPOSITE_REL_TOL * max(scale, 1.0)


RANK_CODE = """
import functools, json, sys
import torch, torch.distributed as dist
from r4w_tpu_torch import parallel
from r4w_tpu_torch.parallel.dryrun import ring_shift
from r4w_tpu_torch.waveforms import lora

rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
torch.set_num_threads(1)
parallel.init_group(rank, world, port, "cpu")
try:
    mesh = parallel.make_mesh(("dp",), device="cpu")
    params = lora.LoRaParams(sf=7)
    payload = torch.arange(16, dtype=torch.int32) % 128
    ber = parallel.ber_sweep(functools.partial(lora.loopback_ber, params), payload,
                             {snrs}, n_lanes={lanes}, seed=3, mesh=mesh)
    grid = parallel.make_mesh(("dp", "sp"), (world // 2, 2), device="cpu") if world % 2 == 0 \\
        else parallel.make_mesh(("dp", "sp"), (world, 1), device="cpu")
    total = parallel.shard_map_sum(lambda v: v * 1.0, grid)(torch.tensor([float(rank + 1)]))
    ring = ring_shift(torch.tensor([complex(rank, -rank)] * 3, dtype=torch.complex64))
    try:
        parallel.make_mesh(device="cuda")
        wrong_backend = None
    except ValueError as e:
        wrong_backend = str(e)
    with open(f"{{out}}.{{rank}}", "w") as f:
        json.dump({{"ber": ber.tolist(), "total": total.tolist(),
                   "ring": [[z.real, z.imag] for z in ring.tolist()],
                   "wrong_backend": wrong_backend}}, f)
finally:
    dist.destroy_process_group()
""".format(snrs=SWEEP_SNRS, lanes=SWEEP_LANES)


def run_ranks(world: int, tmp_path) -> list:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    port, out = parallel.free_port(), str(tmp_path / "rank")
    procs = [subprocess.Popen([sys.executable, "-c", RANK_CODE, str(r), str(world), str(port),
                               out], env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=SPAWN_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [json.loads(Path(f"{out}.{r}").read_text()) for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_sweep_sum_ring_and_backend(world, tmp_path):
    ranks = run_ranks(world, tmp_path)
    params = lora.LoRaParams(sf=7)
    payload = torch.arange(16, dtype=torch.int32) % 128
    unsharded = parallel.ber_sweep(functools.partial(lora.loopback_ber, params), payload,
                                   SWEEP_SNRS, n_lanes=SWEEP_LANES, seed=3).tolist()
    full = sum(range(1, world + 1))
    for r, got in enumerate(ranks):
        assert got["ber"] == unsharded           # every rank gathers the whole grid
        assert got["total"] == [float(full)]     # summed over dp and sp
        prev = (r - 1) % world
        assert got["ring"] == [[float(prev), float(-prev)]] * 3
        assert "nccl" in got["wrong_backend"] and "gloo" in got["wrong_backend"]
    assert 0.0 < unsharded[0] and unsharded[-1] < unsharded[0]


def test_lane_noise_slices_the_whole_draw():
    """With a mesh, a rank's noise is its lanes' rows of the draw the
    unsharded sweep makes from the same generator."""

    class OneAxis:
        def get_group(self, axis):
            return "g"

    shape = (2, 3, 5)
    seen = {}

    def trial(snr, source):
        seen["noise"] = source(shape, torch.device("cpu"))
        return torch.zeros(snr.shape)

    gen = torch.Generator().manual_seed(9)
    whole = torch.Generator().manual_seed(9)
    re, im = torch.randn((6, 3, 5), generator=whole), torch.randn((6, 3, 5), generator=whole)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(parallel.dist, "get_world_size", lambda group=None: 3)
        mp.setattr(parallel.dist, "get_rank", lambda group=None: 1)
        mp.setattr(parallel, "all_gather_rows", lambda local, group: local)
        grid = parallel.monte_carlo_ber(trial, 6, (0.0, 1.0, 2.0), generator=gen,
                                        mesh=OneAxis())
    assert grid.shape == (2, 3)
    assert torch.equal(seen["noise"], torch.complex(re, im)[2:4])


def test_lanes_must_split_over_the_axis(monkeypatch):
    class OneAxis:
        def get_group(self, axis):
            return "g"

    monkeypatch.setattr(parallel.dist, "get_world_size", lambda group=None: 4)
    monkeypatch.setattr(parallel.dist, "get_rank", lambda group=None: 0)
    with pytest.raises(ValueError, match="do not split"):
        parallel.monte_carlo_ber(lambda s, g: s, 6, (0.0,), generator=torch.Generator(),
                                 mesh=OneAxis())


def test_dryrun_refuses_more_ranks_than_the_device_has():
    with pytest.raises(RuntimeError, match="needs 1 cuda ranks, cuda has 0"):
        dryrun.dryrun_multichip(1, "cuda")
    with pytest.raises(RuntimeError, match="cpu ranks"):
        dryrun.dryrun_multichip((os.cpu_count() or 1) + 1, "cpu")
    assert parallel.backend_for("cuda") == "nccl" and parallel.backend_for("cpu") == "gloo"
    with pytest.raises(ValueError):
        parallel.backend_for("meta")


def test_channel_model_names_equal_reference():
    assert typing.get_args(ChannelModelName) == typing.get_args(ref_channel.ChannelModelName)


def test_entry_reexports_dryrun():
    from r4w_tpu_torch import entry

    assert entry.dryrun_multichip is dryrun.dryrun_multichip


def test_dryrun_kills_ranks_at_its_timeout():
    with pytest.raises(RuntimeError, match=r"ranks timed out \[0, 1\] after 0.5 s"):
        dryrun.dryrun_multichip(2, "cpu", timeout_s=0.5)
