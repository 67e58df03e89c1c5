"""The port's DLL/PLL tracking against ``r4w_tpu.gnss.tracking``.

Three C/A channels at 2.046 MS/s with 20 ms nav bits and numpy noise at
48 dB-Hz, seeded 0.05 chips and 10 Hz off their truth, run 300 one-ms
blocks through the port's batched `track` and through ``jax.vmap(track)``.
``lax.scan`` compiles its body (fused multiply-adds, its own summation
order), so the two agree to float32 rounding carried by the loop, not bit
for bit. Tolerances: code phase 1e-3 chips; carrier frequency 0.1 Hz;
prompts and early/late magnitudes 1e-3 of the channel's largest prompt;
discriminators 1e-3; C/N0 0.05 dB; nav bits identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.gnss import prn as ref_prn
from r4w_tpu.gnss import tracking as ref_tracking
from r4w_tpu_torch.gnss import tracking

FS = 2.046e6
BLOCKS = 300
CN0_DBHZ = 48.0
# PRN, Doppler Hz, code phase at sample 0 (chips): code epochs, and so bit
# edges, near block edges, and no code phase crosses the wrap at 1023 chips
CHANNELS = ((7, 800.0, 0.3), (12, -1500.0, 0.6), (21, 2400.0, 0.5))
SEED_ERR_CHIPS, SEED_ERR_HZ = 0.05, -10.0
CODE_PHASE_TOL = 1e-3  # chips
FREQ_TOL = 0.1  # Hz
PROMPT_REL_TOL = 1e-3  # of the channel's largest |prompt|
DISC_TOL = 1e-3
CN0_TOL = 0.05  # dB


@pytest.fixture(autouse=True)
def one_thread():
    """A 1 ms block is a few thousand samples; torch's CPU thread pool costs
    more than it saves at that size (20x here on 8 threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _channel(prn_id, dop, chip0, n, rng, aux_prn=None):
    t = np.arange(n) / FS
    code = ref_prn.gps_ca_code(prn_id).astype(np.float64)
    bits = 1 - 2 * rng.integers(0, 2, n // int(FS * 0.02) + 2)
    chip = chip0 + t * 1.023e6 * (1 + dop / 1.57542e9)
    epoch = np.floor(chip).astype(np.int64)
    s = code[epoch % 1023] * bits[epoch // (1023 * 20)]  # bit edges on code epochs
    if aux_prn is not None:  # a data companion at the same alignment, half the amplitude
        s = s + 0.5 * ref_prn.gps_ca_code(aux_prn)[np.floor(chip).astype(np.int64) % 1023]
    s = s * np.exp(2j * np.pi * (dop * t + 0.1))
    std = np.sqrt(FS / 10 ** (CN0_DBHZ / 10) / 2)
    return (s + std * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    n = BLOCKS * int(FS / 1000)
    x = np.stack([_channel(p, d, c, n, rng) for p, d, c in CHANNELS])
    codes = np.stack([ref_prn.gps_ca_code(p) for p, _, _ in CHANNELS]).astype(np.float32)
    phase0 = np.array([c + SEED_ERR_CHIPS for _, _, c in CHANNELS], np.float32)
    dop0 = np.array([d + SEED_ERR_HZ for _, d, _ in CHANNELS], np.float32)
    return x, codes, phase0, dop0


def _hold(got, want):
    """Per-block outputs of the port (torch) within tolerance of JAX's."""
    want = {k: np.asarray(v) for k, v in want._asdict().items()}
    got = {k: v.numpy() for k, v in got._asdict().items()}
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    scale = np.abs(want["prompt_i"] + 1j * want["prompt_q"]).max(axis=-1, keepdims=True)
    for name in ("prompt_i", "prompt_q", "early_mag", "late_mag"):
        assert np.all(np.abs(got[name] - want[name]) <= PROMPT_REL_TOL * scale), name
    for name, tol in (("code_phase", CODE_PHASE_TOL), ("carrier_freq", FREQ_TOL),
                      ("dll_disc", DISC_TOL), ("pll_disc", DISC_TOL), ("cn0_dbhz", CN0_TOL)):
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=tol, err_msg=name)
    return got, want


def _vmap_track(cfg):
    return jax.jit(jax.vmap(lambda s, x, c: ref_tracking.track(cfg, s, x, c)))


def test_init_state_matches():
    cfg, pcfg = ref_tracking.TrackingConfig(sample_rate=FS), tracking.TrackingConfig(sample_rate=FS)
    _, _, phase0, dop0 = _inputs()
    want = ref_tracking.init_state(cfg, jnp.asarray(phase0), jnp.asarray(dop0))
    got = tracking.init_state(pcfg, phase0, dop0, device="cpu")
    for g, w in zip(got, want):
        assert g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert pcfg.loop_gains() == cfg.loop_gains() and pcfg.block_size == cfg.block_size == 2046


def test_three_channels_match_vmapped_reference():
    x, codes, phase0, dop0 = _inputs()
    cfg, pcfg = ref_tracking.TrackingConfig(sample_rate=FS), tracking.TrackingConfig(sample_rate=FS)
    _, want = _vmap_track(cfg)(ref_tracking.init_state(cfg, jnp.asarray(phase0), jnp.asarray(dop0)),
                               jnp.asarray(x), jnp.asarray(codes))
    final, got = tracking.track(pcfg, tracking.init_state(pcfg, phase0, dop0, device="cpu"),
                                torch.from_numpy(x), torch.from_numpy(codes))
    got, want = _hold(got, want)
    np.testing.assert_array_equal(final.code_phase.numpy(), got["code_phase"][:, -1])
    # locked: each loop ends on its channel's Doppler
    assert np.all(np.abs(got["carrier_freq"][:, -50:].mean(-1) - [d for _, d, _ in CHANNELS]) < 20)
    np.testing.assert_array_equal(tracking.extract_nav_bits(torch.from_numpy(got["prompt_i"])),
                                  np.asarray(ref_tracking.extract_nav_bits(want["prompt_i"])))


def test_shared_capture_read_by_start():
    """Two PRNs in one capture, each channel's windows from its own start
    sample (the receiver's epoch-aligned windows), against the reference's
    vmap of dynamic_slice; and the port's per-row path on copied windows."""
    rng = np.random.default_rng(4)
    n = (BLOCKS + 2) * 2046
    x = (_channel(5, 1200.0, 100.0, n, rng) + _channel(11, -700.0, 900.2, n, rng)
         ).astype(np.complex64)
    codes = np.stack([ref_prn.gps_ca_code(p) for p in (5, 11)]).astype(np.float32)
    start = np.array([1846, 246])  # samples to the next code epoch of each PRN
    phase0 = np.array([0.05, 0.25], np.float32)
    dop0 = np.array([1190.0, -690.0], np.float32)
    cfg, pcfg = ref_tracking.TrackingConfig(sample_rate=FS), tracking.TrackingConfig(sample_rate=FS)
    n_keep = ((n - int(start.max())) // 2046) * 2046
    run = jax.jit(jax.vmap(lambda s, c, i0, xx: ref_tracking.track(
        cfg, s, jax.lax.dynamic_slice(xx, (i0,), (n_keep,)), c), in_axes=(0, 0, 0, None)))
    _, want = run(ref_tracking.init_state(cfg, jnp.asarray(phase0), jnp.asarray(dop0)),
                  jnp.asarray(codes), jnp.asarray(start.astype(np.int32)), jnp.asarray(x))
    st = tracking.init_state(pcfg, phase0, dop0, device="cpu")
    _, got = tracking.track(pcfg, st, torch.from_numpy(x), torch.from_numpy(codes), start=start)
    _hold(got, want)
    rows = torch.from_numpy(np.stack([x[s: s + n_keep] for s in start]))
    _, by_row = tracking.track(pcfg, st, rows, torch.from_numpy(codes))
    _hold(by_row, want)


def test_aux_code_and_one_channel():
    """Two channels, each with a data companion code read as two sub-prompts
    a block, against the reference's vmap; then the first channel alone (no
    channel axis) against the same reference row. (XLA compiles a
    one-channel vmap with other roundings than a batch, so the reference is
    held at two channels.)"""
    rng = np.random.default_rng(9)
    pairs = ((7, 19, 800.0, 0.3), (12, 25, -1500.0, 0.6))  # PRN, aux PRN, Hz, chip
    x = np.stack([_channel(p, d, c, BLOCKS * 2046, rng, aux_prn=a) for p, a, d, c in pairs])
    codes = np.stack([ref_prn.gps_ca_code(p) for p, _, _, _ in pairs]).astype(np.float32)
    aux = np.stack([ref_prn.gps_ca_code(a) for _, a, _, _ in pairs]).astype(np.float32)
    phase0 = np.array([c + SEED_ERR_CHIPS for _, _, _, c in pairs], np.float32)
    dop0 = np.array([d + SEED_ERR_HZ for _, _, d, _ in pairs], np.float32)
    cfg, pcfg = ref_tracking.TrackingConfig(sample_rate=FS), tracking.TrackingConfig(sample_rate=FS)
    run = jax.jit(jax.vmap(lambda s, xx, c, a: ref_tracking.track(cfg, s, xx, c, aux_code=a,
                                                                   aux_per_block=2)))
    _, want = run(ref_tracking.init_state(cfg, jnp.asarray(phase0), jnp.asarray(dop0)),
                  jnp.asarray(x), jnp.asarray(codes), jnp.asarray(aux))
    _, got = tracking.track(pcfg, tracking.init_state(pcfg, phase0, dop0, device="cpu"),
                            torch.from_numpy(x), torch.from_numpy(codes),
                            aux_code=torch.from_numpy(aux), aux_per_block=2)
    assert got.aux_i.shape == (2, BLOCKS, 2)
    held, want_np = _hold(got, want)
    scale = np.abs(want_np["prompt_i"] + 1j * want_np["prompt_q"]).max(axis=-1)[:, None, None]
    assert np.abs(want_np["aux_i"]).max() > 0
    for name in ("aux_i", "aux_q"):
        assert np.all(np.abs(held[name] - want_np[name]) <= PROMPT_REL_TOL * scale), name
    _, one = tracking.track(pcfg, tracking.init_state(pcfg, phase0[0], dop0[0], device="cpu"),
                            torch.from_numpy(x[0]), torch.from_numpy(codes[0]),
                            aux_code=torch.from_numpy(aux[0]), aux_per_block=2)
    assert one.prompt_i.shape == (BLOCKS,) and one.aux_i.shape == (BLOCKS, 2)
    _hold(one, type(want)(*(v[0] for v in want)))


def test_extract_nav_bits_matches():
    p = np.random.default_rng(1).standard_normal((3, 413)).astype(np.float32)
    for bps in (20, 4):
        got = tracking.extract_nav_bits(torch.from_numpy(p), bps)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(ref_tracking.extract_nav_bits(p, bps)))


def test_dll_s_curve_matches():
    cfg = ref_tracking.TrackingConfig(sample_rate=4_092_000.0)  # tests/test_gnss.py:134
    code = ref_prn.gps_ca_code(1)
    offs = np.linspace(-1.0, 1.0, 21)
    got = tracking.dll_s_curve(tracking.TrackingConfig(sample_rate=4_092_000.0), code, offs,
                               device="cpu").numpy()
    np.testing.assert_allclose(got, np.asarray(ref_tracking.dll_s_curve(cfg, code, offs)),
                               rtol=0, atol=1e-5)
    assert got[10] == pytest.approx(0.0, abs=0.05) and got[13] > 0.1 and got[7] < -0.1
