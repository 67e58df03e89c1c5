"""The port's channel layer against ``r4w_tpu.channel`` and
``r4w_tpu.ops.impairments``.

JAX's threefry and torch's Philox give different noise, so parity runs
the reference's own draws: either JAX's noise injected (``noise=``) or a
threefry key (``key=``), for which `channel.threefry` makes JAX's draws in
numpy (`uniform`'s floats equal JAX's bit for bit). The Philox path is
held to ``tests/test_channel.py``'s statistics with the same bars. The
numpy tables of `channel.tdl` are copies of the reference's source.
"""

import ast
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from r4w_tpu import channel as ref_ch
from r4w_tpu.channel import channel as ref
from r4w_tpu.channel import tdl as ref_tdl
from r4w_tpu.core import types as ref_types
from r4w_tpu.ops import impairments as ref_imp
from r4w_tpu_torch import channel as ch
from r4w_tpu_torch.channel import awgn, threefry
from r4w_tpu_torch.channel import tdl
from r4w_tpu_torch.core import types
from r4w_tpu_torch.ops import impairments as imp

REL_TOL = 1e-5


def _samples(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    return float(np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("kw", [dict(), dict(path_loss_db=6.0), dict(measured_power=2.5)])
@pytest.mark.parametrize("snr_db", [-10.0, 0.0, 12.5])
def test_awgn_with_injected_noise_matches_reference(snr_db, kw):
    x = _samples((3, 256))
    key = jax.random.key(7)
    noise = np.array(ref._complex_normal(key, x.shape, 1.0))
    want = ref.awgn(key, x, snr_db, **kw)
    got = awgn(torch.from_numpy(x), snr_db, noise=torch.from_numpy(noise), **kw)
    assert got.dtype == torch.complex64 and got.shape == x.shape
    assert _rel(got, want) < REL_TOL


def test_awgn_batched_snr_matches_reference():
    x = _samples((4, 512), seed=1)
    snrs = np.array([-20.0, -5.0, 0.0, 30.0], np.float32)[:, None]  # broadcasts to (4, 1)
    key = jax.random.key(3)
    noise = np.array(ref._complex_normal(key, x.shape, 1.0))
    want = ref.awgn(key, x, snrs)
    got = awgn(torch.from_numpy(x), torch.from_numpy(snrs), noise=torch.from_numpy(noise))
    assert _rel(got, want) < REL_TOL


def test_awgn_lanes_by_snrs_grid_broadcasts_noise():
    """(lanes, 1, N) noise and (SNRs, 1) SNRs serve a (lanes, SNRs, N) grid in one call."""
    x = _samples((64,), seed=2)
    keys = jax.random.split(jax.random.key(5), 3)
    snrs = np.array([-4.0, 0.0], np.float32)
    noise = np.stack([np.asarray(ref._complex_normal(k, x.shape, 1.0)) for k in keys])
    got = awgn(torch.from_numpy(x).expand(3, 2, 64), torch.from_numpy(snrs)[:, None],
               noise=torch.from_numpy(noise)[:, None, :])
    assert got.shape == (3, 2, 64)
    for lane, k in enumerate(keys):
        for j, s in enumerate(snrs):
            assert _rel(got[lane, j], ref.awgn(k, x, s)) < REL_TOL


def test_awgn_generator_is_reproducible():
    x = torch.from_numpy(_samples((2, 1024)))
    a = awgn(x, 3.0, generator=torch.Generator().manual_seed(11))
    b = awgn(x, 3.0, generator=torch.Generator().manual_seed(11))
    c = awgn(x, 3.0, generator=torch.Generator().manual_seed(12))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_awgn_generator_noise_variance_within_three_sigma():
    x = torch.ones((64, 4096), dtype=torch.complex64)
    snr_db = 3.0
    noise = awgn(x, snr_db, generator=torch.Generator().manual_seed(0)) - x
    target = 10.0 ** (-snr_db / 10.0) / 2.0  # per component, signal power 1
    parts = torch.cat([noise.real.reshape(-1), noise.imag.reshape(-1)]).double()
    var = float(parts.var())
    assert abs(var - target) < 3.0 * target * np.sqrt(2.0 / parts.numel())
    assert abs(float(parts.mean())) < 3.0 * np.sqrt(target / parts.numel())


def test_awgn_needs_exactly_one_noise_source():
    x = torch.ones(8, dtype=torch.complex64)
    with pytest.raises(ValueError, match="exactly one"):
        awgn(x, 0.0)
    with pytest.raises(ValueError, match="exactly one"):
        awgn(x, 0.0, generator=torch.Generator(), noise=torch.zeros(8, dtype=torch.complex64))


def test_db_helpers_and_core_types_match_reference():
    db = np.array([-20.0, -3.0, 0.0, 7.5], np.float32)
    for name in ("db_to_linear_power", "db_to_linear_amplitude"):
        np.testing.assert_allclose(getattr(types, name)(db, device="cpu").numpy(),
                                   np.asarray(getattr(ref_types, name)(db)), rtol=1e-6)
    lin = np.array([1e-3, 0.5, 1.0, 1e4], np.float32)
    np.testing.assert_allclose(types.linear_power_to_db(lin, device="cpu").numpy(),
                               np.asarray(ref_types.linear_power_to_db(lin)), rtol=1e-6, atol=1e-5)
    sizes = (0, 1, 2, 3, 1000, 4096)
    assert [types.next_pow2(n) for n in sizes] == [ref_types.next_pow2(n) for n in sizes]
    assert (types.IQ_DTYPE, types.REAL_DTYPE, types.SYMBOL_DTYPE) == (
        torch.complex64, torch.float32, torch.int32)
    assert types.CommonParams() == types.CommonParams(**vars(ref_types.CommonParams()))
    err = types.BufferTooShort(4, 2)
    assert isinstance(err, types.DspError) and (err.expected, err.actual) == (4, 2)
    assert str(err) == str(ref_types.BufferTooShort(4, 2))


# ---------------------------------------------------------------- the rest of the channel layer

REPO = Path(__file__).resolve().parents[1]
# max|port - reference| / max|reference| on the reference's own draws: float32
# cos/sin and complex products part by ulps, and Jakes' 16-term sums of cosines
# and phase noise's cumulative sum add in another order (measured at most
# 3.7e-7 over these cases)
CHANNEL_TOL = 2e-6
THEORY_TOL = 2e-6  # absolute: JAX's float32 erfc is ~1e-6 off
SEEDS = (0, 3, 11, 12345)


def _rel_to(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    return float(np.max(np.abs(got.numpy() - want)) / max(float(np.max(np.abs(want))), 1e-30))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape,lo,hi", [((16,), 0.0, 1.0), ((16,), 0.0, 2 * np.pi),
                                         ((4, 2500), -3.5, 7.25), ((10_000,), 0.1, 0.7)])
def test_threefry_uniform_equals_jax_bit_for_bit(seed, shape, lo, hi):
    want = np.asarray(jax.random.uniform(jax.random.key(seed), shape, np.float32, lo, hi))
    got = threefry.uniform(threefry.key(seed), shape, lo, hi)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_awgn_with_key_draws_the_references_noise(seed):
    x = _samples((3, 2048), seed=seed)
    want = ref.awgn(jax.random.key(seed), x, 7.0, path_loss_db=2.0)
    got = awgn(torch.from_numpy(x), 7.0, key=threefry.key(seed), path_loss_db=2.0)
    assert _rel(got, want) < REL_TOL


@pytest.mark.parametrize("cfo_hz", [1000.0, -1234.5, 330_000.0, -0.25])
def test_cfo_matches_reference_with_floor_modulo(cfo_hz):
    x = _samples((2, 9000), seed=1)  # past one 4096-sample t_hi step
    got = ch.cfo(torch.from_numpy(x), cfo_hz, 1e6, initial_phase=0.3)
    assert _rel_to(got, ref.cfo(x, cfo_hz, 1e6, initial_phase=0.3)) < CHANNEL_TOL


def test_remainder_is_the_floor_modulo():
    v = torch.tensor([-2.75, -1.0, -0.25, -1e-8, 0.0, 0.5, 3.25], dtype=torch.float32)
    np.testing.assert_array_equal(torch.remainder(v, 1.0).numpy(),
                                  np.asarray(jax.numpy.mod(v.numpy(), 1.0)))


@pytest.mark.parametrize("delay,amp", [(0, 0.5), (3, 0.0), (7, 0.4), (5000, 0.9)])
def test_multipath_2ray_matches_reference(delay, amp):
    x = _samples((2, 300), seed=2)
    np.testing.assert_array_equal(ch.multipath_2ray(torch.from_numpy(x), delay, amp).numpy(),
                                  np.asarray(ref.multipath_2ray(x, delay, amp)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("model", ["rayleigh", "rician", "block_fading"])
def test_fading_on_the_references_draws(model, seed):
    x = _samples((3, 1000), seed=seed)
    k, key = threefry.key(seed), jax.random.key(seed)
    xt = torch.from_numpy(x)
    got, want = {
        "rayleigh": lambda: (ch.rayleigh(xt, key=k), ref.rayleigh(key, x)),
        "rician": lambda: (ch.rician(xt, 3.5, key=k), ref.rician(key, x, 3.5)),
        "block_fading": lambda: (ch.block_fading(xt, 300, key=k),
                                 ref.block_fading(key, x, 300)),
    }[model]()
    assert got.shape == x.shape and _rel_to(got, want) < CHANNEL_TOL


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fs,fd", [(125e3, 2.0), (1e6, 5.0), (30.72e6, 300.0)])
def test_doppler_processes_on_the_references_draws(fs, fd, seed):
    k, key = threefry.key(seed), jax.random.key(seed)
    jakes = ch.jakes_fading(8192, fd, fs, key=k, device="cpu")
    assert jakes.shape == (8192,) and jakes.dtype == torch.complex64
    assert _rel_to(jakes, ref_ch.jakes_fading(key, 8192, fd, fs)) < CHANNEL_TOL
    gauss = ch.gaussian_doppler_fading(8192, fd, fs, key=k, device="cpu")
    assert _rel_to(gauss, ref_ch.gaussian_doppler_fading(key, 8192, fd, fs)) < CHANNEL_TOL
    flat = ch.flat_doppler_shift(8192, fd, fs, device="cpu")
    assert _rel_to(flat, ref_ch.flat_doppler_shift(8192, fd, fs)) < CHANNEL_TOL
    assert ch.velocity_to_doppler(30.0, 2.4e9) == ref_ch.velocity_to_doppler(30.0, 2.4e9)


@pytest.mark.parametrize("profile", ["EPA", "EVA", "ETU"])
@pytest.mark.parametrize("fs", [125e3, 1e6, 30.72e6])
def test_tdl_channel_on_the_references_draws(profile, fs):
    x = _samples((2, 4096), seed=4)  # a batch: every row takes the same fading
    got = tdl.tdl_channel(torch.from_numpy(x), profile, fs, 50.0, key=threefry.key(5))
    assert _rel_to(got, ref_tdl.tdl_channel(jax.random.key(5), x, profile, fs, 50.0)) < CHANNEL_TOL


def test_tdl_at_125ksps_only_sums_fading_processes():
    delays, amps = tdl.profile_taps("EPA", 125e3)
    assert not delays.any()
    x = torch.ones((2, 512), dtype=torch.complex64)
    y = tdl.tdl_channel(x, "EPA", 125e3, 2.0, key=threefry.key(3))
    h = sum(float(a) * ch.jakes_fading(512, 2.0, 125e3, key=k, device="cpu")
            for a, k in zip(amps, threefry.split(threefry.key(3), len(delays))))
    torch.testing.assert_close(y[0], h, rtol=0, atol=1e-6)
    assert torch.equal(y[0], y[1])


@pytest.mark.parametrize("model", ["ideal", "awgn", "awgn_cfo", "awgnwithcfo", "multipath",
                                   "rayleigh", "rician", "tdl_awgn", "tdlawgn",
                                   "freq_selective", "frequencyselective", "jakes",
                                   "jakesfading"])
def test_apply_channel_follows_the_references_splits(model):
    x = _samples((2, 3000), seed=6)
    kw = dict(model=model, snr_db=15.0, cfo_hz=-100.0, multipath_delay=2,
              multipath_amplitude=0.3, sample_rate=1e6, tdl_profile="EVA", doppler_hz=20.0)
    want = ref.apply_channel(jax.random.key(6), x, ref.ChannelConfig(**kw))
    from r4w_tpu_torch import convert
    cfg = convert.channel_config_from_reference(ref.ChannelConfig(**kw))
    assert cfg == ch.ChannelConfig(**kw)
    got = ch.apply_channel(torch.from_numpy(x), cfg, key=threefry.key(6))
    assert _rel_to(got, want) < CHANNEL_TOL


def test_apply_channel_rejects_unknown_models_and_two_sources():
    x = torch.ones(8, dtype=torch.complex64)
    with pytest.raises(ValueError, match="unknown channel model"):
        ch.apply_channel(x, ch.ChannelConfig(model="warp"), key=threefry.key(0))
    with pytest.raises(ValueError, match="exactly one"):
        ch.apply_channel(x, ch.ChannelConfig(), key=threefry.key(0), generator=torch.Generator())
    with pytest.raises(ValueError, match="exactly one"):
        ch.rayleigh(x)


def test_theory_and_measured_snr_match_reference():
    snrs = np.linspace(-30.0, 10.0, 41).astype(np.float32)
    for sf in (7, 12):
        np.testing.assert_allclose(ch.theoretical_ber_awgn(snrs, sf, "cpu").numpy(),
                                   np.asarray(ref.theoretical_ber_awgn(snrs, sf)), rtol=0,
                                   atol=THEORY_TOL)
    x = _samples((3, 4096), seed=7)
    y = np.array(ref.awgn(jax.random.key(7), x, 9.0))
    np.testing.assert_allclose(ch.measure_snr(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
                               np.asarray(ref.measure_snr(x, y)), rtol=0, atol=1e-5)


def test_tdl_tables_are_the_references_source():
    def segments(path):
        text = path.read_text()
        out = {}
        for node in ast.parse(text).body:
            if isinstance(node, ast.FunctionDef):
                out[node.name] = ast.get_source_segment(text, node)
            elif isinstance(node, ast.Assign):
                out[node.targets[0].id] = ast.get_source_segment(text, node)
        return out

    got = segments(REPO / "r4w_tpu_torch" / "channel" / "tdl.py")
    want = segments(REPO / "r4w_tpu" / "channel" / "tdl.py")
    for name in ("TDL_PROFILES", "profile_taps", "rms_delay_spread", "coherence_bandwidth"):
        assert got[name] == want[name], name
    for profile in ("EPA", "EVA", "ETU"):
        for fs in (125e3, 1e6, 30.72e6):
            for a, b in zip(tdl.profile_taps(profile, fs), ref_tdl.profile_taps(profile, fs)):
                np.testing.assert_array_equal(a, b)
        assert tdl.coherence_bandwidth(profile) == ref_tdl.coherence_bandwidth(profile)


# ---------------------------------------------------------------- impairments


@pytest.mark.parametrize("seed", SEEDS)
def test_phase_noise_on_the_references_draws(seed):
    x = _samples((2, 8192), seed=seed)
    got = imp.phase_noise(torch.from_numpy(x), 100.0, 1e6, key=threefry.key(seed))
    assert _rel_to(got, ref_imp.phase_noise(jax.random.key(seed), x, 100.0, 1e6)) < CHANNEL_TOL


@pytest.mark.parametrize("gain_db,phase_deg", [(0.5, 2.0), (-1.2, -7.5), (3.0, 25.0)])
def test_iq_imbalance_estimate_and_correction_match_reference(gain_db, phase_deg):
    x = _samples((4096,), seed=8)
    z = np.array(ref_imp.iq_imbalance(x, gain_db, phase_deg))
    got = imp.iq_imbalance(torch.from_numpy(x), gain_db, phase_deg)
    assert _rel_to(got, z) < CHANNEL_TOL
    gain, phase = imp.iq_imbalance_estimate(torch.from_numpy(z))
    want_gain, want_phase = ref_imp.iq_imbalance_estimate(z)
    np.testing.assert_allclose(gain.numpy(), np.asarray(want_gain), rtol=1e-6)
    np.testing.assert_allclose(phase.numpy(), np.asarray(want_phase), rtol=1e-5, atol=1e-7)
    fixed = imp.iq_imbalance_correct(torch.from_numpy(z), gain, phase)
    want = ref_imp.iq_imbalance_correct(z, want_gain, want_phase)
    assert _rel_to(fixed, want) < CHANNEL_TOL


@pytest.mark.parametrize("name,args", [("dc_offset", (0.1, -0.2)), ("saleh_pa", ()),
                                       ("saleh_pa", (1.9, 1.0, 3.0, 8.0)), ("rapp_pa", ()),
                                       ("rapp_pa", (0.8, 3.0))])
def test_memoryless_impairments_match_reference(name, args):
    x = _samples((2, 4096), seed=9)
    got = getattr(imp, name)(torch.from_numpy(x), *args)
    assert got.dtype == torch.complex64
    assert _rel_to(got, getattr(ref_imp, name)(x, *args)) < CHANNEL_TOL


@pytest.mark.parametrize("bits,full_scale", [(12, 1.0), (8, 2.0), (4, 0.7)])
def test_quantize_dac_matches_reference_and_rounds_half_to_even(bits, full_scale):
    x = _samples((2, 4096), seed=10)
    np.testing.assert_array_equal(imp.quantize_dac(torch.from_numpy(x), bits, full_scale).numpy(),
                                  np.asarray(ref_imp.quantize_dac(x, bits, full_scale)))


@pytest.mark.parametrize("bits,full_scale", [(12, 1.0), (8, 2.0), (4, 0.5)])
def test_quantize_dac_rounds_exact_half_steps_to_even(bits, full_scale):
    step = full_scale / 2 ** (bits - 1)  # a power of two: (k + 0.5)·step is exact
    half = ((np.arange(-9, 9) + 0.5) * step).astype(np.float32)
    halves = (half + 1j * half[::-1]).astype(np.complex64)
    got = imp.quantize_dac(torch.from_numpy(halves), bits, full_scale).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref_imp.quantize_dac(halves, bits, full_scale)))
    levels = got.real / np.float32(step)
    inside = np.abs(half / np.float32(step)) < 2 ** (bits - 1) - 1  # not clipped
    assert np.all(levels[inside] % 2 == 0)  # the even neighbour of each half step


def test_ops_and_channel_export_as_the_reference():
    import r4w_tpu.ops as ref_ops
    import r4w_tpu_torch.ops as ops

    assert set(ch.__all__) == set(ref_ch.__all__)
    assert "impairments" in ops.__all__ and "impairments" in ref_ops.__all__
    assert ops.impairments is imp


# ---------------------------------------------------------------- Philox statistics
# tests/test_channel.py's statistics on the port's Philox draws, with its bars


def _tone(n=4096):
    return torch.exp(1j * 0.1 * torch.arange(n, dtype=torch.float32)).to(torch.complex64)


def test_philox_awgn_snr_matches_configured():
    x = _tone(1 << 14)
    for snr in (0.0, 10.0, 20.0):
        y = awgn(x, snr, generator=torch.Generator().manual_seed(1))
        assert abs(float(ch.measure_snr(x, y)) - snr) < 1.0


def test_cfo_rotates_tone():
    fs = 125_000.0
    y = ch.cfo(torch.ones(1000, dtype=torch.complex64), cfo_hz=1000.0, sample_rate=fs).numpy()
    freq = np.mean(np.angle(y[1:] * np.conj(y[:-1]))) * fs / (2 * np.pi)
    assert abs(freq - 1000.0) < 1.0


@pytest.mark.parametrize("model", ["rayleigh", "rician", "block_fading"])
def test_philox_fading_unit_mean_power(model):
    x = torch.ones(1 << 16, dtype=torch.complex64)
    gen = torch.Generator().manual_seed(2)
    y = {"rayleigh": lambda: ch.rayleigh(x, generator=gen),
         "rician": lambda: ch.rician(x, 5.0, generator=gen),
         "block_fading": lambda: ch.block_fading(x.expand(64, -1), 256, generator=gen)}[model]()
    assert abs(float(torch.mean(torch.abs(y) ** 2)) - 1.0) < 0.05


def test_multipath_2ray_impulse():
    x = torch.zeros(16, dtype=torch.complex64)
    x[0] = 1.0
    y = ch.multipath_2ray(x, delay_samples=3, amplitude=0.5).numpy()
    assert abs(y[0] - 1.0) < 1e-6 and abs(y[3] - 0.5) < 1e-6


def test_philox_jakes_fading_statistics():
    h = ch.jakes_fading(1 << 15, 100.0, 125_000.0, generator=torch.Generator().manual_seed(4))
    assert 0.5 < float(torch.mean(torch.abs(h) ** 2)) < 2.0
    assert float(torch.std(torch.abs(h))) > 0.1


def test_philox_tdl_profiles_exist_and_apply():
    x = _tone(8192)
    for profile in ("EPA", "EVA", "ETU"):
        y = ch.tdl_channel(x, profile, 30.72e6, 50.0, generator=torch.Generator().manual_seed(5))
        assert y.shape == x.shape and bool(torch.all(torch.isfinite(torch.view_as_real(y))))


def test_rms_delay_spread_ordering():
    assert ch.rms_delay_spread("EPA") < ch.rms_delay_spread("EVA") < ch.rms_delay_spread("ETU")


def test_philox_apply_channel_dispatch():
    x = _tone()
    for model in ("ideal", "awgn", "awgn_cfo", "multipath", "rayleigh", "rician", "tdl_awgn",
                  "jakes"):
        cfg = ch.ChannelConfig(model=model, snr_db=15.0, cfo_hz=100.0, multipath_delay=2,
                               multipath_amplitude=0.3, sample_rate=125_000.0)
        assert ch.apply_channel(x, cfg, generator=torch.Generator().manual_seed(6)).shape == x.shape


def test_theoretical_ber_monotone():
    ber = ch.theoretical_ber_awgn([-20.0, -10.0, 0.0], 7, "cpu").numpy()
    assert ber[0] > ber[1] > ber[2]


def test_monte_carlo_lanes_are_decorrelated_on_the_references_keys():
    """tests/test_channel.py:100's lanes: key 7 split into 64, its bar. At
    10 dB the lanes share a tone of 10x the noise power, so the expected
    correlation of two lanes is 1/1.1 = 0.909, above the bar: the
    reference passes on its own draws, which the port reproduces."""
    x = _tone(1024)
    lanes = threefry.split(threefry.key(7), 64)
    ys = torch.stack([awgn(x, 10.0, key=k) for k in lanes])
    want = np.asarray(jax.vmap(lambda k: ref.awgn(k, x.numpy(), 10.0))(
        jax.random.split(jax.random.key(7), 64)))
    assert ys.shape == (64, 1024) and _rel_to(ys, want) < REL_TOL
    assert abs(np.corrcoef(ys[0].real.numpy(), ys[1].real.numpy())[0, 1]) < 0.9


def test_philox_monte_carlo_lanes_draw_independent_noise():
    """The Philox lanes' noise itself is uncorrelated (|r| < 0.15, about 5
    standard errors at 1024 samples): one generator draws every lane."""
    x = _tone(1024)
    ys = awgn(x.expand(64, -1), 10.0, generator=torch.Generator().manual_seed(7))
    noise = (ys - x).real.numpy()
    assert ys.shape == (64, 1024)
    assert abs(np.corrcoef(noise[0], noise[1])[0, 1]) < 0.15


def test_philox_phase_noise_variance():
    x = torch.ones((256, 512), dtype=torch.complex64)
    y = imp.phase_noise(x, 1000.0, 1e6, generator=torch.Generator().manual_seed(8))
    steps = torch.angle(y[:, 1:] * torch.conj(y[:, :-1])).double()
    var = float(steps.var())
    target = 2 * np.pi * 1000.0 / 1e6
    assert abs(var - target) < 3.0 * target * np.sqrt(2.0 / steps.numel())


# ---------------------------------------------------------------- default device


def _on_meta(fn) -> None:
    """`fn()` returns tensors on meta (the stand-in for the card here)."""
    out = fn()
    for t in out if isinstance(out, tuple) else (out,):
        assert t.device.type == "meta", t.device


_X = _samples((64,), seed=11)
CREATES_TENSORS = {
    "cfo": lambda: ch.cfo(_X, 100.0, 1e3),
    "multipath_2ray": lambda: ch.multipath_2ray(_X, 2, 0.5),
    "rayleigh": lambda: ch.rayleigh(_X, key=threefry.key(1)),
    "awgn_key": lambda: awgn(_X, 3.0, key=threefry.key(1)),
    "jakes_fading": lambda: ch.jakes_fading(64, 5.0, 1e3, key=threefry.key(1)),
    "gaussian_doppler_fading": lambda: ch.gaussian_doppler_fading(64, 5.0, 1e3,
                                                                  key=threefry.key(1)),
    "flat_doppler_shift": lambda: ch.flat_doppler_shift(64, 5.0, 1e3),
    "tdl_channel": lambda: ch.tdl_channel(_X, "EPA", 1e6, 5.0, key=threefry.key(1)),
    "theoretical_ber_awgn": lambda: ch.theoretical_ber_awgn([0.0, 3.0], 7),
    "phase_noise": lambda: imp.phase_noise(_X, 10.0, 1e3, key=threefry.key(1)),
    "iq_imbalance_estimate": lambda: imp.iq_imbalance_estimate(_X),
    "quantize_dac": lambda: imp.quantize_dac(_X),
}


@pytest.mark.parametrize("name", sorted(CREATES_TENSORS))
def test_numpy_and_threefry_draws_go_to_the_default_device(name, monkeypatch):
    """With the default device set to meta, numpy input and host-made
    threefry draws land there, never on the CPU."""
    monkeypatch.setattr(types, "DEFAULT_DEVICE", torch.device("meta"))
    _on_meta(CREATES_TENSORS[name])
