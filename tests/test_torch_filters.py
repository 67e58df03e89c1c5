"""The port's DDC path against ``r4w_tpu``: FIRs, designs, resamplers, DDC/DUC.

The same numpy inputs go through the JAX functions (on the CPU) and the
port's (``device="cpu"``, the plain versions of the FIR and NCO kernels).
Designs and windows are numpy copies and must agree bit for bit; filter
outputs agree within 1e-5 of their peak (float32 sums taken in another
order), mixer outputs within 1e-4 (the same float32 phase, then sin and
cos from two libraries). Also here: a stream begun in JAX goes on in the
port, and entry points handed numpy put it on the default device.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.core import windows as ref_windows
from r4w_tpu.ops import filters as ref_filters
from r4w_tpu.ops import filters2 as ref_filters2
from r4w_tpu.ops import resample as ref_resample
from r4w_tpu.ops import stream_math as ref_stream_math
from r4w_tpu_torch import convert, entry
from r4w_tpu_torch.channel import awgn
from r4w_tpu_torch.core import types, windows
from r4w_tpu_torch.ops import coding, filters, filters2, resample, stream_math
from r4w_tpu_torch.parallel import batch_demodulate, batch_modulate, ber_sweep
from r4w_tpu_torch.waveforms import lora
from r4w_tpu_torch.waveforms.lora import chirp
from r4w_tpu_torch.waveforms.lora_waveform import LoRaWaveform

FIR_TOL = 1e-5  # of max|y|
MIX_TOL = 1e-4  # of max|y|
WINDOWS = ("rect", "rectangular", "boxcar", "none", "hann", "hamming", "blackman",
           "blackmanharris", "bartlett", "flattop", "kaiser", "gaussian")


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _signal(rng, shape, complex_=True) -> np.ndarray:
    x = rng.standard_normal(shape)
    if complex_:
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(np.complex64 if complex_ else np.float32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------------- FIRs


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("with_state", [False, True])
def test_fir_filter_and_apply_match_reference(complex_, with_state):
    rng = np.random.default_rng(10 + 2 * complex_ + with_state)
    taps = rng.standard_normal(33).astype(np.float32)
    x = _signal(rng, (2, 700), complex_)
    state = _signal(rng, (2, 32), complex_) if with_state else None
    want_y, want_s = ref_filters.fir_filter(taps, jnp.asarray(x),
                                            None if state is None else jnp.asarray(state))
    got_y, got_s = filters.fir_filter(taps, _t(x), None if state is None else _t(state))
    assert got_y.dtype == (torch.complex64 if complex_ else torch.float32)
    assert _rel(got_y, want_y) < FIR_TOL
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    if not with_state:
        assert _rel(filters.fir_apply(taps, _t(x)), ref_filters.fir_apply(taps, jnp.asarray(x))) \
            < FIR_TOL


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_decimating_fir_in_blocks_matches_reference_one_shot(factor):
    rng = np.random.default_rng(factor)
    taps = ref_filters.design_lowpass(31, 0.4 / factor, 1.0)
    x = _signal(rng, (3, 4 * 512))
    want, want_state = ref_filters.decimating_fir(taps, jnp.asarray(x), factor)
    blocks, state = [], None
    for block in np.split(x, 4, axis=-1):
        y, state = filters.decimating_fir(taps, _t(block), factor, state)
        blocks.append(y)
    got = torch.cat(blocks, dim=-1)
    assert got.shape == (3, 4 * 512 // factor)
    assert _rel(got, want) < FIR_TOL
    np.testing.assert_array_equal(state.numpy(), np.asarray(want_state))
    one_shot, _ = filters.decimating_fir(taps, _t(x), factor)
    torch.testing.assert_close(got, one_shot, rtol=0, atol=1e-6)


@pytest.mark.parametrize("factor,complex_", [(3, True), (5, False), (1, True)])
def test_decimating_fir_is_fir_filter_kept_every_factor(factor, complex_):
    """fir_decimate(cat(state, x), taps[::-1], f) == fir_filter(taps, x, state)[0][..., ::f]."""
    rng = np.random.default_rng(20 + factor)
    taps = rng.standard_normal(21).astype(np.float32)
    x, state = _t(_signal(rng, (2, 301), complex_)), _t(_signal(rng, (2, 20), complex_))
    dense, dense_state = filters.fir_filter(taps, x, state)
    kept, kept_state = filters.decimating_fir(taps, x, factor, state)
    assert kept.shape[-1] == math.ceil(301 / factor)
    torch.testing.assert_close(kept, dense[..., ::factor], rtol=0, atol=1e-6)
    assert torch.equal(kept_state, dense_state)


@pytest.mark.parametrize("block", [10, 64])
def test_fir_filter_in_short_blocks_matches_reference_one_shot(block):
    """Blocks shorter than K-1 (the new state is then partly the old one) and
    longer, the state carried from none: the outputs equal JAX's one shot
    and the last state equals JAX's."""
    rng = np.random.default_rng(block)
    taps = rng.standard_normal(31).astype(np.float32)
    x = _signal(rng, (2, 6 * block))
    want, want_state = ref_filters.fir_filter(taps, jnp.asarray(x))
    parts, state = [], None
    for chunk in np.split(x, 6, axis=-1):
        y, state = filters.fir_filter(taps, _t(chunk), state)
        parts.append(y)
    assert _rel(torch.cat(parts, dim=-1), want) < FIR_TOL
    np.testing.assert_array_equal(state.numpy(), np.asarray(want_state))


@pytest.mark.parametrize("n", [100, 10])
def test_new_state_is_a_copy_of_the_block(n):
    """Refilling the block's buffer after the call leaves the state alone."""
    rng = np.random.default_rng(n)
    taps = rng.standard_normal(15).astype(np.float32)
    x, state = _t(_signal(rng, (2, n))), _t(_signal(rng, (2, 14)))
    want = torch.cat([state, x], dim=-1)[..., -14:].clone()
    for fn in (lambda: filters.fir_filter(taps, x, state),
               lambda: filters.decimating_fir(taps, x, 4, state)):
        _, new_state = fn()
        assert new_state.is_contiguous()
        assert new_state.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()
        saved = x.clone()
        x.fill_(7.0)
        assert torch.equal(new_state, want)
        x.copy_(saved)


def test_filters_hand_the_state_to_the_kernel_and_never_concatenate(monkeypatch):
    """fir_filter and decimating_fir pass x itself and the state (or
    zero_state, nothing allocated) to the dispatcher: no concatenation and
    no zero fill around the kernel when N >= K-1."""
    calls = []

    def dispatch(x, taps, factor=1, state=None, *, zero_state=False):
        calls.append((x, state, zero_state, factor))
        return x[..., ::factor]

    def refuse(*args, **kwargs):
        raise AssertionError("the filter concatenated or filled around the kernel")

    rng = np.random.default_rng(3)
    taps = rng.standard_normal(9).astype(np.float32)
    x, state = _t(_signal(rng, (2, 50))), _t(_signal(rng, (2, 8)))
    monkeypatch.setattr(filters, "fir_decimate_dispatch", dispatch)
    monkeypatch.setattr(torch, "cat", refuse)
    monkeypatch.setattr(torch, "zeros", refuse)
    monkeypatch.setattr(torch.Tensor, "new_zeros", refuse)
    filters.fir_filter(taps, x)
    filters.decimating_fir(taps, x, 4, state)
    (x1, s1, z1, f1), (x2, s2, z2, f2) = calls
    assert x1 is x and s1 is None and z1 and f1 == 1
    assert x2 is x and s2 is state and not z2 and f2 == 4


def test_interpolating_fir_and_moving_filters_match_reference():
    rng = np.random.default_rng(30)
    taps = ref_filters.design_lowpass(25, 0.1, 1.0)
    x = _signal(rng, (2, 300))
    xr = _signal(rng, (400,), complex_=False)
    assert _rel(filters.interpolating_fir(taps, _t(x), 4),
                ref_filters.interpolating_fir(taps, jnp.asarray(x), 4)) < FIR_TOL
    got, got_s = filters.moving_average(_t(xr), 16)
    want, want_s = ref_filters.moving_average(jnp.asarray(xr), 16)
    assert _rel(got, want) < FIR_TOL
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    for sig in (x, xr):
        assert _rel(filters.moving_rms(_t(sig), 8), ref_filters.moving_rms(jnp.asarray(sig), 8)) \
            < FIR_TOL


def test_freq_xlating_fir_in_blocks_matches_reference_one_shot():
    """A centre whose phase step is 1/16 rad, so every block's float32 phase
    equals the one-shot phase exactly and only the filter state carries."""
    fs = 1e6
    center = -fs / (32 * math.pi)
    assert np.float32(-2.0 * math.pi * center / fs) == np.float32(1 / 16)
    rng = np.random.default_rng(40)
    taps = ref_filters.design_lowpass(31, 50e3, fs)
    x = _signal(rng, (2, 3 * 512))
    want, want_state, want_phase = ref_filters.freq_xlating_fir(taps, jnp.asarray(x), center, fs)
    got, _, phase = filters.freq_xlating_fir(taps, _t(x), center, fs)
    assert _rel(got, want) < MIX_TOL and phase == want_phase
    blocks, state, phase, ref_state, ref_phase = [], None, 0.0, None, 0.0
    for block in np.split(x, 3, axis=-1):
        y, state, phase = filters.freq_xlating_fir(taps, _t(block), center, fs, state, phase)
        _, ref_state, ref_phase = ref_filters.freq_xlating_fir(
            taps, jnp.asarray(block), center, fs, ref_state, ref_phase)
        assert phase == ref_phase
        blocks.append(y)
    assert _rel(torch.cat(blocks, dim=-1), want) < FIR_TOL
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state), rtol=0, atol=1e-5)


def test_fir_stream_continues_from_reference_state():
    """Two blocks in JAX, the state carried across by convert.fir_from_reference,
    two more in the port: the whole equals JAX's one-shot output."""
    rng = np.random.default_rng(50)
    taps = ref_filters.design_lowpass(63, 0.05, 1.0)
    x = _signal(rng, (2, 4 * 400))
    want, _ = ref_filters.decimating_fir(taps, jnp.asarray(x), 8)
    parts, state = np.split(x, 4, axis=-1), None
    head = []
    for block in parts[:2]:
        y, state = ref_filters.decimating_fir(taps, jnp.asarray(block), 8, state)
        head.append(np.asarray(y))
    taps_t, state_t = convert.fir_from_reference(taps, np.asarray(state), device="cpu")
    assert taps_t.dtype == torch.float32 and state_t.dtype == torch.complex64
    assert convert.fir_from_reference(taps, device="cpu")[1] is None
    tail = []
    for block in parts[2:]:
        y, state_t = filters.decimating_fir(taps_t, _t(block), 8, state_t)
        tail.append(y.numpy())
    assert _rel(np.concatenate(head + tail, axis=-1), want) < FIR_TOL


# ------------------------------------------------------- designs, windows


@pytest.mark.parametrize("kind", WINDOWS)
@pytest.mark.parametrize("n", [1, 2, 33, 64])
def test_windows_equal_reference(kind, n):
    np.testing.assert_array_equal(windows._np_window(kind, n), ref_windows._np_window(kind, n))
    got = windows.make_window(kind, n, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_windows.make_window(kind, n)))
    np.testing.assert_array_equal(windows.window_gains(kind, n), ref_windows.window_gains(kind, n))


def test_window_options_and_unknown_kind():
    for kind, kw in (("kaiser", {"beta": 5.0}), ("gaussian", {"sigma": 0.3})):
        np.testing.assert_array_equal(windows._np_window(kind, 40, **kw),
                                      ref_windows._np_window(kind, 40, **kw))
    with pytest.raises(ValueError, match="unknown window"):
        windows.make_window("triangle", 8, device="cpu")


@pytest.mark.parametrize("name,args", [
    ("design_lowpass", (63, 30.72e6 / 20, 30.72e6)),
    ("design_lowpass", (64, 0.2, 1.0, "blackman")),
    ("design_highpass", (31, 0.1, 1.0)),
    ("design_highpass", (51, 2e3, 48e3, "hann")),
    ("design_bandpass", (41, 0.1, 0.2, 1.0)),
    ("design_bandpass", (65, 8e3, 12e3, 48e3, "kaiser")),
    ("hilbert_fir_taps", ()),
    ("hilbert_fir_taps", (31, "blackman")),
    ("fractional_delay_taps", (0.3,)),
    ("fractional_delay_taps", (-0.25, 16)),
    ("design_equiripple", (31, [(0.0, 0.1), (0.2, 0.5)], [1.0, 0.0])),
    ("design_equiripple", (41, [(0.0, 0.15), (0.25, 0.5)], [1.0, 0.0], [1.0, 10.0])),
    ("design_remez", (31, [(0.0, 0.1), (0.2, 0.5)], [1.0, 0.0])),
    ("design_remez", (45, [(0.0, 0.1), (0.15, 0.3), (0.35, 0.5)], [0.0, 1.0, 0.0])),
])
def test_designs_equal_reference(name, args):
    got, want = getattr(filters, name)(*args), getattr(ref_filters, name)(*args)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_design_errors_match_reference():
    for fn in (filters.design_equiripple, filters.design_remez):
        with pytest.raises(ValueError, match="odd tap count"):
            fn(30, [(0.0, 0.1), (0.2, 0.5)], [1.0, 0.0])
        with pytest.raises(ValueError, match="equal length"):
            fn(31, [(0.0, 0.1), (0.2, 0.5)], [1.0])
    with pytest.raises(ValueError, match="odd tap count"):
        resample.halfband_taps(30)


# ------------------------------------------------------------- resamplers


@pytest.mark.parametrize("num_taps", [15, 31])
def test_polyphase_decompose_and_halfband_taps_equal_reference(num_taps):
    taps = ref_filters.design_lowpass(num_taps, 0.1, 1.0)
    for phases in (2, 4, 5):
        np.testing.assert_array_equal(resample.polyphase_decompose(taps, phases),
                                      ref_resample.polyphase_decompose(taps, phases))
    np.testing.assert_array_equal(resample.halfband_taps(num_taps),
                                  ref_resample.halfband_taps(num_taps))


@pytest.mark.parametrize("name,args", [
    ("polyphase_decimate", (4,)),
    ("polyphase_interpolate", (3,)),
    ("rational_resample", (3, 2)),
    ("rational_resample", (2, 3)),
    ("halfband_decimate", ()),
])
def test_resamplers_match_reference(name, args):
    rng = np.random.default_rng(len(name) + len(args))
    x = _signal(rng, (2, 600))
    taps = ref_filters.design_lowpass(29, 0.1, 1.0)
    if name.startswith("polyphase"):
        got = getattr(resample, name)(_t(x), taps, *args)
        want = getattr(ref_resample, name)(jnp.asarray(x), taps, *args)
    else:
        got = getattr(resample, name)(_t(x), *args)
        want = getattr(ref_resample, name)(jnp.asarray(x), *args)
    assert got.dtype == torch.complex64
    assert _rel(got, want) < FIR_TOL


# ------------------------------------------------------------ DDC/DUC/VCO


def test_ddc_matches_reference_channel_extraction():
    """tests/test_detect_streammath.py: +200 kHz wanted, -300 kHz interferer."""
    fs = 1_000_000.0
    n = np.arange(65536)
    x = (np.exp(2j * np.pi * 200e3 * n / fs)
         + np.exp(2j * np.pi * -300e3 * n / fs)).astype(np.complex64)
    want = np.asarray(ref_stream_math.digital_down_convert(jnp.asarray(x), 200e3, fs,
                                                           decimation=8))
    got = stream_math.digital_down_convert(_t(x), 200e3, fs, decimation=8).numpy()
    assert _rel(got, want) < MIX_TOL
    spec = np.abs(np.fft.fft(got))
    assert np.argmax(spec) in (0, 1, len(spec) - 1)
    assert spec.max() > 8 * np.sort(spec)[-len(spec) // 4]


def test_ddc_and_duc_match_reference_up_down_conversion():
    """tests/test_known_answers_r4q.py: a 2 kHz tone up-converted ×4 to
    40 kHz, then down-converted; each stage against the reference."""
    fs_in, interp, f_c, f_b = 50e3, 4, 40e3, 2e3
    x = np.exp(2j * np.pi * f_b * np.arange(4096) / fs_in).astype(np.complex64)
    want_up = np.asarray(ref_filters2.digital_up_converter(jnp.asarray(x), interp, f_c,
                                                           fs_in * interp))
    got_up = filters2.digital_up_converter(_t(x), interp, f_c, fs_in * interp)
    assert _rel(got_up, want_up) < MIX_TOL
    want = np.asarray(ref_stream_math.digital_down_convert(jnp.asarray(want_up), f_c,
                                                           fs_in * interp, interp))
    got = stream_math.digital_down_convert(_t(want_up), f_c, fs_in * interp, interp)
    assert _rel(got, want) < MIX_TOL
    # the round trip through the port alone, at the reference test's bar
    down = stream_math.digital_down_convert(got_up, f_c, fs_in * interp, interp).numpy()
    ref = np.exp(-2j * np.pi * f_b * np.arange(down.shape[0]) / fs_in)
    seg = slice(128, down.shape[0] - 128)
    assert np.abs(np.mean(down[seg] * ref[seg])) == pytest.approx(1.0, rel=0.1)


def test_duc_ddc_round_trip_at_the_smoke_rates():
    """Batched baseband at 3.84 MS/s, ×8 to 30.72 MS/s at 7.68 MHz and back:
    the 120 kHz tone returns at amplitude 1 ± 0.02 in every stream."""
    fs_in, interp, f_c = 3.84e6, 8, 7.68e6
    rng = np.random.default_rng(60)
    start = rng.uniform(0, 2 * np.pi, (2, 1))
    m = np.arange(1 << 13)
    x = np.exp(1j * (2 * np.pi * 120e3 * m / fs_in + start)).astype(np.complex64)
    up = filters2.digital_up_converter(_t(x), interp, f_c, fs_in * interp)
    down = stream_math.digital_down_convert(up, f_c, fs_in * interp, interp).numpy()
    assert down.shape == x.shape
    seg = slice(64, x.shape[-1] - 64)
    amp = np.abs(np.mean(down[:, seg] * np.conj(x[:, seg]), axis=-1))
    assert np.all(np.abs(amp - 1.0) < 0.02), amp


def test_vco_matches_reference():
    rng = np.random.default_rng(70)
    ctrl = rng.uniform(-1.0, 1.0, (2, 4096)).astype(np.float32)
    want = np.asarray(ref_stream_math.vco(jnp.asarray(ctrl), 2000.0, 100e3, phase0=0.5))
    got = stream_math.vco(_t(ctrl), 2000.0, 100e3, phase0=0.5)
    assert got.dtype == torch.complex64
    assert _rel(got, want) < MIX_TOL


def test_ddc_bench_checks_at_a_small_size():
    x = entry.ddc_signal("cpu", seed=1, streams=2, samples=1 << 15)
    y = stream_math.digital_down_convert(x, entry.DDC_CENTER_HZ, entry.DDC_RATE_HZ,
                                         entry.DDC_DECIMATION)
    checks = entry.ddc_check(y)
    assert y.shape == (2, 1 << 12) and checks["rejection_db"] >= entry.DDC_REJECTION_DB
    with pytest.raises(AssertionError, match="amplitude"):
        entry.ddc_check(0.5 * y)
    with pytest.raises(ValueError, match="CUDA"):
        entry.ddc_bench("cpu")


@pytest.mark.cuda
def test_ddc_on_card_launches_no_concatenation_and_no_fill():
    """The DDC on the card: the NCO and FIR kernels, the state's copy, and no
    concatenation or zero-fill kernel (the profiler's device events)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    x = entry.ddc_signal("cuda", seed=1, streams=2, samples=1 << 15)
    stream_math.digital_down_convert(x, entry.DDC_CENTER_HZ, entry.DDC_RATE_HZ,
                                     entry.DDC_DECIMATION)  # warm-up: loads the kernels
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        y = stream_math.digital_down_convert(x, entry.DDC_CENTER_HZ, entry.DDC_RATE_HZ,
                                             entry.DDC_DECIMATION)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any("fir_decimate_kernel" in n for n in names)
    assert any("nco_mix" in n for n in names)
    assert not [n for n in names if "cat" in n.lower() or "fill" in n.lower()], names
    entry.ddc_check(y)


# ------------------------------------------- numpy inputs go to the device


def _lands_on_meta(fn):
    """`fn()` either returns a tensor on meta or fails naming the meta device."""
    try:
        out = fn()
    except (ValueError, RuntimeError) as err:
        assert "meta" in str(err).lower(), err
    else:
        out = out if isinstance(out, torch.Tensor) else out.symbols
        assert out.device.type == "meta", out.device


_P7 = lora.LoRaParams(sf=7)
_RX = np.zeros(_P7.samples_per_symbol * 8, np.complex64)
NUMPY_ENTRY_POINTS = {
    "waveform_demodulate": lambda: LoRaWaveform(device=torch.device("meta")).demodulate(_RX),
    "awgn": lambda: awgn(_RX, 3.0, noise=torch.zeros(_RX.shape, dtype=torch.complex64)),
    "symbol_chirps": lambda: chirp.symbol_chirps(_P7, np.array([1, 2, 3], np.int32)),
    "demodulate_symbols": lambda: lora.demodulate_symbols(_P7, _RX),
    "loopback_ber": lambda: lora.loopback_ber(_P7, np.arange(4), 0.0,
                                              noise=torch.zeros(1, dtype=torch.complex64)),
    "ber_sweep": lambda: ber_sweep(lambda p, s, generator: s, np.arange(4), [0.0], n_lanes=2),
    "batch_modulate": lambda: batch_modulate(lambda p: p, np.ones((2, 3), np.int32)),
    "batch_demodulate": lambda: batch_demodulate(lambda b: b, _RX[None]),
    "coding": lambda: coding.gray_encode(np.arange(8)),
    "db_to_linear_power": lambda: types.db_to_linear_power(np.array([0.0, 3.0])),
    "db_to_linear_amplitude": lambda: types.db_to_linear_amplitude([0.0, 6.0]),
    "linear_power_to_db": lambda: types.linear_power_to_db(np.array([1.0, 10.0])),
    "fir_filter": lambda: filters.fir_filter(np.ones(3, np.float32), _RX),
    "digital_down_convert": lambda: stream_math.digital_down_convert(_RX, 1e3, 125e3, 4),
}


@pytest.mark.parametrize("name", sorted(NUMPY_ENTRY_POINTS))
def test_numpy_inputs_go_to_the_default_device(name, monkeypatch):
    """With the default device set to meta, numpy handed to an entry point
    lands there (a meta result, or the dispatcher refusing meta), never
    on the CPU."""
    monkeypatch.setattr(types, "DEFAULT_DEVICE", torch.device("meta"))
    _lands_on_meta(NUMPY_ENTRY_POINTS[name])


def test_tensor_inputs_keep_their_device():
    wf = LoRaWaveform(device=torch.device("meta"))
    tx = lora.modulate(_P7, torch.arange(4, dtype=torch.int32), device="cpu")
    assert wf.demodulate(tx).symbols.device.type == "cpu"
    assert types.db_to_linear_power(torch.zeros(2)).device.type == "cpu"
    assert filters.fir_apply(np.ones(3, np.float32), torch.ones(8)).device.type == "cpu"
