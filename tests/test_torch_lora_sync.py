"""The port's LoRa synchronisation and FFT helpers against the JAX package.

`detect_preamble` must reach the reference's decisions (detected, frame
and payload start, preamble bin) on the same captures, with the CFO
estimate within 1e-3 of a bin, on the reference's three scenarios
(tests/test_kernels_sync_arq.py: a packet behind a noise gap, a 400 Hz
CFO, noise alone) at SF7 and SF9, oversample 1 and 2; the dechirped
windows within 1e-4 of their peak. Captures are made with numpy and the
JAX package's modulator. The card's run of the same path is marked
``cuda``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.core import fftops as ref_fftops
from r4w_tpu.waveforms import lora as ref_lora
from r4w_tpu.waveforms.lora import packet as ref_packet
from r4w_tpu.waveforms.lora import sync as ref_sync
from r4w_tpu_torch.core import fftops
from r4w_tpu_torch.entry import lora_packet_roundtrip, packet_capture
from r4w_tpu_torch.kernels import dechirp
from r4w_tpu_torch.waveforms import lora
from r4w_tpu_torch.waveforms.lora import sync

REL_TOL = 1e-4      # dechirped power, max|Δ| / max(reference)
SYNC_TOL = 2e-6     # CFO-corrected samples, absolute: float32 phase of the same estimate
SCENARIOS = ("gap", "cfo", "noise")
GRID = [(sf, osf) for sf in (7, 9) for osf in (1, 2)]


def _capture(scenario: str, sf: int, osf: int) -> np.ndarray:
    """The reference test's capture for `scenario`, made by the JAX package."""
    p = ref_lora.LoRaParams(sf=sf, oversample=osf)
    rng = np.random.default_rng(sf * 10 + osf)
    if scenario == "noise":
        n = 6000 * osf * (1 << (sf - 7))
        return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    if scenario == "gap":
        tx = np.asarray(ref_lora.modulate(p, jnp.asarray([0xAA, 0x55, 0x0F]),
                                          include_preamble=True))
        gap = 0.05 * (rng.standard_normal(777) + 1j * rng.standard_normal(777))
        return np.concatenate([gap, tx]).astype(np.complex64)
    tx = np.asarray(ref_lora.modulate(p, jnp.asarray([1, 2]), include_preamble=True))
    t = np.arange(tx.shape[-1]) / p.sample_rate
    return (tx * np.exp(2j * np.pi * 400.0 * t)).astype(np.complex64)


def _params(sf, osf):
    return lora.LoRaParams(sf=sf, oversample=osf), ref_lora.LoRaParams(sf=sf, oversample=osf)


def _assert_same_decisions(got: sync.SyncResult, want: ref_sync.SyncResult, p) -> None:
    for field in ("detected", "frame_start", "payload_start", "preamble_peak_bin"):
        assert getattr(got, field).item() == np.asarray(getattr(want, field)).item(), field
    bin_hz = p.bw_hz / p.chips_per_symbol
    assert abs(float(got.cfo_hz) - float(want.cfo_hz)) < 1e-3 * bin_hz


def _first_of_ties(power: np.ndarray) -> np.ndarray:
    """`power` (W, K) with ties resolved as the port resolves them, in a way
    an argmax (the reference's choice) agrees with: in each row, the bins
    within TIE_REL of the highest after the first of them are lowered to
    just under it; then the candidate windows tied with the first tied one
    are scaled to just under it. Each first is then the strict maximum and
    the others stay tied with it."""
    rows = np.arange(power.shape[0])
    near = power >= power.max(-1, keepdims=True) * np.float32(1.0 - sync.TIE_REL)
    first = near.argmax(-1)
    top = power[rows, first]
    out = np.where(near, np.minimum(power, (top * np.float32(1.0 - 1e-6))[:, None]), power)
    out[rows, first] = top
    _, cand, peak, _ = sync.preamble_candidates(torch.from_numpy(out))
    cand = torch.unique(cand).numpy()
    peak = peak.numpy()[cand]
    tied = cand[peak >= peak.max() * np.float32(1.0 - sync.TIE_REL)]
    for j in tied[1:]:
        out[j] *= np.float32(out[tied[0]].max() / out[j].max() * (1.0 - 1e-6))
    return out


def _reference_first_of_ties(monkeypatch, rparams, rx: np.ndarray):
    """The reference's decisions on its own transforms where its argmax
    meets the first of tied candidate windows, as the port's rule takes it;
    elsewhere the reference's own. Returns (result, tied)."""
    power, starts = ref_sync.dechirp_windows(rparams, jnp.asarray(rx))
    power = np.array(power)
    monkeypatch.setattr(ref_sync, "dechirp_windows",
                        lambda *a: (jnp.asarray(_first_of_ties(power)), starts))
    tied = sync.candidates_tied(torch.from_numpy(power))
    return ref_sync.detect_preamble(rparams, jnp.asarray(rx)), tied


def _reference_fft(rows: torch.Tensor, chirp: torch.Tensor) -> torch.Tensor:
    """The reference's dechirped power of the same rows: the product and the
    transform in JAX, so the power is the reference's bit for bit."""
    spec = jnp.fft.fft(jnp.asarray(rows.numpy()) * jnp.asarray(chirp.numpy()), axis=-1)
    return torch.from_numpy(np.array(spec.real ** 2 + spec.imag ** 2))


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("sf,osf", GRID)
def test_detect_preamble_decisions_match_reference(monkeypatch, sf, osf, scenario):
    """On the reference's own dechirped power, every decision is the
    reference's: the run test, the window choice, the SFD bin, the split of
    CFO and timing. Where candidate windows tie, both packages are given
    the power with the first tied window the strict maximum (the port's
    rule; an argmax agrees). The transforms themselves are held to 1e-4
    below."""
    params, rparams = _params(sf, osf)
    rx = _capture(scenario, sf, osf)
    power, starts = ref_sync.dechirp_windows(rparams, jnp.asarray(rx))
    broken = _first_of_ties(np.array(power))
    monkeypatch.setattr(ref_sync, "dechirp_windows", lambda *a: (jnp.asarray(broken), starts))
    monkeypatch.setattr(sync, "dechirp_windows",
                        lambda *a: (torch.from_numpy(broken), torch.from_numpy(np.array(starts))))
    monkeypatch.setattr(sync, "dechirp_power_dispatch", _reference_fft)
    got = sync.detect_preamble(params, torch.from_numpy(rx))
    want = ref_sync.detect_preamble(rparams, jnp.asarray(rx))
    _assert_same_decisions(got, want, params)
    assert got.cfo_hz.item() == float(want.cfo_hz)


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("sf,osf", GRID)
def test_detect_preamble_matches_reference(monkeypatch, sf, osf, scenario):
    """The port's own transforms reach the reference's decisions. Where the
    candidate windows lie wholly inside the preamble (the CFO capture has no
    gap) their peaks are equal but for float32 rounding: the reference's
    argmax then picks by rounding, and the port takes the first of them, so
    the port is held to the reference's decisions with that same window.
    Each scenario meets the reference test's own bar
    (tests/test_kernels_sync_arq.py): the packet behind the gap within half
    a symbol; the 400 Hz CFO estimated within 1000 Hz, which the reference
    meets at all four (SF, oversample) here; noise not detected."""
    params, rparams = _params(sf, osf)
    rx = _capture(scenario, sf, osf)
    got = sync.detect_preamble(params, torch.from_numpy(rx))
    want, tied = _reference_first_of_ties(monkeypatch, rparams, rx)
    assert got.detected.device.type == "cpu" and got.cfo_hz.dtype == torch.float32
    _assert_same_decisions(got, want, params)
    assert tied == (scenario == "cfo")
    if scenario == "gap":
        assert bool(got.detected)
        assert abs(int(got.frame_start) - 777) <= params.samples_per_symbol // 2
    elif scenario == "cfo":
        assert bool(got.detected) and abs(float(got.cfo_hz) - 400.0) < 1000.0
    else:
        assert not bool(got.detected)


def test_first_peak_takes_the_first_of_tied_powers():
    """Powers within TIE_REL of the highest are tied and the first of them
    wins, whatever rounding put on top; a lead beyond TIE_REL still wins."""
    power = torch.tensor([[1.0, 3.0, 3.0 * (1 + 5e-6), 2.0],
                          [3.0, 1.0, 1.0, 3.0],
                          [3.0, 1.0, 3.0 * (1 + 2e-5), 2.0]])
    assert sync.first_peak(power).tolist() == [1, 0, 2]
    assert sync.first_peak(torch.tensor([2.0, 2.0 * (1 + 1e-6)])).item() == 0


@pytest.mark.parametrize("sf,osf", GRID)
def test_dechirp_windows_match_reference(sf, osf):
    params, rparams = _params(sf, osf)
    rx = _capture("gap", sf, osf)
    for stride in (None, params.samples_per_symbol // 3):
        power, starts = sync.dechirp_windows(params, torch.from_numpy(rx), stride)
        want, want_starts = ref_sync.dechirp_windows(rparams, jnp.asarray(rx), stride)
        want = np.asarray(want)
        assert power.shape == want.shape == (len(want_starts), params.chips_per_symbol)
        np.testing.assert_array_equal(starts.numpy(), np.asarray(want_starts))
        assert np.max(np.abs(power.numpy() - want)) / want.max() < REL_TOL
    short, no_starts = sync.dechirp_windows(params, torch.from_numpy(rx[:100]))
    assert short.shape == (0, params.chips_per_symbol) and no_starts.numel() == 0


@pytest.mark.parametrize("sf,osf", GRID)
def test_synchronize_matches_reference_and_decodes(sf, osf):
    params, rparams = _params(sf, osf)
    rx = _capture("gap", sf, osf)
    aligned, res = sync.synchronize(params, torch.from_numpy(rx))
    want, _ = ref_sync.synchronize(rparams, jnp.asarray(rx))
    want = np.asarray(want)
    assert aligned.shape == want.shape and aligned.dtype == torch.complex64
    np.testing.assert_allclose(aligned.numpy(), want, rtol=0, atol=SYNC_TOL)
    got = lora.demodulate(params, aligned).payload[:3].tolist()
    assert got == np.asarray(ref_lora.demodulate(rparams, jnp.asarray(want)).payload[:3]).tolist()
    if osf == 1:  # at oversample 2 both packages start the frame one sample early
        assert got == [0xAA, 0x55, 0x0F]
    none, res = sync.synchronize(params, torch.from_numpy(_capture("noise", sf, osf)))
    assert none is None and not bool(res.detected)


def test_short_capture_and_sfd_clip_match_reference():
    """No window: nothing detected. A capture cut inside the sync symbols
    moves the SFD window back to the capture's end (the explicit clip)."""
    params, rparams = _params(7, 1)
    rx = _capture("gap", 7, 1)
    for n in (100, 777 + 11 * params.samples_per_symbol):
        got = sync.detect_preamble(params, torch.from_numpy(rx[:n]))
        _assert_same_decisions(got, ref_sync.detect_preamble(rparams, jnp.asarray(rx[:n])),
                               params)
    assert not bool(sync.detect_preamble(params, torch.from_numpy(rx[:100])).detected)
    assert sync.synchronize(params, torch.from_numpy(rx[:100]))[0] is None


def test_run_test_wraps_around_the_capture_end():
    """Two upchirps at the end and two at the start agree through the
    circular roll, as in the reference: detected, where the same capture
    without the two at the start is not."""
    params, rparams = _params(7, 1)
    n = params.samples_per_symbol
    up = np.asarray(ref_lora.chirp.base_upchirp(rparams))
    rng = np.random.default_rng(9)
    quiet = 0.01 * (rng.standard_normal(6 * n) + 1j * rng.standard_normal(6 * n))
    tail = 0.01 * (rng.standard_normal(3 * n // 4) + 1j * rng.standard_normal(3 * n // 4))
    rx = np.concatenate([up, up, quiet, up, up, tail]).astype(np.complex64)
    got = sync.detect_preamble(params, torch.from_numpy(rx), min_symbols=4)
    want = ref_sync.detect_preamble(rparams, jnp.asarray(rx), min_symbols=4)
    _assert_same_decisions(got, want, params)
    assert bool(got.detected)
    no_wrap = np.concatenate([quiet[: 2 * n], quiet, up, up, tail]).astype(np.complex64)
    assert not bool(sync.detect_preamble(params, torch.from_numpy(no_wrap)).detected)
    assert not bool(ref_sync.detect_preamble(rparams, jnp.asarray(no_wrap)).detected)


@pytest.mark.parametrize("sf,cfo", [(7, 0.0), (7, 400.0), (8, 0.0)])
def test_packet_roundtrip_entry_on_cpu(sf, cfo):
    """The entry point's capture equals the reference's construction, and the
    packet comes back whole with its CRC."""
    params, rparams = _params(sf, 1)
    out = lora_packet_roundtrip(sf, cfo_hz=cfo, seed=sf, device="cpu")
    assert out["detected"] and out["crc_ok"] is True and out["payload"] == out["sent"]
    assert len(out["sent"]) == 255 and abs(out["frame_start"] - 777) <= params.samples_per_symbol // 2
    if cfo:
        assert abs(out["cfo_hz"] - cfo) < params.bw_hz / params.chips_per_symbol
    rx = packet_capture(params, out["sent"], cfo, sf, "cpu")
    frame = ref_packet.build_packet(out["sent"])
    tx = np.asarray(ref_lora.modulate(rparams, jnp.asarray(frame), include_preamble=True))
    rng = np.random.default_rng(sf)
    gap = 0.05 * (rng.standard_normal(777) + 1j * rng.standard_normal(777))
    want = np.concatenate([gap, tx])
    want = (want * np.exp(2j * np.pi * cfo * np.arange(want.size) / rparams.sample_rate))
    np.testing.assert_allclose(rx.numpy(), want.astype(np.complex64), rtol=0, atol=2e-6)
    res = ref_sync.detect_preamble(rparams, jnp.asarray(rx.numpy()))
    assert int(res.frame_start) == out["frame_start"]


def _spectrum(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


FFTOPS_CASES = {
    "fft": lambda m, x: m.fft(x, n=96),
    "ifft": lambda m, x: m.ifft(x),
    "fftshift": lambda m, x: m.fftshift(x),
    "power_spectrum": lambda m, x: m.power_spectrum(x),
    "magnitude": lambda m, x: m.magnitude(x),
    "find_peak": lambda m, x: m.find_peak(x),
    "find_peak_interpolated": lambda m, x: m.find_peak_interpolated(x),
    "find_peak_interpolated_axis0": lambda m, x: m.find_peak_interpolated(x, axis=0),
    "cross_correlate": lambda m, x: m.cross_correlate(x, x[..., :17]),
    "spectrogram": lambda m, x: m.spectrogram(x, nfft=16, hop=5, window="hamming"),
}


@pytest.mark.parametrize("name", sorted(FFTOPS_CASES))
def test_fftops_match_reference(name):
    x = _spectrum((3, 80), 5)
    x[1, 17] = 40.0  # a clear peak next to the wrap of row 1
    x[2, 79] = 40.0
    got = FFTOPS_CASES[name](fftops, torch.from_numpy(x))
    want = FFTOPS_CASES[name](ref_fftops, jnp.asarray(x))
    got, want = (got if isinstance(got, tuple) else (got,)), (
        want if isinstance(want, tuple) else (want,))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and g.dtype.is_complex == np.iscomplexobj(w)
        if not g.is_floating_point() and not g.is_complex():
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            scale = max(float(np.max(np.abs(w))), 1.0)
            assert float(np.max(np.abs(g.numpy() - w))) <= 2e-6 * scale, name


def test_fftops_edges():
    flat = torch.ones(1, 8, dtype=torch.complex64)
    idx, mag = fftops.find_peak_interpolated(flat)
    assert float(idx) == 0.0 and float(mag) == 1.0  # a flat spectrum: no shift
    assert fftops.spectrogram(torch.ones(10, dtype=torch.complex64), nfft=16).shape == (0, 16)
    assert fftops.cross_correlate(torch.ones(1), torch.ones(1)).shape == (1,)


@pytest.mark.cuda
@pytest.mark.parametrize("sf,osf", GRID)
def test_sync_on_card_equals_cpu(sf, osf):
    """The card's windows within 1e-4 of the CPU's, and the card's own
    decisions equal to the CPU's own on the same capture: the kernel and
    the plain FFT round differently, and the first-of-ties rule keeps that
    rounding from picking the window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the dechirp kernel has no CPU or interpret mode")
    params, _ = _params(sf, osf)
    for scenario in SCENARIOS:
        rx = torch.from_numpy(_capture(scenario, sf, osf))
        before = dechirp.dechirp_power.launches
        got = sync.detect_preamble(params, rx.cuda())
        assert dechirp.dechirp_power.launches == before + 2  # the windows and the SFD
        _assert_same_decisions(got, sync.detect_preamble(params, rx), params)
        power = sync.dechirp_windows(params, rx.cuda())[0].cpu()
        ref = sync.dechirp_windows(params, rx)[0]
        assert float((power - ref).abs().max() / ref.max()) < REL_TOL
