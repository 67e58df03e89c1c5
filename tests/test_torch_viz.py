"""The figures' port (`r4w_tpu_torch.viz`) against the reference's.

Each figure's data is captured where it is drawn: matplotlib is replaced by
a recorder (`_Recorder`) in both packages, so the arrays handed to
``ax.plot``/``ax.imshow``/``ax.scatter`` are compared, the port's within
1e-4 dB of the reference's for the spectrum and the waterfall (the Welch
PSD in float32 on both, the waterfall's framed FFT in float64 on both) and
equal for the time, constellation and eye traces. The reference's
``test_plot_primitives`` runs on the port and draws real PNGs; the gallery's
counterpart is marked slow, as the reference's is.
"""

from __future__ import annotations

import os

import jax
import numpy as np
import pytest
import torch

from r4w_tpu import viz as ref_viz
from r4w_tpu_torch import viz
from r4w_tpu_torch.channel import awgn, rayleigh, threefry
from r4w_tpu_torch.waveforms import create_waveform

DB_TOL = 1e-4
CPU = torch.device("cpu")


class _Recorder:
    """Stands in for pyplot, figures and axes: records every call by the
    name of the attribute called."""

    def __init__(self, log, name=""):
        self._log, self._name = log, name

    def __getattr__(self, name):
        return _Recorder(self._log, name)

    def __call__(self, *args, **kwargs):
        self._log.append((self._name, args, kwargs))
        if self._name == "subplots":
            return _Recorder(self._log), _Recorder(self._log)
        return _Recorder(self._log)

    def __getitem__(self, key):
        return _Recorder(self._log)

    def __iter__(self):
        return iter(())


def _drawn(module, monkeypatch, fn_name, *args, **kwargs) -> dict:
    """The arrays `module.fn_name` draws, by drawing call."""
    log = []
    monkeypatch.setattr(module, "_mpl", lambda: _Recorder(log))
    monkeypatch.setattr(module, "_save", lambda fig, path: None)
    getattr(module, fn_name)(*args, **kwargs)
    out: dict[str, list] = {}
    for name, a, _ in log:
        if name in ("plot", "imshow", "scatter", "semilogy"):
            out.setdefault(name, []).append([np.asarray(v) for v in a])
    return out


def _iq(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    return (np.exp(2j * np.pi * 0.01 * np.arange(n))
            + 0.1 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)


def _lora_burst():
    wf = create_waveform("LoRa-SF7", 125_000.0, CPU)
    return wf.modulate(bytes(range(64)))


CASES = {"tone": lambda: _iq(), "short": lambda: _iq(50, 1), "lora": lambda: _lora_burst().numpy()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_spectrum_data_equals_the_references(monkeypatch, case):
    x = CASES[case]()
    got = _drawn(viz, monkeypatch, "plot_spectrum", torch.from_numpy(x), "s.png", 125e3)
    want = _drawn(ref_viz, monkeypatch, "plot_spectrum", x, "s.png", 125e3)
    (gf, gdb), (wf, wdb) = got["plot"][0], want["plot"][0]
    np.testing.assert_array_equal(gf, wf)
    assert gdb.dtype == wdb.dtype == np.float32
    np.testing.assert_allclose(gdb, wdb, atol=DB_TOL, rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_waterfall_data_equals_the_references(monkeypatch, case):
    x = CASES[case]()
    got = _drawn(viz, monkeypatch, "plot_waterfall", torch.from_numpy(x), "w.png", 125e3)
    want = _drawn(ref_viz, monkeypatch, "plot_waterfall", x, "w.png", 125e3)
    g, w = got["imshow"][0][0], want["imshow"][0][0]
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, atol=DB_TOL, rtol=0)
    # the private helper is what the figure draws
    np.testing.assert_array_equal(viz._waterfall_db(torch.from_numpy(x)), g)


def test_time_constellation_and_eye_data_equal_the_references(monkeypatch):
    x = _iq()
    for fn, args in (("plot_time", ("t.png", "Waveform", 1e3)),
                     ("plot_constellation", ("c.png",)),
                     ("plot_eye", (8, "e.png"))):
        got = _drawn(viz, monkeypatch, fn, torch.from_numpy(x), *args)
        want = _drawn(ref_viz, monkeypatch, fn, x, *args)
        assert got.keys() == want.keys()
        for name in want:
            for g, w in zip(got[name], want[name]):
                for a, b in zip(g, w):
                    np.testing.assert_array_equal(a, b)


def test_channel_gallery_data_equals_the_references(monkeypatch):
    """The channel figures' noisy QPSK: the port's threefry keys 0, 1, 2
    draw the reference's noise and fading."""
    from r4w_tpu.channel import awgn as jawgn, rayleigh as jrayleigh
    from r4w_tpu.waveforms import create_waveform as jcreate

    tx = create_waveform("QPSK", 48_000.0, CPU).modulate(b"gallery-payload")
    jtx = jcreate("QPSK", 48_000.0).modulate(b"gallery-payload")
    np.testing.assert_allclose(tx.numpy(), np.asarray(jtx), atol=1e-6)
    port = awgn(rayleigh(tx, key=threefry.key(1)), 15.0, key=threefry.key(2))
    ref = np.asarray(jawgn(jax.random.key(2), jrayleigh(jax.random.key(1), jtx), 15.0))
    np.testing.assert_allclose(port.numpy(), ref, atol=2e-5)
    g = _drawn(viz, monkeypatch, "plot_waterfall", port, "w.png", 48_000.0)["imshow"][0][0]
    w = _drawn(ref_viz, monkeypatch, "plot_waterfall", ref, "w.png", 48_000.0)["imshow"][0][0]
    np.testing.assert_allclose(g, w, atol=DB_TOL, rtol=0)


@pytest.mark.parametrize("n", [1, 37, 63])
def test_welch_psd_of_a_short_input_equals_the_references(n):
    """Shorter than one segment: the reference's gather clamps its indices,
    so the last sample repeats to fill the segment (`ops.measure.welch_psd`)."""
    from r4w_tpu.ops.measure import welch_psd as jwelch

    from r4w_tpu_torch.ops.measure import welch_psd

    x = np.stack([_iq(n, 2), _iq(n, 3)])
    got = welch_psd(torch.from_numpy(x), nperseg=64, sample_rate=2.0).numpy()
    want = np.asarray(jwelch(x, nperseg=64, sample_rate=2.0))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_plot_primitives(tmp_path):
    pytest.importorskip("matplotlib")
    import test_viz

    saved = test_viz.viz
    test_viz.viz = viz
    try:
        test_viz.test_plot_primitives(tmp_path)
    finally:
        test_viz.viz = saved


def test_figures_take_card_tensors_by_device(monkeypatch):
    """The spectrum and waterfall data are computed on the tensor's device
    (here the CPU) and read to the host once, as numpy."""
    x = _lora_burst()
    f, db = viz._spectrum_db(x, 125e3)
    assert isinstance(db, np.ndarray) and db.shape == f.shape == (1024,)
    w = viz._waterfall_db(x)
    assert isinstance(w, np.ndarray) and w.shape[1] == 256


@pytest.mark.slow
def test_generate_gallery_subset(tmp_path):
    pytest.importorskip("matplotlib")
    made = viz.generate_gallery(str(tmp_path), ["BPSK", "CW"], 48000.0, device=CPU)
    assert len(made) == 6
    for p in made:
        assert os.path.getsize(p) > 5000
    made = viz.generate_channel_gallery(str(tmp_path), device=CPU)
    assert len(made) == 6
