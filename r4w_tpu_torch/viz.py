"""Plot gallery (reference gallery/*.png + r4w-gui educational views
re-design: constellation/spectrum/waterfall/eye/BER figures as PNGs).

Styling follows the dataviz method: color is assigned by job —
categorical series use a fixed-order validated palette (I=blue,
Q=orange, ...), magnitude (waterfall/persistence) uses a single-hue
light-to-dark sequential ramp, grids/axes are recessive, text wears
text colors, one axis per chart.

The port's counterpart of ``r4w_tpu.viz``. The figures take tensors (or
numpy). The Welch PSD (`ops.measure.welch_psd`) and the waterfall's framed
FFT run on the tensor's device (`_spectrum_db`, `_waterfall_db`); each
figure's data is read to the host once. matplotlib is imported inside
`_mpl`, so the package imports where matplotlib is absent. The galleries
modulate on the port's waveforms on `device` (the card unless named) and
draw the channel figures' noise and fading from threefry keys 0, 1 and 2,
the reference's ``jax.random.key`` draws.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from r4w_tpu_torch.core.types import DEFAULT_DEVICE

# fixed-order categorical palette (validated; light surface)
SERIES = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100"]
SURFACE = "#fcfcfb"
TEXT = "#0b0b0b"
TEXT_2 = "#52514e"
GRID = "#e6e5e2"
SEQUENTIAL = "Blues"  # one hue, light -> dark


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _style(ax):
    ax.set_facecolor(SURFACE)
    ax.grid(True, color=GRID, linewidth=0.6)
    ax.set_axisbelow(True)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_color(TEXT_2)
    ax.tick_params(colors=TEXT_2, labelsize=8)
    ax.xaxis.label.set_color(TEXT_2)
    ax.yaxis.label.set_color(TEXT_2)
    ax.title.set_color(TEXT)


def _save(fig, path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.patch.set_facecolor(SURFACE)
    fig.savefig(path, dpi=110, bbox_inches="tight",
                facecolor=SURFACE)
    import matplotlib.pyplot as plt

    plt.close(fig)


def _host(x) -> np.ndarray:
    """`x` as a numpy array: a tensor is read to the host once."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flat(x) -> torch.Tensor:
    """`x` as a flat tensor on its own device (numpy goes to the CPU)."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    return t.reshape(-1)


def _spectrum_db(iq, sample_rate: float = 1.0, nfft: int = 1024):
    """The spectrum figure's data: (frequencies (nfft,) float64 on the host,
    Welch PSD in dB (nfft,) float32 computed on the IQ's device)."""
    from r4w_tpu_torch.ops.measure import welch_psd

    x = _flat(iq)
    nfft = min(nfft, max(64, x.shape[0] // 2))
    psd = welch_psd(x, nperseg=nfft, sample_rate=sample_rate)
    db = 10 * torch.log10(torch.clamp_min(psd, 1e-20))
    f = np.fft.fftshift(np.fft.fftfreq(nfft, 1.0 / sample_rate))
    return f, _host(db)


def _waterfall_db(iq, nfft: int = 256) -> np.ndarray:
    """The waterfall figure's data: (frames, nfft) dB of the Hann-windowed
    framed FFT (half-frame hop, complex128), computed on the IQ's device.
    Short bursts shrink the FFT and keep at least two frames."""
    x = _flat(iq)
    n = x.shape[0]
    if n < 2 * nfft:  # short bursts: shrink the FFT, keep >=2 frames
        nfft = max(16, 1 << int(np.log2(max(n // 2, 16))))
        if n < nfft:
            x = torch.nn.functional.pad(x, (0, nfft - n))
    hop = nfft // 2
    n_frames = max(1, (x.shape[0] - nfft) // hop + 1)
    frames = x.to(torch.complex128).unfold(0, nfft, hop)[:n_frames]
    win = torch.from_numpy(np.hanning(nfft)).to(x.device)
    spec = torch.fft.fftshift(torch.fft.fft(frames * win, dim=-1), dim=-1)
    return _host(20 * torch.log10(torch.clamp_min(torch.abs(spec), 1e-12)))


def plot_constellation(symbols, path: str, title: str = "Constellation"):
    """Scatter of IQ decision points (gallery/waveforms constellations)."""
    plt = _mpl()
    s = _host(symbols).reshape(-1)
    fig, ax = plt.subplots(figsize=(4, 4))
    _style(ax)
    ax.scatter(s.real, s.imag, s=14, color=SERIES[0], alpha=0.7,
               edgecolors="none")
    ax.axhline(0, color=GRID, lw=0.8)
    ax.axvline(0, color=GRID, lw=0.8)
    ax.set_title(title)
    ax.set_xlabel("I")
    ax.set_ylabel("Q")
    ax.set_aspect("equal")
    _save(fig, path)
    return path


def plot_time(iq, path: str, title: str = "Waveform",
              sample_rate: float | None = None, max_samples: int = 2000):
    """I/Q traces vs time (GUI modulation view)."""
    plt = _mpl()
    x = _host(_flat(iq)[:max_samples])
    t = np.arange(len(x))
    xlabel = "sample"
    if sample_rate:
        t = t / sample_rate * 1e3
        xlabel = "time (ms)"
    fig, ax = plt.subplots(figsize=(7, 2.8))
    _style(ax)
    ax.plot(t, x.real, color=SERIES[0], lw=1.2, label="I")
    if np.iscomplexobj(x):
        ax.plot(t, x.imag, color=SERIES[1], lw=1.2, label="Q")
        leg = ax.legend(loc="upper right", frameon=False, fontsize=8)
        for txt in leg.get_texts():
            txt.set_color(TEXT_2)
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    _save(fig, path)
    return path


def plot_spectrum(iq, path: str, sample_rate: float = 1.0,
                  nfft: int = 1024, title: str = "Spectrum"):
    """Welch PSD in dB (analysis/spectrum.rs + gallery spectra)."""
    f, db = _spectrum_db(iq, sample_rate, nfft)
    return draw_spectrum(f, db, path, sample_rate, title)


def draw_spectrum(f, db, path: str, sample_rate: float = 1.0, title: str = "Spectrum"):
    """The spectrum figure from its data (`_spectrum_db`), on the host."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(7, 2.8))
    _style(ax)
    ax.plot(f / (1e3 if sample_rate > 1 else 1), db, color=SERIES[0],
            lw=1.2)
    ax.set_title(title)
    ax.set_xlabel("frequency (kHz)" if sample_rate > 1 else
                  "frequency (cycles/sample)")
    ax.set_ylabel("PSD (dB)")
    _save(fig, path)
    return path


def plot_waterfall(iq, path: str, sample_rate: float = 1.0,
                   nfft: int = 256, title: str = "Waterfall"):
    """Spectrogram, single-hue sequential ramp (GUI streaming view)."""
    return draw_waterfall(_waterfall_db(iq, nfft), path, sample_rate, title)


def draw_waterfall(db, path: str, sample_rate: float = 1.0, title: str = "Waterfall"):
    """The waterfall figure from its data (`_waterfall_db`), on the host."""
    plt = _mpl()
    n_frames = db.shape[0]
    fig, ax = plt.subplots(figsize=(6, 3.4))
    _style(ax)
    ax.grid(False)
    vmax = float(db.max())
    im = ax.imshow(db, aspect="auto", origin="lower", cmap=SEQUENTIAL,
                   vmin=vmax - 60.0, vmax=vmax,
                   extent=[-sample_rate / 2, sample_rate / 2, 0,
                           n_frames])
    cb = fig.colorbar(im, ax=ax, pad=0.02)
    cb.set_label("dB", color=TEXT_2, fontsize=8)
    cb.ax.tick_params(colors=TEXT_2, labelsize=7)
    ax.set_title(title)
    ax.set_xlabel("frequency")
    ax.set_ylabel("frame")
    _save(fig, path)
    return path


def plot_eye(iq, sps: int, path: str, title: str = "Eye diagram",
             n_traces: int = 80):
    """Overlaid 2-symbol traces (eye_diagram.rs / GUI demod view)."""
    plt = _mpl()
    x = _host(_flat(iq)).real
    span = 2 * sps
    n = min(n_traces, (len(x) - span) // sps)
    fig, ax = plt.subplots(figsize=(4.6, 3))
    _style(ax)
    t = np.arange(span) / sps
    for k in range(n):
        ax.plot(t, x[k * sps:k * sps + span], color=SERIES[0], lw=0.8,
                alpha=0.25)
    ax.set_title(title)
    ax.set_xlabel("symbol time")
    _save(fig, path)
    return path


def plot_ber_curves(snrs_db, curves: dict, path: str,
                    title: str = "BER vs SNR"):
    """Semilog BER curves, fixed-order categorical series + direct
    labels (ber_tool.rs / waveform_comparison view)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(5.4, 3.6))
    _style(ax)
    for i, (name, ber) in enumerate(curves.items()):
        c = SERIES[i % len(SERIES)]
        ber = np.maximum(np.asarray(ber, float), 1e-7)
        ax.semilogy(snrs_db, ber, color=c, lw=1.6, marker="o", ms=3.5,
                    label=name)
        ax.annotate(name, (snrs_db[-1], ber[-1]), textcoords="offset points",
                    xytext=(4, 0), color=c, fontsize=8)
    ax.set_title(title)
    ax.set_xlabel("SNR (dB)")
    ax.set_ylabel("BER")
    if len(curves) >= 2:
        leg = ax.legend(loc="lower left", frameon=False, fontsize=8)
        for txt in leg.get_texts():
            txt.set_color(TEXT_2)
    _save(fig, path)
    return path


def generate_gallery(outdir: str, names=None, sample_rate: float = 48000.0,
                     payload: bytes = b"r4w", device=DEFAULT_DEVICE):
    """Regenerate the reference's gallery/ PNG set for our waveforms,
    modulated on `device`."""
    from r4w_tpu_torch.waveforms import create_waveform, list_waveforms

    made = []
    for name in (names or list_waveforms()):
        wf = create_waveform(name, sample_rate, device)
        if wf is None:
            continue
        try:
            iq = wf.modulate(payload)
        except Exception:
            continue
        base = name.lower().replace("/", "-").replace(" ", "_")
        d = os.path.join(outdir, "waveforms")
        made.append(plot_time(iq, os.path.join(d, f"{base}_time.png"),
                              f"{name} waveform", sample_rate))
        made.append(plot_spectrum(iq, os.path.join(
            d, f"{base}_spectrum.png"), sample_rate, title=f"{name} PSD"))
        made.append(plot_waterfall(iq, os.path.join(
            d, f"{base}_waterfall.png"), sample_rate,
            title=f"{name} waterfall"))
    return made


def generate_channel_gallery(outdir: str, sample_rate: float = 48000.0,
                             device=DEFAULT_DEVICE):
    """Channel-impairment figures (gallery/channels), on `device`."""
    from r4w_tpu_torch.channel import awgn, rayleigh, threefry
    from r4w_tpu_torch.waveforms import create_waveform

    wf = create_waveform("QPSK", sample_rate, device)
    tx = wf.modulate(b"gallery-payload")
    made = []
    for label, iq in (
        ("clean", tx),
        ("awgn_10db", awgn(tx, 10.0, key=threefry.key(0))),
        ("rayleigh", awgn(rayleigh(tx, key=threefry.key(1)), 15.0,
                          key=threefry.key(2))),
    ):
        d = os.path.join(outdir, "channels")
        made.append(plot_waterfall(iq, os.path.join(
            d, f"qpsk_{label}_waterfall.png"), sample_rate,
            title=f"QPSK {label}"))
        made.append(plot_time(iq, os.path.join(d, f"qpsk_{label}_time.png"),
                              f"QPSK {label}", sample_rate))
    return made
