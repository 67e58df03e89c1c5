"""The NBFM dispatch monitor and the blocks gate (`dispatch_gates`).

`dispatch_monitor_chain` runs on the CPU on a scene of its own at 1.2 s
(3 rows of 0.4 s at 2.4 MS/s): channel C (CTCSS and the ANI), channel D
(one POCSAG page), the idle channel E and an unmodulated carrier H. It is held
against the same chain composed of the JAX package's functions on the same
numpy rows (`stream_math.digital_down_convert` a row at a time, joined as
the port joins them; `filters.decimating_fir`, `modem.quadrature_demod`,
`stream_blocks.power_squelch` a channel at a time, `protocols.ctcss_detect`,
`audio.dtmf_detect`, `packets.pocsag_decode`): squelch masks, tones, the
ANI and the page equal; the channels within IQ_TOL of their peak, the
tone metrics within TOL, the audio within AUDIO_TOL of its RMS while the
squelch is open. The bars need the full scene (8 s, eight channels) and
hold on the card; the gate's ANI bar is the JAX composition's reading of
the gate's own scene (its first 5 rows, channel C). The row seam: rows of a capture down-converted with
their lead and joined equal a float64 DDC of the whole stream within
SEAM_TOL (the float32 oscillator's phase, ω·n to 840 rad at these rows,
where an ulp is 6e-5 rad), and the samples beside a seam are no further
off than the rest. `protocol_blocks_gate` runs on the CPU and covers every
`BLOCKS` entry of packets and audio and every public function of
protocols, applied and adsb.
"""

import jax.numpy as jnp
import numpy as np
import torch

from r4w_tpu.ops import audio as ref_au
from r4w_tpu.ops import filters as ref_filters
from r4w_tpu.ops import modem as ref_modem
from r4w_tpu.ops import packets as ref_pk
from r4w_tpu.ops import protocols as ref_pr
from r4w_tpu.ops import stream_blocks as ref_sb
from r4w_tpu.ops import stream_math as ref_sm
from r4w_tpu_torch import dispatch_gates as dg
from r4w_tpu_torch.ops import filters
from r4w_tpu_torch.ops.stream_math import digital_down_convert

ROWS = 3
TOL = 1e-5
IQ_TOL = 1e-5
AUDIO_TOL = 1e-4
SEAM_TOL = 5e-4

SMALL = (
    dg.Channel("C", -250.0e3, "voice", ((0.1, 1.2),), ctcss_hz=156.7, ani="5551234", ani_at=0.3,
               speech_at=(2.0,)),
    dg.Channel("D", -25.0e3, "pocsag", ((0.1, 1.2),), pages=((1234567, 0, "911"),)),
    dg.Channel("E", 100.0e3, "idle"),
    dg.Channel("H", 850.0e3, "carrier", ((0.0, 1.2),)),
)


def _reference_chain(rows: np.ndarray, channels) -> dict:
    """The monitor composed of the JAX package's functions."""
    block = rows.shape[-1] - dg.LEAD
    joined = []
    for ch in channels:
        y = [np.asarray(ref_sm.digital_down_convert(jnp.asarray(r), ch.offset_hz,
                                                    dg.CAPTURE_RATE_HZ, dg.DDC_DECIMATION))
             for r in rows]
        rot = dg.row_rotation(ch.offset_hz, rows.shape[0], "cpu", block).numpy()
        joined.append(np.concatenate([np.asarray(jnp.asarray(v[dg.LEAD // dg.DDC_DECIMATION:])
                                                 * rot[i]) for i, v in enumerate(y)]))
    chans = np.stack(joined)
    iq = np.asarray(ref_filters.decimating_fir(ref_filters.design_lowpass(
        dg.SELECT_TAPS, dg.SELECT_CUTOFF_HZ, dg.CHANNEL_RATE_HZ), jnp.asarray(chans),
        dg.SELECT_DECIMATION)[0])
    open_mask = np.stack([np.asarray(ref_sb.power_squelch(jnp.asarray(v), dg.SQUELCH_DB,
                                                          dg.SQUELCH_ALPHA)[0]) != 0 for v in iq])
    fm = np.asarray(ref_modem.quadrature_demod(jnp.asarray(iq), dg.IF_RATE_HZ / (
        2 * np.pi * dg.VOICE_DEVIATION_HZ)))
    audio = np.asarray(ref_filters.decimating_fir(ref_filters.design_lowpass(
        dg.AUDIO_TAPS, dg.AUDIO_CUTOFF_HZ, dg.IF_RATE_HZ), jnp.asarray(fm),
        dg.AUDIO_DECIMATION)[0])
    w = int(dg.TONE_WINDOW_S * dg.AUDIO_RATE_HZ)
    n_win = audio.shape[-1] // w
    tones, metrics = ref_pr.ctcss_detect(jnp.asarray(audio[:, :n_win * w].reshape(
        len(channels), n_win, w)), dg.AUDIO_RATE_HZ)
    names = [ch.name for ch in channels]
    opened = {n: dg._intervals(open_mask[i]) for i, n in enumerate(names)}
    dial, pages = {}, []
    if dg.DIAL_CHANNEL in names:
        i = names.index(dg.DIAL_CHANNEL)
        for start, _ in opened[dg.DIAL_CHANNEL]:
            a0 = -(-start // dg.AUDIO_DECIMATION)
            dial[start] = ref_au.dtmf_detect(jnp.asarray(
                audio[i, a0:a0 + int(dg.ANI_WINDOW_S * dg.AUDIO_RATE_HZ)]), dg.AUDIO_RATE_HZ)
    if dg.PAGE_CHANNEL in names:
        i = names.index(dg.PAGE_CHANNEL)
        for start, stop in opened[dg.PAGE_CHANNEL]:
            for words in dg.find_batches(dg.slice_bits(fm[i, start:stop])):
                addr, func, nib, valid = ref_pk.pocsag_decode(words)
                pages.append((int(addr), int(func), ref_pk.pocsag_digits_to_str(nib, valid)))
    return {"channels": chans, "open": open_mask, "opened": opened, "audio": audio,
            "tones": np.asarray(tones), "metrics": np.asarray(metrics), "dial": dial,
            "pages": pages}


def test_chain_against_jax_composition():
    rows, truth = dg.dispatch_scene(ROWS, SMALL)
    got = dg.dispatch_monitor_chain(torch.from_numpy(rows), SMALL)
    want = _reference_chain(rows, SMALL)
    np.testing.assert_array_equal(got["open"].numpy(), want["open"])
    assert got["opened"] == want["opened"]
    np.testing.assert_array_equal(got["tones"].numpy(), want["tones"])
    np.testing.assert_allclose(got["metrics"].numpy(), want["metrics"], rtol=TOL)
    assert got["dial"] == want["dial"] and got["pages"] == want["pages"]
    ch = got["channels"].numpy()
    assert np.max(np.abs(ch - want["channels"])) <= IQ_TOL * np.max(np.abs(want["channels"]))
    for i in range(len(SMALL)):
        m = want["open"][i, ::dg.AUDIO_DECIMATION][: want["audio"].shape[-1]]
        if m.any():
            a, b = got["audio"][i].numpy()[m], want["audio"][i][m]
            assert np.max(np.abs(a - b)) <= AUDIO_TOL * np.sqrt(np.mean(b * b)), i
    # the small scene's own truth: C and D open from 0.1 s, E closed, C's tone,
    # the page back
    bars = dg.dispatch_bars(got, truth)
    assert bars["squelch"]["E"] == [] and len(bars["squelch"]["C"]) == 1
    assert abs(bars["squelch"]["D"][0][0] - 0.1) <= dg.EDGE_TOL_S
    assert got["pages"] == [(1234567, 0, "911")]
    assert bars["tones"]["C"] == [np.float32(156.7)]


def test_gate_ani_bar_is_the_jax_reading():
    """The gate's ANI bar is what the JAX composition decodes from channel
    C of the gate's own scene (its first 5 rows hold the whole ANI window)."""
    rows, _ = dg.dispatch_scene(5)
    want = _reference_chain(rows, (dg.CHANNELS[2],))
    got = dg.dispatch_monitor_chain(torch.from_numpy(rows), (dg.CHANNELS[2],))
    assert list(want["dial"].values()) == [dg.EXPECTED_ANI]
    assert got["dial"] == want["dial"]


def _float64_ddc(x: np.ndarray, offset_hz: float) -> np.ndarray:
    k = np.arange(x.size)
    base = x * np.exp(-2j * np.pi * offset_hz / dg.CAPTURE_RATE_HZ * k)
    taps = filters.design_lowpass(dg.DDC_TAPS, dg.CAPTURE_RATE_HZ / (2.5 * dg.DDC_DECIMATION),
                                  dg.CAPTURE_RATE_HZ).astype(np.float64)
    return np.convolve(base, taps)[: x.size][::dg.DDC_DECIMATION]


def test_ddc_rows_join_without_a_seam():
    """Rows led by the LEAD samples before them, down-converted from zero
    state and phase, trimmed and rotated, equal a float64 DDC of the whole
    stream; the outputs beside each row edge are no further off than the
    rest."""
    rng = np.random.default_rng(3)
    rows_n, block = 10, 300
    x = (rng.standard_normal(rows_n * block) + 1j * rng.standard_normal(rows_n * block)).astype(
        np.complex64)
    rows = np.zeros((rows_n, dg.LEAD + block), np.complex64)
    for r in range(rows_n):
        rows[r, dg.LEAD:] = x[r * block:(r + 1) * block]
        if r:
            rows[r, :dg.LEAD] = x[r * block - dg.LEAD:r * block]
    for offset in (-875.0e3, 362.5e3):
        y = digital_down_convert(torch.from_numpy(rows), offset, dg.CAPTURE_RATE_HZ,
                                 dg.DDC_DECIMATION)
        got = dg.join_rows(y, offset, block).numpy()
        want = _float64_ddc(x.astype(np.complex128), offset)
        err = np.abs(got - want) / np.sqrt(np.mean(np.abs(want) ** 2))
        assert got.shape == want.shape and err.max() <= SEAM_TOL, err.max()
        per_row = block // dg.DDC_DECIMATION
        edge = np.concatenate([np.arange(r * per_row - 2, r * per_row + 3)
                               for r in range(1, rows_n)])
        assert err[edge].max() <= err.max() and err[edge].mean() <= 3 * err.mean()


def test_ctcss_false_alarm_rates():
    """The tone bank's false alarms at its threshold of 8: on white noise
    (a channel with no carrier) ~3.5% of 1 s windows; on noise rising with
    f² (a carrier's discriminator noise) ~31%, every false tone in the
    bank's upper part. The gate's carrier bound rests on these rates;
    the JAX package's detector reads the same tones on a subset."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((1500, 8001))
    for noise, lo, hi in ((w[:, :8000], 0.0, 0.06), (np.diff(w, axis=1), 0.26, 0.36)):
        x = torch.from_numpy(noise.astype(np.float32))
        tones = dg.pr.ctcss_detect(x, 8000.0)[0].numpy()
        rate = float(np.mean(tones != -1.0))
        assert lo <= rate <= hi, rate
        want = np.asarray(ref_pr.ctcss_detect(jnp.asarray(x[:100].numpy()), 8000.0)[0])
        np.testing.assert_array_equal(tones[:100], want)
    assert abs(dg.CARRIER_FALSE_RATE - rate) <= 0.05
    assert tones[tones != -1.0].min() >= np.float32(dg.CARRIER_FALSE_MIN_HZ)


def test_pocsag_slicer_finds_every_batch():
    """The host glue on an ideal discriminator: 20 samples a bit, a lead of
    carrier, the preamble and two batches; both pages back."""
    bits = dg._pocsag_bits(((1234567, 0, "911"), (2000001, 3, "5550100")))
    fm = np.concatenate([np.zeros(240), np.repeat(np.where(bits == 1, -1.0, 1.0), 20)])
    words = dg.find_batches(dg.slice_bits(fm + 0.1 * np.random.default_rng(0).standard_normal(
        fm.size)))
    assert words.shape == (2, 17)
    out = []
    for w in words:
        addr, func, nib, valid = ref_pk.pocsag_decode(w)
        out.append((int(addr), int(func), ref_pk.pocsag_digits_to_str(nib, valid)))
    assert out == [(1234567, 0, "911"), (2000001, 3, "5550100")]


def test_protocol_blocks_gate_covers_the_slice():
    gate = dg.protocol_blocks_gate("cpu")
    assert gate["ok"], (gate["failed"], gate["missing"])
    assert len(gate["worst"]) == len(dg.blocks_names()) >= 24 + 13
