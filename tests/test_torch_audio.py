"""`ops.audio` against the JAX package.

tests/test_audio.py and the audio cases of the known-answer files run on
the port through `torch_port_proxy` (the phase vocoder, MELP and formant
tests too, which the reference marks slow: on the port they take a few
seconds). Parity cases hold every function against the reference on the
same numpy inputs: decisions (DTMF strings, pitch lags, bit allocations,
voicing) equal, floats within TOL of the largest reference magnitude (FFTs
and sums in another order), LOOP_TOL for the step loops and the Levinson
recursions (float32 products summed in another order, carried through the
recursion; the reference's LPC and MELP run compiled, as one XLA program
each, which fuses some products into multiply-adds), PV_TOL for the phase vocoder (its phase sums reach tens of
thousands of radians, where a float32 ulp is 4e-3 rad, and JAX's float32
cumulative sum rounds them in another order). The trap tests: equal digits
at 80/40 ms merge when a frame straddles the gap, as in the reference;
overlap-adds sum each sample's frames in frame order, bit for bit with the
reference's scatter-add.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.ops import audio as ref
from r4w_tpu_torch.ops import audio as au
from torch_port_proxy import check_parity, run_reference_test

TOL = 1e-5
LOOP_TOL = 1e-4
PV_TOL = 1e-3
FS = 8000.0

AU = "r4w_tpu_torch.ops.audio"
KA = {"r4w_tpu.ops.audio": AU}

REFERENCE_TESTS = [
    *[("test_audio", n, {}, {"au": AU}, {}) for n in (
        "TestDtmf.test_dtmf_roundtrip", "TestMfcc.test_mfcc_shape_and_sensitivity",
        "TestPhaseVocoder.test_stretch_preserves_pitch", "TestVocoders.test_lpc_whitens_ar_process",
        "TestVocoders.test_melp_roundtrip_preserves_pitch_and_energy",
        "TestVocoders.test_formant_track_finds_resonance",
        "TestPsychoacoustic.test_codec_roundtrip_snr",
        "TestRestorePitch.test_voice_restore_improves_snr",
        "TestRestorePitch.test_pitch_detect_and_track",
        "TestCancellers.test_echo_canceller_converges",
        "TestCancellers.test_feedback_suppressor_kills_howl",
        "TestCancellers.test_channel_vocoder_imposes_envelope")],
    *[("test_known_answers_families", "test_dtmf_tone_pair_exact", KA, {}, {"digit": d})
      for d in "#*0123456789ABCD"],
    *[("test_known_answers_r4", "test_dtmf_detects_itu_tone_pairs", KA, {},
       {"digit": d, "lo": lo, "hi": hi}) for d, lo, hi in (
        ("1", 697.0, 1209.0), ("5", 770.0, 1336.0), ("9", 852.0, 1477.0), ("0", 941.0, 1336.0))],
    ("test_known_answers_r4i", "TestDtmf.test_all_sixteen_keys_roundtrip", KA, {}, {}),
    *[("test_known_answers_r4i", "TestDtmf.test_tone_pair_frequencies_match_q23", KA, {},
       {"digit": d, "f_lo": lo, "f_hi": hi}) for d, lo, hi in (
        ("1", 697.0, 1209.0), ("5", 770.0, 1336.0), ("9", 852.0, 1477.0), ("D", 941.0, 1633.0),
        ("0", 941.0, 1336.0), ("#", 941.0, 1477.0))],
    ("test_known_answers_r4i", "TestDtmf.test_repeated_digit_separated_by_gap", KA, {}, {}),
    ("test_known_answers_r4i", "TestDtmf.test_silence_detects_nothing", KA, {}, {}),
    ("test_known_answers_r4m", "TestPhaseVocoder.test_time_stretch_preserves_pitch", KA, {}, {}),
    ("test_known_answers_r4o", "TestPitchDetect.test_a440", KA, {}, {}),
    ("test_known_answers_r4p", "TestEchoCancelNlms.test_known_echo_path_erle_and_weights", KA,
     {}, {}),
]


@pytest.mark.parametrize("module,name,modules,swaps,params", REFERENCE_TESTS,
                         ids=[f"{t[0]}::{t[1]}{t[4] or ''}" for t in REFERENCE_TESTS])
def test_reference_test_on_port(monkeypatch, module, name, modules, swaps, params):
    run_reference_test(monkeypatch, module, name, modules, params=params, **swaps)


def _voice(rng, n=8192, f0=180.0):
    """Harmonics of f0 under a slow envelope, in noise."""
    t = np.arange(n) / FS
    x = sum(np.sin(2 * np.pi * f0 * k * t) / k for k in range(1, 8))
    x *= 0.6 + 0.4 * np.sin(2 * np.pi * 3.0 * t)
    return (x + 0.2 * rng.standard_normal(n)).astype(np.float32)


def _ar2(rng, n=4096):
    e = rng.standard_normal(n)
    x = np.zeros(n)
    for i in range(2, n):
        x[i] = 1.3 * x[i - 1] - 0.6 * x[i - 2] + e[i]
    return x.astype(np.float32)


def _keys(d: dict, *names):
    return [d[k] for k in names]


def _cases():
    r = np.random.default_rng(17)
    voice = _voice(r)
    noisy = np.concatenate([0.3 * r.standard_normal(2048), voice[2048:]]).astype(np.float32)
    ar = _ar2(r)
    far = r.standard_normal(3000).astype(np.float32)
    echo = (0.8 * far + 0.4 * np.roll(far, 5) + 0.2 * np.roll(far, 11)).astype(np.float32)
    howl = (np.sin(2 * np.pi * 2000 * np.arange(3000) / FS) + 0.05 * r.standard_normal(3000)
            ).astype(np.float32)
    dial = np.asarray(ref.dtmf_generate("19*#AD"))
    dial = (dial + 0.01 * r.standard_normal(dial.size)).astype(np.float32)
    melp_fields = ("lpc", "gain", "pitch", "voiced")
    return [
        ("dtmf_generate", lambda: au.dtmf_generate("147*0#", device="cpu"),
         lambda: ref.dtmf_generate("147*0#"), (), 0),
        ("dtmf_energies", lambda a: au.dtmf_energies(a),
         lambda a: _reference_energies(a), (dial,), TOL),
        ("dtmf_detect", lambda a: torch.tensor([ord(c) for c in au.dtmf_detect(a)]),
         lambda a: np.asarray([ord(c) for c in ref.dtmf_detect(a)]), (dial,), 0),
        ("mfcc", lambda a: au.mfcc(a, FS), lambda a: ref.mfcc(a, FS), (voice,), TOL),
        ("mfcc_short", lambda a: au.mfcc(a[:400], FS, 10, 20, 256, 128),
         lambda a: ref.mfcc(a[:400], FS, 10, 20, 256, 128), (voice,), TOL),
        ("phase_vocoder_slow", lambda a: au.phase_vocoder(a, 0.5),
         lambda a: ref.phase_vocoder(a, 0.5), (voice,), PV_TOL),
        ("phase_vocoder_fast", lambda a: au.phase_vocoder(a, 1.5, 512, 128),
         lambda a: ref.phase_vocoder(a, 1.5, 512, 128), (voice,), PV_TOL),
        ("lpc_coeffs_frame", lambda a: au.lpc_coeffs_frame(a.reshape(8, -1), 6),
         jax.jit(lambda a: ref.lpc_coeffs_frame(a.reshape(8, -1), 6)), (ar,), LOOP_TOL),
        ("lpc_coeffs_frame_silent", lambda a: au.lpc_coeffs_frame(a.reshape(4, -1) * 0, 4),
         jax.jit(lambda a: ref.lpc_coeffs_frame(a.reshape(4, -1) * 0, 4)), (ar,), 0),
        ("melp_analyze", lambda a: _keys(au.melp_analyze(a, FS, order=6), *melp_fields),
         jax.jit(lambda a: _keys(ref.melp_analyze(a, FS, order=6), *melp_fields)), (voice,),
         LOOP_TOL),
        ("melp_synthesize", lambda a: au.melp_synthesize(au.melp_analyze(a, FS, order=6), seed=3),
         jax.jit(lambda a: ref.melp_synthesize(ref.melp_analyze(a, FS, order=6), seed=3)),
         (voice[:3600],), LOOP_TOL),
        ("formant_track", lambda a: au.formant_track(a, FS, order=6, n_formants=2),
         lambda a: ref.formant_track(a, FS, order=6, n_formants=2), (ar,), LOOP_TOL),
        ("psychoacoustic_encode", lambda a: au.psychoacoustic_encode(a, 16000.0),
         lambda a: ref.psychoacoustic_encode(a, 16000.0), (voice,), TOL),
        ("psychoacoustic_decode", lambda a: au.psychoacoustic_decode(
            *au.psychoacoustic_encode(a, 16000.0, 256, 3), 256),
         lambda a: ref.psychoacoustic_decode(*ref.psychoacoustic_encode(a, 16000.0, 256, 3), 256),
         (voice,), TOL),
        ("voice_restore", lambda a: au.voice_restore(a, FS), lambda a: ref.voice_restore(a, FS),
         (noisy,), TOL),
        ("pitch_detect", lambda a: au.pitch_detect(a[:2048], FS),
         lambda a: ref.pitch_detect(a[:2048], FS), (voice,), TOL),
        ("pitch_track", lambda a: au.pitch_track(a, FS), lambda a: ref.pitch_track(a, FS),
         (voice,), TOL),
        ("echo_cancel_nlms", lambda m, f: au.echo_cancel_nlms(m, f, 16),
         lambda m, f: ref.echo_cancel_nlms(m, f, 16), (echo, far), LOOP_TOL),
        ("feedback_suppress", lambda a: au.feedback_suppress(a, 64),
         lambda a: ref.feedback_suppress(a, 64), (howl,), LOOP_TOL),
        ("channel_vocoder", lambda m, c: au.channel_vocoder(m, c, FS),
         lambda m, c: ref.channel_vocoder(m, c, FS), (voice, far), TOL),
    ]


def _reference_energies(a):
    """The reference detector's device half, as its body computes it."""
    frames = jnp.asarray(a)[: (a.shape[0] // 320) * 320].reshape(-1, 320)
    t = jnp.arange(320, dtype=jnp.float32) / 8000.0
    freqs = jnp.asarray(ref._DTMF_LOW + ref._DTMF_HIGH, jnp.float32)
    ph = 2 * np.pi * freqs[:, None] * t[None, :]
    e = (frames @ jnp.cos(ph).T) ** 2 + (frames @ jnp.sin(ph).T) ** 2
    return e, jnp.mean(frames ** 2, axis=-1) * 320 ** 2 / 4


CASES = _cases()


@pytest.mark.parametrize("name,port,want,args,tol", CASES, ids=[c[0] for c in CASES])
def test_parity(name, port, want, args, tol):
    check_parity(port, want, args, tol=tol, label=name)


@pytest.mark.parametrize("lead,want", [(0, "5551234"), (160, "51234")])
def test_dtmf_repeated_digits_merge_as_reference(lead, want):
    """At 80/40 ms, frames aligned with the dial keep the repeats; half a
    frame of lead puts a frame across each gap, which still holds the
    tone's tail, so the reference merges the 5s and so does the port."""
    rng = np.random.default_rng(1)
    dial = np.asarray(ref.dtmf_generate("5551234"))
    audio = (np.concatenate([np.zeros(lead, np.float32), dial])
             + 1e-3 * rng.standard_normal(lead + dial.size)).astype(np.float32)
    assert ref.dtmf_detect(jnp.asarray(audio)) == want
    assert au.dtmf_detect(torch.from_numpy(audio)) == want


@pytest.mark.parametrize("hop,length", [(4, 16), (3, 16), (8, 8)])
def test_overlap_add_sums_in_frame_order(hop, length):
    """Several frames a sample (4 at hop 4), with magnitudes that make
    the sum's order visible: equal bit for bit to the reference's
    scatter-add, and not to the reverse order."""
    rng = np.random.default_rng(hop)
    scale = np.float32([1e8, 1.0, 1e-3, 1e4] * 4)[:length]
    frames = (rng.standard_normal((7, length)) * scale).astype(np.float32)
    n_out = 6 * hop + length + 5
    idx = np.arange(7)[:, None] * hop + np.arange(length)[None, :]
    want = np.asarray(jnp.zeros(n_out, jnp.float32).at[idx.reshape(-1)].add(
        jnp.asarray(frames).reshape(-1)))
    got = au.overlap_add(torch.from_numpy(frames), hop, n_out).numpy()
    np.testing.assert_array_equal(got, want)
    if length > hop:
        backwards = np.zeros(n_out, np.float32)
        for f in reversed(range(7)):
            backwards[f * hop:f * hop + length] += frames[f]
        assert not np.array_equal(backwards, want)


def test_voice_restore_rows_are_calls():
    """Leading rows of voice_restore are separate calls, each with its own
    noise floor."""
    rng = np.random.default_rng(9)
    rows = np.stack([_voice(rng, 4096), _voice(rng, 4096, 120.0)])
    got = au.voice_restore(torch.from_numpy(rows), FS)
    for i in range(2):
        np.testing.assert_array_equal(got[i].numpy(),
                                      au.voice_restore(torch.from_numpy(rows[i]), FS).numpy())
