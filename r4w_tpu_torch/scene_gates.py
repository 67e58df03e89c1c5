"""A multi-emitter RF scene through the loopback SDR into a triggered SigMF capture.

`rf_scene_gate(device)` drives the host layer's data plane at a wideband
SDR front end's rate, 30.72 MS/s (an LTE 20 MHz capture), for one second in
blocks of 2^20 samples:

- `sim.scenario.ScenarioEngine` composes five emitters around a receiver
  moving north at 250 m/s (`Trajectory.linear`): two CW tones at ±6 MHz,
  one 20 km north and one 15 km south, 20 dB apart in transmit power; a
  BFSK burst from the waveform factory at the scene's rate carrying
  `PAYLOAD`, 10 km east; a noise jammer 5 km west, on from 0.40 s to
  0.55 s; a 2 MHz linear sweep jammer;
- each block is injected into the loopback `sim.Simulator` and received
  through its AWGN channel (the reference's threefry key from the
  simulator's own generator), then through the `sim.hal.DigitalAttenuator`;
- an `observe.CaptureManager` armed with 2^16 pre-trigger samples is
  triggered by the block whose power first exceeds 10× the quiet blocks'
  (the jammer's onset: the engine switches emitters per block), records
  2^23 samples after it and is saved as cf32 SigMF in a temporary
  directory, then replayed through `sim.SigmfReplayDevice`;
- `streams.burst_tagger` tags the jammer's window on the replay's power in
  4096-sample windows and `streams.stream_to_pdus` cuts it out; the BFSK
  burst after the window is cut with `streams.chain(skiphead, head)`,
  down-converted by two decimating FIRs (÷64, ÷32) to 15 kS/s and decoded;
- an `observe.MetricsRegistry` counts samples and blocks and times each
  block into a histogram; its Prometheus text is fetched once from
  `observe.serve_metrics` on 127.0.0.1;
- `config.R4wConfig` defaults are validated and the gate's profile (block
  size, capture lengths) is applied from a dict.

Bars (the reference's tests at this scene's size): each tone's spectral
peak within 100 Hz of its offset plus the Doppler `emitter_status`
predicts; the tones' power ratio within 1.5 dB of the predicted
difference; the jammer's window above 10× the power around it; the
payload decoded from the replay; the replay equal to the capture bit for
bit; the trigger at the configured pre-trigger count (annotation and the
tagged onset); the exported sample counter equal to the scene's samples.
"""

from __future__ import annotations

import os
import tempfile
import time
import urllib.request

import numpy as np
import torch

from r4w_tpu_torch import config as r4w_config
from r4w_tpu_torch import streams
from r4w_tpu_torch.core.types import DEFAULT_DEVICE, resolve_device
from r4w_tpu_torch.observe import (CaptureConfig, CaptureManager, CaptureState, MetricsRegistry,
                                   Timer)
from r4w_tpu_torch.observe import get_logger, serve_metrics
from r4w_tpu_torch.ops import filters
from r4w_tpu_torch.sim import SigmfReplayDevice, Simulator, SimulatorConfig
from r4w_tpu_torch.sim.hal import DigitalAttenuator
from r4w_tpu_torch.sim.scenario import (NoiseJammerEmitter, SceneConfig, ScenarioEngine,
                                        SweepJammerEmitter, ToneEmitter, Trajectory,
                                        WaveformEmitter)
from r4w_tpu_torch.waveforms import create_waveform

log = get_logger("scene")

RATE_HZ = 30.72e6
SECONDS = 1.0
LAT, LON, ALT = 45.0, 7.0, 100.0
RX_SPEED_MPS = 250.0
TONE_OFFSET_HZ = 6.0e6         # ± this: equal |f|, so the float32 sample time costs both alike
TONE_CARRIER_HZ = 1e9
TONE_POWERS_DBM = (30.0, 10.0)
PAYLOAD = b"R4W"
DDC_STAGES = ((64, 255, 100e3), (32, 127, 4e3))  # (factor, taps, cutoff Hz): to 15 kS/s
JAMMER_WINDOW_S = (0.40, 0.55)
ATTENUATION_DB = 10.0
SNR_DB = 30.0                  # the simulator's AWGN against each block's power
TRIGGER_RATIO = 10.0           # block power over the quiet blocks' median
QUIET_BLOCKS = 4
TAG_WINDOW = 4096              # samples per power window of the burst tagger
PROFILE = {"device": {"driver": "simulator", "sample_rate": RATE_HZ,
                      "frequency": TONE_CARRIER_HZ},
           "metrics": {"enabled": True, "port": 9090},
           "profiles": {"scene": {"buffer": {"block_size": 1 << 20},
                                  "capture": {"pre_trigger_samples": 1 << 16,
                                              "post_trigger_samples": 1 << 23}}}}
PEAK_TOL_HZ = 100.0
RATIO_TOL_DB = 1.5
JAMMER_RATIO_MIN = 10.0
LINE_BINS = 50                 # ± bins of 1/SECONDS Hz summed for a tone's power


def _north(km: float) -> float:
    return LAT + km / 111.195  # degrees of latitude for km


def _east(km: float) -> float:
    return LON + km / (111.195 * np.cos(np.radians(LAT)))


def scene(seconds: float = SECONDS, block: int = 1 << 20, device=DEFAULT_DEVICE,
          jammer=JAMMER_WINDOW_S) -> ScenarioEngine:
    """The gate's engine on `device` (a shorter scene, with the jammer's
    window `jammer` inside it, for tests)."""
    cfg = SceneConfig(sample_rate=RATE_HZ, duration_s=seconds, block_size=block,
                      noise_figure_db=6.0, seed=21)
    rx = Trajectory.linear(LAT, LON, ALT, (0.0, RX_SPEED_MPS, 0.0))
    emitters = [
        ToneEmitter(id="tone_north", carrier_hz=TONE_CARRIER_HZ, power_dbm=TONE_POWERS_DBM[0],
                    offset_hz=TONE_OFFSET_HZ, trajectory=Trajectory.static(_north(20.0), LON, ALT)),
        ToneEmitter(id="tone_south", carrier_hz=TONE_CARRIER_HZ, power_dbm=TONE_POWERS_DBM[1],
                    offset_hz=-TONE_OFFSET_HZ,
                    trajectory=Trajectory.static(_north(-15.0), LON, ALT)),
        WaveformEmitter(id="bfsk", carrier_hz=433e6, power_dbm=20.0, waveform_name="BFSK",
                        payload=PAYLOAD, sample_rate=RATE_HZ,
                        trajectory=Trajectory.static(LAT, _east(10.0), ALT)),
        NoiseJammerEmitter(id="noise_jammer", carrier_hz=TONE_CARRIER_HZ, power_dbm=40.0,
                           seed=5, t_on=jammer[0], t_off=jammer[1],
                           trajectory=Trajectory.static(LAT, _east(-5.0), ALT)),
        SweepJammerEmitter(id="sweep_jammer", carrier_hz=TONE_CARRIER_HZ, power_dbm=20.0,
                           sweep_hz=2e6, period_s=0.01,
                           trajectory=Trajectory.static(_north(6.0), _east(6.0), ALT)),
    ]
    return ScenarioEngine(cfg, emitters, rx, reference_power_dbm=-90.0, device=device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_chain(engine: ScenarioEngine, settings: r4w_config.R4wConfig, capture_dir: str,
              metrics: MetricsRegistry) -> dict:
    """Engine → simulator → attenuator → capture, block by block; returns
    the received stream, the capture manager and the trigger block."""
    dev = engine.device
    cfg = engine.config
    block = settings.buffer.block_size
    sim = Simulator(SimulatorConfig(sample_rate=cfg.sample_rate, channel_snr_db=SNR_DB,
                                    seed=cfg.seed), device=dev)
    att = DigitalAttenuator()
    att.set_attenuation(ATTENUATION_DB)
    cap = CaptureManager(CaptureConfig(
        pre_trigger_samples=settings.capture.pre_trigger_samples,
        post_trigger_samples=settings.capture.post_trigger_samples,
        sample_rate=cfg.sample_rate, frequency=settings.device.frequency), device=dev)
    samples = metrics.counter("r4w_scene_samples_total", "samples received")
    blocks = metrics.counter("r4w_scene_blocks_total", "blocks received")
    latency = metrics.histogram("r4w_scene_block_seconds", "seconds a block, host",
                                buckets=(1e-4, 1e-3, 1e-2, 1e-1, 1.0))
    rx = torch.empty(cfg.total_samples, dtype=torch.complex64, device=dev)
    powers: list[float] = []
    trigger_block = None
    cap.arm()
    pos = 0
    while not engine.is_done:
        with Timer(latency):
            composite = engine.generate_block(block)
            n = composite.shape[0]
            sim.inject_signal(composite)
            y = att.apply(sim.receive(n))
            rx[pos:pos + n] = y
            power = float(torch.mean(y.real ** 2 + y.imag ** 2))
            if (trigger_block is None and len(powers) >= QUIET_BLOCKS
                    and power > TRIGGER_RATIO * float(np.median(powers))):
                trigger_block = len(powers)
                cap.trigger()
            if cap.state != CaptureState.COMPLETE:
                cap.process(y)
            powers.append(power)
        samples.inc(n)
        blocks.inc()
        pos += n
    path = os.path.join(capture_dir, "scene.sigmf-data")
    cap.save(path, description="r4w_tpu_torch rf scene")
    log.info("scene: %d blocks, trigger at block %s", len(powers), trigger_block)
    return {"rx": rx, "capture": cap, "path": path, "trigger_block": trigger_block,
            "block": block}


def tone_lines(rx: torch.Tensor, engine: ScenarioEngine, seconds: float) -> dict:
    """Each tone's spectral peak (Hz) and line power (±LINE_BINS bins) over
    the whole received stream, beside `emitter_status` at mid-scene."""
    fs = engine.config.sample_rate
    n = rx.shape[0]
    power = torch.fft.fft(rx).abs() ** 2
    status = {s.id: s for s in engine.emitter_status(seconds / 2)}
    out = {}
    for em in engine.emitters[:2]:
        want = em.offset_hz + status[em.id].doppler_hz
        k0 = int(round(em.offset_hz / fs * n)) % n
        half = int(round(2 * abs(status[em.id].doppler_hz) + 1000.0))
        idx = torch.remainder(torch.arange(k0 - half, k0 + half + 1, device=rx.device), n)
        seg = power[idx]
        kp = int(idx[int(torch.argmax(seg))])
        f_peak = (kp - n if kp > n // 2 else kp) * fs / n
        line = torch.remainder(torch.arange(kp - LINE_BINS, kp + LINE_BINS + 1,
                                            device=rx.device), n)
        out[em.id] = {"peak_hz": f_peak, "want_hz": want, "err_hz": f_peak - want,
                      "line_power": float(power[line].sum()),
                      "predicted_dbm": status[em.id].received_power_dbm,
                      "doppler_hz": status[em.id].doppler_hz}
    return out


def decode_payload(replay: torch.Tensor, first_sample: int, engine: ScenarioEngine) -> dict:
    """The BFSK payload from the last whole burst of the replay: cut with
    the stream blocks, two decimating FIRs down to 15 kS/s, the factory
    demodulator. `first_sample` is the replay's first sample in the scene;
    `window` is the cut's (offset, length) in the replay."""
    fs = engine.config.sample_rate
    em = next(e for e in engine.emitters if e.id == "bfsk")
    burst = len(em._burst)
    factor = 1
    delay = 0.0
    for f, k, _ in DDC_STAGES:
        delay += (k - 1) / 2 * factor
        factor *= f
    skip_out = int(round(delay / factor))
    pad = (skip_out + 2) * factor
    end = first_sample + replay.shape[0]
    start = ((end - burst - pad) // burst) * burst  # the last burst that fits with the pad
    cut = streams.chain(lambda x: streams.skiphead(x, start - first_sample),
                        lambda x: streams.head(x, burst + pad))
    y = cut(replay)
    rate = fs
    for f, k, cutoff in DDC_STAGES:
        taps = filters.design_lowpass(k, cutoff, rate)
        y, _ = filters.decimating_fir(taps, y, f)
        rate /= f
    wf = create_waveform("BFSK", rate, device=replay.device)
    n_out = burst // factor
    res = wf.demodulate(y[skip_out:skip_out + n_out])
    got = bytes(res.bits[: len(PAYLOAD)].cpu().numpy().astype(np.uint8))
    return {"payload": got, "ok": got == PAYLOAD, "burst_start": start, "rate_hz": rate,
            "window": (start - first_sample, burst + pad)}


def jammer_window(replay: torch.Tensor, pre: int) -> dict:
    """The burst tagger's edges on the replay's power in TAG_WINDOW windows
    (threshold: the geometric mean of the history's power and the loudest
    window), the jammer's PDU and its power over the rest."""
    n = (replay.shape[0] // TAG_WINDOW) * TAG_WINDOW
    pw = torch.mean((replay[:n].abs() ** 2).reshape(-1, TAG_WINDOW), dim=-1)
    floor = float(torch.mean(replay[:pre].abs() ** 2))
    thr = float(np.sqrt(floor * float(pw.max())))
    mask = torch.repeat_interleave(pw > thr, TAG_WINDOW)
    tags = streams.burst_tagger(replay[:n], mask, key="jammer")
    edges = [t.offset for t in tags]
    pdus = streams.stream_to_pdus(replay, [0] + edges[:2]) if len(edges) >= 2 else []
    inside = pdus[1].data if len(pdus) > 1 else replay[:0]
    outside = torch.cat([pdus[0].data, pdus[2].data]) if len(pdus) > 2 else replay[:0]
    p_in = float(torch.mean(inside.abs() ** 2)) if inside.numel() else 0.0
    p_out = float(torch.mean(outside.abs() ** 2)) if outside.numel() else float("inf")
    return {"tags": [(t.offset, t.value) for t in tags], "ratio": p_in / p_out,
            "window": edges[:2]}


def fetch_metrics(metrics: MetricsRegistry) -> str:
    """The registry's Prometheus text, fetched once over HTTP from a server
    on 127.0.0.1 at a free port, then the server is shut down."""
    server = serve_metrics(port=0, registry=metrics, host="127.0.0.1")
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/metrics"
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.read().decode()
    finally:
        server.shutdown()
        server.server_close()


def rf_scene_gate(device=DEFAULT_DEVICE, seconds: float = SECONDS, profile: dict | None = None,
                  jammer=JAMMER_WINDOW_S) -> dict:
    """The scene for `seconds` (the gate: 1 s at 30.72 MS/s) on
    `device`, every bar checked; `profile` overrides `PROFILE` and `jammer`
    the jammer's window (tests use a shorter scene, smaller blocks and
    captures)."""
    device = resolve_device(device)
    raw = PROFILE if profile is None else profile
    defaults_ok = r4w_config.R4wConfig().validate() == []
    settings = r4w_config.R4wConfig.from_dict(raw).with_profile("scene")
    problems = settings.validate()
    metrics = MetricsRegistry()
    stage: dict = {}
    _sync(device)
    t0 = time.perf_counter()
    engine = scene(seconds, settings.buffer.block_size, device, jammer)
    with tempfile.TemporaryDirectory() as tmp:
        run = run_chain(engine, settings, tmp, metrics)
        _sync(device)
        t1 = time.perf_counter()
        stage["chain_s"] = t1 - t0
        replay_dev = SigmfReplayDevice(run["path"], device=device)
        cap = run["capture"]
        captured = cap.samples()
        replay = replay_dev.receive(captured.shape[0])
        with open(run["path"][: -len("-data")] + "-meta") as f:
            meta_text = f.read()
        annotations = replay_dev._meta.annotations
    stage["capture_io_s"] = time.perf_counter() - t1
    t2 = time.perf_counter()
    pre = settings.capture.pre_trigger_samples
    lines = tone_lines(run["rx"], engine, seconds)
    first = (run["trigger_block"] or 0) * run["block"] - cap.pre_count
    payload = decode_payload(replay, first, engine)
    jam = jammer_window(replay, pre)
    text = fetch_metrics(metrics)
    stage["analysis_s"] = time.perf_counter() - t2
    counter = next(float(line.split()[1]) for line in text.splitlines()
                   if line.startswith("r4w_scene_samples_total "))
    a, b = (lines[e.id] for e in engine.emitters[:2])
    ratio_db = 10 * np.log10(a["line_power"] / b["line_power"])
    want_db = a["predicted_dbm"] - b["predicted_dbm"]
    bars = {
        "tone_peaks": all(abs(v["err_hz"]) <= PEAK_TOL_HZ for v in lines.values()),
        "tone_ratio": abs(ratio_db - want_db) <= RATIO_TOL_DB,
        "jammer_window": jam["ratio"] > JAMMER_RATIO_MIN,
        "payload": payload["ok"],
        "replay_equal": bool(torch.equal(replay, captured)),
        "trigger_at_pre": (run["trigger_block"] is not None
                           and annotations[0]["core:sample_start"] == pre
                           and jam["window"][:1] == [pre]),
        "sample_counter": counter == engine.config.total_samples,
        "config": defaults_ok and problems == [],
    }
    bars = {k: bool(v) for k, v in bars.items()}
    _sync(device)
    return {"ok": all(bars.values()), "bars": bars, "tones": lines, "ratio_db": ratio_db,
            "want_ratio_db": want_db, "jammer": jam, "payload": payload,
            "trigger_block": run["trigger_block"], "capture_samples": captured.shape[0],
            "metrics_text": text, "sigmf_meta": meta_text,
            "samples": engine.config.total_samples, "stage_s": stage,
            "seconds": time.perf_counter() - t0, "capture": captured,
            "device": str(device)}
