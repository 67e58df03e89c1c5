"""The host layer's two gates: ``r4w benchmark``'s remote-lab path and the
pipeline wizard's block graph, each at a full LoRa packet.

`remote_lab_gate(device)` drives the distributed path of SURVEY §3.4 on
loopback: an `agent.AgentServer` on 127.0.0.1 (port 0) serving from a
thread, an `agent.AgentClient` on its JSON-lines control plane, and a
`benchmark.BenchmarkReceiver` on the native UDP receiver (iqcore's C++
thread and lock-free ring) that demodulates each batch on the device.

- Control plane: ``ping``, ``status``, ``list_waveforms`` (the port's 50
  names) and an unknown command, each answered as the reference answers.
- Phase 1, one packet: ``start_tx`` of LoRa-SF7 at 125 kS/s with a 255-byte
  payload (LoRa's largest; printable ASCII from ``default_rng(20)``, as the
  protocol carries the payload as text), no repeat. The receiver reads
  exactly the burst's 48,288 samples; bars: the samples equal the device's
  modulated burst bit for bit, no sequence gap, the decoded bytes equal the
  payload and the CPU's decode of the same samples.
- Phase 2, the reference's ``BenchmarkReceiver.run(duration_s=5.0)``:
  ``start_tx`` with repeat on and no pacing; the clock starts after the
  first processed batch; bars: at least 1.0 Msps demodulated (the
  reference's LoRa SF7 objective, MEASURABLE_OBJECTIVES.md:44-45) and the
  batch latencies ordered, p99 ≥ avg > 0. Reported: offered and processed
  rates, packets, sequence gaps and overrun floats of the phase, the
  runner's `rt.LatencyHistogram` percentiles, and the dechirp kernel's
  launches. An unpaced sender on loopback may outrun the ring: overruns
  are reported, not barred.

The gate fails at once when the native receiver is not the one in use
(the library did not build): it never falls back to the Python socket.

`block_graph_gate(device)` runs the pipeline wizard's graph (`graph_nodes`:
a LoRa-SF7 burst of the same payload through ``awgn_channel`` at 16 dB, a
DC blocker and the demodulator, a Welch PSD and a decimating FIR off the
channel, and an unknown block with a dependent) with
``run_pipeline(nodes, seed=0, sample_rate=125000.0)``. On the card it
launches the dechirp kernel (``rx``), the first-order recursion (``flt``)
and the FIR (``dec``). Bars: the reference's order, shapes and dtypes,
``rx.decoded_ok``, the reference's errors on ``bad`` and ``down`` and no
other. `compare_reports` holds one report against another (the card's
against the CPU's, or against the reference's).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from r4w_tpu_torch import native
from r4w_tpu_torch.agent import AgentClient, AgentServer
from r4w_tpu_torch.benchmark import BenchmarkMetrics, BenchmarkReceiver
from r4w_tpu_torch.core.types import DEFAULT_DEVICE, resolve_device
from r4w_tpu_torch.kernels.dechirp import dechirp_power
from r4w_tpu_torch.ops.filters import design_lowpass
from r4w_tpu_torch.pipeline import run_pipeline
from r4w_tpu_torch.rt import LatencyHistogram
from r4w_tpu_torch.scheduler import SampleSchedule, ScheduledEvent
from r4w_tpu_torch.waveforms import create_waveform, list_waveforms

WAVEFORM = "LoRa-SF7"
RATE_HZ = 125_000.0
PAYLOAD_BYTES = 255          # LoRa's largest payload
PAYLOAD_SEED = 20
BURST_SAMPLES = 48_288       # LoRa-SF7 at 125 kS/s with a 255-byte payload
RUN_SECONDS = 5.0            # the reference's BenchmarkReceiver.run default
MIN_MSPS = 1.0               # demodulated, MEASURABLE_OBJECTIVES.md:44-45
DEADLINE_S = 3.0             # every wait on a socket
GRAPH_SNR_DB = "16"
GRAPH_NPERSEG = 1024
GRAPH_TAPS = (63, 50e3, 500e3)   # design_lowpass(num_taps, cutoff, sample_rate)
GRAPH_FACTOR = 4
GRAPH_SEED = 0
POWER_TOL_DB = 0.01          # one report against another: power and SNR estimate
PREVIEW_TOL = 1e-4           # preview points and spectrum bins, absolute
# The reference's report of the gate's graph at a 255-byte payload
# (r4w_tpu.pipeline.run_pipeline on the CPU): shapes and dtypes by node.
GRAPH_ORDER = ["tx", "ch", "flt", "rx", "psd", "dec", "bad", "down"]
GRAPH_SHAPES = {"tx": ([48_288], "complex64"), "ch": ([48_288], "complex64"),
                "flt": ([48_288], "complex64"), "rx": ([255], "int32"),
                "psd": ([1024], "float32"), "dec": ([12_072], "complex64")}
GRAPH_ERRORS = {"bad": "PipelineError: unknown block 'no_such_block'",
                "down": "PipelineError: input 'bad' unavailable"}
# `hopping_link_gate`'s link as a schedule: 64 channels, 40 ms hops at 2.048 MS/s,
# the last 4,096 samples of each the guard (painted over the hop).
HOP_RATE_HZ = 2.048e6
HOP_CHANNELS = 64
HOP_COUNT = 250
HOP_DWELL_S = 0.040
HOP_GUARD = 4_096


def gate_payload(n: int = PAYLOAD_BYTES, seed: int = PAYLOAD_SEED) -> bytes:
    """`n` printable ASCII bytes from ``default_rng(seed)``."""
    return bytes(np.random.default_rng(seed).integers(32, 127, n).astype(np.uint8))


def _wait(predicate, deadline_s: float = DEADLINE_S, poll_s: float = 0.002) -> bool:
    end = time.perf_counter() + deadline_s
    while time.perf_counter() < end:
        if predicate():
            return True
        time.sleep(poll_s)
    return predicate()


def control_plane(client: AgentClient) -> dict:
    """The four control-plane replies and whether each is the reference's."""
    replies = {"ping": client.ping(), "status": client.status(),
               "list_waveforms": client.call("list_waveforms"), "nonsense": client.call("nonsense")}
    ok = {"ping": replies["ping"]["response"] == "pong"
          and isinstance(replies["ping"]["timestamp"], float),
          "status": replies["status"]["response"] == "status"
          and replies["status"]["data"]["tx_active"] is False
          and replies["status"]["data"]["rx_active"] is False,
          "list_waveforms": replies["list_waveforms"] == {"response": "ok",
                                                          "data": list_waveforms()},
          "nonsense": replies["nonsense"] == {"response": "error",
                                              "message": "unknown command nonsense"}}
    return {"replies": replies, "ok": ok}


def remote_lab_gate(device=DEFAULT_DEVICE) -> dict:
    """`r4w benchmark`'s agent → UDP → demodulate path (module docstring)."""
    dev = resolve_device(device)
    payload = gate_payload()
    server = AgentServer(host="127.0.0.1", port=0, device=dev)
    serving = server.serve_in_thread()
    client = AgentClient(port=server.port, timeout_s=DEADLINE_S)
    receiver = BenchmarkReceiver(port=0, waveform_name=WAVEFORM, sample_rate=RATE_HZ, device=dev)
    try:
        if receiver.native is None:
            raise RuntimeError(f"the native UDP receiver is not in use: {native.build_error()}")
        target = f"127.0.0.1:{receiver.port}"
        control = control_plane(client)

        # Phase 1: one packet.
        burst = create_waveform(WAVEFORM, RATE_HZ, dev).modulate(payload).cpu().numpy()
        n = burst.shape[0]
        reply = client.start_tx(target, waveform=WAVEFORM, message=payload.decode("ascii"),
                                sample_rate=RATE_HZ)
        sent = server.join_tx(DEADLINE_S)
        arrived = _wait(lambda: receiver.native.available_samples >= n)
        samples = receiver.native.read(n + 1)
        extra = receiver.native.available_samples
        stats1 = receiver.native.stats
        t0 = time.perf_counter()
        bits = receiver.runner.process(samples)
        first_batch_s = time.perf_counter() - t0
        decoded = bytes(bits[: len(payload)].astype(np.uint8))
        cpu_bits = create_waveform(WAVEFORM, RATE_HZ, "cpu").demodulate(
            torch.from_numpy(samples)).bits.numpy()
        one = {"reply": reply, "samples": int(samples.shape[0]), "burst_samples": int(n),
               "seq_gaps": stats1["seq_gaps"], "packets": stats1["packets"],
               "decoded": decoded, "first_batch_s": first_batch_s}

        # Phase 2: the reference's run, unpaced.
        receiver.runner.metrics = BenchmarkMetrics()
        receiver.runner.histogram = LatencyHistogram()
        launches0 = dechirp_power.launches
        t_tx = time.perf_counter()
        reply2 = client.start_tx(target, waveform=WAVEFORM, message=payload.decode("ascii"),
                                 sample_rate=RATE_HZ, repeat=True, pps=0)
        metrics = receiver.run(duration_s=RUN_SECONDS, print_fn=lambda _: None)
        offered = server.tx_sent["samples"] / (time.perf_counter() - t_tx)
        stopped = client.stop_tx()
        joined = server.join_tx(DEADLINE_S)
        stats2 = receiver.native.stats
        lat = metrics.latency_stats()
        hist = receiver.runner.histogram.summary()
        run = {"reply": reply2, "stop": stopped, "msps": metrics.throughput_msps(),
               "offered_msps": offered / 1e6, "samples": metrics.samples_processed,
               "batches": metrics.batches, "elapsed_s": metrics.elapsed_s,
               "latency_ms": lat, "histogram_s": hist,
               "packets": stats2["packets"] - stats1["packets"],
               "seq_gaps": stats2["seq_gaps"] - stats1["seq_gaps"],
               "overrun_floats": stats2["overrun_floats"] - stats1["overrun_floats"],
               "packets_dropped": metrics.packets_dropped,
               "dechirp_launches": dechirp_power.launches - launches0}
        bars = {"native_receiver": receiver.native is not None,
                "control_plane": all(control["ok"].values()),
                "sent": reply["response"] == "ok" and sent and arrived,
                "exact_samples": samples.shape[0] == n == BURST_SAMPLES and extra == 0,
                "bit_for_bit": np.array_equal(samples.view(np.uint32), burst.view(np.uint32)),
                "no_seq_gaps": stats1["seq_gaps"] == 0,
                "decoded_payload": decoded == payload,
                "decoded_equals_cpu": np.array_equal(bits, cpu_bits),
                "throughput": run["msps"] >= MIN_MSPS,
                "latency_ordered": lat["p99"] >= lat["avg"] > 0,
                "stopped": stopped["response"] == "ok" and joined}
        bars = {k: bool(v) for k, v in bars.items()}
        return {"ok": all(bars.values()), "bars": bars, "control": control, "packet": one,
                "run": run, "device": str(dev),
                "batch": np.tile(burst, -(-(1 << 16) // n))[: 1 << 16]}
    finally:
        try:
            client.stop_tx()
            client.shutdown()
        finally:
            client.close()
            server.join_tx(DEADLINE_S)
            receiver.close()
            serving.join(DEADLINE_S)


def graph_nodes(payload: bytes | None = None) -> list[dict]:
    """The pipeline wizard's graph of the gate (module docstring)."""
    payload = gate_payload() if payload is None else payload
    wf = {"name": WAVEFORM, "sample_rate": int(RATE_HZ), "hex": payload.hex()}
    taps = [float(t) for t in design_lowpass(*GRAPH_TAPS)]
    return [
        {"id": "tx", "block": "waveform_tx", "params": dict(wf)},
        {"id": "ch", "block": "awgn_channel", "params": {"snr_db": GRAPH_SNR_DB},
         "inputs": ["tx"]},
        {"id": "flt", "block": "dc_blocker", "inputs": ["ch"]},
        {"id": "rx", "block": "waveform_rx", "params": dict(wf), "inputs": ["flt"]},
        {"id": "psd", "block": "welch_psd", "params": {"nperseg": GRAPH_NPERSEG},
         "inputs": ["ch"]},
        {"id": "dec", "block": "polyphase_decimator",
         "params": {"taps": taps, "factor": GRAPH_FACTOR}, "inputs": ["ch"]},
        {"id": "bad", "block": "no_such_block", "inputs": ["tx"]},
        {"id": "down", "block": "dc_blocker", "inputs": ["bad"]},
    ]


def block_graph_gate(device=DEFAULT_DEVICE) -> dict:
    """The pipeline wizard's graph at a full LoRa packet (module docstring)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    report = run_pipeline(graph_nodes(), seed=GRAPH_SEED, sample_rate=RATE_HZ, device=dev)
    seconds = time.perf_counter() - t0
    nodes = report["nodes"]
    errors = {k: v["error"] for k, v in nodes.items() if "error" in v}
    bars = {"order": report["order"] == GRAPH_ORDER,
            "decoded_ok": nodes["rx"].get("decoded_ok") is True,
            "errors": errors == GRAPH_ERRORS,
            "shapes": {k: (nodes[k].get("shape"), nodes[k].get("dtype")) for k in GRAPH_SHAPES}
            == {k: (s, d) for k, (s, d) in GRAPH_SHAPES.items()}}
    bars = {k: bool(v) for k, v in bars.items()}
    return {"ok": all(bars.values()), "bars": bars, "report": report, "seconds": seconds,
            "device": str(dev)}


def _flat_preview(preview: dict) -> dict:
    return {k: np.asarray(v, np.float64) for k, v in preview.items()
            if isinstance(v, list)}


def compare_reports(got: dict, want: dict, power_tol: float = POWER_TOL_DB,
                    preview_tol: float = PREVIEW_TOL) -> dict:
    """One pipeline report against another: the order, each node's keys,
    block, shape, dtype, error and decisions equal; power and SNR estimate
    within `power_tol` dB; every preview value within `preview_tol`.
    Returns {"equal": bool, "worst_power_db", "worst_preview",
    "worst_preview_at": (node, array), "diffs"}."""
    diffs = []
    worst_power = worst_preview = 0.0
    worst_at = None
    if got["order"] != want["order"] or got["ok"] != want["ok"]:
        diffs.append(("order/ok", got["order"], want["order"]))
    for nid, w in want["nodes"].items():
        g = got["nodes"].get(nid, {})
        if set(g) != set(w):
            diffs.append((nid, "keys", sorted(g), sorted(w)))
            continue
        for k, wv in w.items():
            gv = g[k]
            if k in ("power_db", "snr_estimate_db", "samples_per_symbol") or k.startswith("aux"):
                if (gv is None) != (wv is None):
                    diffs.append((nid, k, gv, wv))
                elif wv is not None:
                    d = abs(float(gv) - float(wv))
                    if k == "power_db":
                        worst_power = max(worst_power, d)
                    if not d <= power_tol:
                        diffs.append((nid, k, gv, wv))
            elif k == "preview":
                gp, wp = _flat_preview(gv), _flat_preview(wv)
                scalars = {x: gv[x] for x in gv if x not in gp}
                if scalars != {x: wv[x] for x in wv if x not in wp} or set(gp) != set(wp):
                    diffs.append((nid, "preview", scalars))
                    continue
                for name, arr in wp.items():
                    if gp[name].shape != arr.shape:
                        diffs.append((nid, name, gp[name].shape, arr.shape))
                        continue
                    d = float(np.max(np.abs(gp[name] - arr))) if arr.size else 0.0
                    if d > worst_preview:
                        worst_preview, worst_at = d, (nid, name)
                    if not d <= preview_tol:
                        diffs.append((nid, name, d))
            elif gv != wv:
                diffs.append((nid, k, gv, wv))
    return {"equal": not diffs, "worst_power_db": worst_power, "worst_preview": worst_preview,
            "worst_preview_at": worst_at, "diffs": diffs[:20]}


def hop_schedule(hops: int = HOP_COUNT) -> SampleSchedule:
    """`hopping_link_gate`'s link as a `SampleSchedule`: its LFSR pattern over 64
    channels, a hop every 40 ms at 2.048 MS/s, and each hop's last 4,096
    samples a guard at a higher priority, painted over the hop."""
    from r4w_tpu_torch.ops.infra_fills import hop_pattern_lfsr

    pattern = hop_pattern_lfsr(HOP_CHANNELS, hops, device="cpu").numpy()
    sched = SampleSchedule(HOP_RATE_HZ)
    sched.add_hop_pattern(pattern, dwell_s=HOP_DWELL_S)
    dwell = int(round(HOP_DWELL_S * HOP_RATE_HZ))
    for i in range(hops):
        sched.add(ScheduledEvent((i + 1) * dwell - HOP_GUARD, HOP_GUARD, kind="guard",
                                 channel=-1, priority=1))
    return sched
