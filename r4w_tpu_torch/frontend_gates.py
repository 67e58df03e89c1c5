"""The front ends at full width: the command line and the explorer.

`cli_runs(workdir)` lists the CLI commands a user runs on a 255-byte LoRa
payload (LoRa's largest): `simulate` of LoRa-SF12 over each of the nine
channel models and of LoRa-SF7, the `benchmark`, a six-waveform `compare`,
files through `tx`/`rx` (cf32 and SigMF), `analyze`, `record`/`playback`,
`convert`, and the rest of the subcommands that need neither PyYAML nor
matplotlib. `run_cli_set(runs, device, workdir)` runs them in-process
through `cli.main` with ``--device`` and returns each one's exit, printed
lines and the IQ files written;
`compare_cli(card, cpu)` holds two such runs equal, line for line, but the
lines each run's mode names: wall times (by their form), a clean capture's
SNR estimate (rounding alone), a spectrum's float32 values (within
`ANALYZE_TOL_DB`), the BER gate's Monte-Carlo draws (Philox differs by
device: its points and theory are compared, and its verdict, a 200,000-bit
draw against a 10% bar, is not) and the process's metrics registry (its
gauge line). `CLI_NOT_RUN` names what is left out and why.

`explorer_reference(device)` computes what the explorer's device work
gives for the same inputs on any device: the pipeline wizard's report of
the block-graph gate's graph (`remote_gates.graph_nodes`) at the handler's default
rate, and the demo round of LoRa-SF12 with the 255-byte payload over the
nine channel models; `compare_demo` holds two such rounds together.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import time
import typing
from pathlib import Path

import numpy as np

from r4w_tpu_torch import remote_gates
from r4w_tpu_torch.channel.channel import ChannelModelName

PAYLOAD_HEX = remote_gates.gate_payload().hex()   # 255 printable bytes (the remote-lab gate's)
CHANNEL_MODELS = typing.get_args(ChannelModelName)
COMPARE_WAVEFORMS = "LoRa-SF7,MIL-STD-188-110,STANAG-4285,SINCGARS,QPSK,OFDM"
DEMO_WAVEFORM = "LoRa-SF12"
DEMO_KEYS_EXACT = ("samples", "sample_rate", "samples_per_symbol", "channel", "decoded_ok",
                   "decoded_hex")
ANALYZE_TOL_DB = 1e-3      # analyze --json: float32 Welch sums in another order
FILE_TOL = 1e-5            # files written by tx/record/adsb: float32 IQ, max |Δ|
DEMO_METRIC_REL_TOL = 1e-4  # the demo's float estimates, relative
DEMO_DB_TOL = 1e-3         # the demo's Welch spectrum, dB
DEMO_WATERFALL_REL_TOL = 1e-4  # its waterfall: max|Δ amplitude| / max amplitude; the card's
#                                channels are within 1e-5 of the CPU's (chip_smoke phase 32)
CLI_NOT_RUN = {
    "config": "needs PyYAML (R4wConfig.to_yaml/load_from)",
    "spec": "needs PyYAML (WaveformSpec.load)",
    "gnss scenario": "needs PyYAML (load_scenario_yaml)",
    "gallery": "needs matplotlib",
    "explore": "a server: the explorer phase serves it in-process",
    "agent": "a server: the explorer phase runs an AgentServer in-process",
    "remote": "needs a running agent: the explorer phase relays to one",
    "udp-send": "a network sender: the explorer phase's live stream carries UDP IQ",
    "gnss ephemeris": "needs a RINEX/SP3/IONEX file; fetch needs the network",
}
BENCHMARK_FORM = (r"waveform:    \S+$", r"iterations:  \d+ in \d+\.\d\ds$",
                  r"throughput:  \d+\.\d\d Msamples/s$",
                  r"latency:     avg \d+\.\d\d ms  min \d+\.\d\d  max \d+\.\d\d  "
                  r"p99 \d+\.\d\d$")


def cli_runs(workdir: str) -> list[tuple[str, list[str], str]]:
    """(label, argv, compare mode) of every command, with files in
    `workdir`; the commands that read a file follow the one that writes it."""
    d = Path(workdir)
    hx = ["--hex", PAYLOAD_HEX]
    runs = [(f"simulate LoRa-SF12 {m}", ["simulate", "-w", "LoRa-SF12", *hx, "--channel", m],
             "equal") for m in CHANNEL_MODELS]
    runs += [
        ("simulate LoRa-SF7", ["simulate", "-w", "LoRa-SF7", *hx], "equal"),
        ("benchmark", ["benchmark", "-w", "LoRa-SF7", "--payload-bytes", "255"], "benchmark"),
        ("compare", ["compare", COMPARE_WAVEFORMS, *hx], "equal"),
        ("gnss simulate", ["gnss", "simulate"], "equal"),
        ("gnss info", ["gnss", "info"], "equal"),
        ("gnss code", ["gnss", "code", "--system", "galileo", "--prn", "11"], "equal"),
        ("gnss fix", ["gnss", "fix", str(d / "fix.csv")], "equal"),
        ("tx cf32", ["tx", "-w", "LoRa-SF12", *hx, "-o", str(d / "sf12.cf32")], "equal"),
        ("rx cf32", ["rx", "-w", "LoRa-SF12", "-i", str(d / "sf12.cf32")], "clean_rx"),
        ("tx sigmf", ["tx", "-w", "LoRa-SF12", *hx, "-o", str(d / "sf12.sigmf-data")], "equal"),
        ("rx sigmf", ["rx", "-w", "LoRa-SF12", "-i", str(d / "sf12.sigmf-data")], "clean_rx"),
        ("analyze", ["analyze", "-i", str(d / "sf12.cf32"), "--ascii", "--json"], "analyze"),
        ("record", ["record", "-o", str(d / "rec.sigmf-data"), "--inject", "QPSK", *hx],
         "equal"),
        ("playback", ["playback", "-i", str(d / "rec.sigmf-data"), "-w", "QPSK"], "equal"),
        ("convert", ["convert", "-i", str(d / "sf12.cf32"), "-o", str(d / "sf12.ci16"),
                     "--from-format", "cf32", "--to-format", "ci16"], "equal"),
        ("chirp", ["chirp", "--sf", "12"], "equal"),
        ("chirp symbol", ["chirp", "--sf", "12", "--symbol", "1234", "-o",
                          str(d / "chirp.cf32")], "equal"),
        ("info", ["info", "-w", "LoRa-SF12"], "equal"),
        ("waveform list", ["waveform", "--list"], "equal"),
        ("waveform demo", ["waveform", "--demo", "LoRa-SF12"], "equal"),
        ("adsb generate", ["adsb", "generate", "-o", str(d / "adsb.cf32")], "equal"),
        ("adsb decode", ["adsb", "decode", "-i", str(d / "adsb.cf32")], "equal"),
        ("adsb hex", ["adsb", "generate"], "equal"),
        ("mesh simulate", ["mesh", "simulate", "--nodes", "16"], "equal"),
        ("mesh status", ["mesh", "status"], "equal"),
        ("blocks", ["blocks"], "equal"),
        ("blocks schema", ["blocks", "--schema", "polyphase_decimator"], "equal"),
        ("blocks search", ["blocks", "--search", "lora"], "equal"),
        ("ber-gate", ["ber-gate"], "ber_gate"),
        ("unknown waveform", ["info", "-w", "NOPE"], "equal"),
        ("plugin load", ["plugin", "load", str(d / "libexample_plugin.so")], "equal"),
        ("completions", ["completions"], "equal"),
        ("metrics", ["metrics"], "metrics"),
    ]
    return runs


def files_to_compare(workdir: str) -> dict[str, str]:
    """The paths of the IQ files the commands write, by file name."""
    return {name: str(Path(workdir) / name) for name in
            ("sf12.cf32", "sf12.sigmf-data", "rec.sigmf-data", "chirp.cf32", "adsb.cf32")}


def prepare_inputs(workdir: str) -> None:
    """The inputs the commands read that no command writes: the example
    plugin built with g++ and a CSV of six satellites for `gnss fix`."""
    d = Path(workdir)
    d.mkdir(parents=True, exist_ok=True)
    src = Path(__file__).resolve().parent / "native"
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-I", str(src), "-o",
                    str(d / "libexample_plugin.so"), str(src / "example_plugin.cpp")],
                   check=True, capture_output=True, timeout=120)
    rng = np.random.default_rng(22)
    truth = np.array([1113194.0, -4842853.0, 3985496.0])
    dirs = rng.normal(size=(6, 3))
    sats = truth + 2.66e7 * dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
    rows = np.c_[sats, np.linalg.norm(sats - truth, axis=1) + 1234.5]
    np.savetxt(d / "fix.csv", rows, delimiter=",")


def run_cli(argv: list[str], device) -> dict:
    """One command through `cli.main` with ``--device``: its exit (0, an
    int, or the message `sys.exit` carried), printed lines and seconds."""
    from r4w_tpu_torch import cli

    out = io.StringIO()
    t0 = time.perf_counter()
    code: object = 0
    with contextlib.redirect_stdout(out):
        try:
            cli.main(["--device", str(device), *argv])
        except SystemExit as e:
            code = e.code
    return {"code": code, "lines": out.getvalue().splitlines(),
            "seconds": time.perf_counter() - t0}


def run_cli_set(runs, device, workdir: str, on_run=None) -> dict:
    """Every run of `runs` in order (`on_run(label)` before each), the
    registered waveforms restored after (a plugin adds its own); the IQ
    files the commands wrote, read back, under "files"."""
    from r4w_tpu_torch.waveforms import base as wf_base

    saved = (dict(wf_base._REGISTRY), list(wf_base._CANONICAL))
    out = {}
    try:
        for label, argv, _ in runs:
            if on_run is not None:
                on_run(label)
            out[label] = run_cli(argv, device)
    finally:
        wf_base._REGISTRY.clear()
        wf_base._REGISTRY.update(saved[0])
        wf_base._CANONICAL[:] = saved[1]
    out["files"] = {name: np.fromfile(path, np.complex64)
                    for name, path in files_to_compare(workdir).items() if os.path.exists(path)}
    return out


def cli_reference(device="cpu") -> dict:
    """`cli_runs` on `device` in a temporary directory of its own, with the
    directory's path returned for normalising the printed paths."""
    import tempfile

    workdir = tempfile.mkdtemp(prefix="r4w_cli_")
    prepare_inputs(workdir)
    result = run_cli_set(cli_runs(workdir), device, workdir)
    result["workdir"] = workdir
    return result


def _normalised(lines: list[str], workdir: str) -> list[str]:
    return [line.replace(workdir, "DIR") for line in lines]


def _compare_one(mode: str, got: list[str], want: list[str]) -> str | None:
    """None if two runs' lines agree under `mode`, else why not."""
    if mode == "equal":
        return None if got == want else "lines differ"
    if mode == "benchmark":
        for lines in (got, want):
            if len(lines) != len(BENCHMARK_FORM) or not all(
                    re.match(f, line) for f, line in zip(BENCHMARK_FORM, lines)):
                return f"benchmark lines out of form: {lines}"
        return None if got[0] == want[0] else "benchmark waveform differs"
    if mode == "clean_rx":
        # a clean capture's SNR estimate measures rounding only: its form
        keep = [line for line in got if not line.startswith("snr estimate: ")]
        keep_w = [line for line in want if not line.startswith("snr estimate: ")]
        snr = [line for line in got + want if line.startswith("snr estimate: ")]
        if keep != keep_w or not all(re.match(r"snr estimate: -?\d+\.\d dB$", s) for s in snr):
            return "rx lines differ"
        return None
    if mode == "analyze":
        if got[:-1] != want[:-1]:
            return "analyze lines differ"
        g, w = json.loads(got[-1]), json.loads(want[-1])
        worst = float(np.max(np.abs(np.subtract(g["psd_db"], w["psd_db"]))))
        if g["freqs_hz"] != w["freqs_hz"] or not worst <= ANALYZE_TOL_DB:
            return f"analyze spectrum off by {worst} dB"
        return None
    if mode == "ber_gate":
        g, w = json.loads("\n".join(got)), json.loads("\n".join(want))
        keys = ("scheme", "ebn0_db", "n_bits")
        if [[r[k] for k in keys] for r in g["gates"]] != [[r[k] for k in keys]
                                                          for r in w["gates"]]:
            return "ber-gate points differ"
        theory = max(abs(a["theory"] - b["theory"]) / b["theory"]
                     for a, b in zip(g["gates"], w["gates"]))
        measured = [r["measured"] for r in g["gates"] + w["gates"]]
        if theory > 1e-6 or not all(0.0 < m < 0.5 for m in measured):
            return f"ber-gate theory off by {theory} or a BER out of (0, 0.5)"
        return None
    if mode == "metrics":
        up = re.compile(r"r4w_up 1(\.0)?$")
        return None if any(up.match(x) for x in got) and any(up.match(x) for x in want) \
            else "metrics lack the r4w_up gauge"
    raise ValueError(f"unknown compare mode {mode!r}")


def compare_cli(card: dict, cpu: dict, runs, card_dir: str, cpu_dir: str) -> dict:
    """Two `run_cli_set` results held together: {"equal", "diffs", "worst_file"}."""
    diffs = {}
    for label, _, mode in runs:
        g, w = card[label], cpu[label]
        g_lines, w_lines = _normalised(g["lines"], card_dir), _normalised(w["lines"], cpu_dir)
        code_g = g["code"].replace(card_dir, "DIR") if isinstance(g["code"], str) else g["code"]
        code_w = w["code"].replace(cpu_dir, "DIR") if isinstance(w["code"], str) else w["code"]
        why = "exit differs" if code_g != code_w else _compare_one(mode, g_lines, w_lines)
        if why:
            diffs[label] = {"why": why, "card": g_lines[:6], "cpu": w_lines[:6]}
    worst = 0.0
    for name, want in cpu["files"].items():
        got = card["files"].get(name)
        if got is None or got.shape != want.shape:
            diffs[f"file {name}"] = {"why": "missing or shape"}
            continue
        d = float(np.max(np.abs(got - want))) if want.size else 0.0
        worst = max(worst, d)
        if not d <= FILE_TOL:
            diffs[f"file {name}"] = {"why": f"max|Δ| {d}"}
    if set(card["files"]) != set(cpu["files"]):
        diffs["files"] = {"why": f"{sorted(card['files'])} against {sorted(cpu['files'])}"}
    return {"equal": not diffs, "diffs": diffs, "worst_file": worst}


def benchmark_numbers(lines: list[str]) -> dict:
    """Msamples/s and the latency line's numbers of a `benchmark` run."""
    msps = float(re.search(r"throughput:  (\S+) Msamples/s", lines[2]).group(1))
    lat = [float(v) for v in re.findall(r"(\d+\.\d\d)", lines[3])]
    return {"msamples_per_s": msps, "iterations": int(lines[1].split()[1]),
            "avg_ms": lat[0], "min_ms": lat[1], "max_ms": lat[2], "p99_ms": lat[3]}


def demo_rounds(device) -> dict:
    """The explorer's demo round of LoRa-SF12 with the 255-byte payload over
    the nine channel models on `device` (everything but the drawing)."""
    from r4w_tpu_torch import explorer

    out = {}
    for model in CHANNEL_MODELS:
        r = explorer.demo_round(DEMO_WAVEFORM, PAYLOAD_HEX, channel=model, device=device)
        if "error" in r:
            raise RuntimeError(f"demo round {model}: {r['error']}")
        out[model] = {"metrics": r["metrics"], "stages": r["stages"],
                      "spectrum_db": np.asarray(r["spectrum"][1], np.float32),
                      "waterfall_db": np.asarray(r["waterfall"], np.float32)}
    return out


def explorer_reference(device="cpu") -> dict:
    """The explorer's device work on `device`: the pipeline wizard's report
    of the block-graph gate's graph as /api/pipeline runs it (seed 0, the pipeline's
    default rate) and `demo_rounds`."""
    from r4w_tpu_torch.pipeline import run_pipeline

    return {"pipeline": run_pipeline(remote_gates.graph_nodes(), seed=0, device=device),
            "demo": demo_rounds(device)}


def compare_demo(card: dict, cpu: dict) -> dict:
    """Two `demo_rounds` together: decisions and counts equal, float
    estimates within `DEMO_METRIC_REL_TOL`, the spectra within `DEMO_DB_TOL`
    dB, and the waterfalls as amplitudes, max|Δ| over the largest, within
    `DEMO_WATERFALL_REL_TOL`. A waterfall's dB is no measure of agreement:
    its bins 80-110 dB below the top are a sidelobe's rounding, and a 1e-6
    relative change of the IQ moves them by up to 0.65 dB. Returns
    {"equal", "diffs", "worst_db", "worst_rel", "worst_waterfall_rel",
    "worst_waterfall_db"}."""
    diffs, worst_db, worst_rel, worst_fall, worst_fall_db = [], 0.0, 0.0, 0.0, 0.0
    for model, w in cpu.items():
        g = card[model]
        gm, wm = g["metrics"], w["metrics"]
        if sorted(gm) != sorted(wm) or g["stages"] != w["stages"]:
            diffs.append((model, "keys or stages"))
            continue
        for k, wv in wm.items():
            gv = gm[k]
            if k in DEMO_KEYS_EXACT or not isinstance(wv, float):
                if gv != wv:
                    diffs.append((model, k, gv, wv))
            else:
                rel = abs(gv - wv) / max(abs(wv), 1.0)
                worst_rel = max(worst_rel, rel)
                if rel > DEMO_METRIC_REL_TOL:
                    diffs.append((model, k, gv, wv))
        for k in ("spectrum_db", "waterfall_db"):
            a, b = g[k], w[k]
            if a.shape != b.shape:
                diffs.append((model, k, a.shape, b.shape))
                continue
            d = float(np.max(np.abs(a - b)))
            if k == "spectrum_db":
                worst_db = max(worst_db, d)
                if not d <= DEMO_DB_TOL:
                    diffs.append((model, k, d))
                continue
            worst_fall_db = max(worst_fall_db, d)
            amp_a, amp_b = 10.0 ** (a / 20.0), 10.0 ** (b / 20.0)
            rel = float(np.max(np.abs(amp_a - amp_b)) / np.max(amp_b))
            worst_fall = max(worst_fall, rel)
            if not rel <= DEMO_WATERFALL_REL_TOL:
                diffs.append((model, k, rel))
    return {"equal": not diffs, "diffs": diffs, "worst_db": worst_db, "worst_rel": worst_rel,
            "worst_waterfall_rel": worst_fall, "worst_waterfall_db": worst_fall_db}
