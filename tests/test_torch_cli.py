"""The port's command line (``r4w_tpu_torch.cli``) against ``r4w_tpu.cli``.

Each case runs the same argv in-process through both ``main``s, the port's
with ``--device cpu``, and holds the printed lines equal, line for line,
with the same exit. The lines allowed to differ, and why:

- wall times (`benchmark`'s iterations, throughput and latency, `gnss
  scenario`'s rate, `remote ping`'s round trip): compared by their form;
- `ber-gate`'s measured BERs and the numbers that follow from them: the
  port's Monte-Carlo bits come from Philox, not from JAX's keys, so the
  gate's schemes, points, bit counts, theory and verdict are compared;
- `analyze --json`'s spectrum: float32 Welch sums in another order, held
  within `PSD_TOL_DB`;
- `completions`' last line names the port's module;
- the metadata a waveform that carries no data prints after `simulate`
  (CW's measured frequency): full float reprs of float32 estimates, held
  within `METADATA_REL_TOL`.

The parser's description names the port; it shows only in ``--help``.
"""

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from r4w_tpu import cli as ref_cli
from r4w_tpu_torch import cli
from r4w_tpu_torch.core import types

REPO = Path(__file__).resolve().parents[1]
PAYLOAD_255 = bytes(range(255)).hex()
PSD_TOL_DB = 1e-3        # analyze --json: float32 Welch sums in another order
SAMPLES_TOL = 1e-6       # record: the simulator's float32 noise and mix, max |Δ|
METADATA_REL_TOL = 1e-6  # simulate: float32 estimates printed in full
THEORY_TOL = 1e-6        # ber-gate: JAX's float32 erfc is ~1e-6 off (test_torch_linear_ber)


def _call(main, argv) -> object:
    try:
        main(argv)
    except SystemExit as e:
        return e.code
    return 0


def run_both(capsys, argv):
    """(port (exit, stdout), reference (exit, stdout)) for one argv."""
    got = _call(cli.main, ["--device", "cpu", *argv])
    got_out = capsys.readouterr().out
    want = _call(ref_cli.main, list(argv))
    want_out = capsys.readouterr().out
    return (got, got_out), (want, want_out)


def assert_same(capsys, argv):
    got, want = run_both(capsys, argv)
    assert got[0] == want[0]
    assert got[1].splitlines() == want[1].splitlines()
    return got[1]


SAME_CASES = {
    "info": ["info", "-w", "QPSK"],
    "info_lora": ["info", "-w", "LoRa-SF12"],
    "waveform_list": ["waveform", "--list"],
    "waveform_demo": ["waveform", "--demo", "QPSK"],
    "chirp": ["chirp", "--sf", "12"],
    "chirp_symbol": ["chirp", "--sf", "9", "--symbol", "77"],
    "simulate_bpsk": ["simulate", "-w", "BPSK", "-m", "port", "--snr", "3", "--seed", "0"],
    "simulate_lora_sf7": ["simulate", "-w", "LoRa-SF7", "--hex", PAYLOAD_255, "--snr", "-6",
                          "--seed", "0", "--channel", "awgn_cfo", "--cfo", "150"],
    "simulate_qpsk_tdl": ["simulate", "-w", "QPSK", "--channel", "tdl_awgn", "--snr", "12"],
    "compare": ["compare", "BPSK,QPSK,8-PSK", "-m", "compare me", "--snr", "6"],
    "gnss_info": ["gnss", "info"],
    "gnss_code_gps": ["gnss", "code", "--prn", "7"],
    "gnss_code_galileo": ["gnss", "code", "--system", "galileo", "--prn", "3"],
    "gnss_code_glonass": ["gnss", "code", "--system", "glonass"],
    "gnss_simulate": ["gnss", "simulate"],
    "gnss_simulate_prn": ["gnss", "simulate", "--prn", "9", "--doppler", "-2500",
                          "--code-phase", "500", "--snr", "-18"],
    "adsb_generate": ["adsb", "generate"],
    "adsb_decode_hex": ["adsb", "decode", "--hex-frame", "8D4840D6202CC371C32CE0576098"],
    "blocks": ["blocks"],
    "blocks_search": ["blocks", "--search", "fir"],
    "blocks_json": ["blocks", "--category", "fec", "--json"],
    "blocks_schema": ["blocks", "--schema", "fir_filter"],
    "blocks_schema_unknown": ["blocks", "--schema", "no_such_block"],
    "spec": ["spec", str(REPO / "specs" / "qpsk.yaml"), "--check", "--roundtrip"],
    "config_example": ["config", "--example"],
    "config": ["config"],
    "mesh_simulate": ["mesh", "simulate"],
    "mesh_simulate_16": ["mesh", "simulate", "--nodes", "16", "--loss", "0.1", "--seed", "3"],
    "mesh_status": ["mesh", "status", "--node-id", "4"],
    "metrics": ["metrics"],
    "unknown_waveform": ["info", "-w", "NOPE"],
}


@pytest.mark.parametrize("case", sorted(SAME_CASES))
def test_stdout_equals_reference(capsys, case):
    assert_same(capsys, SAME_CASES[case])


def test_simulate_waveform_that_carries_no_data(capsys):
    (got, got_out), (want, want_out) = run_both(capsys, ["simulate", "-w", "CW", "--snr", "10"])
    assert got == want == 0
    g, w = got_out.splitlines(), want_out.splitlines()
    assert g[:3] == w[:3] and w[0] == "waveform:  CW (carries no data)" and len(g) == len(w) > 3
    for a, b in zip(g[3:], w[3:]):
        key, _, value = b.partition(": ")
        assert a.startswith(key + ": ")
        try:
            assert abs(float(a[len(key) + 2:]) - float(value)) <= METADATA_REL_TOL * abs(float(value))
        except ValueError:
            assert a == b


def test_unknown_waveform_exits_with_the_reference_message(capsys):
    (got, _), (want, _) = run_both(capsys, ["simulate", "-w", "NOPE"])
    assert isinstance(got, str) and got == want
    assert got.startswith("error: unknown waveform 'NOPE'. Available: CW, OOK, ")


def test_gnss_fix_from_csv(capsys, tmp_path):
    rng = np.random.default_rng(1)
    truth = np.array([1113194.0, -4842853.0, 3985496.0])
    dirs = rng.normal(size=(6, 3))
    sats = truth + 2.66e7 * dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
    rows = np.c_[sats, np.linalg.norm(sats - truth, axis=1) + 1234.5]
    path = tmp_path / "fix.csv"
    np.savetxt(path, rows, delimiter=",")
    out = assert_same(capsys, ["gnss", "fix", str(path)])
    assert "clock bias:    1234.5 m" in out


def _noisy_burst(tmp_path, name: str, message: str, snr_db: float, seed: int) -> str:
    """A waveform's burst with numpy noise, written as cf32 (both CLIs read it)."""
    from r4w_tpu_torch.waveforms import create_waveform

    tx = create_waveform(name, 125_000.0, "cpu").modulate(message.encode()).numpy()
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(np.mean(np.abs(tx) ** 2) / 10 ** (snr_db / 10) / 2)
    rx = (tx + sigma * (rng.standard_normal(tx.size) + 1j * rng.standard_normal(tx.size)))
    path = str(tmp_path / f"{name}.cf32")
    rx.astype(np.complex64).tofile(path)
    return path


def test_tx_files_equal_and_rx_of_a_noisy_file(capsys, tmp_path):
    for name in ("LoRa-SF12", "QPSK"):
        a, b = str(tmp_path / "port.cf32"), str(tmp_path / "ref.cf32")
        got = _call(cli.main, ["--device", "cpu", "tx", "-w", name, "-m", "file", "-o", a])
        got_out = capsys.readouterr().out
        want = _call(ref_cli.main, ["tx", "-w", name, "-m", "file", "-o", b])
        want_out = capsys.readouterr().out
        assert got == want == 0
        assert got_out.replace(a, b) == want_out
        np.testing.assert_allclose(np.fromfile(a, np.complex64), np.fromfile(b, np.complex64),
                                   atol=2e-6)
        path = _noisy_burst(tmp_path, name, "noisy file", 12.0, 4)
        out = assert_same(capsys, ["rx", "-w", name, "-i", path])
        assert "noisy file" in out


def test_sigmf_tx_rx_analyze_convert(capsys, tmp_path):
    a, b = str(tmp_path / "port.sigmf-data"), str(tmp_path / "ref.sigmf-data")
    assert _call(cli.main, ["--device", "cpu", "tx", "-w", "LoRa-SF12", "-m", "sigmf",
                            "-o", a]) == 0
    assert _call(ref_cli.main, ["tx", "-w", "LoRa-SF12", "-m", "sigmf", "-o", b]) == 0
    capsys.readouterr()
    assert Path(a).read_bytes() == Path(b).read_bytes()
    assert Path(a[:-4] + "meta").read_text() == Path(b[:-4] + "meta").read_text()
    assert "sigmf" in assert_same(capsys, ["rx", "-w", "LoRa-SF12", "-i", b])
    (got, got_out), (want, want_out) = run_both(capsys, ["analyze", "-i", b, "-s", "125000",
                                                         "--ascii", "--json"])
    assert got == want == 0
    got_lines, want_lines = got_out.splitlines(), want_out.splitlines()
    assert got_lines[:-1] == want_lines[:-1]
    g, w = json.loads(got_lines[-1]), json.loads(want_lines[-1])
    assert g["freqs_hz"] == w["freqs_hz"]
    np.testing.assert_allclose(g["psd_db"], w["psd_db"], atol=PSD_TOL_DB)
    ci16 = [str(tmp_path / f"{k}.ci16") for k in ("port", "ref")]
    (got, got_out), (want, want_out) = (
        (_call(cli.main, ["--device", "cpu", "convert", "-i", b, "-o", ci16[0], "--from-format",
                          "cf32", "--to-format", "ci16"]), capsys.readouterr().out),
        (_call(ref_cli.main, ["convert", "-i", b, "-o", ci16[1], "--from-format", "cf32",
                              "--to-format", "ci16"]), capsys.readouterr().out))
    assert got == want == 0 and got_out.replace(ci16[0], ci16[1]) == want_out
    assert Path(ci16[0]).read_bytes() == Path(ci16[1]).read_bytes()


def test_record_and_playback(capsys, tmp_path):
    a, b = str(tmp_path / "port.sigmf-data"), str(tmp_path / "ref.sigmf-data")
    argv = ["record", "--inject", "QPSK", "-m", "recorded", "--duration", "0.2"]
    assert _call(cli.main, ["--device", "cpu", *argv, "-o", a]) == 0
    got_out = capsys.readouterr().out
    assert _call(ref_cli.main, [*argv, "-o", b]) == 0
    assert got_out.replace(a, b) == capsys.readouterr().out
    x, y = np.fromfile(a, np.complex64), np.fromfile(b, np.complex64)
    assert x.shape == y.shape
    assert float(np.max(np.abs(x - y))) <= SAMPLES_TOL
    out = assert_same(capsys, ["playback", "-i", b, "-w", "QPSK"])
    assert bytes.fromhex(out.split(": ")[-1].strip()).startswith(b"recorded")


def test_adsb_through_a_file(capsys, tmp_path):
    a, b = str(tmp_path / "port.cf32"), str(tmp_path / "ref.cf32")
    assert _call(cli.main, ["--device", "cpu", "adsb", "generate", "-o", a]) == 0
    got_out = capsys.readouterr().out
    assert _call(ref_cli.main, ["adsb", "generate", "-o", b]) == 0
    assert got_out.replace(a, b) == capsys.readouterr().out
    np.testing.assert_allclose(np.fromfile(a, np.complex64), np.fromfile(b, np.complex64),
                               atol=1e-6)
    assert "R4WTPU" in assert_same(capsys, ["adsb", "decode", "-i", b])


def test_ber_gate_structure(capsys):
    argv = ["ber-gate", "--scheme", "qpsk", "--points", "5.0,6.0", "--bits", "100000"]
    (got, got_out), (want, want_out) = run_both(capsys, argv)
    assert got == want == 0
    g, w = json.loads(got_out), json.loads(want_out)
    assert g["pass"] is w["pass"] is True
    for a, b in zip(g["gates"], w["gates"], strict=True):
        assert (a["scheme"], a["ebn0_db"], a["n_bits"]) == (b["scheme"], b["ebn0_db"], b["n_bits"])
        assert abs(a["theory"] - b["theory"]) <= THEORY_TOL * b["theory"]
        assert a["ci_low"] <= a["measured"] <= a["ci_high"]


def test_benchmark_lines_by_form(capsys):
    argv = ["benchmark", "-w", "LoRa-SF7", "--payload-bytes", "255", "--duration", "0.3"]
    (got, got_out), (want, want_out) = run_both(capsys, argv)
    assert got == want == 0
    assert got_out.splitlines()[0] == want_out.splitlines()[0] == "waveform:    LoRa"
    form = [r"waveform:    LoRa$", r"iterations:  \d+ in \d+\.\d\ds$",
            r"throughput:  \d+\.\d\d Msamples/s$",
            r"latency:     avg \d+\.\d\d ms  min \d+\.\d\d  max \d+\.\d\d  p99 \d+\.\d\d$"]
    for out in (got_out, want_out):
        lines = out.splitlines()
        assert len(lines) == len(form)
        assert all(re.match(f, line) for f, line in zip(form, lines)), lines


def test_gnss_scenario_from_yaml(capsys, tmp_path):
    cfg = tmp_path / "two_sv.yaml"
    cfg.write_text("satellites:\n"
                   "  - prn: 3\n    signal: gpsl1ca\n    cn0_dbhz: 45.0\n"
                   "    elevation_deg: 50.0\n    azimuth_deg: 120.0\n    doppler_hz: 900.0\n"
                   "  - prn: 11\n    signal: gpsl1ca\n    cn0_dbhz: 40.0\n"
                   "    elevation_deg: 30.0\n    azimuth_deg: 250.0\n    doppler_hz: -1500.0\n"
                   "output:\n  sample_rate: 2046000.0\n  duration_s: 0.01\n")
    outs = []
    for main, name, extra in ((cli.main, "port", ["--device", "cpu"]), (ref_cli.main, "ref", [])):
        out = str(tmp_path / f"{name}.sigmf-data")
        assert _call(main, [*extra, "gnss", "scenario", "--config", str(cfg), "-o", out]) == 0
        line = capsys.readouterr().out.strip()
        outs.append(line.replace(out, "OUT"))
        assert np.fromfile(out, np.complex64).shape == (20460,)
    form = r"2 SVs x 0\.01s @ 2\.046 MS/s -> OUT in \d+\.\ds \(\d+\.\d Msamples/s\)$"
    assert all(re.match(form, line) for line in outs), outs


def test_plugin_load_native(capsys, tmp_path):
    src = REPO / "r4w_tpu_torch" / "native"
    so = tmp_path / "libexample.so"
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-I", str(src), "-o", str(so),
                    str(src / "example_plugin.cpp")], check=True, capture_output=True,
                   timeout=120)
    from r4w_tpu_torch.waveforms import base as wf_base

    saved = (dict(wf_base._REGISTRY), list(wf_base._CANONICAL))
    try:
        out = assert_same(capsys, ["plugin", "load", str(so)])
    finally:
        wf_base._REGISTRY.clear()
        wf_base._REGISTRY.update(saved[0])
        wf_base._CANONICAL[:] = saved[1]
    assert "example-native" in out and "manchester-ook" in out


def test_completions_name_the_port(capsys):
    (got, got_out), (want, want_out) = run_both(capsys, ["completions"])
    assert got == want == 0
    g, w = got_out.splitlines(), want_out.splitlines()
    assert g[:-1] == w[:-1]
    assert g[-1] == w[-1].replace("r4w_tpu.cli", "r4w_tpu_torch.cli")


def _parser_tree(parser, path=()) -> dict:
    """{subcommand path: {dest: (options, default, type, required, choices, nargs)}}."""
    tree = {path: {}}
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                tree.update(_parser_tree(sub, path + (name,)))
            continue
        if action.dest == "help":
            continue
        tree.setdefault(path, {})[action.dest] = (
            tuple(action.option_strings), action.default,
            getattr(action.type, "__name__", action.type), action.required,
            tuple(action.choices) if action.choices else None, action.nargs)
    return tree


def test_subcommands_equal_reference_but_jit():
    got, want = _parser_tree(cli.build_parser()), _parser_tree(ref_cli.build_parser())
    assert got.pop(()) == {"device": (("--device",), "cuda", None, False, None, None)}
    assert want.pop(()) == {}
    assert sorted(got) == sorted(want)
    assert want[("blocks",)].pop("jit")[0] == ("--jit",)
    for path in want:
        assert {k: v for k, v in got[path].items() if k != "fn"} \
            == {k: v for k, v in want[path].items() if k != "fn"}, path
    assert len(want) >= 30


def test_device_default_is_the_port_default(monkeypatch):
    assert cli.build_parser().parse_args(["info"]).device == str(types.DEFAULT_DEVICE) == "cuda"
    monkeypatch.setattr(types, "DEFAULT_DEVICE", torch.device("meta"))
    assert cli.build_parser().parse_args(["info"]).device == "meta"


def test_device_is_where_tensors_are_made(monkeypatch, capsys):
    """`simulate` modulates and decodes on the named device: a spy on the
    factory sees the device the option gave."""
    from r4w_tpu_torch.waveforms import base as wf_base

    seen = []
    real = wf_base.create_waveform

    def spy(name, sample_rate=125_000.0, device=types.DEFAULT_DEVICE):
        seen.append(torch.device(device))
        return real(name, sample_rate, device)

    monkeypatch.setattr("r4w_tpu_torch.waveforms.create_waveform", spy)
    assert _call(cli.main, ["--device", "cpu", "simulate", "-w", "QPSK"]) == 0
    assert "match:     YES" in capsys.readouterr().out
    assert seen == [torch.device("cpu")]


def test_python_m_simulate_subprocess():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "r4w_tpu_torch", "--device", "cpu",
                           "simulate", "-w", "LoRa-SF7", "-m", "python -m", "--snr", "-3"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "match:     YES" in proc.stdout
    assert f"payload:   {b'python -m'.hex()} (9 bytes)" in proc.stdout


def test_ber_gate_result_fields_are_the_reference_fields():
    from r4w_tpu.ber import BerGateResult as Ref

    from r4w_tpu_torch.ber import BerGateResult

    assert [f.name for f in dataclasses.fields(BerGateResult)] \
        == [f.name for f in dataclasses.fields(Ref)]


def _command_key(path) -> str:
    """A subcommand's name as `frontend_gates` lists it: the group and its
    command for gnss/adsb/mesh (``gnss ephemeris`` for both of its own),
    else the first word."""
    if tuple(path[:2]) == ("gnss", "ephemeris"):
        return "gnss ephemeris"
    return " ".join(path[:2]) if path[0] in ("gnss", "adsb", "mesh") else path[0]


def test_frontend_runs_cover_every_subcommand():
    """The card's CLI phase (`frontend_gates.cli_runs`) runs every subcommand
    but those `CLI_NOT_RUN` names, and LoRa-SF12 over the nine models."""
    from r4w_tpu_torch import frontend_gates

    runs = frontend_gates.cli_runs("/nonexistent")
    ran = {_command_key(argv) for _, argv, _ in runs}
    tree = _parser_tree(cli.build_parser())
    leaves = [p for p in tree if p and not any(q[:len(p)] == p and q != p for q in tree)]
    every = {_command_key(path) for path in leaves}
    assert every - ran == set(frontend_gates.CLI_NOT_RUN)
    assert ran <= every
    models = [a[a.index("--channel") + 1] for _, a, _ in runs if "--channel" in a]
    assert models == list(frontend_gates.CHANNEL_MODELS) and len(models) == 9


def test_frontend_compare_cli(tmp_path):
    """Two CPU runs of a few of the card's commands agree; a changed line,
    exit or file is caught."""
    from r4w_tpu_torch import frontend_gates

    frontend_gates.prepare_inputs(str(tmp_path))
    keep = {"simulate LoRa-SF7", "gnss fix", "tx cf32", "rx cf32", "analyze", "metrics",
            "unknown waveform", "chirp symbol"}
    runs = [r for r in frontend_gates.cli_runs(str(tmp_path)) if r[0] in keep]
    assert len(runs) == len(keep)
    a = frontend_gates.run_cli_set(runs, "cpu", str(tmp_path))
    other = tmp_path / "other"
    frontend_gates.prepare_inputs(str(other))
    runs_b = frontend_gates.cli_runs(str(other))
    b = frontend_gates.run_cli_set([r for r in runs_b if r[0] in keep], "cpu", str(other))
    verdict = frontend_gates.compare_cli(a, b, runs, str(tmp_path), str(other))
    assert verdict["equal"], verdict["diffs"]
    assert a["simulate LoRa-SF7"]["lines"][-1] == "match:     YES"
    a["simulate LoRa-SF7"]["lines"][-2] = "BER:       0.5000"
    a["unknown waveform"]["code"] = 1
    a["files"]["sf12.cf32"] = a["files"]["sf12.cf32"] * 1.001
    diffs = frontend_gates.compare_cli(a, b, runs, str(tmp_path), str(other))["diffs"]
    assert set(diffs) == {"simulate LoRa-SF7", "unknown waveform", "file sf12.cf32"}
