"""What the benchmark loads: never JAX nor the JAX package ``r4w_tpu``,
with top-level module names compared whole (``r4w_tpu_torch`` is the
program and is not ``r4w_tpu``), and the reference nothing of the program.
Without a card, or without the program, the command prints no result."""

import json
import os
import shutil
import subprocess
import sys

from portbench import harness

ROOT = str(harness.CHECKOUT)
ENV = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}

DRIVE_TINY = f"""
import dataclasses, json, sys, time
sys.path.insert(0, {ROOT!r})
from portbench import harness
tiny = {{
    "lorawan_eu868_dr5.mc_sweep": dict(lanes_at_sf7=4, warm=1, profiled=1, stepped=1),
    "meshtastic_longfast.rx_frames": dict(frames_per_block=2, pool_blocks=2, warm=1, profiled=2,
                                          stepped=1),
}}
for name, tr in tiny.items():
    cell = harness.find_cell(name)
    cell = dataclasses.replace(cell, traffic={{**cell.traffic, **tr}})
    for trace in (False, True):
        harness.run_cell(cell, 3, 0.2, trace, "cpu", time.perf_counter())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_modules(code: str, cwd=ROOT) -> list[str]:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=cwd, env=ENV, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_the_program_and_never_jax_or_the_jax_package():
    tops = _top_modules(DRIVE_TINY)
    assert "r4w_tpu_torch" in tops and "torch" in tops
    assert not set(tops) & set(harness.FORBIDDEN_MODULES), tops


def test_the_reference_loads_nothing_of_the_program():
    code = (f"import json, sys; sys.path.insert(0, {ROOT!r})\n"
            "import portbench.reference.lora, portbench.roofline, portbench.trace\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    tops = _top_modules(code)
    assert not set(tops) & {"r4w_tpu_torch", *harness.FORBIDDEN_MODULES}, tops


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "r4w_tpu_torch_fake_child", sys)
    for name in harness.FORBIDDEN_MODULES:
        monkeypatch.delitem(sys.modules, name, raising=False)
        for key in [k for k in sys.modules if k.startswith(name + ".")]:
            monkeypatch.delitem(sys.modules, key)
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "r4w_tpu.entry", sys)
    assert harness.loaded_forbidden() == ["jax", "r4w_tpu"]


def test_the_command_prints_no_result_without_a_card_or_the_program(tmp_path):
    cmd = [sys.executable, "portbench/run.py", "--workload", "lorawan_eu868_dr5.mc_sweep",
           "--seed", "5", "--seconds", "1", "--trace", "0"]
    import torch

    if not torch.cuda.is_available():
        out = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, env=ENV,
                             timeout=600)
        assert out.returncode != 0 and out.stdout == ""
    # a directory with BENCHMARK.json and the benchmark's files alone has no program
    shutil.copy(harness.CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=tmp_path, env=ENV,
                         timeout=600)
    assert out.returncode != 0 and out.stdout == ""
    code = ("import sys, time; sys.path.insert(0, '.')\n"
            "from portbench import harness\n"
            "harness.run_cell(harness.find_cell('meshtastic_longfast.rx_frames'), 1, 0.1,"
            " False, 'cpu', time.perf_counter())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, env=ENV, timeout=600)
    assert out.returncode != 0 and "r4w_tpu_torch" in out.stderr and out.stdout == ""
