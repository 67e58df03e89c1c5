"""Each cell through the command for 2 s on the card: the result line is
there, correct, on the card, with the cell's metrics. Skips without a card;
run on the chip with ``python -m pytest portbench/tests -m cuda``."""

import json
import subprocess
import sys

import pytest

from portbench import harness

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_each_cell_runs_correct_on_the_card(name, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.find_cell(name)
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", name, "--seed",
                          "2147483711", "--seconds", "2", "--trace", str(trace)],
                         capture_output=True, text=True, cwd=harness.CHECKOUT, timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == cell.chips
    assert set(res["metrics"]) == set(cell.per_layer if trace else cell.end_to_end)
    assert all(m["value"] > 0 for m in res["metrics"].values())
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert res["breakdown"]["device_ops"] and res["breakdown"]["idle_gaps"]
    assert list(res)[-1] == "checks"
