"""Every registry block through the block-graph pipeline, on one device.

`registry_survey(device)` runs each of the 523 blocks of
`registry.default_registry()` through `pipeline.run_pipeline` with its
schema's default parameters (the node carries no parameters, so every
parameter takes its default):

- a block whose schema names a stream input (a row of role "input" other
  than the PRNG key) is the second node of a two-node graph whose first node
  is the block graph's ``waveform_tx`` burst (`remote_gates.graph_nodes`:
  LoRa-SF7, a 255-byte payload, 48,288 complex64 samples at 125 kS/s);
- a source block (no stream input) is a single node.

The pipeline's demodulator pseudo-block ``waveform_rx`` runs too, behind
the same burst with the burst's own parameters (524 nodes in all): on the
card it launches the dechirp kernel.

Every graph runs with the same seed, so a keyed block draws the same
threefry bits on every device. The survey reads each block's node entry
(shape, dtype, power, auxiliary scalars, or its error) and its seconds.

`compare_surveys(card, cpu)` holds one survey against another: the blocks
that err must be the same on both, with the same error (its message, with
object addresses and device names taken out: a block that fails on the CPU
for want of a parameter must not fail earlier on the card for another
cause), and every block that runs on both must give the same shape and
dtype and a power within `POWER_TOL_DB` (0.01 dB, the rounding the
reference's pipeline summary gives). `EXEMPT` names the blocks whose power
may miss that bar on the card, each with its cause.
"""

from __future__ import annotations

import re
import time

from r4w_tpu_torch.core.types import DEFAULT_DEVICE, resolve_device
from r4w_tpu_torch.pipeline import run_pipeline
from r4w_tpu_torch.registry import default_registry
from r4w_tpu_torch.remote_gates import RATE_HZ, graph_nodes

SEED = 0
POWER_TOL_DB = 0.01
# Blocks whose power may differ card against CPU by more than POWER_TOL_DB,
# each with its cause (none so far).
EXEMPT: dict[str, str] = {}
PSEUDO_BLOCKS = ("waveform_rx",)


def stream_inputs(schema: list[dict]) -> list[str]:
    """The stream inputs a block's schema names: rows of role "input" other
    than the PRNG key."""
    return [r["name"] for r in schema if r["role"] == "input" and r["name"] != "key"]


def survey_nodes(name: str, schema: list[dict]) -> list[dict]:
    """The graph that runs block `name`: behind the LoRa-SF7 burst if its
    schema names a stream input (a pseudo-block with the burst's own
    parameters), alone otherwise. The block's node is ``blk``."""
    tx = graph_nodes()[0]
    if name in PSEUDO_BLOCKS:
        return [tx, {"id": "blk", "block": name, "params": dict(tx["params"]), "inputs": ["tx"]}]
    if not stream_inputs(schema):
        return [{"id": "blk", "block": name}]
    return [tx, {"id": "blk", "block": name, "inputs": ["tx"]}]


def registry_survey(device=DEFAULT_DEVICE, names=None) -> dict:
    """Run every registry block and `PSEUDO_BLOCKS` (or those in `names`)
    through `run_pipeline` on `device` (module docstring). Returns
    {"device", "blocks": {name: node entry + "seconds" + "stream"}, "ok":
    [...], "errors": {name: error}, "seconds"}."""
    dev = resolve_device(device)
    reg = default_registry()
    if names is None:
        names = [info.name for info in reg.list()] + list(PSEUDO_BLOCKS)
    blocks: dict[str, dict] = {}
    t_all = time.perf_counter()
    for name in names:
        schema = [] if name in PSEUDO_BLOCKS else reg.param_schema(name)
        nodes = survey_nodes(name, schema)
        t0 = time.perf_counter()
        report = run_pipeline(nodes, seed=SEED, previews=False, sample_rate=RATE_HZ, device=dev)
        entry = dict(report["nodes"]["blk"])
        if len(nodes) == 2 and "error" in report["nodes"]["tx"]:
            raise RuntimeError(f"the survey's source burst failed on {dev}: "
                               f"{report['nodes']['tx']['error']}")
        entry["seconds"] = time.perf_counter() - t0
        entry["stream"] = len(nodes) == 2
        blocks[name] = entry
    errors = {k: v["error"] for k, v in blocks.items() if "error" in v}
    return {"device": str(dev), "blocks": blocks, "errors": errors,
            "ok": sorted(k for k in blocks if k not in errors),
            "seconds": time.perf_counter() - t_all}


def error_cause(error: str) -> str:
    """An error message without object addresses and device names."""
    return re.sub(r"\b(cuda(:\d+)?|cpu)\b", "DEV", re.sub(r"0x[0-9a-fA-F]+", "0x", error))


def compare_surveys(card: dict, cpu: dict, power_tol: float = POWER_TOL_DB) -> dict:
    """`card` against `cpu` (module docstring). Returns {"equal": bool,
    "card_only": {name: error}, "cpu_only": {name: error},
    "differing_errors": {name: (card error, CPU error)}, "mismatch": {name:
    (what, card, cpu)}, "exempt": {...}, "worst_power_db", "worst_at"}."""
    card_err, cpu_err = set(card["errors"]), set(cpu["errors"])
    differing = {k: (card["errors"][k], cpu["errors"][k]) for k in sorted(card_err & cpu_err)
                 if error_cause(card["errors"][k]) != error_cause(cpu["errors"][k])}
    mismatch, exempt = {}, {}
    worst, worst_at = 0.0, None
    for name in sorted(set(card["ok"]) & set(cpu["ok"])):
        g, w = card["blocks"][name], cpu["blocks"][name]
        diff = None
        if (g["shape"], g["dtype"]) != (w["shape"], w["dtype"]):
            diff = ("shape/dtype", (g["shape"], g["dtype"]), (w["shape"], w["dtype"]))
        elif ("power_db" in g) != ("power_db" in w):
            diff = ("power_db", g.get("power_db"), w.get("power_db"))
        elif "power_db" in w:
            d = abs(g["power_db"] - w["power_db"])
            if name not in EXEMPT and d > worst:
                worst, worst_at = d, name
            if not d <= power_tol:
                diff = ("power_db", g["power_db"], w["power_db"])
        if diff is not None:
            (exempt if name in EXEMPT else mismatch)[name] = diff
    card_only = {k: card["errors"][k] for k in sorted(card_err - cpu_err)}
    cpu_only = {k: cpu["errors"][k] for k in sorted(cpu_err - card_err)}
    return {"equal": not (card_only or cpu_only or differing or mismatch),
            "card_only": card_only, "cpu_only": cpu_only, "differing_errors": differing,
            "mismatch": mismatch, "exempt": exempt, "worst_power_db": worst,
            "worst_at": worst_at}
