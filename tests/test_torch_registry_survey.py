"""The registry survey's machinery (`r4w_tpu_torch.registry_survey`) on one
block a category, on the CPU.

Each block's graph is the one the survey builds (behind the block graph's
LoRa-SF7 burst when the schema names a stream input, alone otherwise),
run through the port's `run_pipeline` with the schema's defaults; its node
is held against the JAX package's `run_pipeline` on the same graph (shape
and dtype equal, power within the reference's 0.01 dB rounding, the same
blocks erring), and `compare_surveys` is held to its rules on surveys made
to differ.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from r4w_tpu_torch import registry_survey as rs
from r4w_tpu_torch.ops import exotic_modems
from r4w_tpu_torch.registry import BlockCategory, default_registry

# one block a category: the first of its category that runs on the
# schema's defaults (resampler: none does; its first block errs everywhere)
BY_CATEGORY = {
    "source": "preamble_gen", "sink": "null_sink", "filter": "de_emphasis",
    "modulator": "burst_shaper", "demodulator": "am_demod", "sync": "cfo_estimator",
    "fec": "psychoacoustic_codec", "measurement": "burst_detector",
    "channel": "rayleigh_channel", "resampler": "arbitrary_resampler",
    "gnss": "ionospheric_scintillation_analyzer", "radar": "cfar",
    "math": "magnitude_squared",
}


@pytest.fixture(scope="module")
def survey():
    return rs.registry_survey("cpu", names=list(BY_CATEGORY.values()))


def test_one_block_a_category():
    reg = default_registry()
    assert {reg.get(n).category.value for n in BY_CATEGORY.values()} == \
        {c.value for c in BlockCategory}
    for cat, name in BY_CATEGORY.items():
        assert reg.get(name).category.value == cat


def test_survey_graphs_by_schema():
    reg = default_registry()
    src = rs.survey_nodes("preamble_gen", reg.param_schema("preamble_gen"))
    assert src == [{"id": "blk", "block": "preamble_gen"}]
    stream = rs.survey_nodes("cfar", reg.param_schema("cfar"))
    assert stream[0]["block"] == "waveform_tx" and stream[0]["params"]["name"] == "LoRa-SF7"
    assert len(bytes.fromhex(stream[0]["params"]["hex"])) == 255
    assert stream[1] == {"id": "blk", "block": "cfar", "inputs": ["tx"]}
    rx = rs.survey_nodes("waveform_rx", [])
    assert rx[1]["params"] == stream[0]["params"] and rx[1]["inputs"] == ["tx"]
    # the PRNG key is not a stream: a keyed source stays a single node
    assert rs.stream_inputs([{"name": "key", "role": "input"}, {"name": "n", "role": "param"}]) == []


def test_survey_report(survey):
    assert survey["device"] == "cpu"
    assert set(survey["blocks"]) == set(BY_CATEGORY.values())
    assert set(survey["errors"]) == {"arbitrary_resampler"}
    assert "ratio" in survey["errors"]["arbitrary_resampler"]
    assert sorted(survey["ok"]) == sorted(set(BY_CATEGORY.values()) - {"arbitrary_resampler"})
    for name, entry in survey["blocks"].items():
        assert entry["seconds"] >= 0
        assert entry["stream"] == (name != "preamble_gen")
    assert survey["blocks"]["burst_shaper"]["shape"] == [48_288]
    assert survey["blocks"]["preamble_gen"]["dtype"] == "int32"


def test_demodulator_pseudo_block_decodes_the_burst():
    got = rs.registry_survey("cpu", names=["waveform_rx"])["blocks"]["waveform_rx"]
    assert got["decoded_ok"] is True and got["shape"] == [255] and got["stream"]


def test_survey_is_reproducible(survey):
    """The same seed gives the same draws: a second survey equals the
    first (the keyed rayleigh_channel among them)."""
    again = rs.registry_survey("cpu", names=list(BY_CATEGORY.values()))
    cmp = rs.compare_surveys(again, survey)
    assert cmp["equal"] and cmp["worst_power_db"] == 0.0


@pytest.mark.parametrize("category", sorted(BY_CATEGORY))
def test_block_node_equals_the_references(survey, category):
    """The port's node against the JAX package's pipeline on the same graph."""
    from r4w_tpu.pipeline import run_pipeline as jax_run_pipeline
    from r4w_tpu_torch.remote_gates import RATE_HZ

    name = BY_CATEGORY[category]
    nodes = rs.survey_nodes(name, default_registry().param_schema(name))
    want = jax_run_pipeline(nodes, seed=rs.SEED, previews=False, sample_rate=RATE_HZ)
    w, g = want["nodes"]["blk"], survey["blocks"][name]
    assert ("error" in g) == ("error" in w), (g.get("error"), w.get("error"))
    if "error" in w:
        return
    assert (g["shape"], g["dtype"]) == (w["shape"], w["dtype"])
    assert ("power_db" in g) == ("power_db" in w)
    if "power_db" in w:
        assert abs(g["power_db"] - w["power_db"]) <= 0.005 + 1e-4


def test_compare_surveys_rules(survey):
    card = copy.deepcopy(survey)
    assert rs.compare_surveys(card, survey)["equal"]
    # a block that errs on the card only
    card["errors"]["cfar"] = "TypeError: can't convert cuda:0 device type tensor to numpy"
    card["ok"].remove("cfar")
    # a power that moves by more than 0.01 dB, and a shape that differs
    card["blocks"]["am_demod"]["power_db"] += 0.02
    card["blocks"]["de_emphasis"]["shape"] = [1]
    cmp = rs.compare_surveys(card, survey)
    assert not cmp["equal"]
    assert list(cmp["card_only"]) == ["cfar"] and not cmp["cpu_only"]
    assert set(cmp["mismatch"]) == {"am_demod", "de_emphasis"}
    assert cmp["mismatch"]["de_emphasis"][0] == "shape/dtype"
    # an exempt block's miss is listed apart and does not fail the survey
    saved = dict(rs.EXEMPT)
    rs.EXEMPT["am_demod"] = "test"
    try:
        card["blocks"]["de_emphasis"]["shape"] = survey["blocks"]["de_emphasis"]["shape"]
        card["errors"].pop("cfar")
        card["ok"].append("cfar")
        cmp = rs.compare_surveys(card, survey)
        assert cmp["equal"] and set(cmp["exempt"]) == {"am_demod"}
    finally:
        rs.EXEMPT.clear()
        rs.EXEMPT.update(saved)


def test_erring_blocks_must_err_for_the_same_cause(survey):
    card = copy.deepcopy(survey)
    card["errors"]["arbitrary_resampler"] = \
        "TypeError: can't convert cuda:0 device type tensor to numpy."
    cmp = rs.compare_surveys(card, survey)
    assert not cmp["equal"] and list(cmp["differing_errors"]) == ["arbitrary_resampler"]
    # addresses and device names are not causes
    assert rs.error_cause("ValueError: <function f at 0x7f12ab> on cuda:0") == \
        rs.error_cause("ValueError: <function f at 0x55aa01> on cpu")


class _CardTensor(torch.Tensor):
    """A CPU tensor that refuses numpy's conversion, as a CUDA tensor does:
    only an explicit read to the host (`.cpu().numpy()`) gets its values."""

    def __array__(self, dtype=None, copy=None):
        raise TypeError("can't convert cuda:0 device type tensor to numpy. Use Tensor.cpu() "
                        "to copy the tensor to host memory first.")


def test_power_quality_classifier_reads_a_device_tensor_once():
    """The one block the card survey found erring for another cause than on
    the CPU: `power_quality_classify` converted its input with np.asarray,
    which a CUDA tensor refuses; it now reads a tensor to the host first."""
    fs, f0 = 3200.0, 50.0
    t = np.arange(int(fs)) / fs
    x = np.sin(2 * np.pi * f0 * t)
    x[640:960] *= 0.5          # a sag in frames 10-14
    want = exotic_modems.power_quality_classify(x, fs, f0, device="cpu")
    card_like = torch.from_numpy(x).as_subclass(_CardTensor)
    with pytest.raises(TypeError, match="cuda:0"):
        np.asarray(card_like)
    got = exotic_modems.power_quality_classify(card_like, fs, f0, device="cpu")
    assert got == want and (10, "sag") in want


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the survey compares the card with the CPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_survey_node_on_card_equals_cpu():
    names = ["power_quality_event_classifier", "de_emphasis", "cfar", "waveform_rx"]
    card = rs.registry_survey(_card(), names=names)
    cpu = rs.registry_survey("cpu", names=names)
    assert rs.compare_surveys(card, cpu)["equal"]
