"""`correct` comes out false for the control and for each fault a cell can
have, with the harness's look for a chip skipped and the rest of a run
driven on the CPU at a size a test run holds: the control (the reference in
the program's place, in bfloat16), an answer altered where it is produced,
and half of the batch left out with the rest standing in for it. The cells
run on one chip and carry no training state, so the faults of a state left
unchanged and of an exchange between chips left out do not arise."""

import dataclasses
import time
from typing import NamedTuple

import pytest
import torch

from portbench import harness
from portbench.control import ReferenceProgram

SWEEP = "lorawan_eu868_dr5.mc_sweep"
RX = "meshtastic_longfast.rx_frames"
TINY = {
    SWEEP: dict(lanes_at_sf7=8, warm=1),
    RX: dict(frames_per_block=128, pool_blocks=1, warm=1),
}


def _run(name, program=None, trace=False):
    cell = harness.find_cell(name)
    cell = dataclasses.replace(cell, traffic={**cell.traffic, **TINY[name]})
    return harness.run_cell(cell, 2 ** 31 + 77, 0.3, trace, "cpu", time.perf_counter(),
                            program=program)


class Demodulated(NamedTuple):
    payload: torch.Tensor
    symbols: torch.Tensor


class Faulty:
    """The port's LoRa entries with one fault planted underneath."""

    def __init__(self, fault: str):
        from r4w_tpu_torch.waveforms import lora

        self.lora, self.fault = lora, fault

    def loopback_ber(self, params, payload, snr_db, *, noise):
        if self.fault == "half_batch":
            half = payload.shape[0] // 2
            ber = self.lora.loopback_ber(params, payload[:half], snr_db, noise=noise)
            return torch.cat([ber, ber.mean(dim=0, keepdim=True).expand(half, -1)])
        ber = self.lora.loopback_ber(params, payload, snr_db, noise=noise).clone()
        ber[0, -1] += 8.0 / (8 * payload.shape[-1])   # one byte of one packet decoded wrong
        return ber

    def demodulate(self, params, block):
        if self.fault == "half_batch":
            res = self.lora.demodulate(params, block[: block.shape[0] // 2])
            return Demodulated(torch.cat([res.payload, res.payload]),
                               torch.cat([res.symbols, res.symbols]))
        res = self.lora.demodulate(params, block)
        payload, symbols = res.payload.clone(), res.symbols.clone()
        if self.fault == "altered_byte":
            payload[-1, 0] ^= 0x5A
        else:
            symbols[-1, 0] = (symbols[-1, 0] + 1) % params.chips_per_symbol
        return Demodulated(payload, symbols)


@pytest.mark.parametrize("name", [SWEEP, RX])
def test_the_port_comes_out_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("name", [SWEEP, RX])
def test_the_control_in_bfloat16_comes_out_not_correct(name):
    res = _run(name, program=ReferenceProgram("bfloat16"))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", [SWEEP, RX])
def test_the_reference_in_float32_in_the_programs_place_comes_out_correct(name):
    res = _run(name, program=ReferenceProgram("float32"))
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("name,fault", [(SWEEP, "altered_answer"), (SWEEP, "half_batch"),
                                        (RX, "altered_byte"), (RX, "altered_symbol"),
                                        (RX, "half_batch")])
def test_a_planted_fault_comes_out_not_correct(name, fault):
    res = _run(name, program=Faulty(fault))
    assert not res["correct"], res["checks"]


def test_the_stepped_trace_run_equals_the_whole_call():
    res = _run(SWEEP, trace=True)
    assert res["checks"]["stepped_mismatch"]["value"] == 0 and res["correct"]
    assert set(res["metrics"]) == {"idle_share.sim", "demod_roofline.sim", "channel_ms.sim",
                                   "modem_ms.sim"}
