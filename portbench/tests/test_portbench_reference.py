"""The benchmark's plain LoRa reference against the port, at tiny sizes on
the CPU's plain paths, for both configurations."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.reference import lora as ref

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
NAMES = ["lorawan_eu868_dr5", "meshtastic_longfast"]


def _setup(name, frames=3, seed=5):
    from r4w_tpu_torch.waveforms import lora

    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    params = lora.LoRaParams(sf=cfg["sf"], bw_hz=cfg["bw_hz"], cr=cfg["cr"],
                             low_data_rate_optimize=cfg["low_data_rate_optimize"])
    g = torch.Generator().manual_seed(seed)
    payload = torch.randint(0, 256, (frames, cfg["payload_bytes"]), generator=g,
                            dtype=torch.int32)
    return lora, params, ref.phy_of(cfg), cfg, payload, g


@pytest.mark.parametrize("name", NAMES)
def test_sizes_match_the_configuration(name):
    lora, params, phy, cfg, payload, _ = _setup(name, frames=1)
    assert phy.n_symbols(cfg["payload_bytes"]) == cfg["payload_symbols"]
    assert phy.n_symbols(cfg["payload_bytes"]) * phy.chips == cfg["samples_per_packet"]
    assert params.n_payload_symbols(cfg["payload_bytes"]) == cfg["payload_symbols"]


@pytest.mark.parametrize("name", NAMES)
def test_encode_and_modulate_equal_the_port(name):
    lora, params, phy, cfg, payload, _ = _setup(name)
    assert torch.equal(ref.encode(phy, payload).to(torch.int32),
                       lora.encode_symbols(params, payload))
    mine = ref.modulate(phy, payload)
    port = lora.modulate(params, payload, include_preamble=False, device="cpu")
    assert mine.shape == port.shape == (3, cfg["samples_per_packet"])
    assert float((mine - port).abs().max()) < 1e-5


@pytest.mark.parametrize("name", NAMES)
def test_decode_inverts_encode_and_equals_the_port(name):
    lora, params, phy, cfg, payload, g = _setup(name)
    n = cfg["payload_bytes"]
    assert torch.equal(ref.decode(phy, ref.encode(phy, payload), n), payload.long())
    symbols = torch.randint(0, phy.chips, (3, cfg["payload_symbols"]), generator=g,
                            dtype=torch.int32)
    assert torch.equal(ref.decode(phy, symbols, n).to(torch.int32),
                       lora.decode_symbols(params, symbols)[..., :n])


@pytest.mark.parametrize("name", NAMES)
def test_noisy_demodulation_equals_the_port_off_near_ties(name):
    lora, params, phy, cfg, payload, g = _setup(name)
    snr = torch.tensor([cfg["snr_floor_db"] - 3.0, cfg["snr_floor_db"],
                        cfg["snr_floor_db"] + 3.0])
    noise = ref.complex_noise(g, (3, cfg["samples_per_packet"]), "cpu")
    rx = ref.awgn(ref.modulate(phy, payload), snr, noise)
    port = lora.demodulate(params, rx)
    p = ref.power(phy, rx)
    symbols = torch.argmax(p, dim=-1)
    differ = symbols != port.symbols.long()
    assert not bool((differ & ~ref.near_ties(p, 1e-4)).any())
    assert float(ref.symbol_gap(p, port.symbols).max()) < 1e-5
    assert torch.equal(ref.decode(phy, port.symbols, cfg["payload_bytes"]).to(torch.int32),
                       port.payload[..., : cfg["payload_bytes"]])


@pytest.mark.parametrize("name", NAMES)
def test_channel_equals_the_ports_awgn_on_the_same_noise(name):
    from r4w_tpu_torch.channel import awgn

    _, _, phy, cfg, payload, g = _setup(name, frames=2)
    tx = ref.modulate(phy, payload)[:, None, :]
    snr = torch.tensor([cfg["snr_floor_db"], 0.0])
    noise = ref.complex_noise(g, (2, 2, cfg["samples_per_packet"]), "cpu")
    mine = ref.awgn(tx, snr, noise)
    port = awgn(tx.expand(2, 2, -1), snr[..., None], noise=noise)
    assert float((mine - port).abs().max()) < 1e-5


def test_loopback_ber_equals_the_reference_on_the_same_noise():
    lora, params, phy, cfg, _, g = _setup("lorawan_eu868_dr5")
    n = cfg["payload_bytes"]
    payload = torch.randint(0, 256, (2, 1, n), generator=g, dtype=torch.int32)
    snr = torch.tensor([-12.0, -9.0, -7.5, -4.0])
    shape = (2, 4, cfg["samples_per_packet"])
    noise = ref.complex_noise(torch.Generator().manual_seed(9), shape, "cpu")
    ber = lora.loopback_ber(params, payload, snr, noise=noise)
    rx = ref.awgn(ref.modulate(phy, payload), snr, noise)
    p = ref.power(phy, rx)
    got = ref.decode(phy, torch.argmax(p, dim=-1), n)
    errors = ref.bit_errors(got, payload)
    slack = ref.near_ties(p, 1e-4).sum(dim=-1) * phy.sf
    assert bool(((torch.round(ber.double() * 8 * n) - errors).abs() <= slack).all())
    assert float(ber[:, -1].max()) < float(ber[:, 0].min())   # errors fall with SNR


def test_whitening_and_hamming_tables_are_loras():
    # the LFSR from 0xFF with feedback parity(state & 0x3A), by hand
    assert ref.whitening_np(4).tolist() == [0xFF, 0x38, 0x8D, 0xF9]
    enc, dec = ref.hamming_np(1)
    assert all(int(dec[enc[d]]) == d for d in range(16))
    assert [bin(int(c) >> 4).count("1") for c in enc] == [bin(d).count("1") & 1
                                                           for d in range(16)]
    enc4, dec4 = ref.hamming_np(4)
    assert all(int(dec4[int(enc4[d]) ^ (1 << b)]) == d for d in range(16) for b in range(8))


def test_bit_errors_and_gap_helpers():
    a = torch.tensor([[0x00, 0xFF], [0x0F, 0x01]])
    b = torch.tensor([[0x01, 0xFF], [0xF0, 0x01]])
    assert ref.bit_errors(a, b).tolist() == [1, 8]
    p = torch.tensor([[[1.0, 4.0, 3.99999]]])
    assert ref.near_ties(p, 1e-4).tolist() == [[True]]
    gap = ref.symbol_gap(p, torch.tensor([[0]]))
    assert np.isclose(float(gap), 0.75)
    assert float(ref.symbol_gap(p, torch.tensor([[7]]))) == 1.0
