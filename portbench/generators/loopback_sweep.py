"""Monte-Carlo BER sweep through the port's ``loopback_ber``, as a radio
engineer runs it for a BER curve.

Each call is one (lanes, SNRs) grid: a random payload of the configuration's
size a lane, drawn from the seed, shared by the lane's SNRs, and noise drawn
inside the call from the harness's own generator, handed to ``awgn`` as its
``noise=`` callable. Lanes follow the traffic's ``lanes_at_sf7``, halved for
each spreading factor above 7; the SNRs are the traffic's offsets
from the configuration's demodulation floor. Calls run in a closed loop with
at most ``in_flight`` of them dispatched and not yet known to be done.

Judging: once the window has closed, a sample of its calls drawn from the
seed is run again through ``portbench.reference`` on the same payloads and
noise. A packet's bit errors in the port (its BER times the bits) may differ
from the reference's only by what its near-tie symbols allow: a symbol whose
two largest DFT bins lie within ``near_tie`` of the largest can fall either
way under rounding and moves at most sf data bits. The compared number is the
largest excess over that allowance.
"""

from __future__ import annotations

import importlib
import time
from collections import deque

import numpy as np
import torch

from portbench.generators import Marker, StageTimer, check, mean_stage_ms, synchronize, thirds
from portbench.harness import seed_of
from portbench.reference import lora as ref

TAGS = {"warm": -1, "window": 0, "profiled": 1, "stepped": 2}   # tags of the calls' seeds
LANES_PER_BLOCK = 64      # lanes the reference judges at once, to bound its memory


class Traffic:
    """The sweep's inputs, its closed loop of calls and their judging."""

    def __init__(self, cell, seed: int, device: torch.device, program):
        cfg, tr = cell.config, cell.traffic
        self.port = importlib.import_module("r4w_tpu_torch.waveforms.lora")
        self.program = program or self.port
        self.params = self.port.LoRaParams(sf=cfg["sf"], bw_hz=cfg["bw_hz"], cr=cfg["cr"],
                                           low_data_rate_optimize=cfg["low_data_rate_optimize"])
        self.phy = ref.phy_of(cfg)
        self.seed, self.device, self.tr = seed, device, tr
        self.n_bytes = int(cfg["payload_bytes"])
        self.lanes = int(tr["lanes_at_sf7"]) >> (self.phy.sf - 7)
        self.snrs = [cfg["snr_floor_db"] + o for o in tr["snr_offsets_db"]]
        self.snr = torch.tensor(self.snrs, dtype=torch.float32, device=device)
        self.n_samples = self.phy.n_symbols(self.n_bytes) * self.phy.chips
        self.g_payload = torch.Generator(device=device)
        self.g_noise = torch.Generator(device=device)
        self.grids = []

    @property
    def packets(self) -> int:
        return self.lanes * len(self.snrs)

    def inputs(self, tag: int, i: int):
        """Call i's payload, and its noise as the callable `awgn` draws from."""
        self.g_payload.manual_seed(seed_of(self.seed, 1, tag, i))
        payload = torch.randint(0, 256, (self.lanes, 1, self.n_bytes), generator=self.g_payload,
                                dtype=torch.int32, device=self.device)
        self.g_noise.manual_seed(seed_of(self.seed, 2, tag, i))
        gen = self.g_noise
        return payload, lambda shape, device: ref.complex_noise(gen, shape, device)

    def call(self, tag: int, i: int) -> torch.Tensor:
        payload, noise = self.inputs(tag, i)
        return self.program.loopback_ber(self.params, payload, self.snr, noise=noise)

    def loop(self, tag: int, seconds: float | None = None, calls: int | None = None):
        """Closed loop of calls, `in_flight` at most outstanding; ends after
        `seconds` or `calls` and waits for the last. Returns (BER grids,
        seconds from the first dispatch to the last call done)."""
        depth = int(self.tr["in_flight"])
        out, pending, self.done_at = [], deque(), []
        t0 = time.perf_counter()
        deadline = t0 + seconds if seconds is not None else None
        while (time.perf_counter() < deadline) if deadline is not None else len(out) < calls:
            out.append(self.call(tag, len(out)))
            pending.append(Marker(self.device))
            if len(pending) > depth:
                pending.popleft().wait()
                self.done_at.append(time.perf_counter() - t0)
        synchronize(self.device)
        return out, time.perf_counter() - t0

    def segment(self, phase: str, n: int) -> None:
        self.loop(TAGS[phase], calls=n)

    def window(self, seconds: float) -> tuple[dict, dict]:
        self.grids, window_s = self.loop(TAGS["window"], seconds=seconds)
        calls = len(self.grids)
        return ({"window_s": window_s, "attempted": calls * self.packets, "failed": 0,
                 "payload_bits": calls * self.packets * 8 * self.n_bytes},
                {"calls": calls, "thirds": thirds(self.done_at, window_s)})

    def stepped(self, n: int) -> tuple[dict, int]:
        runs, mismatch = [], 0
        for i in range(n):
            ms, bad = self.step(i)
            runs.append(ms)
            mismatch += bad
        return ({"stage_ms": mean_stage_ms(runs),
                 "demod_rows": self.packets * self.phy.n_symbols(self.n_bytes),
                 "demod_k": self.phy.chips}, mismatch)

    def step(self, i: int) -> tuple[dict, int]:
        """One call stepped through the public calls that `loopback_ber`
        composes, with CUDA events between them. Returns (ms a stage, lanes
        where the stepped BER differs from `loopback_ber`'s on the same
        inputs)."""
        from r4w_tpu_torch.channel import awgn
        from r4w_tpu_torch.ops import coding

        lora = self.port
        payload, noise = self.inputs(TAGS["stepped"], i)
        whole = self.program.loopback_ber(self.params, payload, self.snr, noise=noise)
        payload, noise = self.inputs(TAGS["stepped"], i)
        t = StageTimer(self.device)
        t.mark("modulate")
        tx = lora.modulate(self.params, payload, include_preamble=False, device=self.device)
        t.mark("awgn")
        batch = torch.broadcast_shapes(tx.shape[:-1], self.snr.shape)
        rx = awgn(tx.expand(*batch, tx.shape[-1]), self.snr[..., None], noise=noise)
        t.mark("demodulate_symbols")
        symbols, _, _ = lora.demodulate_symbols(self.params, rx)
        t.mark("decode_symbols")
        got = lora.decode_symbols(self.params, symbols)
        t.mark("ber")
        ber = torch.mean((coding.bytes_to_bits(payload) != coding.bytes_to_bits(
            got[..., : self.n_bytes])).to(torch.float32), dim=-1)
        t.mark("end")
        ms = t.ms()
        return ms, int((ber != whole).sum())

    def judge(self) -> tuple[dict, dict]:
        """Largest excess of a packet's bit-error gap over its near-tie
        allowance, over a sample of the window's calls drawn from the seed."""
        c, grids = self.tr["check"], self.grids
        rng = np.random.default_rng(seed_of(self.seed, 3))
        picks = sorted(rng.choice(len(grids), size=min(int(c["calls"]), len(grids)),
                                  replace=False).tolist())
        bits = 8 * self.n_bytes
        worst, raw, ties, compared = 0.0, 0.0, 0, 0
        for i in picks:
            payload, _ = self.inputs(TAGS["window"], i)
            noise = ref.complex_noise(self.g_noise, (self.lanes, len(self.snrs), self.n_samples),
                                      self.device)
            port_errors = torch.round(grids[i].to(torch.float64) * bits)
            for lo in range(0, self.lanes, LANES_PER_BLOCK):
                sl = slice(lo, lo + LANES_PER_BLOCK)
                tx = ref.modulate(self.phy, payload[sl])
                rx = ref.awgn(tx, self.snr, noise[sl])
                p = ref.power(self.phy, rx)
                got = ref.decode(self.phy, torch.argmax(p, dim=-1), self.n_bytes)
                errors = ref.bit_errors(got, payload[sl])
                near = ref.near_ties(p, float(c["near_tie"])).sum(dim=-1)
                gap = (port_errors[sl] - errors).abs().nan_to_num(nan=1e30)
                worst = max(worst, float((gap - near * self.phy.sf).max()))
                raw = max(raw, float(gap.max()))
                ties += int(near.sum())
                compared += errors.numel()
            del noise
        mean_ber = torch.stack(grids).mean(dim=(0, 1)).tolist()
        return ({"excess_bits_max": check(worst, c["limits"]["excess_bits_max"])},
                {"compared_packets": compared, "near_tie_symbols": ties, "raw_gap_bits_max": raw,
                 "mean_ber": dict(zip(self.snrs, mean_ber))})
