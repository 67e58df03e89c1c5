"""Frame demodulation through the port's ``demodulate`` on blocks of
received frames that already sit on the card, as a gateway or a mesh node
takes a batch of captured frames; the decoded bytes are read to the host.

The captures are a pool of ``pool_blocks`` distinct blocks of
``frames_per_block`` payload-aligned frames, made in set-up by
``portbench.reference``'s modulator and noise from the seed: a random
payload of the configuration's size a frame, at an SNR drawn uniformly from
the traffic's ``snr_offset_db`` range around the configuration's floor.
Blocks are handed over in turn; ``in_flight`` blocks are outstanding at a
hand-over, so block i + 1 is handed over before block i's bytes are read.

Judging: every block's bytes are compared, through the distinct outputs of
each pool block, with the reference's decode of the port's own symbols
(exact), and the symbols of those outputs and of a sample of blocks drawn
from the seed are held against the reference's DFT power: the compared
number is the widest gap by which a decision's power lies below the
reference's largest bin, as a share of it.
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

FRAMES_PER_CHUNK = 16     # frames the reference judges at once, to bound its memory


class Traffic:
    """The receiver's pool of captures, its loop of blocks and their judging."""

    def __init__(self, cell, seed: int, device: torch.device, program):
        cfg, tr = cell.config, cell.traffic
        self.port = importlib.import_module("r4w_tpu_torch.waveforms.lora")
        self.program = program or self.port
        self.params = self.port.LoRaParams(sf=cfg["sf"], bw_hz=cfg["bw_hz"], cr=cfg["cr"],
                                           low_data_rate_optimize=cfg["low_data_rate_optimize"])
        self.phy = ref.phy_of(cfg)
        self.seed, self.device, self.tr = seed, device, tr
        self.n_bytes = int(cfg["payload_bytes"])
        self.frames = int(tr["frames_per_block"])
        self.n_samples = self.phy.n_symbols(self.n_bytes) * self.phy.chips
        lo, hi = (cfg["snr_floor_db"] + o for o in tr["snr_offset_db"])
        g = torch.Generator(device=device)
        self.pool = []
        for p in range(int(tr["pool_blocks"])):
            g.manual_seed(seed_of(seed, 1, p))
            payload = torch.randint(0, 256, (self.frames, self.n_bytes), generator=g,
                                    dtype=torch.int32, device=device)
            snr = lo + (hi - lo) * torch.rand(self.frames, generator=g, device=device)
            noise = ref.complex_noise(g, (self.frames, self.n_samples), device)
            self.pool.append(ref.awgn(ref.modulate(self.phy, payload), snr, noise))
            del noise
        self.slots = None
        self.latency_s, self.done_at = [], []
        self.outputs = {p: [] for p in range(len(self.pool))}   # distinct (bytes, symbols, count)
        self.sampled = []                                       # (pool block, symbols)
        self.rng = np.random.default_rng(seed_of(seed, 4))

    def hand(self, i: int):
        """Hand block i to the demodulator and queue its bytes' copy to the host."""
        p = i % len(self.pool)
        t_hand = time.perf_counter()
        res = self.program.demodulate(self.params, self.pool[p])
        if self.slots is None:
            pin = self.device.type == "cuda"
            self.slots = [torch.empty(tuple(res.payload.shape), dtype=res.payload.dtype,
                                      pin_memory=pin) for _ in range(int(self.tr["in_flight"]) + 1)]
        slot = self.slots[i % len(self.slots)]
        slot.copy_(res.payload, non_blocking=True)
        return i, p, t_hand, res.symbols, slot, Marker(self.device)

    def complete(self, item, keep: bool, seen: int) -> None:
        """Wait for a block's bytes on the host; file them under their pool
        block's distinct outputs, and keep a sample of symbols."""
        i, p, t_hand, symbols, slot, marker = item
        marker.wait()
        if not keep:
            return
        self.latency_s.append(time.perf_counter() - t_hand)
        self.done_at.append(time.perf_counter() - self.t0)
        got = slot.numpy()
        for entry in self.outputs[p]:
            if np.array_equal(entry[0], got):
                entry[2] += 1
                break
        else:
            self.outputs[p].append([got.copy(), symbols, 1])
        # reservoir sample of the window's blocks, drawn from the seed
        size = int(self.tr["check"]["sampled_blocks"])
        if len(self.sampled) < size:
            self.sampled.append((p, symbols))
        else:
            j = int(self.rng.integers(0, seen))
            if j < size:
                self.sampled[j] = (p, symbols)

    def loop(self, seconds: float | None = None, blocks: int | None = None, keep: bool = True):
        """Hand blocks in turn until `seconds` or `blocks` are done; returns
        (blocks, seconds from the first hand-over to the last bytes read)."""
        depth = int(self.tr["in_flight"])
        pending, i = deque(), 0
        t0 = self.t0 = time.perf_counter()
        deadline = t0 + seconds if seconds is not None else None
        while (time.perf_counter() < deadline) if deadline is not None else i < blocks:
            pending.append(self.hand(i))
            i += 1
            if len(pending) >= depth:
                self.complete(pending.popleft(), keep, i - len(pending))
        while pending:
            self.complete(pending.popleft(), keep, i - len(pending))
        synchronize(self.device)
        return i, time.perf_counter() - t0

    def segment(self, phase: str, n: int) -> None:
        self.loop(blocks=n, keep=False)

    def window(self, seconds: float) -> tuple[dict, dict]:
        blocks, window_s = self.loop(seconds=seconds)
        return ({"window_s": window_s, "attempted": blocks * self.frames, "failed": 0,
                 "samples": blocks * self.frames * self.n_samples,
                 "latency_ms": sorted(1e3 * x for x in self.latency_s)},
                {"blocks": blocks, "thirds": thirds(self.done_at, window_s)})

    def stepped(self, n: int) -> tuple[dict, int]:
        runs, mismatch = [], 0
        for i in range(n):
            ms, bad = self.step(i)
            runs.append(ms)
            mismatch += bad
        return ({"stage_ms": mean_stage_ms(runs),
                 "demod_rows": self.frames * self.phy.n_symbols(self.n_bytes),
                 "demod_k": self.phy.chips}, mismatch)

    def step(self, i: int) -> tuple[dict, int]:
        """Block i stepped through `demodulate_symbols`, then `decode_symbols`
        with the bytes' read-back. Returns (ms a stage, bytes that differ
        from `demodulate`'s on the same block)."""
        p = i % len(self.pool)
        whole = self.program.demodulate(self.params, self.pool[p]).payload.cpu()
        out = self.slots[0]
        t = StageTimer(self.device)
        t.mark("demodulate_symbols")
        symbols, _, _ = self.port.demodulate_symbols(self.params, self.pool[p])
        t.mark("decode_readback")
        out.copy_(self.port.decode_symbols(self.params, symbols), non_blocking=True)
        t.mark("end")
        ms = t.ms()
        return ms, int((out != whole).sum())

    def judge(self) -> tuple[dict, dict]:
        """Bytes against the reference's decode of the port's symbols, and
        the widest gap of a kept symbol below the reference's best bin."""
        c = self.tr["check"]
        wrong, gap, kept = 0, 0.0, 0
        chunk = FRAMES_PER_CHUNK
        for p, block in enumerate(self.pool):
            mine = [(e[1], e) for e in self.outputs[p]] + [(s, None) for q, s in self.sampled
                                                           if q == p]
            if not mine:
                continue
            for lo in range(0, self.frames, chunk):
                power = ref.power(self.phy, block[lo:lo + chunk])
                for symbols, entry in mine:
                    sym = symbols[lo:lo + chunk]
                    g = ref.symbol_gap(power, sym)
                    gap = max(gap, float(g.nan_to_num(nan=1e30).max()))
                    if entry is not None:
                        want = ref.decode(self.phy, sym, self.n_bytes).cpu().numpy()
                        have = entry[0][lo:lo + chunk, : self.n_bytes]
                        wrong += int((want != have).sum()) * entry[2]
            kept += len(mine)
        blocks = sum(e[2] for es in self.outputs.values() for e in es)
        return ({"symbol_gap_max": check(gap, c["limits"]["symbol_gap_max"]),
                 "bytes_wrong": check(wrong, c["limits"]["bytes_wrong"])},
                {"compared_blocks": blocks, "symbol_sets_compared": kept,
                 "distinct_outputs": sum(len(es) for es in self.outputs.values())})
