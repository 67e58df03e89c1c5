"""ARQ / HARQ link-layer recovery.

PyTorch counterpart of ``r4w_tpu.arq``: stop-and-wait and selective-repeat
ARQ with retransmission budgets (host bookkeeping, copied), and HARQ type
II (incremental redundancy) on the rate-1/2 K=7 convolutional code:
transmission 1 sends the even coded bits, the retransmission the odd
ones, and the receiver depunctures and soft-combines before each Viterbi
decode. Bits and LLRs cross the API as numpy arrays; encoding,
puncturing, combining and decoding run on `resolve_device(device)` (on a
CUDA device the decode launches both Hopper Viterbi kernels).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from r4w_tpu_torch.core.types import REAL_DTYPE, SYMBOL_DTYPE, resolve_device
from r4w_tpu_torch.fec.convolutional import conv_encode, depuncture, puncture, viterbi_decode


class ArqState(enum.Enum):
    IDLE = "idle"
    WAITING_ACK = "waiting_ack"
    FAILED = "failed"
    DELIVERED = "delivered"


@dataclasses.dataclass
class ArqStats:
    sent: int = 0
    retransmissions: int = 0
    delivered: int = 0
    failed: int = 0


class SelectiveRepeatArq:
    """Selective-repeat ARQ with a window."""

    def __init__(self, window: int = 8, max_retries: int = 3):
        self.window = window
        self.max_retries = max_retries
        self.tx_queue: dict[int, tuple[bytes, int]] = {}  # seq -> (data, tries)
        self.next_seq = 0
        self.stats = ArqStats()

    def send(self, data: bytes) -> int:
        seq = self.next_seq
        self.next_seq += 1
        self.tx_queue[seq] = (data, 1)
        self.stats.sent += 1
        return seq

    def pending(self) -> list[int]:
        return sorted(self.tx_queue)[: self.window]

    def on_ack(self, seq: int):
        if seq in self.tx_queue:
            del self.tx_queue[seq]
            self.stats.delivered += 1

    def on_nack(self, seq: int) -> bool:
        """Returns True if a retransmission is scheduled."""
        if seq not in self.tx_queue:
            return False
        data, tries = self.tx_queue[seq]
        if tries > self.max_retries:
            del self.tx_queue[seq]
            self.stats.failed += 1
            return False
        self.tx_queue[seq] = (data, tries + 1)
        self.stats.retransmissions += 1
        return True


# HARQ-II puncture patterns: TX1 keeps even coded bits, TX2 the odd ones
_P1 = (1, 0)
_P2 = (0, 1)


class HarqSender:
    """Incremental-redundancy HARQ sender."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._coded: dict[int, torch.Tensor] = {}
        self.next_seq = 0

    def first_transmission(self, bits: np.ndarray) -> tuple[int, np.ndarray]:
        coded = conv_encode(torch.as_tensor(np.asarray(bits), dtype=SYMBOL_DTYPE,
                                            device=self.device))
        seq = self.next_seq
        self.next_seq += 1
        self._coded[seq] = coded
        return seq, puncture(coded, _P1).cpu().numpy()

    def retransmission(self, seq: int) -> np.ndarray:
        """Complementary redundancy bits for a NACKed block."""
        return puncture(self._coded[seq], _P2).cpu().numpy()


class HarqReceiver:
    """Soft-combining receiver: buffers LLRs across transmissions."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._llr: dict[int, torch.Tensor] = {}
        self._n_info: dict[int, int] = {}

    def receive(self, seq: int, llr_punctured: np.ndarray, n_info: int,
                which: int = 1) -> np.ndarray:
        """Accumulate a transmission (which=1: even bits, 2: odd bits) and
        decode the combined LLRs. Returns the decoded bits."""
        total = (n_info + 6) * 2  # K=7 terminated rate-1/2
        pat = _P1 if which == 1 else _P2
        llr = torch.as_tensor(np.asarray(llr_punctured), dtype=REAL_DTYPE, device=self.device)
        full = depuncture(llr, pat, total, fill=0.0)
        if seq in self._llr:
            self._llr[seq] = self._llr[seq] + full
        else:
            self._llr[seq] = full
            self._n_info[seq] = n_info
        return viterbi_decode(self._llr[seq], soft=True).cpu().numpy()


def harq_roundtrip_demo(bits: np.ndarray, noise_std: float, rng,
                        device=None) -> tuple[bool, bool]:
    """(decoded_ok_after_tx1, decoded_ok_after_combining): the incremental-
    redundancy gain, with the channel noise drawn from the numpy `rng`."""
    tx = HarqSender(device)
    rx = HarqReceiver(device)
    seq, p1 = tx.first_transmission(bits)
    llr1 = (1 - 2.0 * p1) + rng.normal(0, noise_std, len(p1))
    got1 = rx.receive(seq, 2 * llr1 / noise_std**2, len(bits), which=1)
    ok1 = np.array_equal(got1, bits)
    p2 = tx.retransmission(seq)
    llr2 = (1 - 2.0 * p2) + rng.normal(0, noise_std, len(p2))
    got2 = rx.receive(seq, 2 * llr2 / noise_std**2, len(bits), which=2)
    ok2 = np.array_equal(got2, bits)
    return ok1, ok2
