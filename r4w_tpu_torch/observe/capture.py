"""IQ capture manager with arm/trigger semantics (observe/capture.rs:53
re-design): ring-buffered pre-trigger history + post-trigger length,
written out as SigMF.

PyTorch counterpart of ``r4w_tpu.observe.capture``. Blocks stay tensors on
their device: the history keeps the last `pre_trigger_samples`, the
post-trigger blocks are kept as given, and `save` reads the recording to
the host in one copy. As in the reference, a block processed while armed
enters the history whole before the level is tested, so a threshold
trigger inside a block records the block's tail in the history too; a
caller that wants the history to end at the trigger calls `trigger()`
before the block that holds it.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from r4w_tpu_torch.core.types import IQ_DTYPE, to_tensor
from r4w_tpu_torch.io import sigmf


class CaptureState(enum.Enum):
    IDLE = "idle"
    ARMED = "armed"
    TRIGGERED = "triggered"
    COMPLETE = "complete"


@dataclasses.dataclass
class CaptureConfig:
    pre_trigger_samples: int = 4096
    post_trigger_samples: int = 65536
    sample_rate: float = 1e6
    frequency: float = 0.0
    format: str = "cf32"


class CaptureManager:
    """Feed blocks via `process`; call `arm()` then `trigger()` (or use
    a threshold trigger) and `save(path)` when COMPLETE. Blocks that are
    not tensors go to `device` (default: the CUDA card)."""

    def __init__(self, config: CaptureConfig = CaptureConfig(), device=None):
        self.config = config
        self.device = device
        self.state = CaptureState.IDLE
        self._pre: torch.Tensor | None = None
        self._post: list[torch.Tensor] = []
        self._post_count = 0

    def arm(self):
        self.state = CaptureState.ARMED
        self._post = []
        self._post_count = 0

    def trigger(self):
        if self.state == CaptureState.ARMED:
            self.state = CaptureState.TRIGGERED

    def process(self, block, trigger_level: float | None = None):
        """Feed a block; optional amplitude threshold auto-trigger (one
        read of the block's first crossing, if any)."""
        block = to_tensor(block, IQ_DTYPE, None if isinstance(block, torch.Tensor)
                          else self.device)
        if self.state == CaptureState.ARMED:
            prev = block[:0] if self._pre is None else self._pre
            self._pre = torch.cat((prev, block))[-self.config.pre_trigger_samples:]
            if trigger_level is not None:
                above = torch.abs(block) >= trigger_level
                idx = int(torch.argmax(above.to(torch.int8))) if block.numel() else 0
                if block.numel() and bool(above[idx]):
                    self.state = CaptureState.TRIGGERED
                    tail = block[idx:]
                    self._post.append(tail)
                    self._post_count += tail.shape[0]
        elif self.state == CaptureState.TRIGGERED:
            need = self.config.post_trigger_samples - self._post_count
            take = block[: max(need, 0)]
            self._post.append(take)
            self._post_count += take.shape[0]
        if (self.state == CaptureState.TRIGGERED
                and self._post_count >= self.config.post_trigger_samples):
            self.state = CaptureState.COMPLETE

    @property
    def pre_count(self) -> int:
        return 0 if self._pre is None else int(self._pre.shape[0])

    def samples(self) -> torch.Tensor:
        parts = ([] if self._pre is None else [self._pre]) + self._post
        if not parts:
            return torch.zeros(0, dtype=IQ_DTYPE, device=self.device)
        return torch.cat(parts)

    def save(self, path: str, description: str = "r4w_tpu capture"):
        sigmf.write_sigmf(
            path, self.samples(), self.config.sample_rate,
            self.config.frequency, self.config.format, description,
            annotations=[{
                "core:sample_start": self.pre_count,
                "core:sample_count": self._post_count,
                "core:label": "trigger",
            }],
        )
        self.state = CaptureState.IDLE
