"""Accelerator backend seam (fpga_accel.rs / r4w-fpga: the FpgaAccelerator
trait, traits.rs:26, and its sim/zynq/lattice backends; register-map
semantics are not ported, per SURVEY §2.8).

PyTorch counterpart of ``r4w_tpu.accel``. The trait's fft, FIR and
chirp-correlate offload entry points map to a thin Backend protocol with
two implementations:

* ``TorchAccelerator`` — offload on a torch device (the card unless
  named): cuFFT transforms, the FIR as an FFT convolution, the chirp
  correlation as an FFT cross-correlation. The analogue of the
  reference's real-hardware backends.
* ``SimulatedAccelerator`` — pure numpy, mirroring r4w-fpga's `sim`
  backend (a software model used when no device exists), and doubling as
  the cross-check oracle.

Capability discovery mirrors traits.rs (supports_fft/fir/correlate + max
sizes).
"""

from __future__ import annotations

import dataclasses
from typing import Protocol

import numpy as np
import torch

from r4w_tpu_torch.core.types import DEFAULT_DEVICE, IQ_DTYPE, next_pow2, resolve_device, to_tensor


@dataclasses.dataclass(frozen=True)
class AcceleratorCapabilities:
    """Discovery record (traits.rs DeviceCapabilities role)."""
    name: str
    max_fft: int
    supports_fft: bool = True
    supports_fir: bool = True
    supports_chirp_correlate: bool = True


class Accelerator(Protocol):
    """FpgaAccelerator-trait analogue."""

    def capabilities(self) -> AcceleratorCapabilities: ...

    def fft(self, x): ...

    def fir(self, x, taps): ...

    def chirp_correlate(self, x, chirp): ...


class TorchAccelerator:
    """The torch backend: offload to `device`; numpy inputs are moved there,
    results stay there."""

    def __init__(self, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)

    def _iq(self, x) -> torch.Tensor:
        return to_tensor(x, IQ_DTYPE, self.device)

    def capabilities(self) -> AcceleratorCapabilities:
        return AcceleratorCapabilities(name=f"torch-{self.device.type}", max_fft=1 << 24)

    def fft(self, x) -> torch.Tensor:
        return torch.fft.fft(self._iq(x), dim=-1)

    def fir(self, x, taps) -> torch.Tensor:
        """Full linear convolution (length N + K - 1) by FFT."""
        x, taps = self._iq(x), self._iq(taps)
        n = x.shape[-1] + taps.shape[-1] - 1
        nfft = next_pow2(n)
        y = torch.fft.ifft(torch.fft.fft(x, nfft) * torch.fft.fft(taps, nfft))
        return y[..., :n]

    def chirp_correlate(self, x, chirp) -> torch.Tensor:
        """Cross-correlation of x with chirp at lags 0..N-1 by FFT."""
        x, chirp = self._iq(x), self._iq(chirp)
        n = x.shape[-1]
        nfft = next_pow2(2 * n)
        c = torch.fft.ifft(torch.fft.fft(x, nfft) * torch.conj(torch.fft.fft(chirp, nfft)))
        return c[..., :n]


class SimulatedAccelerator:
    """Software model (r4w-fpga sim/mod.rs role): numpy reference."""

    def capabilities(self) -> AcceleratorCapabilities:
        return AcceleratorCapabilities(name="sim", max_fft=1 << 20)

    def fft(self, x):
        return np.fft.fft(np.asarray(x, np.complex64))

    def fir(self, x, taps):
        return np.convolve(np.asarray(x, np.complex64), np.asarray(taps, np.complex64))

    def chirp_correlate(self, x, chirp):
        x = np.asarray(x, np.complex64)
        c = np.asarray(chirp, np.complex64)
        n = x.shape[-1]
        nfft = 1 << (2 * n - 1).bit_length()
        out = np.fft.ifft(np.fft.fft(x, nfft) * np.conj(np.fft.fft(c, nfft)))
        return out[:n]


def create_accelerator(backend: str = "torch", device=DEFAULT_DEVICE) -> Accelerator:
    """Factory (r4w-fpga lib.rs:33-45 backend selection)."""
    if backend == "torch":
        return TorchAccelerator(device)
    if backend == "sim":
        return SimulatedAccelerator()
    raise ValueError(f"unknown accelerator backend '{backend}'")
