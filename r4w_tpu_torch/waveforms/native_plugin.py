"""Adapter exposing C-ABI plugin waveforms through the Waveform API.

PyTorch counterpart of ``r4w_tpu.waveforms.native_plugin``. The native side
implements ``r4w_tpu_torch/native/r4w_plugin.h`` (plugin/abi.rs); this
wrapper moves IQ across the boundary as interleaved f32 and presents the
standard modulate/demodulate surface, so plugin waveforms are
indistinguishable from built-ins in the factory. The plugin runs on the
host: `modulate` puts its samples on the waveform's device, `demodulate`
reads the samples to the host once and returns the bytes as a tensor on
the waveform's device.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from r4w_tpu_torch.core.types import DEFAULT_DEVICE, SYMBOL_DTYPE, CommonParams
from r4w_tpu_torch.waveforms.base import DemodResult, Waveform, WaveformInfo


@dataclasses.dataclass
class NativePluginWaveform(Waveform):
    """One waveform exported by a loaded C plugin."""

    lib: ctypes.CDLL
    waveform_id: str
    sample_rate: float = 125_000.0
    device: torch.device = DEFAULT_DEVICE

    @property
    def common_params(self) -> CommonParams:
        return CommonParams(sample_rate=self.sample_rate)

    def samples_per_symbol(self) -> int:
        return 1

    def info(self) -> WaveformInfo:
        return WaveformInfo(name=self.waveform_id,
                            full_name=f"native plugin waveform {self.waveform_id!r}",
                            description="loaded from a C-ABI plugin (native/r4w_plugin.h)",
                            complexity=1, bits_per_symbol=1)

    def modulate(self, data) -> torch.Tensor:
        if isinstance(data, (bytes, bytearray)):
            payload = np.frombuffer(bytes(data), np.uint8)
        elif isinstance(data, torch.Tensor):
            payload = data.cpu().numpy().astype(np.uint8)
        else:
            payload = np.asarray(data, np.uint8)
        payload = np.ascontiguousarray(payload)
        max_samples = max(payload.size * 8 * 64, 4096)
        buf = np.empty(max_samples * 2, np.float32)
        n = self.lib.r4w_modulate(
            self.waveform_id.encode(), ctypes.c_double(self.sample_rate),
            payload.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), ctypes.c_int64(payload.size),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ctypes.c_int64(max_samples))
        if n < 0:
            raise RuntimeError(f"plugin modulate failed for {self.waveform_id!r}")
        inter = buf[: 2 * n]
        iq = (inter[0::2] + 1j * inter[1::2]).astype(np.complex64)
        return torch.from_numpy(iq).to(self.device)

    def demodulate(self, samples) -> DemodResult:
        if isinstance(samples, torch.Tensor):
            x = samples.detach().to("cpu", torch.complex64).numpy()
        else:
            x = np.asarray(samples, np.complex64)
        inter = np.empty(x.size * 2, np.float32)
        inter[0::2] = x.real.reshape(-1)
        inter[1::2] = x.imag.reshape(-1)
        out = np.empty(max(x.size // 8, 16), np.uint8)
        n = self.lib.r4w_demodulate(
            self.waveform_id.encode(), ctypes.c_double(self.sample_rate),
            inter.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ctypes.c_int64(x.size),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), ctypes.c_int64(out.size))
        if n < 0:
            raise RuntimeError(f"plugin demodulate failed for {self.waveform_id!r}")
        bits = torch.from_numpy(out[:n].astype(np.int32)).to(self.device)
        return DemodResult(bits=bits, symbols=torch.zeros(0, dtype=SYMBOL_DTYPE,
                                                          device=self.device))
