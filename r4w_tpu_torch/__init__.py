"""r4w_tpu_torch — the r4w_tpu waveform framework on PyTorch and CUDA.

A port of the JAX package ``r4w_tpu`` to PyTorch, with its Pallas TPU
kernels rewritten by hand for NVIDIA Hopper (sm_90a). The subpackages
mirror ``r4w_tpu``'s layout. ``r4w_tpu`` stays the reference: the port is
held against it on the same inputs, and never imports it or JAX.

Ported so far: the LoRa loopback path (parameters, chirps, coding chain,
AWGN, modem, Monte-Carlo sweeps, the `Waveform` factory) and its kernel,
the fused dechirp + DFT power (`kernels.dechirp`); the K=7 soft Viterbi
path (`fec.convolutional`, MIL-STD-188-110) and its two kernels
(`kernels.viterbi`); the digital down-converter path (`ops.filters`,
`ops.resample`, `ops.stream_math`, `ops.filters2`) and its two kernels,
the FIR with decimation (`kernels.fir`) and the oscillator mix
(`kernels.nco`); the GPS, Galileo and GLONASS receivers (`gnss`); the
link round trips (LoRa packets, PSK/QAM, the BER gate, STANAG 4285,
ARQ/HARQ); the whole waveform fleet, the 50 names of the reference's
factory (`waveforms`); and the channel models (`channel`: AWGN, CFO,
Rayleigh, Rician, block and Jakes fading, the 3GPP TDL profiles;
`ops.impairments`) and the FEC codecs (`fec`: LDPC, DVB-S2X, turbo,
polar, TCM on the Viterbi kernels, fountain codes, the interleavers and
max-log-MAP decoding).
"""

__version__ = "0.1.0"

from r4w_tpu_torch.waveforms import WaveformFactory, create_waveform, list_waveforms

__all__ = [
    "WaveformFactory",
    "list_waveforms",
    "create_waveform",
    "__version__",
]
