from r4w_tpu_torch.waveforms.lora.params import LoRaParams, sf7, sf12
from r4w_tpu_torch.waveforms.lora import chirp, modem
from r4w_tpu_torch.waveforms.lora.modem import (
    LoRaDemodResult,
    decode_symbols,
    demodulate,
    demodulate_symbols,
    encode_symbols,
    loopback_ber,
    modulate,
)

__all__ = [
    "LoRaParams",
    "sf7",
    "sf12",
    "chirp",
    "modem",
    "LoRaDemodResult",
    "decode_symbols",
    "demodulate",
    "demodulate_symbols",
    "encode_symbols",
    "loopback_ber",
    "modulate",
]
