"""Forward error correction. Ported so far: convolutional coding with the
Viterbi decoder (`fec.convolutional`) and puncturing."""

from r4w_tpu_torch.fec.convolutional import (
    conv_encode,
    depuncture,
    puncture,
    viterbi_decode,
    viterbi_decode_mxu,
)

__all__ = ["conv_encode", "viterbi_decode", "viterbi_decode_mxu", "puncture", "depuncture"]
