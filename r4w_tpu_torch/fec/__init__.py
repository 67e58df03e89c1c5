"""Forward error correction. Ported so far: convolutional coding with the
Viterbi decoder (`fec.convolutional`) and puncturing, CRCs (`fec.crc`),
the repetition, Golay and GF(2) matrix codes (`fec.block`), and GF(2^m)
arithmetic with the Reed-Solomon and BCH codecs (`fec.galois`, a byte
copy of the reference's numpy module: it runs on the host)."""

from r4w_tpu_torch.fec.convolutional import (
    conv_encode,
    depuncture,
    puncture,
    viterbi_decode,
    viterbi_decode_mxu,
)

__all__ = ["conv_encode", "viterbi_decode", "viterbi_decode_mxu", "puncture", "depuncture"]
