"""Forward error correction, exported as the reference's ``r4w_tpu.fec``
exports it. Ported so far: convolutional coding with the Viterbi decoder
and the max-log-MAP decoder (`fec.convolutional`) and puncturing, CRCs
(`fec.crc`), the repetition, Golay and GF(2) matrix codes (`fec.block`),
GF(2^m) arithmetic with the Reed-Solomon and BCH codecs (`fec.galois`, a
byte copy of the reference's numpy module: it runs on the host), LDPC
(`fec.ldpc`) and DVB-S2X LDPC (`fec.dvb_s2x`) with min-sum decoding, the
turbo code (`fec.turbo`), the polar code (`fec.polar`, its SC decoder on
the host as in the reference), trellis-coded 8PSK (`fec.tcm`), fountain
codes and rate matching (`fec.fountain`) and the interleavers
(`fec.interleave`)."""

from r4w_tpu_torch.fec import dvb_s2x, fountain
from r4w_tpu_torch.fec.block import (
    golay_decode,
    golay_encode,
    matrix_encode,
    repetition_decode,
    repetition_encode,
    syndrome,
)
from r4w_tpu_torch.fec.convolutional import (
    conv_encode,
    depuncture,
    map_decode,
    puncture,
    viterbi_decode,
    viterbi_decode_mxu,
)
from r4w_tpu_torch.fec.crc import CRC_PARAMS, crc_check, crc_compute, fletcher16
from r4w_tpu_torch.fec.galois import BCH, GF, ReedSolomon
from r4w_tpu_torch.fec.interleave import (
    block_deinterleave,
    block_interleave,
    patterned_deinterleave,
    patterned_interleave,
)
from r4w_tpu_torch.fec.ldpc import (
    ldpc_decode,
    ldpc_encode,
    ldpc_extract_data,
    make_regular_ldpc,
)
from r4w_tpu_torch.fec.polar import frozen_mask, polar_decode, polar_encode
from r4w_tpu_torch.fec.turbo import default_interleaver, turbo_decode, turbo_encode
from r4w_tpu_torch.ops.coding import hamming_decode, hamming_encode

__all__ = [
    "fountain", "dvb_s2x",
    "conv_encode", "viterbi_decode", "viterbi_decode_mxu", "map_decode", "puncture",
    "depuncture",
    "crc_compute", "crc_check", "fletcher16", "CRC_PARAMS",
    "repetition_encode", "repetition_decode", "golay_encode",
    "golay_decode", "matrix_encode", "syndrome",
    "GF", "ReedSolomon", "BCH",
    "ldpc_encode", "ldpc_decode", "ldpc_extract_data", "make_regular_ldpc",
    "turbo_encode", "turbo_decode", "default_interleaver",
    "polar_encode", "polar_decode", "frozen_mask",
    "block_interleave", "block_deinterleave",
    "patterned_interleave", "patterned_deinterleave",
    "hamming_encode", "hamming_decode",
]
