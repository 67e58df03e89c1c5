"""IQ file I/O (io/mod.rs family root: io/format.rs, SigMF).

PyTorch counterpart of ``r4w_tpu.io``."""

from r4w_tpu_torch.io import iqformat, sigmf
from r4w_tpu_torch.io.iqformat import (
    bytes_per_sample,
    convert_iq_file,
    decode_samples,
    encode_samples,
    list_formats,
    read_iq_file,
    write_iq_file,
)
from r4w_tpu_torch.io.sigmf import SigmfMeta, read_sigmf, write_sigmf

__all__ = [
    "iqformat", "sigmf",
    "bytes_per_sample", "convert_iq_file", "decode_samples",
    "encode_samples", "list_formats", "read_iq_file", "write_iq_file",
    "SigmfMeta", "read_sigmf", "write_sigmf",
]
