"""Hand-written Hopper kernels, each beside its plain PyTorch version."""

from r4w_tpu_torch.kernels.dechirp import (
    dechirp_power,
    dechirp_power_cuda,
    dechirp_power_dispatch,
)
from r4w_tpu_torch.kernels.viterbi import (
    viterbi_forward,
    viterbi_forward_cuda,
    viterbi_forward_dispatch,
    viterbi_traceback,
    viterbi_traceback_cuda,
    viterbi_traceback_dispatch,
)

__all__ = [
    "dechirp_power",
    "dechirp_power_cuda",
    "dechirp_power_dispatch",
    "viterbi_forward",
    "viterbi_forward_cuda",
    "viterbi_forward_dispatch",
    "viterbi_traceback",
    "viterbi_traceback_cuda",
    "viterbi_traceback_dispatch",
]
