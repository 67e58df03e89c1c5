"""Hand-written Hopper kernels, each beside its plain PyTorch version."""

from r4w_tpu_torch.kernels.dechirp import (
    dechirp_power,
    dechirp_power_cuda,
    dechirp_power_dispatch,
)
from r4w_tpu_torch.kernels.fir import fir_decimate, fir_decimate_cuda, fir_decimate_dispatch
from r4w_tpu_torch.kernels.nco import (
    nco_mix,
    nco_mix_cuda,
    nco_mix_dispatch,
    nco_rotate,
    nco_rotate_cuda,
    nco_rotate_dispatch,
)
from r4w_tpu_torch.kernels.recurrence import (
    first_order_recurrence,
    first_order_recurrence_cuda,
    first_order_recurrence_dispatch,
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
    "fir_decimate",
    "fir_decimate_cuda",
    "fir_decimate_dispatch",
    "first_order_recurrence",
    "first_order_recurrence_cuda",
    "first_order_recurrence_dispatch",
    "nco_mix",
    "nco_mix_cuda",
    "nco_mix_dispatch",
    "nco_rotate",
    "nco_rotate_cuda",
    "nco_rotate_dispatch",
    "viterbi_forward",
    "viterbi_forward_cuda",
    "viterbi_forward_dispatch",
    "viterbi_traceback",
    "viterbi_traceback_cuda",
    "viterbi_traceback_dispatch",
]
