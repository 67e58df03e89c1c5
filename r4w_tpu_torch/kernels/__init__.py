"""Hand-written Hopper kernels, each beside its plain PyTorch version."""

from r4w_tpu_torch.kernels.dechirp import (
    dechirp_power,
    dechirp_power_cuda,
    dechirp_power_dispatch,
)

__all__ = ["dechirp_power", "dechirp_power_cuda", "dechirp_power_dispatch"]
