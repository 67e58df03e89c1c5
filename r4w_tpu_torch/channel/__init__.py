from r4w_tpu_torch.channel.channel import (
    ChannelConfig,
    apply_channel,
    awgn,
    block_fading,
    cfo,
    measure_snr,
    multipath_2ray,
    rayleigh,
    rician,
    theoretical_ber_awgn,
)
from r4w_tpu_torch.channel.doppler import (
    flat_doppler_shift,
    gaussian_doppler_fading,
    jakes_fading,
    velocity_to_doppler,
)
from r4w_tpu_torch.channel.tdl import (
    TDL_PROFILES,
    coherence_bandwidth,
    profile_taps,
    rms_delay_spread,
    tdl_channel,
)

__all__ = [
    "ChannelConfig",
    "apply_channel",
    "awgn",
    "block_fading",
    "cfo",
    "measure_snr",
    "multipath_2ray",
    "rayleigh",
    "rician",
    "theoretical_ber_awgn",
    "flat_doppler_shift",
    "gaussian_doppler_fading",
    "jakes_fading",
    "velocity_to_doppler",
    "TDL_PROFILES",
    "coherence_bandwidth",
    "profile_taps",
    "rms_delay_spread",
    "tdl_channel",
]
