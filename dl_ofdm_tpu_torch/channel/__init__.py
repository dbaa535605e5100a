"""AWGN and 3GPP Rayleigh channels, fractional-delay FIR (the names of
`dl_ofdm_tpu/channel/__init__.py`)."""
from dl_ofdm_tpu_torch.channel.profiles import (  # noqa: F401
    TapProfile, get_profile, PROFILE_NAMES)
from dl_ofdm_tpu_torch.channel.awgn import awgn_channel  # noqa: F401
from dl_ofdm_tpu_torch.channel.rayleigh import (  # noqa: F401
    RayleighChannel, ChannelOut)
