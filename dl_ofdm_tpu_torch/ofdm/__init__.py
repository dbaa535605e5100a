"""OFDM transmitter: constellations, subcarrier plans and the TX operator."""
from dl_ofdm_tpu_torch.ofdm.papr import clip_papr, clip_papr_iq  # noqa: F401
