"""OFDM transmitter: constellations, subcarrier plans and the TX operator
(the names of `dl_ofdm_tpu/ofdm/__init__.py`)."""
from dl_ofdm_tpu_torch.ofdm.constellation import (  # noqa: F401
    const_table,
    bits_to_symbols,
    matlab_gray_table,
    demod_nearest,
    bits_from_indices,
    indices_from_bits,
)
from dl_ofdm_tpu_torch.ofdm.plan import SubcarrierPlan, lte_dl_cfg  # noqa: F401
from dl_ofdm_tpu_torch.ofdm.tx import ofdm_modulate_frames, OFDMTx  # noqa: F401
from dl_ofdm_tpu_torch.ofdm.papr import clip_papr, clip_papr_iq  # noqa: F401
