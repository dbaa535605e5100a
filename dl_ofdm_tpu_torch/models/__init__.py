"""Receivers: the DCCN, the DNN ablation, the equalizers and the composed
receivers."""
from dl_ofdm_tpu_torch.models.dccn import (  # noqa: F401
    DCCNReceiver, DNNReceiver, RxOutputs)
from dl_ofdm_tpu_torch.models.equalizers import (  # noqa: F401
    EQUALIZER_REGISTRY, Equalizer)
from dl_ofdm_tpu_torch.models.receiver import EqualizedReceiver  # noqa: F401
