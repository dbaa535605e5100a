"""Training loops, metrics and checkpoint I/O (the names of
`dl_ofdm_tpu/train/__init__.py`)."""
from dl_ofdm_tpu_torch.train.metrics import (  # noqa: F401
    confusion_matrix, ber_from_confusion, cross_entropy, l2_regularization)
from dl_ofdm_tpu_torch.train.loop import Trainer, TrainState  # noqa: F401
