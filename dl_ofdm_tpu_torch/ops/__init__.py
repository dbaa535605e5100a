"""Complex real-pair ops, norms and the hand-written CUDA kernels (the
names of `dl_ofdm_tpu/ops/__init__.py`; nothing is built on import)."""
from dl_ofdm_tpu_torch.ops.complex_ops import (  # noqa: F401
    ComplexDense,
    ComplexConv2d,
    complex_mul,
    iq_to_complex,
    complex_to_iq,
)
from dl_ofdm_tpu_torch.ops.norms import (  # noqa: F401
    frame_layer_norm, batch_norm_ref, leaky_relu)
