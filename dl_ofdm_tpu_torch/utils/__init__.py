"""Timing and observability utilities (port of `dl_ofdm_tpu/utils/`).

`utils/cache.py` has no counterpart: PyTorch runs eagerly and the port's
kernels are built once per source by `ops/cuda_build.py`.
"""
from dl_ofdm_tpu_torch.utils.observability import (  # noqa: F401
    Throughput, dump_constellation, profile_trace)
