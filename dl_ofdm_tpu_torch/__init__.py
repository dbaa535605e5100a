"""dl_ofdm_tpu_torch — the PyTorch/CUDA port of `dl_ofdm_tpu`.

A second package beside the JAX one, ported slice by slice and tested
against it (`tests/test_torch_*.py`).  It imports torch and numpy, never
jax and never `dl_ofdm_tpu`: the few NumPy-only modules it needs from there
(`config`, `ofdm.plan`, `channel.profiles`) are copied.

The modules keep the JAX package's layout and names, so each one's
counterpart is found at the same path.  Complex data stays IQ-last
(`[..., 2]` real pairs) at every public function.  Entry points run on
`cuda` unless the caller passes `device="cpu"`; with no card and no
`device="cpu"` they raise (`resolve_device`).

Ported so far: the BER-sweep (serving) path with the `fft_like` complex
dense layer on a hand-written Hopper kernel (`csrc/complex_dense.cu`); the
training step of the basic `Trainer` on AWGN, static and Jakes-Doppler
(mobile) fading, with its two kernels (`csrc/fused_synth.cu`,
`csrc/fused_model.cu`); the PRNG probe (`csrc/philox_probe.cu`); and the
equalizer transfer-learning stage (`models/equalizers.py`,
`models/receiver.py`, `train/equalizer_loop.py`), whose static FIR runs on
`csrc/fir_shift_accum.cu`; and the device mesh (`parallel/`): data and
tensor parallelism over the ranks of a [dp, tp] grid in one process for
training, the equalizer stage and the sweeps (`parallel/tp.py`), and the
sequence-parallel halo FIR, whose ring exchange runs on
`csrc/ring_exchange.cu`; the bf16 receiver (`compute_dtype`,
through `complex_dense`'s bf16 mode); and the entry points: `cli.py`,
`runner.py`, the checkpoints and resume payloads of `train/checkpoint.py`
and `utils/` (`timing`, `observability`); the classical-receiver
baselines (`baselines/`: the MATLAB-parity link, estimators 1-10, the
CLI's `baseline`), whose static channel runs on `fir_shift_accum`; and
the rest of `eval/` (the `.mat` waveform interop, plots); and the
ablation and legacy paths (`DNNReceiver`, `models/e2e_blocks.py`,
`ofdm/legacy_tx.py`, `ofdm/papr.py`, `channel/legacy.py`, the AWGN and
complex FFT FIR variants).  `ofdm/papr.py::clip_papr` and the complex FFT
variants take complex tensors, as the JAX functions do.
`utils/cache.py` (JAX's persistent compilation cache) has no counterpart:
PyTorch runs eagerly, and `ops/cuda_build.py` builds each kernel once per
source.
"""
from __future__ import annotations

import torch

from dl_ofdm_tpu_torch.config import (  # noqa: F401
    OFDMConfig, ChannelConfig, TrainConfig)


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks for
    another.  Raises when CUDA is asked for (or implied) and there is none:
    the port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dl_ofdm_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
