"""BER-vs-SNR sweep protocols and the result CSV schema (`sweep`), the
MATLAB `.mat` waveform interop (`mat_export`, `mat_eval`) and BER plots
(`plots`); the names of `dl_ofdm_tpu/eval/__init__.py`."""
from dl_ofdm_tpu_torch.eval.sweep import (  # noqa: F401
    ber_sweep, cross_channel_sweep, SweepResult)
