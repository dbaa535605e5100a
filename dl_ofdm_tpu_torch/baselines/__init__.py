"""The classical-receiver baselines (port of `dl_ofdm_tpu/baselines/`):
the MATLAB-parity link (`matlab_link`), estimators 1-10 (`estimators`,
`cp_enhanced`, `interp`, `pdp`) and the BER benchmark (`classical_rx`)."""
from dl_ofdm_tpu_torch.baselines.estimators import ESTIMATOR_NAMES  # noqa: F401
from dl_ofdm_tpu_torch.baselines.pdp import mmse_pdp, rms_delay_spread  # noqa: F401
