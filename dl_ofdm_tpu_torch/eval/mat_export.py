"""Golden `.mat` waveform export — the writer side of the MATLAB<->framework
interoperability contract.

Port of `dl_ofdm_tpu/eval/mat_export.py`.  The reference consumes
MATLAB-exported waveform files in `test_model_mat`
(`dev/py/ofdmreceiver_np_mp.py:143-188`) and the v1 archive tester
(`test_v1/test_ofdm_cdnn_awgn.py:88-119`): a `TX_bit_iq_<mod>_<chan>_FFT<N>
[_shortcp].mat` holding `Ch_Data` — complex waveform COLUMNS, one frame per
column, 1/3 of the receiver's scale (the loader multiplies by 3,
`ofdmreceiver_np_mp.py:171`) — and `txbits` (the flattened label bits).
No such files ship with the repo, so this module generates goldens from
the port's TX (`ofdm.tx.ofdm_modulate_frames_iq`), and `eval/mat_eval.py`
closes the loop with real file traffic.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from dl_ofdm_tpu_torch import resolve_device
from dl_ofdm_tpu_torch.eval.mat_eval import MOD_NAMES, mat_file_name
from dl_ofdm_tpu_torch.ofdm.plan import SubcarrierPlan
from dl_ofdm_tpu_torch.ofdm.tx import ofdm_modulate_frames_iq


def export_mat_waveforms(plan: SubcarrierPlan, nbits: int, channel: str,
                         n_frames: int, out_dir: str, seed: int = 0,
                         longcp: bool = True, bits: np.ndarray | None = None,
                         device=None) -> str:
    """Write a golden `TX_bit_iq_*.mat`; returns its path.

    The bits [n_frames, frame_size, nbits] are fair coin flips from a
    generator seeded with `seed` on `device` (`resolve_device`), or
    `bits` as given; the waveform is modulated on `device`."""
    import scipy.io as sio

    dev = resolve_device(device)
    if bits is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        bits_t = torch.randint(0, 2, (n_frames, plan.frame_size, nbits),
                               generator=gen, device=dev, dtype=torch.int32)
    else:
        bits_t = torch.tensor(np.asarray(bits), dtype=torch.int32, device=dev)
    wf = ofdm_modulate_frames_iq(bits_t, plan=plan).cpu().numpy()
    # file contract: complex columns [samples_per_frame, n_frames] at 1/3 of
    # the receiver scale (the loader multiplies by 3)
    wf_c = (wf[..., 0] + 1j * wf[..., 1]).reshape(n_frames, -1).T / 3.0
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, mat_file_name(nbits, channel, plan.nfft,
                                               longcp))
    sio.savemat(path, {"Ch_Data": wf_c.astype(np.complex128),
                       "txbits": bits_t.cpu().numpy().reshape(-1, 1)
                       .astype(np.uint8)})
    return path
