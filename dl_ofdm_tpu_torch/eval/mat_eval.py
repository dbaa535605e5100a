"""Cross-implementation validation on MATLAB-exported waveforms.

Port of `dl_ofdm_tpu/eval/mat_eval.py`.  Parity with `test_model_mat`
(`dev/py/ofdmreceiver_np_mp.py:143-188`) and the v1 archive tester
(`test_v1/test_ofdm_cdnn_awgn.py:88-119`): load
`TX_bit_iq_<mod>_<chan>_FFT<N>[_shortcp].mat` containing `Ch_Data` (complex
waveform columns) and `txbits`, scale IQ by 3 as the reference does
(`:171`), add AWGN per SNR point, and evaluate a trained receiver — the
MATLAB<->framework interoperability contract (shape [n_fr, nsym, K+CP, 2]).
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from dl_ofdm_tpu_torch import resolve_device
from dl_ofdm_tpu_torch.channel.awgn import awgn_channel
from dl_ofdm_tpu_torch.eval.sweep import SweepResult
from dl_ofdm_tpu_torch.ops.norms import batch_norm_ref
from dl_ofdm_tpu_torch.train import metrics as M
from dl_ofdm_tpu_torch.train.loop import first_output

MOD_NAMES = ["BPSK", "QPSK", "8QAM", "16QAM"]


def mat_file_name(nbits: int, channel: str, nfft: int,
                  longcp: bool = True) -> str:
    cpstr = "" if longcp else "_shortcp"
    return f"TX_bit_iq_{MOD_NAMES[nbits - 1]}_{channel}_FFT{nfft}{cpstr}.mat"


def load_mat_waveforms(data_dir: str, nbits: int, channel: str, nfft: int,
                       nsymbol: int, frame_size: int, longcp: bool = True,
                       device=None):
    """Returns (chan_iq [n_fr, nsym, K+CP, 2] float32 x3-scaled, bits
    [n_fr, frame_size, nbits] int32), on `device` (`resolve_device`)."""
    import scipy.io as sio

    dev = resolve_device(device)
    mat = sio.loadmat(os.path.join(data_dir, mat_file_name(nbits, channel,
                                                           nfft, longcp)))
    iq = np.transpose(mat["Ch_Data"], (1, 0))
    n_fr = iq.shape[0]
    iq = iq.reshape(n_fr, nsymbol, -1)
    chan_iq = 3.0 * np.stack([iq.real, iq.imag], axis=-1).astype(np.float32)
    bits = mat["txbits"].reshape(n_fr, frame_size, nbits).astype(np.int32)
    return torch.from_numpy(chan_iq).to(dev), torch.from_numpy(bits).to(dev)


@torch.no_grad()
def mat_point(model: torch.nn.Module, chan_iq: torch.Tensor,
              bits: torch.Tensor, snr: float,
              generator: torch.Generator | None = None,
              unit_noise: torch.Tensor | None = None):
    """One SNR point over the file's waveforms (`mat_eval.py:46-53`):
    (logits, confusion counts, CE).  The bf16 unit noise comes from
    `generator`, or is `unit_noise` as given."""
    snr_vec = torch.full((chan_iq.shape[0],), float(snr),
                         device=chan_iq.device)
    y, _ = awgn_channel(chan_iq, snr_vec, generator, unit_noise=unit_noise)
    logits = first_output(model(batch_norm_ref(y)))
    conf = M.confusion_matrix(bits, M.bit_predictions(logits))
    return logits, conf, M.cross_entropy(logits, bits)


def evaluate_on_mat(model: torch.nn.Module, chan_iq: torch.Tensor,
                    bits: torch.Tensor, snrs=range(-10, 31), seed: int = 0,
                    log_fn=print,
                    unit_noise: Sequence[torch.Tensor] | None = None
                    ) -> SweepResult:
    """Sweep AWGN over the fixed MATLAB waveforms and measure BER, with a
    trained receiver (its weights loaded) on the waveforms' device: the
    noise from a generator seeded with `seed`, or `unit_noise[i]` at
    point i."""
    gen = torch.Generator(device=chan_iq.device).manual_seed(seed)
    bers, losses = [], []
    for i, snr in enumerate(snrs):
        _, conf, ce = mat_point(model, chan_iq, bits, snr, gen,
                                None if unit_noise is None else unit_noise[i])
        ber = float(M.ber_from_confusion(conf)[1])
        bers.append(ber)
        losses.append(float(ce))
        log_fn(f"SNR: {snr:.2f}, BER: {ber:.8f}, Loss: {float(ce):f}")
    return SweepResult(np.asarray(list(snrs), dtype=float),
                       np.asarray(bers), np.asarray(losses))
