"""BER-vs-SNR sweep protocols and the CSV result schema.

Port of the single-device protocols of `dl_ofdm_tpu/eval/sweep.py:45-164`
(reference `dev/py/ofdmreceiver_np.py:59-91`: SNR -10:1:30, 20,000 frames
per point, CSV columns SNR,BER,Loss):

  * interleaved (default): all SNR points share each batch through a
    per-frame SNR vector; the input normalization takes its moments per
    SNR group (`batch_frames // n_points` frames), and per-point error and
    CE counts come back through the one-hot group mask;
  * `point_batch=True`: one SNR point per batch, normalization over the
    whole batch (the reference's protocol, `ofdmreceiver_np_mp.py:89`).

Counts accumulate on the device and are read once at the end of the sweep.
The mesh (`mesh=`) variants are a later slice.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterable

import numpy as np
import torch

from dl_ofdm_tpu_torch.train import metrics as M


@dataclasses.dataclass
class SweepResult:
    snr: np.ndarray
    ber: np.ndarray
    loss: np.ndarray

    def to_csv(self, path: str) -> str:
        """Reference CSV schema: header SNR,BER,Loss; SNR as index column."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write("SNR,BER,Loss\n")
            for s, b, l in zip(self.snr, self.ber, self.loss):
                f.write(f"{s},{b},{l}\n")
        return path


def interleaved_groups(snrs, batch_frames: int, device):
    """The interleaved batch layout: (snr_vec [B], onehot [B, n_points]),
    frames ordered repeat-major so every SNR point recurs through the batch
    (`sweep.py:88-99`, single device)."""
    n_pts = len(snrs)
    rep = max(1, batch_frames // n_pts, 4)
    snr_np = np.repeat(np.asarray(snrs, np.float32), rep)
    idx_np = np.repeat(np.arange(n_pts), rep)
    order = np.argsort(np.tile(np.arange(rep), n_pts), kind="stable")
    onehot = np.eye(n_pts, dtype=np.float32)[idx_np[order]]
    return (torch.from_numpy(snr_np[order]).to(device),
            torch.from_numpy(onehot).to(device))


@torch.no_grad()
def eval_batch(trainer, snr_vec: torch.Tensor, onehot: torch.Tensor,
               generator: torch.Generator | None = None,
               bits: torch.Tensor | None = None,
               unit_noise: torch.Tensor | None = None):
    """One interleaved batch -> (errors [n_points] int64, summed per-frame
    CE [n_points]) (`sweep.py:101-121`)."""
    bits, rx_in, _, _, _ = trainer.synthesize(
        snr_vec.shape[0], snr_vec, generator, norm_groups=onehot, bits=bits,
        unit_noise=unit_noise)
    logits, _ = trainer.model(rx_in)
    pred = M.bit_predictions(logits)
    err_per_frame = (pred != bits).sum(dim=(1, 2))
    errors = (err_per_frame[:, None] * onehot.to(torch.int64)).sum(dim=0)
    ce = M.frame_cross_entropy(logits, bits) @ onehot
    return errors, ce


@torch.no_grad()
def ber_sweep(trainer, generator: torch.Generator | None = None,
              snrs: Iterable[int] = range(-10, 31),
              frames_per_point: int = 20000,
              batch_frames: int = 2000,
              log_fn=print,
              point_batch: bool = False) -> SweepResult:
    """Run the BER sweep of `trainer.model` with data made on its device.

    `generator` (on `trainer.device`) drives every draw; the device's
    default generator when None."""
    snrs = list(snrs)
    n_pts = len(snrs)
    dev = trainer.device
    bits_per_frame = trainer.plan.frame_size * trainer.cfg.nbits
    tot_err = torch.zeros(n_pts, dtype=torch.int64, device=dev)
    tot_ce = torch.zeros(n_pts, dtype=torch.float64, device=dev)
    if point_batch:
        batch_frames = min(batch_frames, frames_per_point)
        n_calls = max(1, frames_per_point // batch_frames)
        frames = n_calls * batch_frames
        for i, snr in enumerate(snrs):
            snr_vec = torch.full((batch_frames,), float(snr), device=dev)
            for _ in range(n_calls):
                bits, rx_in, _, _, _ = trainer.synthesize(
                    batch_frames, snr_vec, generator)
                logits, _ = trainer.model(rx_in)
                tot_err[i] += (M.bit_predictions(logits) != bits).sum()
                tot_ce[i] += M.frame_cross_entropy(logits, bits).sum()
    else:
        snr_vec, onehot = interleaved_groups(snrs, batch_frames, dev)
        frames = snr_vec.shape[0] // n_pts
        n_calls = max(1, frames_per_point // frames)
        frames *= n_calls
        for _ in range(n_calls):
            errors, ce = eval_batch(trainer, snr_vec, onehot, generator)
            tot_err += errors
            tot_ce += ce
    bers = tot_err.cpu().numpy() / (frames * bits_per_frame)
    losses = tot_ce.cpu().numpy() / frames
    for snr, ber, loss in zip(snrs, bers, losses):
        log_fn(f"SNR: {snr:.2f}, BER: {ber:.8f}, Loss: {loss:f}")
    return SweepResult(np.asarray(snrs, dtype=float), np.asarray(bers),
                       np.asarray(losses))
