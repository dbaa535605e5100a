"""Losses and metrics of training and the sweep.

Port of `dl_ofdm_tpu/train/metrics.py` (reference `dev/py/util.py:37-48`,
`dev/py/ofdmreceiver_np.py:154-171`) and of the per-frame CE the sweep
computes inline (`dl_ofdm_tpu/eval/sweep.py:117-121`).  Confusion counts
stay integers (int64) at any batch size.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def bit_predictions(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the 2-class axis as a strict compare: ties go to 0."""
    return (logits[..., 1] > logits[..., 0]).to(torch.int32)


def frame_cross_entropy(logits: torch.Tensor,
                        bits: torch.Tensor) -> torch.Tensor:
    """[B, ..., 2] logits, [B, ...] bits -> [B] mean per-bit 2-class CE."""
    z = logits.reshape(logits.shape[0], -1, 2)
    logp = F.log_softmax(z, dim=-1)
    y = bits.reshape(bits.shape[0], -1, 1).to(torch.int64)
    return -torch.gather(logp, -1, y)[..., 0].mean(dim=1)


def cross_entropy(logits: torch.Tensor, y_bits: torch.Tensor,
                  double_softmax: bool = False) -> torch.Tensor:
    """Mean per-bit 2-class cross entropy.  `double_softmax=True` applies
    softmax first, the reference's quirk (`ofdmreceiver_np.py:155-159`)."""
    z = logits.reshape(-1, 2)
    if double_softmax:
        z = torch.softmax(z, dim=-1)
    logp = F.log_softmax(z, dim=-1)
    y = y_bits.reshape(-1, 1).to(torch.int64)
    return -torch.gather(logp, -1, y).mean()


def confusion_matrix(y_bits: torch.Tensor,
                     pred_bits: torch.Tensor) -> torch.Tensor:
    """2x2 bit confusion matrix [true, pred] as int64 counts."""
    y = y_bits.reshape(-1).to(torch.int64)
    p = pred_bits.reshape(-1).to(torch.int64)
    n11 = torch.sum(y * p)
    n10 = torch.sum(y) - n11
    n01 = torch.sum(p) - n11
    n00 = y.shape[0] - n11 - n10 - n01
    return torch.stack([torch.stack([n00, n01]), torch.stack([n10, n11])])


def ber_from_confusion(conf: torch.Tensor):
    """(log BER, linear BER), both float32, from a 2x2 confusion matrix."""
    total = torch.clamp(conf.sum(), min=1)
    ber = ((conf[0, 1] + conf[1, 0]) / total).to(torch.float32)
    return torch.log(torch.clamp(ber, min=1e-12)), ber


def _sum_sq(v) -> torch.Tensor:
    """||v||^2; for a leaf split over tp ranks (a list of its shards), the
    shards' sums of squares added in rank order on the first's device."""
    if isinstance(v, list):
        return sum(torch.sum(s * s).to(v[0].device) for s in v)
    return torch.sum(v * v)


def l2_regularization(params: dict, scale: float = 0.01,
                      match: str = "Dense") -> torch.Tensor:
    """Sum of scale*||w||^2 over the `state_dict` entries whose name holds
    `match`: kernels and biases of the Dense layers, never `fft_like` (the
    reference's `l2(0.01)` on every `tf.layers.dense`).  An entry may be
    the list of a split leaf's shards (each leaf counted once), on the
    devices of its tp ranks; the sum is on the first entry's device."""
    terms = [scale * _sum_sq(v) for k, v in params.items() if match in k]
    return torch.stack([t.to(terms[0].device) for t in terms]).sum()
