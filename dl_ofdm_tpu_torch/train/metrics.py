"""The sweep's metrics: hard bit decisions and per-frame cross-entropy.

Port of `bit_predictions` (`dl_ofdm_tpu/train/metrics.py`) and of the CE
the sweep computes inline (`dl_ofdm_tpu/eval/sweep.py:117-121`).
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
