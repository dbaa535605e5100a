"""The receiver and its data plane: bits -> TX -> channel -> AWGN -> norm.

Port of the parts of `dl_ofdm_tpu/train/loop.py::Trainer` that the BER
sweep runs (`__init__`, `synthesize` at `loop.py:230-254`, the model).  The
optimizer, the training step and the fused kernels of the training path
are later slices.  Random draws come from an explicit `torch.Generator` in
place of `jax.random` keys; the streams differ from JAX's, so the tests
hand both packages the same numpy draws (`bits=`, `unit_noise=`).
"""
from __future__ import annotations

import torch

from dl_ofdm_tpu_torch import resolve_device
from dl_ofdm_tpu_torch.channel.awgn import awgn_channel
from dl_ofdm_tpu_torch.channel.rayleigh import RayleighChannel
from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
from dl_ofdm_tpu_torch.models.dccn import DCCNReceiver
from dl_ofdm_tpu_torch.ofdm.plan import build_plan
from dl_ofdm_tpu_torch.ofdm.tx import ofdm_modulate_frames_iq
from dl_ofdm_tpu_torch.ops.norms import batch_norm_ref


class Trainer:
    """The basic DCCN receiver on an AWGN or static fading channel.

    `device` defaults to `cuda` and raises where there is none
    (`resolve_device`); the model's parameters live there."""

    def __init__(self, cfg: OFDMConfig, tc: TrainConfig, channel: str = "AWGN",
                 mobile: bool = False,
                 device: str | torch.device | None = None):
        if cfg.compute_dtype is not None:
            raise NotImplementedError(
                "OFDMConfig.compute_dtype (bf16 receiver GEMMs) is not "
                "ported yet")
        self.device = resolve_device(device)
        self.cfg, self.tc = cfg, tc
        self.plan = build_plan(cfg)
        self.model = DCCNReceiver(
            nbits=cfg.nbits, nfft=cfg.nfft, cp_len=self.plan.cp_len,
            nfilter=cfg.nfilter, frame_size=self.plan.frame_size,
            nsymbol=cfg.nsymbol, keep_cp=cfg.cp).to(self.device)
        self.channel = RayleighChannel(
            channel=channel, nfft=cfg.nfft,
            sample_rate=self.plan.sample_rate, mobile=mobile)

    def synthesize(self, n_frames: int, snr_db: torch.Tensor,
                   generator: torch.Generator | None = None,
                   norm_groups: torch.Tensor | None = None,
                   bits: torch.Tensor | None = None,
                   unit_noise: torch.Tensor | None = None):
        """bits -> waveform -> fading -> AWGN -> normalized receiver input.

        Returns (bits [B, frame, nbits] int32, rx_in [B, S, K+CP, 2],
        h_freq, noise_power, waveform), as the JAX method does.  Draws bits,
        then tap gains, then unit noise from `generator`; `bits=` and
        `unit_noise=` replace the first and last draws.  `norm_groups`
        [B, G] one-hot: per-group normalization statistics (the interleaved
        sweep)."""
        dev = self.device
        if bits is None:
            bits = torch.randint(
                0, 2, (n_frames, self.plan.frame_size, self.cfg.nbits),
                generator=generator, device=dev, dtype=torch.int32)
        wf = ofdm_modulate_frames_iq(bits, self.plan)        # [B, S, K+CP, 2]
        ch = self.channel(wf, generator)
        y_iq, noise_pwr = awgn_channel(ch.y, snr_db, generator,
                                       unit_noise=unit_noise)
        rx_in = batch_norm_ref(y_iq, group_onehot=norm_groups)
        return bits, rx_in, ch.h_freq, noise_pwr, wf
