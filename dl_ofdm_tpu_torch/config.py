"""Configuration dataclasses, copied from `dl_ofdm_tpu/config.py`.

The port keeps its own copy so that it imports nothing of the JAX package.
What follows is the JAX module's docstring.

Configuration dataclasses (replaces the reference's ~20 `tf.app.flags` per program).

The reference duck-types its flag objects so they can be built programmatically
(`test_v1/test_ofdm_cdnn_awgn.py:31-49`); here configs are frozen dataclasses,
usable both from the CLI (`dl_ofdm_tpu/cli.py` in the JAX package) and as
plain values.  Flag parity map (reference `dev/py/ofdmreceiver_np.py:30-53`,
`dev/py/ofdmreceiver_np_mp.py:32-59`):

  nbits nfft nsymbol npilot nguard nfilter pilot cp longcp -> OFDMConfig
  channel mobile                                            -> ChannelConfig
  SNR batch_size max_epoch_num early_stop init_learning seed
  msg_length split token save_dir opt load_model test       -> TrainConfig
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class OFDMConfig:
    """Static OFDM link parameters; the derived subcarrier plan lives in
    `dl_ofdm_tpu_torch.ofdm.plan.SubcarrierPlan` (reference `dev/py/ofdm.py:198-273`)."""

    nbits: int = 1            # bits/symbol: 1=BPSK 2=QPSK 3=8QAM 4=16QAM
    nfft: int = 64            # FFT size (subcarriers)
    nsymbol: int = 7          # OFDM symbols per frame
    npilot: int = 8           # pilots/symbol (non-lte pilot schemes only)
    nguard: int = 8           # guard subcarriers/symbol (non-lte schemes only)
    nfilter: int = 64         # filters of the learned-DFT (fft_like) layer
    pilot: str = "lte"        # 'lte' | 'scattered' | 'block' | 'comb'
    cp: bool = True           # receiver keeps the CP (CP-exploitation path)
    longcp: bool = True       # CP length: 25% of nfft if True else 7%
    compute_dtype: Optional[str] = None  # 'bfloat16': receiver GEMMs run on
                                         # bf16 activations (f32 params/
                                         # accumulation/logits) — halves HBM
                                         # traffic on the memory-bound forward;
                                         # 'float32' computes as None does
                                         # (the JAX CLI's third choice) but
                                         # keeps the fused route closed

    def __post_init__(self):
        if self.pilot not in ("lte", "scattered", "block", "comb"):
            raise ValueError(f"Unsupported pilot type {self.pilot!r}")
        if self.compute_dtype not in (None, "bfloat16", "float32"):
            raise ValueError(
                f"Unsupported compute_dtype {self.compute_dtype!r}")
        if not 1 <= self.nbits <= 4:
            raise ValueError("nbits must be in 1..4")


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """Channel selection (reference `dev/py/radio.py:277-510`)."""

    channel: str = "AWGN"     # AWGN | Flat | EPA | EVA | ETU | Custom |
                              # mixRayleigh | mixAll
    mobile: bool = False      # enable Jakes Doppler (per-profile Fd)
    mix_doppler: bool = False # alternate Doppler on/off across frames ("mix")

    @property
    def is_awgn(self) -> bool:
        return self.channel.lower() == "awgn"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training/eval parameters (reference flag defaults preserved)."""

    snr: float = 3.0
    batch_size: int = 512          # frames per step = batch_size // nsymbol
    msg_length: int = 100800       # symbols per epoch (frames = msg_length//nsymbol)
    max_epoch_num: int = 1000
    early_stop: int = 100
    init_learning: float = 1e-3
    lr_decay_steps: int = 500      # exponential_decay(0.001, 500, 0.98, staircase)
    lr_decay_rate: float = 0.98
    seed: int = 1
    token: str = "OFDM"
    save_dir: str = "./output/"
    opt: int = 0                   # equalizer variant id (registry key)
    reg_coeff: float = 1e-4        # L2-regularization coefficient (basic stage)
    double_softmax: bool = False   # reproduce reference quirk of CE on softmaxed
                                   # outputs (ofdmreceiver_np.py:155-159); the
                                   # default trains on true logits.
    grad_clip: float = 0.0         # optax.clip_by_global_norm when > 0
                                   # (extension; the reference has no clipping)
    curriculum_offset: Optional[float] = None  # dB shift of the equalizer-stage
                                   # SNR curriculum grid; None = auto
                                   # (+2.5 dB per extra modulation bit,
                                   # see train/curriculum.py)
    curriculum_tail: bool = False  # extended-tail SNR grid 0-33 dB with mass
                                   # shifted into the 27-33 bins — fixes the
                                   # 30 dB test point sitting beyond the
                                   # reference grid's 27 dB training edge
                                   # (see train/curriculum.py SNR_TAIL_*)
    fused_model_matmul_dtype: str = "bfloat16"  # GEMM input dtype inside
                                   # the fused DCCN fwd+bwd kernel
                                   # (ops/fused_model.py): measured on chip
                                   # (p19 control + direct probe) the two
                                   # modes produce BIT-IDENTICAL gradients —
                                   # Mosaic lowers the f32 dots to the same
                                   # single-pass bf16-input MXU op — and the
                                   # explicit bf16 casts only shrink VMEM
                                   # operand traffic (~25% faster), so bf16
                                   # is the default.  'float32' remains for
                                   # CPU interpret-mode exactness (tests).
    best_metric: str = "ce"        # epoch best-model selection: 'ce' (default;
                                   # documented deviation — the metric the
                                   # gradient actually optimizes) or 'total'
                                   # (reference parity: CE + reg + log-BER
                                   # total cost, `ofdmreceiver_np.py:268-272`
                                   # — includes the noisy non-differentiable
                                   # log-BER term)

    def frames_per_epoch(self, nsymbol: int = 7) -> int:
        """Frames per epoch = msg_length // nsymbol (symbols per frame)."""
        return self.msg_length // nsymbol
