"""MATLAB-parity OFDM link for the classical-baseline suite.

Port of `dl_ofdm_tpu/baselines/matlab_link.py`.  The reference's classical
receivers are benchmarked on a slightly different link than its Python
DCCN path (`dev/m/OFDM_Benchmark_dev.m`):

  * qammod(...,'gray') constellations (unscaled) rather than the Python maps;
  * pilot power tied to the constellation peak: txamp*sqrt(1/2)*(1+1j)
    (`:251-253`);
  * scaled transforms: IFFT_Data = (N/sqrt(N-2*Np)) * ifft(Data)
    and Rx_Freq = (sqrt(N-2*Np)/N) * fft(Rx) (`:256,339`);
  * per-symbol PAPR-8 clip (`:260-267`);
  * physically-normalized Rayleigh path gains (`rayleighchan`
    NormalizePathGains) and a CAUSAL channel filter (`filter(h, x)`), i.e.
    full-convolution prefix rather than np.convolve 'same' (`:283-301`);
  * awgn(...,'measured'): noise power = measured mean signal power / SNR.

A link lives on one device and keeps its constants there (tables, index
tensors).  Each random draw comes from the caller's `torch.Generator`, in
the order transmit, fade, noise, or is injected (`sym_idx=`, `z=`,
`theta=`, `unit_noise=`) so that tests feed both packages the same draws.
The static channel's causal filter is `channel.fir.fir_same_iq` with zero
offsets: on a card one launch of the `fir_shift_accum` kernel a batch.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from dl_ofdm_tpu_torch.channel import fir
from dl_ofdm_tpu_torch.channel.doppler import (jakes_gains_from_phases,
                                              jakes_phases)
from dl_ofdm_tpu_torch.channel.profiles import get_profile
from dl_ofdm_tpu_torch.ofdm.constellation import (_bit_table_np,
                                                 _matlab_table_np,
                                                 demod_nearest,
                                                 matlab_gray_table)
from dl_ofdm_tpu_torch.ofdm.plan import SubcarrierPlan
from dl_ofdm_tpu_torch.ops import cfloat

# MATLAB Fd table (`OFDM_Benchmark_dev.m:93-108`) — note ETU is 70 Hz here
# vs 300 Hz in the reference Python code (known inconsistency, SURVEY 7.3).
MATLAB_FD = {"awgn": 0.0, "flat": 0.0, "epa": 5.0, "eva": 70.0, "etu": 70.0,
             "custom": 80.0}


@dataclasses.dataclass
class MatlabLinkOut:
    y: torch.Tensor            # [B, S, K+CP, 2] channel output (pre-noise)
    g: torch.Tensor            # [B, S, K, 2] ground-truth channel DFT


class MatlabLink:
    def __init__(self, plan: SubcarrierPlan, m_order: int,
                 channel: str = "flat", mobile: bool = False,
                 per_sample: bool = False, device=None):
        """`per_sample=True` applies the mobile fading as MATLAB's
        `filter(rayleighchan, x)` does — per-SAMPLE time-varying tap gains,
        causal, state continuous across symbol boundaries within the frame
        (`dev/m/OFDM_Benchmark_dev.m:277-311`) — instead of the
        symbol-averaged FIR (documented deviation #7).  The mobile ground
        truth G then averages the SAME per-sample gains over every sample
        instant in the symbol (exact G3d semantics, `:303-309`).

        `device`: where the link's constants and every tensor it makes
        live (the CPU when None)."""
        dev = torch.device("cpu" if device is None else device)
        self.device = dev
        self.plan = plan
        self.m = m_order
        self.nbits = int(np.log2(m_order))
        self.channel = channel.lower()
        self.mobile = mobile
        self.per_sample = per_sample
        self.table_iq = matlab_gray_table(m_order, dev)
        txamp = float(np.abs(_matlab_table_np(m_order)).max())
        pv = txamp * np.sqrt(0.5)
        self.pilot_iq = torch.tensor([pv, pv], dtype=torch.float32,
                                     device=dev)
        # scaled-transform factor N/sqrt(N-2*Np)
        self.tx_scale = plan.nfft / np.sqrt(plan.nfft - 2 * plan.n_pilot)
        self.profile = get_profile(self.channel, plan.sample_rate,
                                   weighting="physical")
        self.fd = MATLAB_FD[self.channel] if mobile else 0.0
        self.data_sc = torch.from_numpy(plan.data_sc).to(dev)
        self.pilot_sc = torch.from_numpy(plan.pilot_sc).to(dev)
        self.bit_table = torch.from_numpy(_bit_table_np(self.nbits)).to(dev)
        self.coeff = torch.tensor(self.profile.ch_coeff, dtype=torch.float32,
                                  device=dev)
        self.alpha = torch.tensor(self.profile.alpha_matrix,
                                  dtype=torch.float32, device=dev)

    # -- transmitter ---------------------------------------------------------
    def transmit(self, n_frames: int, generator: torch.Generator | None = None,
                 sym_idx: torch.Tensor | None = None) -> tuple:
        """Random symbols -> time-domain frames (with CP, PAPR-clipped):
        (sym_idx [B, frame_size] int64, clipped [B, S, K+CP, 2])."""
        plan = self.plan
        if sym_idx is None:
            sym_idx = torch.randint(0, self.m, (n_frames, plan.frame_size),
                                    generator=generator, device=self.device)
        sym_iq = self.table_iq[sym_idx]
        grid = torch.zeros(n_frames, plan.nsymbol * plan.nfft, 2,
                           device=self.device)
        grid[:, self.data_sc] = sym_iq
        grid[:, self.pilot_sc] = self.pilot_iq
        grid = grid.reshape(n_frames, plan.nsymbol, plan.nfft, 2)
        time = self.tx_scale * cfloat.idft_iq(grid)
        with_cp = torch.cat([time[:, :, -plan.cp_len:], time], dim=2)
        # PAPR-8 clip, per symbol (MATLAB column = symbol)
        pwr = cfloat.abs2_iq(with_cp)
        thresh = 8.0 * pwr.mean(dim=2, keepdim=True)
        scale = torch.sqrt(thresh / torch.clamp(pwr, min=1e-20))
        clipped = torch.where((pwr > thresh)[..., None],
                              with_cp * scale[..., None], with_cp)
        return sym_idx, clipped

    # -- channel -------------------------------------------------------------
    def fade(self, tx: torch.Tensor, generator: torch.Generator | None = None,
             z: torch.Tensor | None = None,
             theta: tuple | None = None) -> MatlabLinkOut:
        """Rayleigh fading with causal filtering + per-symbol ground truth.

        z: [B, taps, 2] CN(0, 1) tap gains of a static channel to use
        instead of drawing them; theta: (th_re, th_im) [B, 48, taps] Jakes
        phases of a mobile one."""
        plan = self.plan
        b, s, n_sc, _ = tx.shape
        p = self.profile
        if self.channel == "awgn":
            g = torch.zeros(b, s, plan.nfft, 2, device=tx.device)
            g[..., 0] = 1.0
            return MatlabLinkOut(tx, g)
        if self.fd > 0.1:
            if theta is None:
                theta = jakes_phases(b, p.n_taps, generator, tx.device)
            if self.per_sample:
                return self._fade_per_sample(tx, theta)
            # MATLAB's mobile ground truth averages G over the sample
            # instants within each symbol (`OFDM_Benchmark_dev.m:303-309`);
            # the DFT is linear in the gains, so average the Jakes gains at
            # `n_sub` intra-symbol instants (the filtering itself uses the
            # symbol-averaged kernel — a documented approximation of
            # MATLAB's per-sample time-varying filter).
            n_sub = 8
            t_sym = n_sc / plan.sample_rate
            t = (torch.arange(s * n_sub, dtype=torch.float32, device=tx.device)
                 * (t_sym / n_sub))
            z_fine = jakes_gains_from_phases(
                *theta, torch.full((b,), self.fd, device=tx.device), t,
                p.n_taps)                          # [B, S*n_sub, taps, 2]
            zck = z_fine.reshape(b, s, n_sub, p.n_taps, 2).mean(dim=2)
        else:
            if z is None:
                z = torch.randn(b, p.n_taps, 2, generator=generator,
                                device=tx.device) / math.sqrt(2.0)
            zck = z[:, None].expand(b, s, p.n_taps, 2)
        a_taps = zck * self.coeff[:, None]
        gt = torch.einsum("bstc,tf->bsfc", a_taps, self.alpha)  # [B, S, F, 2]
        g = cfloat.dft_iq(gt, plan.nfft)
        offsets = np.zeros(b, dtype=np.int64)              # causal filter(h, x)
        if self.fd > 0.1:
            # history length n_taps (< n_fir): reference parity with the
            # Python Doppler path (`dev/py/radio.py:401-402` prepends exactly
            # n_taps samples), which truncates the first n_fir-1-n_taps
            # ISI samples of each symbol; MATLAB's full filter(h, x) keeps
            # them — documented deviation shared with the reference.
            y = fir.fir_per_symbol_iq(tx, gt, p.n_taps, offsets)
        else:
            flat = tx.reshape(b, s * n_sc, 2)
            y = fir.fir_same_iq(flat, gt[:, 0], offsets).reshape(tx.shape)
        return MatlabLinkOut(y, g)

    def _fade_per_sample(self, tx: torch.Tensor, theta: tuple) -> MatlabLinkOut:
        """MATLAB-exact mobile fading: per-sample time-varying FIR
        (`matlab_link.py:147-191`).

        y[n] = sum_f g[n, f] * x[n - f]   (causal, zero prefix — filter(h,x))
        with g[n] = (z[n] o coeff) @ alpha, z[n] the Jakes gains at sample
        instant n (state continuous across the frame, as `rayleighchan`
        filtering is); ground truth G = fft(mean_n-in-symbol g[n]) — the
        exact G3d averaging (`OFDM_Benchmark_dev.m:303-309`).

        A shift-and-accumulate over the n_fir taps (float32 elementwise
        complex MACs): n_fir passes over the flat [B, L, 2] waveform."""
        plan = self.plan
        b, s, n_sc, _ = tx.shape
        p = self.profile
        n_len = s * n_sc
        t = torch.arange(n_len, dtype=torch.float32,
                         device=tx.device) / plan.sample_rate
        z = jakes_gains_from_phases(
            *theta, torch.full((b,), self.fd, device=tx.device), t,
            p.n_taps)                                      # [B, L, taps, 2]
        a = z * self.coeff[:, None]                        # scaled tap gains
        # per-sample FIR kernels g[n] = a[n] @ alpha  -> [B, L, n_fir, 2]
        g_ps = torch.einsum("bltc,tf->blfc", a, self.alpha)
        x = tx.reshape(b, n_len, 2)
        xr, xi = x[..., 0], x[..., 1]
        yr = torch.zeros_like(xr)
        yi = torch.zeros_like(xi)
        for f in range(self.alpha.shape[1]):
            # x[n - f] with zero prefix (causal full-convolution head)
            xr_s = torch.nn.functional.pad(xr, (f, 0))[:, :n_len]
            xi_s = torch.nn.functional.pad(xi, (f, 0))[:, :n_len]
            gr = g_ps[:, :, f, 0]
            gi = g_ps[:, :, f, 1]
            yr = yr + gr * xr_s - gi * xi_s
            yi = yi + gr * xi_s + gi * xr_s
        y = torch.stack([yr, yi], dim=-1).reshape(tx.shape)
        # ground truth: average the SAME gains over all samples per symbol
        zck = z.reshape(b, s, n_sc, p.n_taps, 2).mean(dim=2)
        gt = torch.einsum("bstc,tf->bsfc", zck * self.coeff[:, None],
                          self.alpha)
        return MatlabLinkOut(y, cfloat.dft_iq(gt, plan.nfft))

    # -- noise ---------------------------------------------------------------
    @staticmethod
    def awgn_measured(y: torch.Tensor, snr_db: float,
                      generator: torch.Generator | None = None,
                      unit_noise: torch.Tensor | None = None) -> torch.Tensor:
        """awgn(...,'measured'): noise var = mean |y|^2 / 10^(snr/10).
        float32 unit normals from `generator` (JAX's
        `jax.random.normal(key, y.shape)`), or `unit_noise` as given."""
        p_sig = cfloat.abs2_iq(y).mean()
        n_var = p_sig * 10.0 ** (-snr_db / 10.0)
        if unit_noise is None:
            unit_noise = torch.randn(y.shape, generator=generator,
                                     device=y.device)
        return y + torch.sqrt(n_var / 2.0) * unit_noise

    # -- receiver front end --------------------------------------------------
    def rx_front(self, y: torch.Tensor) -> torch.Tensor:
        """CP strip + scaled FFT -> [B, S, K, 2] frequency grid."""
        return cfloat.dft_iq(y[:, :, self.plan.cp_len:]) / self.tx_scale

    def pilot_ls(self, rx_freq: torch.Tensor) -> torch.Tensor:
        """LS pilot estimates Hhat = Y_p / pilot (pilot is real*(1+1j))."""
        b = rx_freq.shape[0]
        yp = rx_freq.reshape(b, -1, 2)[:, self.pilot_sc]   # [B, P, 2]
        pr, pi = self.pilot_iq[0], self.pilot_iq[1]
        denom = pr ** 2 + pi ** 2
        hr = (yp[..., 0] * pr + yp[..., 1] * pi) / denom
        hi = (yp[..., 1] * pr - yp[..., 0] * pi) / denom
        return torch.stack([hr, hi], dim=-1)

    def demodulate(self, eq_grid: torch.Tensor) -> torch.Tensor:
        """Extract data SCs and min-distance demap -> symbol indices."""
        b = eq_grid.shape[0]
        data = eq_grid.reshape(b, -1, 2)[:, self.data_sc]  # [B, frame, 2]
        return demod_nearest(data, self.table_iq)

    def count_errors(self, tx_idx: torch.Tensor, rx_idx: torch.Tensor):
        """(bit errors, symbol errors) as int64 tensors on the link's
        device, (total bits, total symbols) as ints."""
        tx_bits = self.bit_table[tx_idx]
        rx_bits = self.bit_table[rx_idx]
        bit_err = (tx_bits != rx_bits).sum()
        sym_err = (tx_idx != rx_idx).sum()
        return bit_err, sym_err, tx_bits.numel(), tx_idx.numel()
