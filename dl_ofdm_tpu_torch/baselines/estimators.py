"""Classical channel estimators 1-10 (the MATLAB suite).

Port of `dl_ofdm_tpu/baselines/estimators.py`.  Estimator ids and math
follow `dev/m/OFDM_Benchmark_dev.m:319-427`:

   1 Perfect CSI                      (Gls = true G)
   2 LS + biharmonic spline           (griddata 'v4')
   3 LS + Delaunay linear             (scatteredInterpolant)
   4 ideal per-realization LMMSE      (Rhh = H H', W = Rhh(Rhh+b/snr I)^-1)
   5 LS + CP-enhanced (Quadeer)       (see cp_enhanced.py)
   6 ALMMSE + CP-enhanced
   7 approximate LMMSE                (Rhh from the LS estimate / Frame_size)
   8 LMMSE, uniform-PDP prior Rhh
   9 LMMSE, exponential-PDP prior Rhh
  10 fast LMMSE, long-term Rhh with W precomputed per SNR

  * the per-frame spline/linear `griddata` calls collapse into one static
    interpolation matrix (see interp.py) -> batched matmul;
  * the rank-1 LMMSE inversions (4, 6, 7) use the Sherman-Morrison closed
    form W x = s h (h^H x) / (c + s |h|^2) — algebraically identical to the
    MATLAB `inv` of the rank-1-plus-scaled-identity matrix;
  * prior/long-term LMMSE (8, 9, 10) precompute W once per SNR on the host
    (complex128 NumPy) and apply it as a batched real-pair matmul.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dl_ofdm_tpu_torch.baselines import interp, pdp
from dl_ofdm_tpu_torch.baselines.cp_enhanced import cp_enhanced_frame
from dl_ofdm_tpu_torch.channel.profiles import get_profile
from dl_ofdm_tpu_torch.ofdm.plan import SubcarrierPlan
from dl_ofdm_tpu_torch.ops import cfloat

ESTIMATOR_NAMES = {1: "Perfect", 2: "LS-Spline", 3: "LS-Linear", 4: "LMMSE",
                   5: "LS-Quadeer", 6: "LMMSE-Quadeer", 7: "ALMMSE",
                   8: "LMMSE-Uni-PDP", 9: "LMMSE-Exp-PDP", 10: "LMMSE-Fast"}

# beta per modulation order index (1..4), `OFDM_Benchmark_dev.m:216`
BETAS = {2: 1.0, 4: 1.0, 8: 17.0 / 9.0, 16: 17.0 / 9.0}


def _iq(c: np.ndarray, device) -> torch.Tensor:
    """Host complex -> float32 IQ pair on `device`."""
    c = np.asarray(c)
    return torch.from_numpy(
        np.stack([c.real, c.imag], -1).astype(np.float32)).to(device)


@dataclasses.dataclass
class EstimatorContext:
    """Static per-configuration operators shared by all frames."""
    plan: SubcarrierPlan
    a_spline: torch.Tensor    # [S*K, P] biharmonic interpolation operator
    a_linear: torch.Tensor    # [S*K, P] Delaunay-linear operator
    rhh_uni: np.ndarray       # [K, K] complex prior (host)
    rhh_exp: np.ndarray


def make_context(plan: SubcarrierPlan, channel: str,
                 device=None) -> EstimatorContext:
    """Build the static operators, the interpolation ones on `device`
    (memoized per device by `classical_rx.get_context`)."""
    k, s = plan.nfft, plan.nsymbol
    # pilot coordinates in MATLAB's (subcarrier, symbol) plane, 1-based
    pf = plan.pilot_freq + 1
    pt = plan.pilot_sym + 1
    pilot_xy = np.stack([pf, pt], axis=-1).astype(np.float64)
    gm, gt = np.meshgrid(np.arange(1, k + 1), np.arange(1, s + 1))  # [S, K]
    eval_xy = np.stack([gm.ravel(), gt.ravel()], axis=-1).astype(np.float64)
    a_spline, a_linear = (
        torch.tensor(op(pilot_xy, eval_xy), dtype=torch.float32,
                     device=device)
        for op in (interp.biharmonic_operator, interp.linear_operator))
    if channel.lower() == "awgn":
        rhh_uni = rhh_exp = np.eye(k, dtype=np.complex128)
    else:
        prof = get_profile(channel, plan.sample_rate, weighting="physical")
        trms, _ = pdp.rms_delay_spread(prof.tap_delay_ns * 1e-9,
                                       prof.tap_pow_db)
        trms_samples = trms * plan.sample_rate
        # reference parity: MATLAB passes the tap COUNT as mmse_pdp's L
        # (`OFDM_Benchmark_dev.m:200-201` uses length(tau)), not the delay
        # support in samples — physically questionable at high sample rates
        # but kept verbatim so eq 8/9 curves are comparable.
        n_paths = prof.n_taps
        rhh_uni = pdp.mmse_pdp(n_paths, k, trms_samples, True)
        rhh_exp = pdp.mmse_pdp(n_paths, k, max(trms_samples, 1e-6), False)
    return EstimatorContext(plan=plan, a_spline=a_spline, a_linear=a_linear,
                            rhh_uni=rhh_uni, rhh_exp=rhh_exp)


def _interp_grid(a: torch.Tensor, hhat: torch.Tensor, s: int, k: int):
    """Apply a real interpolation operator to complex pilot estimates.

    a: [S*K, P]; hhat: [B, P, 2] -> [B, S, K, 2]."""
    hr = hhat[..., 0] @ a.T
    hi = hhat[..., 1] @ a.T
    return torch.stack([hr, hi], -1).reshape(hhat.shape[0], s, k, 2)


def _rank1_lmmse(h: torch.Tensor, x: torch.Tensor, c, scale: float = 1.0):
    """W x with W = s h h^H (s h h^H + c I)^{-1} (Sherman-Morrison).

    h, x: [..., K, 2]; returns [..., K, 2]."""
    hh = cfloat.abs2_iq(h).sum(dim=-1, keepdim=True)           # |h|^2
    inner = cfloat.cmul_iq(cfloat.conj_iq(h), x).sum(
        dim=-2, keepdim=True)                                   # h^H x
    denom = c + scale * hh[..., None]
    return scale * cfloat.cmul_iq(h, inner) / denom


def precompute_prior_w(rhh: np.ndarray, beta: float, snr_lin: float,
                       device=None) -> torch.Tensor:
    """W = Rhh (Rhh + (beta/snr) I)^{-1} as an IQ-pair matrix on `device`
    (made on the host in complex128)."""
    n = rhh.shape[0]
    w = rhh @ np.linalg.inv(rhh + (beta / snr_lin) * np.eye(n))
    return _iq(w, device)


def precompute_longterm_w(g: torch.Tensor, beta: float,
                          snr_lin: float) -> torch.Tensor:
    """Fast-LMMSE W from the realized ensemble G [B, S, K, 2]
    (`OFDM_Benchmark_dev.m:319-321,342`), made on the host, returned on
    G's device."""
    g_host = g.cpu().numpy()
    gc = g_host[..., 0] + 1j * g_host[..., 1]
    cols = gc.reshape(-1, gc.shape[-1]).T                      # [K, B*S]
    rhh = (cols @ cols.conj().T) / cols.shape[1]
    return precompute_prior_w(rhh, beta, snr_lin, g.device)


def estimate(eq_idx: int, ctx: EstimatorContext, rx_freq: torch.Tensor,
             hhat_pilots: torch.Tensor, g_true: torch.Tensor,
             snr_lin: float, beta: float,
             w_prior: torch.Tensor | None = None,
             y_time: torch.Tensor | None = None):
    """Returns (g_est [B,S,K,2], x_eq or None).

    For eq_idx 5/6 the CP-enhanced path returns the jointly re-estimated data
    grid X directly (the MATLAB code then uses it instead of Rx./Gls).
    """
    plan = ctx.plan
    s, k = plan.nsymbol, plan.nfft
    c = beta / snr_lin
    if eq_idx == 1:
        return g_true, None
    hls = _interp_grid(ctx.a_spline, hhat_pilots, s, k)
    if eq_idx == 2:
        return hls, None
    if eq_idx == 3:
        return _interp_grid(ctx.a_linear, hhat_pilots, s, k), None
    if eq_idx == 4:
        # per-symbol ideal LMMSE with Rhh = H H^H from true CSI
        return _rank1_lmmse(g_true, hls, c), None
    if eq_idx == 10:
        return cfloat.cmatvec_iq(w_prior, hls), None
    hbar = hls.mean(dim=1, keepdim=True)                       # [B,1,K,2]
    if eq_idx == 7:
        g1 = _rank1_lmmse(hbar, hbar, c, scale=1.0 / s)
        return g1.expand(hls.shape), None
    if eq_idx in (8, 9):
        return cfloat.cmatvec_iq(w_prior, hbar).expand(hls.shape), None
    if eq_idx == 5:
        g0 = hbar.expand(hls.shape)
    elif eq_idx == 6:
        # reference parity: MATLAB's eq6 ALMMSE init omits eq7's
        # /Frame_size scaling (`OFDM_Benchmark_dev.m`: eq6 Rhh=h*h' vs
        # eq7 Rhh=h*h'/Frame_size) — kept verbatim.
        g0 = _rank1_lmmse(hbar, hbar, c).expand(hls.shape)
    else:
        raise ValueError(f"Unsupported estimator {eq_idx}")
    x_eq, g_est = cp_enhanced_frame(rx_freq, g0, y_time, plan.cp_len)
    return g_est, x_eq
