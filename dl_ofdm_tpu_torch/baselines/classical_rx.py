"""Classical OFDM receiver and its BER benchmark.

Port of `dl_ofdm_tpu/baselines/classical_rx.py`, the replacement of
`dev/m/OFDM_Benchmark_dev.m` (M1) and `script_rayleigh.m` (M7): the full
classical link — MATLAB-parity TX, Rayleigh fading, AWGN 'measured', CP
strip + scaled FFT, estimator dispatch (1-10), equalization, Gray
demapping, BER/SER — as batched PyTorch operations on one device.

Protocol parity: SNR -10:5:30, configurable frame count (MATLAB uses 20,000),
CSV `BER_OFDM_<chan>_<est>_<pilot>_<N>_Gray[_mobile][_shortcp].csv` with rows
[SNRs; BER BPSK..16QAM] (`OFDM_Benchmark_dev.m:25-35,474-476`); for fading
channels only BPSK is swept (`:219-223`), matching MATLAB.

Every point runs in full float32 (`full_float32`): the estimators' solves
are ill-conditioned enough that reduced-precision products corrupt them
(JAX measured 5x the BER of the CP-enhanced estimator with bf16 passes,
`classical_rx.py:45-49`).  A point's error counts stay on the device and
are read once, after its last batch.
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterator

import numpy as np
import torch

from dl_ofdm_tpu_torch import resolve_device
from dl_ofdm_tpu_torch.baselines import estimators as E
from dl_ofdm_tpu_torch.baselines.matlab_link import MatlabLink
from dl_ofdm_tpu_torch.ofdm.plan import SubcarrierPlan
from dl_ofdm_tpu_torch.ops import cfloat

_CTX_CACHE: dict = {}


def get_context(plan: SubcarrierPlan, channel: str,
                device=None) -> E.EstimatorContext:
    """`make_context`, made once per configuration, channel and device."""
    dev = torch.device("cpu" if device is None else device)
    key = (plan.nfft, plan.nsymbol, plan.cp_len, tuple(plan.pilot_sc),
           channel.lower(), dev)
    if key not in _CTX_CACHE:
        _CTX_CACHE[key] = E.make_context(plan, channel, dev)
    return _CTX_CACHE[key]


@contextlib.contextmanager
def full_float32():
    """float32 products without TF32 inside the block, the caller's
    settings restored after."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.set_float32_matmul_precision(prev[1])


def one_batch(link: MatlabLink, ctx: E.EstimatorContext, eq_idx: int,
              w_prior, snr_db: float, beta: float, nb: int,
              generator: torch.Generator | None = None,
              draws: dict | None = None):
    """One batch of `nb` frames through the link and estimator `eq_idx`
    (`classical_rx.py:40-74`): (bit errors, symbol errors) as device
    tensors, (bits, symbols) as ints.  `draws`: `sym_idx`, `z` or `theta`,
    and `unit_noise` to use instead of drawing them."""
    draws = draws or {}
    snr_lin = 10.0 ** (snr_db / 10.0)
    tx_idx, tx_wave = link.transmit(nb, generator, draws.get("sym_idx"))
    ch = link.fade(tx_wave, generator, z=draws.get("z"),
                   theta=draws.get("theta"))
    y = link.awgn_measured(ch.y, snr_db, generator, draws.get("unit_noise"))
    rx_freq = link.rx_front(y)
    if link.channel == "awgn":
        eq_grid = rx_freq
    else:
        hhat = link.pilot_ls(rx_freq)
        g_est, x_eq = E.estimate(eq_idx, ctx, rx_freq, hhat, ch.g, snr_lin,
                                 beta, w_prior=w_prior, y_time=y)
        if x_eq is not None:
            eq_grid = x_eq
        else:
            d = cfloat.abs2_iq(g_est) + 1e-12
            eq_grid = cfloat.cmul_iq(rx_freq,
                                     cfloat.conj_iq(g_est)) / d[..., None]
    return link.count_errors(tx_idx, link.demodulate(eq_grid))


def run_point(link: MatlabLink, ctx: E.EstimatorContext, eq_idx: int,
              generator: torch.Generator | None, snr_db: float,
              n_frames: int, batch: int = 2000, beta: float = 1.0,
              draws: Iterator[dict] | None = None):
    """One SNR point (`classical_rx.py:77-110`): returns (ber, ser).

    Eq 10 first fades one more batch, its long-term ensemble, whose
    realized Rhh gives W.  `draws` yields the injected draws of each
    batch in order (eq 10's ensemble first: `sym_idx` and `z` or
    `theta`), as `one_batch` takes them."""
    with full_float32():
        snr_lin = 10.0 ** (snr_db / 10.0)
        w_prior = None
        if eq_idx in (8, 9):
            rhh = ctx.rhh_uni if eq_idx == 8 else ctx.rhh_exp
            w_prior = E.precompute_prior_w(rhh, beta, snr_lin, link.device)
        if eq_idx == 10:
            d = next(draws) if draws is not None else {}
            _, wv = link.transmit(min(batch, n_frames), generator,
                                  d.get("sym_idx"))
            g_ens = link.fade(wv, generator, z=d.get("z"),
                              theta=d.get("theta")).g
            w_prior = E.precompute_longterm_w(g_ens, beta, snr_lin)
        errs = torch.zeros(2, dtype=torch.int64, device=link.device)
        bits = syms = 0
        remaining = n_frames
        while remaining > 0:
            nb = min(batch, remaining)
            be, se, tb, ts = one_batch(
                link, ctx, eq_idx, w_prior, float(snr_db), float(beta), nb,
                generator, next(draws) if draws is not None else None)
            errs += torch.stack([be, se])
            bits += tb
            syms += ts
            remaining -= nb
        bit_err, sym_err = errs.tolist()
    return bit_err / max(bits, 1), sym_err / max(syms, 1)


def export_snr_point_mat(link: MatlabLink, generator: torch.Generator | None,
                         snr_db: float, n_frames: int, path: str):
    """Per-SNR waveform export — `save_tx_data` parity
    (`OFDM_Benchmark_dev.m:460-466`, `parsave(filename, y, txbits, rxbits)`):
    the noisy time waveform (complex columns), the transmitted bits and the
    demodulated bits, one .mat per SNR point."""
    from scipy.io import savemat
    tx_idx, tx_wave = link.transmit(n_frames, generator)
    ch = link.fade(tx_wave, generator)
    y = link.awgn_measured(ch.y, snr_db, generator)
    rx_idx = link.demodulate(link.rx_front(y))   # estimator-free (LS outside)
    y_np = y.cpu().numpy()
    y_c = (y_np[..., 0] + 1j * y_np[..., 1]).reshape(n_frames, -1).T
    shifts = np.arange(link.nbits - 1, -1, -1)

    def to_bits(idx):
        return ((idx.cpu().numpy()[..., None] >> shifts) & 1).reshape(-1, 1)

    savemat(path, {"y": y_c.astype(np.complex64),
                   "txbits": to_bits(tx_idx).astype(np.uint8),
                   "rxbits": to_bits(rx_idx).astype(np.uint8)})
    return path


def run_benchmark(plan: SubcarrierPlan, channel: str, eq_idx: int,
                  longcp: bool = True, mobile: bool = False,
                  n_frames: int = 20000, snrs=tuple(range(-10, 31, 5)),
                  seed: int = 0, save_dir: str = ".", log_fn=print,
                  mods=None, tag: str = "", save_tx_data: bool = False,
                  per_sample: bool = False, device=None):
    """Full sweep for one (channel, estimator); writes the MATLAB-schema CSV
    (`classical_rx.py:139-224`) on `device` (`resolve_device`: the card
    unless the caller asks for another), every draw from one generator
    seeded with `seed`.

    `mods=None` keeps MATLAB parity (all four modulations for AWGN, BPSK
    only for fading, `OFDM_Benchmark_dev.m:219-223`).  Passing an explicit
    subset of (2, 4, 8, 16) sweeps those modulations on any channel; rows
    land in the same schema slots (row 1+index in the canonical modulation
    order).  `tag` is appended to the filename so such extended sweeps
    never collide with parity CSVs.
    """
    dev = resolve_device(device)
    if per_sample and not tag:
        # never overwrite the symbol-averaged parity CSVs (frozen schema)
        tag = "_persample"
    is_awgn = channel.lower() == "awgn"
    mod_order = (2, 4, 8, 16)
    ber_all = np.zeros((5, len(snrs)))
    ser_all = np.zeros((5, len(snrs)))
    if mods is None:
        mods = mod_order if is_awgn else (2,)
    else:
        bad = set(mods) - set(mod_order)
        if bad:
            raise ValueError(f"mods takes modulation orders from {mod_order},"
                             f" got {sorted(bad)}")
        if not tag:
            raise ValueError("explicit mods= requires a filename tag= so "
                             "MATLAB-parity CSVs are never overwritten")
        # non-parity sweep: unswept rows are NaN (loud) rather than the
        # schema's zeros, which would read as perfect decoding
        ber_all[1:] = np.nan
        ser_all[1:] = np.nan
    ber_all[0] = ser_all[0] = snrs
    ctx = get_context(plan, channel, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    mod_names = {2: "BPSK", 4: "QPSK", 8: "8QAM", 16: "16QAM"}
    with full_float32():
        log_fn(f"{channel}/{E.ESTIMATOR_NAMES[eq_idx]} on {dev}: float32 "
               f"matmul precision {torch.get_float32_matmul_precision()}, "
               f"allow_tf32 {torch.backends.cuda.matmul.allow_tf32}")
        for m in mods:
            mi = mod_order.index(m)
            # per_sample: MATLAB-exact per-sample time-varying mobile fading
            # (measured delta vs the symbol-averaged FIR <=0.07% at MATLAB
            # Doppler rates, runs/p19_mobile_per_sample.json)
            link = MatlabLink(plan, m, channel, mobile, per_sample=per_sample,
                              device=dev)
            beta = E.BETAS[m]
            for si, snr in enumerate(snrs):
                ber, ser = run_point(link, ctx, eq_idx, gen, float(snr),
                                     n_frames, beta=beta)
                ber_all[mi + 1, si] = ber
                ser_all[mi + 1, si] = ser
                log_fn(f"{channel}/{E.ESTIMATOR_NAMES[eq_idx]} M={m} "
                       f"SNR={snr}: BER={ber:.6f}")
                if save_tx_data:
                    mat_dir = os.path.join(save_dir, "mat")
                    os.makedirs(mat_dir, exist_ok=True)
                    cpstr = "" if longcp else "_shortcp"
                    export_snr_point_mat(
                        link, gen, float(snr), min(n_frames, 2000),
                        os.path.join(mat_dir,
                                     f"ofdm_{channel.lower()}_{mod_names[m]}"
                                     f"_{int(snr)}dB{cpstr}.mat"))
    mobile_str = "_mobile" if mobile else ""
    cp_str = "" if longcp else "_shortcp"
    name = (f"BER_OFDM_{channel}_{E.ESTIMATOR_NAMES[eq_idx]}_"
            f"{plan.pilot_type}_{plan.nfft}_Gray{mobile_str}{cp_str}{tag}.csv")
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, name)
    np.savetxt(path, ber_all, delimiter=",")
    # SER artifact parity: MATLAB stores berofdm_all AND serofdm_all in the
    # .mat next to the BER csv (`OFDM_Benchmark_dev.m:454-458,474-476`);
    # also write the SER as a same-schema csv for toolless inspection.
    np.savetxt(os.path.join(save_dir, "SER" + name[3:]), ser_all,
               delimiter=",")
    from scipy.io import savemat
    savemat(path[:-4] + ".mat",
            {"berofdm_all": ber_all, "serofdm_all": ser_all,
             "mat_name": name[:-4] + ".mat"})
    return ber_all, ser_all, path
