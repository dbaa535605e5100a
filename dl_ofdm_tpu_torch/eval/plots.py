"""BER curve plotting — replaces the MATLAB semilogy figure output
(`dev/m/OFDM_Benchmark_dev.m:478-489`).  Port of `dl_ofdm_tpu/eval/plots.py`;
matplotlib is imported only by `plot_ber_curves`, so the rest runs where it
is not installed."""
from __future__ import annotations

import numpy as np


def plot_ber_curves(curves: dict[str, tuple[np.ndarray, np.ndarray]],
                    title: str = "", out_png: str | None = None):
    """curves: {label: (snr_db, ber)}; writes a semilogy PNG if requested."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    for label, (snr, ber) in curves.items():
        ber = np.maximum(np.asarray(ber, dtype=float), 1e-7)
        ax.semilogy(snr, ber, "--x", linewidth=1, label=label)
    ax.grid(True, which="both", alpha=0.4)
    ax.set_xlabel("SNR (dB)")
    ax.set_ylabel("BER")
    if title:
        ax.set_title(title)
    ax.legend()
    if out_png:
        fig.savefig(out_png, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_png


def closed_form_ber(modulation: str, snr_per_bit_db: np.ndarray) -> np.ndarray:
    """Textbook AWGN BER curves (analytic oracles for validation).

    BPSK/QPSK: Q(sqrt(2 Eb/N0)); square M-QAM Gray: standard approximation.
    """
    from scipy.special import erfc

    ebn0 = 10.0 ** (np.asarray(snr_per_bit_db, dtype=float) / 10.0)
    m = modulation.upper()
    if m in ("BPSK", "QPSK"):
        return 0.5 * erfc(np.sqrt(2 * ebn0) / np.sqrt(2.0))
    if m == "16QAM":
        # Gray square 16-QAM: Pb ~= (3/4) Q(sqrt(4 Eb / 5 N0))
        return (3.0 / 8.0) * erfc(np.sqrt(2.0 * ebn0 / 5.0))
    raise ValueError(modulation)
