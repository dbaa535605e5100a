"""The model FLOPs of the equalizer stage (variant 12 of the paper's
equalizer, `benchmark/reference/equalizer.py`), the yardstick of
`eq_train_mfu_pct`: counted from the layers' shapes, as `work.py` counts
the DCCN's.  A multiply-add is 2 operations, a complex one 8."""
from __future__ import annotations


def same_taps(n: int, taps: int) -> int:
    """Kernel taps that fall on the input, summed over the n outputs of a
    'same' convolution of width `taps` along an axis of n (XLA's padding,
    the odd pixel after)."""
    lo = (taps - 1) // 2
    return sum(min(taps, n + lo - o) - max(0, lo - o) for o in range(n))


def eq12_forward_flops(nsymbol: int, nfft: int, cp: int, pilots: int) -> int:
    """Model FLOPs of one frame's variant-12 equalizer forward: Dense_in and
    Dense_out per symbol, Dense_pilot, the two interpolation layers and the
    block's dense layer; ToFreq, CorrT and ToTime (complex K x K per
    symbol); the (S, K) block convolution at the taps inside its 'same'
    window.  The layer norm, the division and the activations are not
    counted."""
    s, k, n_sc = nsymbol, nfft, nfft + cp
    grid = 2 * s * k
    dense = (s * 2 * (2 * n_sc) * (2 * k) + 2 * grid * (2 * pilots)
             + 2 * (2 * pilots) * grid + 2 * 2 * grid * grid
             + s * 2 * (4 * k) * (2 * n_sc))
    complex_dense = 3 * s * 8 * k * k
    return dense + complex_dense + 8 * same_taps(s, s) * same_taps(k, k)
