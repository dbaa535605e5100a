"""The work the benchmark's layers do and the least time the card could take
for it: the yardstick of every roofline and `mfu` metric.

Counted from the shapes of each layer's inputs and outputs and from the
model's equations, never from how a kernel is written, so that a later
kernel doing the same work reads against the same bound.  A multiply-add
is 2 operations, a complex one 8.  The synthesize and model counts are
frozen copies of `chip_smoke.py`'s `synth_work`, `model_work` and
`bound_of` (PR 11's counting: every input byte read once, every output
byte written once, the random draws' integer work and special functions).

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the full 700 W power
limit; the result line carries the card's power limit beside them.
"""
from __future__ import annotations

import dataclasses

HBM_BPS = 3.35e12          # HBM3 bytes/s
F32_FLOPS = 67e12          # float32 outside the tensor cores
BF16_FLOPS = 989e12        # bf16 tensor cores, dense
# integer operations of one Philox4x32-10 call: 10 rounds of two
# mul.wide.u32 and two 3-input XORs
PHILOX_INT_OPS = 40


@dataclasses.dataclass(frozen=True)
class SynthShape:
    """What the training step's synthesize function works on, a frame."""
    nsymbol: int
    sps: int            # samples a symbol (nfft + cp)
    nfft: int
    frame_size: int     # data subcarriers a frame
    taps: int           # channel taps (0: AWGN)
    fir_u: int          # FIR length (0: AWGN)

    @property
    def length(self) -> int:
        return self.nsymbol * self.sps


def bound_of(n_bytes, flops, hbm_bps=HBM_BPS, flop_rate=F32_FLOPS,
             int_ops=0, sfu_ops=0):
    """(least seconds, "bytes" or "operations"): the bytes over the memory
    rate against the operations over their peak rates.  A Hopper SM has 128
    float32 lanes, 64 for 32-bit integer arithmetic and 16 for special
    functions (CUDA C++ Programming Guide, compute capability 9.0), so
    integer operations run at a quarter of the float32 rate and special
    functions at a sixteenth; every instruction also takes one of the SM's
    128 issue slots a clock, FMAs counted two operations to one."""
    t_b = n_bytes / hbm_bps
    t_o = max(flops / flop_rate, 4 * int_ops / flop_rate,
              16 * sfu_ops / flop_rate,
              (flops + 2 * int_ops + 2 * sfu_ops) / flop_rate)
    return max((t_b, "bytes"), (t_o, "operations"))


def synth_work(sh: SynthShape, b: int):
    """(bytes, float32 operations, integer operations, special functions)
    of synthesizing b static frames: the per-frame SNR read, the seeds, the
    TX operator and pilot waveform read once, the indices, four planes and
    the [10, L] statistics written once; the TX operator's complex MACs,
    the FIR's, the noise scaling and the partial sums; every Philox call
    (indices one a 4 symbols, taps and noise two a 4 normals) and each
    Box-Muller's log, sqrt, sin and cos."""
    length, d, do_fir = sh.length, sh.frame_size, sh.taps > 0
    n_bytes = (4 * b + 16 + 2 * 4 * d * sh.sps + 2 * 4 * sh.nsymbol * sh.sps
               + 4 * b * d + 4 * 4 * b * length + 4 * 10 * length)
    n_box = length + (sh.taps if do_fir else 0)
    flops = b * (8 * d * sh.sps + 2 * length + 16 * length + 4 * n_box
                 + (8 * sh.fir_u * length if do_fir else 0))
    philox = b * (-(-d // 4) + 2 * -(-length // 4)
                  + (2 * -(-sh.taps // 4) if do_fir else 0))
    return n_bytes, flops, PHILOX_INT_OPS * philox, 4 * b * n_box


def model_work(nsymbol, sps, nfilter, frame_size, nbits, b: int,
               n_params: int):
    """(bytes, operations) of the DCCN's forward, loss and backward for b
    frames from the raw planes: the four planes, indices, the normalizing
    affine and the parameters read once, the gradients written once; the
    five GEMMs (forward fft_like and Dense_extract, Dense_extract's two
    backward products and fft_like's weight gradient) and the head."""
    s_, p_, f_, d_, n = nsymbol, sps, nfilter, frame_size, nbits
    c, ch, j = 2 ** n, 2 ** n + 2, 2 * n
    n_bytes = (4 * 4 * b * s_ * p_ + 4 * b * d_ + 4 * 6 * s_ * p_
               + 2 * 4 * n_params)
    gemm = 2 * b * (2 * s_ * 2 * p_ * 2 * f_ + 3 * (s_ * 2 * f_) * (2 * d_))
    head = b * d_ * (6 * c + 6 * ch * j + 8 * c + 10 * n)
    return n_bytes, gemm + head


def cdense_work(m: int, k: int, f: int):
    """(bytes, operations) of a complex dense layer y [m, f] = x [m, k] W
    [k, f] in float32 IQ pairs: x, wr and wi read once, y written once;
    8 operations a complex MAC."""
    return 4 * (2 * m * k + 2 * k * f + 2 * m * f), 8 * m * k * f


def dccn_forward_flops(nsymbol, sps, nfilter, frame_size, nbits) -> int:
    """Model FLOPs of one frame's DCCN forward: fft_like's complex MACs,
    Dense_extract's, the two head layers' at each of the D positions."""
    c = 2 ** nbits
    return (8 * nsymbol * sps * nfilter
            + 2 * (nsymbol * 2 * nfilter) * (2 * frame_size)
            + frame_size * (2 * 2 * c + 2 * (c + 2) * 2 * nbits))
