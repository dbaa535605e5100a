#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`dl_ofdm_tpu_torch`) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases, each printed with its elapsed seconds:

 1. device: torch and CUDA versions, the card's name and power limit
    (nvidia-smi); TF32 off for matmuls and cuDNN.
 2. build: every CUDA kernel of the port, compiled by nvcc from the
    checkout's sources (`dl_ofdm_tpu_torch/ops/cuda_build.py`).
 3. kernel against its plain version: `complex_dense` at the sweep's shape
    (M = 1968*7, K = 80, F = 64), at a ragged one and at K = 5,000 (past
    the ring: x streamed in K chunks), atol = rtol = 1e-5 (float32 with
    reordered sums); then at three shapes (the sweep's, the
    equalizer's 210,000 x 64 x 64 and the autograd training route's
    65,534 x 80 x 64) the persistent kernel's device time (CUDA graph
    replay), the plain
    version's, one PyTorch call's (complex64 matmul), the card's bound for
    the work, and each one's time when launched from Python.
 4. serving path at full width: the committed 16QAM arm
    (`runs/arms/OFDM_Dense3_4mod_snr20_cpTrue.npz`) through `ber_sweep` on
    the AWGN channel, SNR -10..30 dB, 20,000 frames per point, 2,000-frame
    batches:
      a. the interleaved protocol (416 calls of 1968 frames), held against
         the JAX package's own interleaved curve (`JAX_INTERLEAVED_BER`);
         the kernel's launch count must equal the number of calls;
      b. the point_batch protocol (410 calls of 2000 frames), held against
         the committed CSV `runs/Test_DCCN_OFDM_Dense3_4mod_snr20_cpTrue_AWGN.csv`;
    each point's ratio to its reference is printed.
 6. `fused_synthesize` against its plain version on the same Philox words:
    ETU nbits 1 at 9,362 frames, AWGN nbits 4 at 1,001 frames (ragged),
    mixAll nbits 2 at 997 frames.  Indices equal; signal and noise planes
    within atol 1e-4 (the kernel's logf/sincosf and torch's differ by a few
    ulp, on values up to ~10); `_combine_stats` within rtol 1e-5 (atol 1e-5
    of each row's largest entry); the noise variance within 1 % of std^2
    and the bits' mean within 1 % of 1/2; two kernel calls on the same
    seeds (ETU) bit-identical.  Times: kernel, plain version, bound, and
    the kernel at 37,449 frames.
 7. `dccn_fused_grads` against its plain version on phase 6's raw planes:
    nbits 1 at 9,362 frames and nbits 4 at 1,001 frames, float32 and
    bfloat16 GEMM inputs.  The forward output e within 1e-4 (float32) or
    1e-3 (bfloat16) of its max; the gradients, with the plain version's
    backward run from the kernel's e (so that both take the same slope at
    every leaky kink), per leaf max |dg| <= 1e-4 or 1e-3 of the leaf's max
    |g|; CE within rtol 1e-5; counts equal but for bits whose margin
    |t| < 1e-5.  The plain version also against torch autograd of
    `DCCNReceiver` + `cross_entropy` (nbits 1): asserted in float64 on
    1,024 frames, measured in float32 at full size.
    Times: kernel (device time from a CUDA graph of the calls, and eager),
    plain version, bound (both compute bounds), and as the library time
    autograd's forward and backward of the plain model (cuBLAS).  Then the bf16 kernel (tensor cores) at bench.py's four batch
    sizes beside its bound, its plain version, that float32 autograd
    yardstick and the five GEMMs as bf16 cuBLAS calls (`torch.mm` with
    float32 output where torch offers it).
 8. the training step at full width, `bench.py`'s configuration (nbits 1,
    ETU, SNR 5 dB, bfloat16 GEMM inputs) on the fused route at 2,340,
    9,362, 18,724 and 37,449 frames a step: one warm-up step and 20 timed
    ones, ms/step and IQ samples/s; both kernels' launch counts must equal
    the fused steps.  The same for the autograd route.  Then 20 steps from
    one init on the same batches by each route (float32 products, 9,362
    frames): step 1's gradients agree within 5e-2 of each leaf's max (leaky
    kinks, see phase 7's float32 autograd number); the largest
    parameter difference after 20 steps is printed.  The model kernel
    twice on one synthesized 9,362-frame batch: bit-identical outputs.  Last, `fit` for three
    epochs on AWGN at 5 dB from `init_state`: the train CE must fall.
 9. the synth kernel's Doppler rows and true channel against its plain
    version on the same Philox words: mixRayleigh mobile nbits 1 at 9,362
    frames, ETU mobile nbits 4 at 1,001, mixAll mobile nbits 2 at 997 with
    `want_h`.  Indices equal; planes and h within 5e-6; noise var/std^2
    and the bits' mean as in phase 6.  Times: kernel, plain version, bound
    (from this run's count of Doppler rows).
10. long frames: a fused train step at `OFDMConfig(nfft=128)` (sps 160,
    1,120 samples a frame) and `nfft=128, longcp=False` (sps 137, 959),
    ETU, 2,340 frames, and the synth kernel against its plain version on
    one batch of each (planes within 1e-4, as phase 6).
11. the mobile training path, `bench.py`'s configuration on mixRayleigh
    with Jakes Doppler (`mobile=True`): the fused step at the four batch
    sizes (ms/step, IQ samples/s, each kernel's launches: counts set to 0
    just before, read just after, equal to the steps), `fit` for three
    epochs (the train CE must fall), and a 41-point `ber_sweep` of the
    trained model on ETU mobile (plain Doppler path on the card; 2,000
    frames a point): finite BERs that fall with SNR.
12. the PRNG probe (`python -m dl_ofdm_tpu_torch.ops.prng_probe`): the
    kernel's words equal `philox_words` bit for bit and pass the checks of
    `scripts/prng_quality_check.py`; its time from a CUDA graph of 100
    calls (eager beside it), the plain version's, and its bound,
    max(bytes, integer operations of its Philox calls).
13. `fir_shift_accum` against its plain version on the channel's own FIR
    kernels: ETU (one offset) and mixRayleigh (four offsets, zero-padded
    short kernels) at 30,000 and 73 frames of 560 samples; bit-equal, and
    `fir_same_iq` on the card (one kernel launch) bit-equal to the plain
    loop.  Times at 30,000 frames: kernel, plain
    version, one grouped `F.conv1d` (the library yardstick), bound.  Then
    `complex_dense` at the equalizer's shapes (K = F = 64 on 30,000 x 7
    and 73 x 7 rows) against its plain version (1e-5, as phase 3), with
    its times at the serving shape.
14. the nine committed equalizer arms (`runs/arms/MANIFEST.json`) served
    as `runs/resweep_claims.py:65-91` sweeps them: `EqualizerTrainer` with
    the AWGN base receiver grafted and the arm loaded, `ber_sweep` with
    `point_batch=True`, 30,000 frames a point in one batch, EPA/EVA/ETU at
    20 and 30 dB, generator seed 1919: 54 cells, each BER within
    [0.8, 1.25] of `runs/p19_resweep_claims.json`; the phase's wall time
    and its `fir_shift_accum` and `complex_dense` launches.
15. the equalizer stage's training at full width (nfft 64, opt 12,
    mixRayleigh, the QPSK base receiver grafted, a fresh equalizer):
    `train_step_curriculum` at 73 and 9,362 frames on the plain data plane
    and on `fused_curriculum` (one `fused_synth` launch a step), ms/step,
    CE and `chan_mse`; after the steps every `receiver.*` parameter equals
    the grafted one bit for bit and Adam holds moments for `Equalizer.*`
    only.  Then `fit` for three epochs: finite, the last epoch's CE below
    the first's.
16. the mobile equalizer step (mixRayleigh with Jakes Doppler, opt 0,
    8QAM, as the `Equalizer0_mixRayleigh_mobile` arm) on both data
    planes: ms/step, launches.
17. where the equalizer step's time goes, last because the profiler
    slows the launches that follow it: phase 15's trainers on both data
    planes, a warm-up step, then at 73 frames 20 steps timed and 20 under
    `torch.profiler`, at 9,362 frames 5 and 5: ms/step, device-busy ms a
    step (the union of kernel intervals), the idle share of that ms/step,
    kernels a step, the host's waits on the device and copies a step, the
    top kernels.
18. where the bf16 model kernel's time goes at the four batch sizes:
    6 calls under `torch.profiler` (those with every launch recorded
    count), device µs a call for the prologue, each of the
    five tensor-core GEMMs, the head, the reductions (split and column
    sums, the head's sums, the fold) and the parameter packing.
19. the multi-device path on virtual ranks of one card (a mesh that lists
    the card 4 or 8 times; run after phase 16, before the profiled phases):
      a. the dp training step, `bench.py`'s configuration on
         `make_mesh([cuda:0] * 4, dp=4)`: 9,362 frames rounded to 9,364
         (2,341 a rank), one warm-up and 10 timed steps (ms/step),
         `fir_shift_accum` 4 launches a step, step-1 gradients within 5e-2
         of each leaf's max of the single-device autograd route on the
         same four shards (phase 8's tolerance), replicas bit-identical;
      b. the 16QAM arm's mesh sweeps (dp 4): point_batch in 2,000-frame
         batches against the committed CSV, interleaved at 7,872 frames a
         call (48 a point and rank) against `JAX_INTERLEAVED_BER`, 5 %
         as phase 4; `complex_dense` 4 launches a call;
      c. the sequence-parallel halo FIR: 64 streams of 1,146,880 samples
         (2,048 frames of 560), 13 taps, offsets 6 and 0, P = 4 and 8,
         both exchanges: bit-equal to `fir_same_iq` of the whole block;
         the ring kernel bit-equal to its plain version at P = 1, 2, 4, 8
         with launches equal to the calls; the ring at P = 1, 2, 4, 8
         captured in one CUDA graph and replayed 100 times with new shard
         contents and nothing reset, each replay bit-equal; the halo FIR
         ('dma') captured at full width for each P and offset and replayed
         with new blocks and kernels, each replay bit-equal to
         `fir_same_iq`; device times (CUDA graphs of 100 calls) and eager
         times of the kernel, its plain version, one `_foreach_copy_` of
         the same slices (the library yardstick) and an empty launch; the
         bytes bound; the halo FIR with each exchange (graph and eager);
      d. one rank a card where the machine has two or more cards (peer
         access printed): 20 eager calls back to back with new inputs and
         no host sync, and one graph a card replayed together 100 times
         with new inputs, each bit-equal to the plain version; the halo
         FIR at full width; otherwise one line that says it was not run.
20. `complex_dense`'s bf16 mode (`compute_dtype='bfloat16'`: the pack
    kernel writes the stacked weight W_s in bf16, a tensor-core GEMM
    rounds each x tile once and sums in float32; csrc/complex_dense_bf16.cu)
    against its plain version (atol = rtol = 1e-5) at the nfft-512 arm's
    shapes (the sweep's call, 6,944 x 640 x 512; the training step's 511
    and 3,584 rows), a ragged shape with odd K (x by cp.async) and K =
    5,000: the pack bit-equal to `pack_stacked_weight_ref`, two calls
    bit-equal, the kernel's and the plain version's largest error against
    float64 sums printed; its gradients (rounded to bf16) within one bf16
    ulp of float64 products; then its time (CUDA graph) beside the FMA
    mode it replaced (`FMA_BF16_MS`, printed as the parent), the float32
    mode's, the plain version's and one bf16 cuBLAS GEMM of the stacked
    real form [M, 2K] x [2K, 2F], its bound (the bytes, or the products
    at the bf16 tensor-core rate), and the pack's time beside its plain
    version's.
21. the committed nfft-512 arm (`runs/arms/OFDM_Big512_1mod.npz`, bf16,
    28.7 M parameters) served at full width: interleaved `ber_sweep` on
    AWGN, SNR -10..20 dB, 20,000 frames a point in 1,000-frame batches
    (625 calls of 992 frames, key 999), held to the JAX package's own
    curve (`JAX_BIG512_BER`, `scripts/sweep_big512_jax.py`) at every
    point and to the committed CSV wherever that curve meets it (-10..15
    dB; the CSV's TPU cliff at 16-20 dB is printed beside both), each
    point's ratio to both; the bf16 launches of `complex_dense` and of
    the pack equal to the calls; frames/s beside the FMA mode's.  First, the
    plain data plane's bf16 unit noise: the table equal to JAX's 128
    values (`JAX_BF16_NORMALS`), `awgn_channel` on the card drawing
    through it.  Profiled with the profiled phases at the end: one
    992-frame call under `torch.profiler`, its busy ms and top kernels.
22. the CLI at full width: `python -m dl_ofdm_tpu_torch.cli train` of the
    nfft-512 bf16 receiver from scratch (3 epochs, a resume payload each
    epoch, its 41-point final sweep) in a temporary directory, then
    `--test True` restoring the checkpoint: the same CSV bytes; then
    resumed training (2 epochs, the payload, 2 more in a fresh trainer)
    against 4 straight epochs, params, Adam moments, step and history
    bit for bit: the nfft-512 bf16 receiver (autograd route),
    `bench.py`'s configuration at 2,340 frames (fused route) and the
    equalizer stage (opt 12, mixRayleigh).  Run after 19, before the
    profiled phases.
 5. (printed last) one `{"kernels": [...]}` line with all seven kernels
    (launches of `fused_synth` and `dccn_fused_grads` from phase 11, of
    `complex_dense` from phase 4a (with its equalizer-path counts, and
    its bf16 mode's GEMM from phases 21 and 22 beside phase 20's
    numbers), of `pack_stacked_weight` from phases 21 and 22, of
    `philox_probe` from phase 12, of `fir_shift_accum` from phases 14, 15
    and 19, of `ring_exchange` from phase 19c), then as the last line
    `{"ok": true, "device": {...}}`.

Any failure raises and exits non-zero; so does a machine with no CUDA
device, or a directory that holds this script without the package.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

T0 = time.time()
ROOT = os.path.dirname(os.path.abspath(__file__))
ARM = os.path.join(ROOT, "runs", "arms", "OFDM_Dense3_4mod_snr20_cpTrue.npz")
CSV = os.path.join(ROOT, "runs",
                   "Test_DCCN_OFDM_Dense3_4mod_snr20_cpTrue_AWGN.csv")
SNRS = list(range(-10, 31))

# BER of the JAX package's interleaved sweep of the same arm and arguments,
# SNR -10..30 dB: `python scripts/sweep_reference_jax.py --protocol
# interleaved --seed 999` (CPU, float32).  A second key (--seed 1000) moves
# no point by more than 1.4%.  The committed CSV does not follow this
# protocol: its curve is that of whole-batch normalization (phase 4b).
JAX_INTERLEAVED_BER = [
    0.421471, 0.410898, 0.39932, 0.385843, 0.37103, 0.354606,
    0.33676, 0.317363, 0.296805, 0.275063, 0.253093, 0.230566,
    0.20815, 0.186322, 0.165008, 0.144478, 0.124531, 0.105826,
    0.0885604, 0.0726856, 0.0588895, 0.0468588, 0.0370376, 0.0291872,
    0.0228072, 0.0180749, 0.0143657, 0.0117336, 0.00966034, 0.00817992,
    0.00698477, 0.00605774, 0.00547841, 0.00501482, 0.00458155, 0.00429312,
    0.00409076, 0.00397151, 0.00380452, 0.00373128, 0.0035702,
]

# (HBM bytes/s, float32 FLOP/s outside the tensor cores): NVIDIA data sheets,
# dense rates at the card's full power limit
PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
         "H200": (4.8e12, 67e12), "H100": (3.35e12, 67e12)}


def log(msg: str) -> None:
    print(f"[{time.time() - T0:7.1f}s] {msg}", flush=True)


def card_peaks(name: str):
    for key, peaks in PEAKS.items():
        if key in name:
            return key, peaks
    raise RuntimeError(f"no published peaks for {name!r} in PEAKS")


def time_ms(fn, iters: int = 100) -> tuple[float, float]:
    """Mean time of one call of `fn`, in ms: (device, eager).

    Device: `iters` calls captured in one CUDA graph and replayed between
    two CUDA events, so the host's launch cost is out of it.  Eager: the
    same calls issued from Python between two events; where the host takes
    longer to launch a call than the card to run it, this is the host's
    pace."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def eager():
        for _ in range(iters):
            fn()

    out = []
    for run in (graph.replay, eager):
        run()                                   # warm-up
        torch.cuda.synchronize()
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    del graph
    return out[0], out[1]


def meets(b, r) -> bool:
    """The curve rule at one point: |b/r - 1| <= 5% where r >= 1e-3, else
    b <= 3 r + 1e-6."""
    return abs(b / r - 1.0) <= 0.05 if r >= 1e-3 else b <= 3 * r + 1e-6


def ratios(ber, ref) -> list:
    """Each point's BER over its reference's (None where that is 0)."""
    return [float(b) / r if r > 0 else None for b, r in zip(ber, ref)]


def check_curve(name, ber, ref, ref_name, snrs=SNRS):
    """`meets` at every point of `snrs`."""
    bad = []
    for snr, b, r in zip(snrs, ber, ref):
        ok = meets(b, r)
        if r >= 1e-3:
            rule = f"ratio {b / r:.4f}"
        else:
            rule = f"<= {3 * r + 1e-6:.3g}"
        log(f"  {name} SNR {snr:+3d} dB: BER {b:.6g}  {ref_name} {r:.6g}  "
            f"{rule}{'' if ok else '  FAIL'}")
        if not ok:
            bad.append(snr)
    if bad:
        raise AssertionError(f"{name} sweep misses {ref_name} at SNR {bad}")


# integer operations of one Philox4x32-10 call: 10 rounds of two
# mul.wide.u32 and two 3-input XORs
PHILOX_INT_OPS = 40
BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core rate (data sheet)
# complex_dense's timed shapes: the sweep's fft_like (1,968 frames x 7
# symbols), the equalizer's ToFreq/CorrT/ToTime when serving, the autograd
# training route's fft_like at 9,362 frames
CD_SHAPES = ((1968 * 7, 80, 64), (210000, 64, 64), (9362 * 7, 80, 64))
TRAIN_FRAMES = (2340, 9362, 18724, 37449)   # bench.py's batch grid // 7
SYNTH_CASES = (("ETU", 1, 9362), ("AWGN", 4, 1001), ("mixAll", 2, 997))
SYNTH_BIG_FRAMES = 37449           # bench.py's largest batch // 7
# (channel, nbits, frames, want_h) of phase 9, all mobile
MOBILE_CASES = (("mixRayleigh", 1, 9362, False), ("ETU", 4, 1001, False),
                ("mixAll", 2, 997, True))


def events_ms(fn, iters: int = 50) -> float:
    """Mean ms of one call of `fn` over `iters` calls issued back to back
    between two CUDA events, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def synth_spec(channel: str, nbits: int, mobile: bool = False, **cfg):
    """The fused synthesize spec a `Trainer` builds for this channel."""
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.train.loop import Trainer
    return Trainer(OFDMConfig(nbits=nbits, **cfg), TrainConfig(),
                   channel=channel, mobile=mobile,
                   device="cpu")._fused_synth_spec


def synth_work(spec, b: int, n_dop: int = 0, want_h: bool = False):
    """(bytes, float32 operations, 32-bit integer operations, special
    functions) the synthesize function needs for b frames, n_dop of them
    Doppler rows: every input read once, every output written once, the
    statistics once as [10, L] whatever the kernel's grid; the TX
    operator's complex MACs (8 operations each), the FIR's, the noise
    scaling and the partial sums; on a Doppler row each sinusoid's
    argument and sum and the per-symbol kernels; with want_h the true
    channel's complex MACs.  The random draws: every Philox4x32-10 call
    (PHILOX_INT_OPS integer operations) of the symbol indices (one a 4
    symbols), the static taps and the noise (two a 4 Box-Mullers) and the
    Jakes phases (one a 4 phases); each Box-Muller's log, sqrt, sin and
    cos (one special function each) and its 4 multiplies; each Jakes
    cosine (one special function)."""
    length, d = spec.length, spec.frame_size
    s1 = spec.nsymbol if spec.mobile else 1
    n_bytes = (4 * b + 16 + 2 * spec.w_r.nbytes + 2 * spec.bias_r.nbytes
               + 4 * b * d + 4 * 4 * b * length + 4 * 10 * length
               + (8 * b * s1 * spec.nfft if want_h else 0))
    n_box = length + (spec.taps if spec.do_fir else 0)     # a frame
    flops = b * (8 * d * spec.sps + 2 * length + 16 * length + 4 * n_box
                 + (8 * spec.fir_u * length if spec.do_fir else 0))
    philox = b * (-(-d // 4) + 2 * -(-length // 4)
                  + (2 * -(-spec.taps // 4) if spec.do_fir else 0))
    sfu = 4 * b * n_box
    if spec.mobile:
        ss = spec.jakes_base_r.shape[0]
        flops += n_dop * spec.nsymbol * spec.taps * (
            2 * ss * 4 + 6 * spec.fir_u)
        philox += n_dop * 2 * -(-(ss * spec.taps) // 4)
        sfu += n_dop * spec.nsymbol * spec.taps * 2 * ss
    if want_h:
        flops += b * s1 * spec.nfft * spec.taps * 8
    return n_bytes, flops, PHILOX_INT_OPS * philox, sfu


def model_work(spec, b: int, n_params: int):
    """(bytes, operations) of the fused DCCN gradient for b frames: the
    raw planes, indices, affine and parameters read once, the gradients
    written once; the five GEMMs (2 operations a MAC) and the head."""
    s_, p_, f_, d_, n = (spec.nsymbol, spec.sps, spec.nfilter,
                         spec.frame_size, spec.nbits)
    c, ch, j = 2 ** n, 2 ** n + 2, 2 * n
    n_bytes = (4 * 4 * b * s_ * p_ + 4 * b * d_ + 4 * 6 * s_ * p_
               + 2 * 4 * n_params)
    gemm = 2 * b * (2 * s_ * 2 * p_ * 2 * f_ + 3 * (s_ * 2 * f_) * (2 * d_))
    head = b * d_ * (6 * c + 6 * ch * j + 8 * c + 10 * n)
    return n_bytes, gemm + head


def phase_synth(tfs, dev, hbm_bps, f32_flops) -> dict:
    """Phase 6: the synth kernel against its plain version."""
    import torch
    out = {}
    seeds = torch.tensor([0x1234ABCD, 0x9E3779B9], dtype=torch.int64,
                         device=dev)
    for channel, nbits, b in SYNTH_CASES:
        spec = synth_spec(channel, nbits)
        snr = torch.full((b,), 5.0, device=dev)
        std = tfs.noise_std(snr)
        got = tfs.fused_synthesize_kernel(spec, seeds, std)
        want = tfs.fused_synthesize_ref(spec, b, std, seeds=seeds)
        torch.cuda.synchronize()
        if not torch.equal(got[0], want[0]):
            raise AssertionError(f"fused_synth {channel}: indices differ")
        err = max(float((a - w).abs().max())
                  for a, w in zip(got[1:5], want[1:5]))
        if err > 1e-4:
            raise AssertionError(f"fused_synth {channel}: planes differ by "
                                 f"{err:.3g} > 1e-4")
        cg = tfs._combine_stats(got[5].sum(0), b)
        cw = tfs._combine_stats(want[5].sum(0), b)
        for name, a, w in zip(("a", "c", "noise_power", "sig_pwr"), cg, cw):
            scale = w.abs().amax(dim=-1, keepdim=True) if w.dim() else 0
            if bool(((a - w).abs() > 1e-5 * (w.abs() + scale)).any()):
                raise AssertionError(f"fused_synth {channel}: _combine_stats "
                                     f"{name} differs beyond rtol 1e-5")
        noise = torch.cat([got[3], got[4]])
        var = float(noise.var() / std[0] ** 2)
        bits = tfs._bits_from_idx(got[0], nbits).float().mean()
        if abs(var - 1) > 0.01 or abs(float(bits) - 0.5) > 0.01:
            raise AssertionError(f"fused_synth {channel}: noise var/std^2 "
                                 f"{var:.4f}, bit mean {float(bits):.4f}")
        line = {"channel": channel, "nbits": nbits, "frames": b,
                "max_abs_err": err, "noise_var_over_std2": var,
                "bit_mean": float(bits)}
        if channel == "ETU":
            again = tfs.fused_synthesize_kernel(spec, seeds, std)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError("fused_synth ETU: two calls on the same "
                                     "seeds differ")
            k_ms = events_ms(lambda: tfs.fused_synthesize_kernel(
                spec, seeds, std), 50)
            p_ms = events_ms(lambda: tfs.fused_synthesize_ref(
                spec, b, std, seeds=seeds), 50)
            n_bytes, flops, int_ops, sfu = synth_work(spec, b)
            bound, by = bound_of(n_bytes, flops, hbm_bps, f32_flops,
                                 int_ops, sfu)
            big = SYNTH_BIG_FRAMES
            std_big = tfs.noise_std(torch.full((big,), 5.0, device=dev))
            big_ms = events_ms(lambda: tfs.fused_synthesize_kernel(
                spec, seeds, std_big), 20)
            w = synth_work(spec, big)
            big_bound, _ = bound_of(w[0], w[1], hbm_bps, f32_flops, *w[2:])
            line.update(kernel_ms=k_ms, plain_ms=p_ms, bytes=n_bytes,
                        flops=flops, int_ops=int_ops, special_functions=sfu,
                        bound_ms=bound, bound_by=by,
                        two_calls_identical=True,
                        plan=tfs.synth_launch_plan(spec, b, dev.index or 0
                                                   )._asdict(),
                        kernel_ms_37449=big_ms, bound_ms_37449=big_bound)
            out["line"] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                           "bound_ms": bound, "bound_by": by,
                           "library_ms": None, "check": "pass"}
            out.setdefault("planes", {})[1] = (b, snr, got)
        if nbits == 4:
            out.setdefault("planes", {})[4] = (b, snr, got)
        log(f"fused_synthesize {channel} nbits {nbits}, {b} frames: kernel "
            f"== plain version (indices equal, planes max |diff| {err:.3g}),"
            f" noise var/std^2 {var:.4f}, bit mean {float(bits):.4f}"
            + (f"; kernel {line['kernel_ms']:.4f} ms (two calls "
               f"bit-identical), {line['kernel_ms_37449']:.4f} ms at "
               f"{SYNTH_BIG_FRAMES} frames, bound {line['bound_ms']:.4f}"
               if "kernel_ms" in line else ""))
        print(json.dumps({"phase": 6, **line}), flush=True)
    return out


def plain_vs_autograd(tfm, rx, spec, params, args, x, bits) -> dict:
    """The plain version against autograd of `DCCNReceiver` +
    `cross_entropy` on the normalized input: asserted in float64 on the
    host (1024 frames; no kink is that close to a float64 rounding), and
    measured in float32 on the card at full size."""
    import torch
    from torch.func import functional_call
    from dl_ofdm_tpu_torch.train.metrics import cross_entropy

    def autograd(model, ps, xx, bb):
        ps = {k: v.detach().requires_grad_() for k, v in ps.items()}
        ce = cross_entropy(functional_call(model, ps, (xx,))[0], bb)
        return ce.detach(), dict(zip(ps, torch.autograd.grad(
            ce, list(ps.values()))))

    out = {}
    m = min(1024, args[1])
    yr, yi, nr, ni = (t[:m].detach().cpu().double() for t in args[3:7])
    c = args[7].cpu().double()
    p64 = {k: v.detach().cpu().double() for k, v in params.items()}
    gp, cep, _ = tfm.dccn_fused_grads_ref(spec, m, p64, yr, yi, nr, ni, c,
                                          args[8][:m].cpu())
    rx64 = type(rx)(nbits=rx.nbits, nfft=64, cp_len=16, nfilter=64,
                    frame_size=320).double()
    x64 = torch.stack([yr * c[0] + nr * c[1] - c[2],
                       yi * c[3] + ni * c[4] - c[5]], -1)
    ce, ga = autograd(rx64, p64, x64.reshape(m, 7, 80, 2), bits[:m].cpu())
    out["plain_vs_autograd_f64_err"] = check_grads(
        "plain version vs autograd (float64)", gp, ga, 1e-4)
    torch.testing.assert_close(cep, ce, rtol=1e-9, atol=0)
    gp32 = tfm.dccn_fused_grads_ref(*args)[0]
    ce32, ga32 = autograd(rx, params, x, bits)
    out["plain_vs_autograd_f32_rel_err"] = max(
        float((gp32[k] - ga32[k]).abs().max() / ga32[k].abs().max())
        for k in ga32)
    return out


def library_step(params, x, bits):
    """Autograd forward and backward of the plain model with library
    products only: fft_like as one complex64 matmul, the Dense layers as
    `F.linear` (cuBLAS), the head and the CE in torch."""
    import torch
    import torch.nn.functional as F
    from dl_ofdm_tpu_torch.ops.norms import leaky_relu
    from dl_ofdm_tpu_torch.train.metrics import cross_entropy
    ps = {k: v.detach().requires_grad_() for k, v in params.items()}
    b = x.shape[0]
    w = torch.complex(ps["fft_like.wr"], ps["fft_like.wi"])
    f = torch.view_as_complex(x.contiguous()) @ w
    f = torch.view_as_real(f + torch.complex(ps["fft_like.br"],
                                             ps["fft_like.bi"]))
    e = F.linear(f.reshape(b, -1), ps["Dense_extract.weight"],
                 ps["Dense_extract.bias"]).reshape(b, -1, 2)
    h = leaky_relu(F.linear(e, ps["Dense_conv1x1.weight"],
                            ps["Dense_conv1x1.bias"]))
    h = leaky_relu(F.linear(torch.cat([h, e], -1), ps["Dense_llr.weight"],
                            ps["Dense_llr.bias"]))
    loss = cross_entropy(h.reshape(b, e.shape[1], -1, 2), bits)
    return dict(zip(ps, torch.autograd.grad(loss, list(ps.values()))))


def check_grads(name, got, want, tol):
    """Per leaf max |got - want| <= tol * max |want|; returns the largest
    absolute difference."""
    worst = 0.0
    for k, w in want.items():
        diff = float((got[k] - w).abs().max())
        if diff > tol * float(w.abs().max()):
            raise AssertionError(f"{name}: {k} differs by {diff:.3g} > "
                                 f"{tol} x {float(w.abs().max()):.3g}")
        worst = max(worst, diff)
    return worst


def phase_model(tfm, tfs, planes, dev, hbm_bps, f32_flops) -> dict:
    """Phase 7: the model kernel against its plain version."""
    import torch
    from torch.func import functional_call
    from dl_ofdm_tpu_torch.models.dccn import DCCNReceiver
    from dl_ofdm_tpu_torch.train.metrics import cross_entropy
    result = {}
    for nbits in (1, 4):
        b, _, (idx, yr, yi, nr, ni, stats) = planes[nbits]
        _, c, _, _ = tfs._combine_stats(stats.sum(0), b)
        rx = DCCNReceiver(nbits=nbits, nfft=64, cp_len=16, nfilter=64,
                          frame_size=320).to(dev)
        rx.reset_parameters(torch.Generator(device=dev).manual_seed(nbits))
        params = {k: v.detach() for k, v in rx.state_dict().items()}
        xr = yr * c[0] + nr * c[1] - c[2]
        xi = yi * c[3] + ni * c[4] - c[5]
        x = torch.stack([xr, xi], -1).reshape(b, 7, 80, 2)
        bits = tfs._bits_from_idx(idx, nbits)
        with torch.no_grad():
            logits, _ = functional_call(rx, params, (x,))
        ambiguous = int(((logits[..., 1] - logits[..., 0]).abs()
                         < 1e-5).sum())
        for dtype in ("float32", "bfloat16"):
            spec = tfm.ModelSpec(nsymbol=7, sps=80, nfilter=64,
                                 frame_size=320, nbits=nbits,
                                 matmul_dtype=dtype)
            args = (spec, b, params, yr, yi, nr, ni, c, idx)
            gk, cek, confk, ek = tfm.dccn_fused_grads_kernel(*args,
                                                             return_e=True)
            _, _, ep = tfm.dccn_forward_ref(spec, params, yr, yi, nr, ni, c)
            _, cep, confp = tfm.dccn_fused_grads_ref(*args)
            # the backward from the kernel's forward output: an f32 sum in
            # another order moves a pre-activation by ~1e-6, and where one
            # lies that close to a leaky kink the two sides would take
            # different slopes (phase 8 shows the size of that)
            gp, _, _ = tfm.dccn_fused_grads_ref(*args, e=ek)
            torch.cuda.synchronize()
            tol = 1e-4 if dtype == "float32" else 1e-3
            e_err = float((ek - ep).abs().max() / ep.abs().max())
            if e_err > tol:
                raise AssertionError(f"dccn_fused_grads nbits {nbits} "
                                     f"{dtype}: forward e off by {e_err:.3g}"
                                     f" of its max")
            err = check_grads(f"dccn_fused_grads nbits {nbits} {dtype}",
                              gk, gp, tol)
            torch.testing.assert_close(cek, cep, rtol=1e-5, atol=0)
            dconf = int((confk - confp).abs().max())
            if int(confk[1].sum()) != int(confp[1].sum()) \
                    or dconf > ambiguous:
                raise AssertionError(f"counts differ: {confk} vs {confp} "
                                     f"({ambiguous} bits with |t| < 1e-5)")
            line = {"phase": 7, "nbits": nbits, "frames": b, "dtype": dtype,
                    "max_abs_err": err, "e_rel_err": e_err, "ce": float(cek),
                    "count_diff": dconf, "ambiguous_bits": ambiguous}
            if nbits == 1 and dtype == "float32":
                line.update(plain_vs_autograd(tfm, rx, spec, params, args, x,
                                              bits))
            if nbits == 1:
                # device time from a CUDA graph of the calls; eager: the
                # same calls issued from Python (the host's pace where it
                # is slower)
                k_ms, k_eager = time_ms(
                    lambda: tfm.dccn_fused_grads_kernel(*args), 20)
                p_ms = events_ms(lambda: tfm.dccn_fused_grads_ref(*args))
                l_ms = events_ms(lambda: library_step(params, x, bits))
                n_params = sum(v.numel() for v in params.values())
                n_bytes, flops = model_work(spec, b, n_params)
                t_b = n_bytes / hbm_bps * 1e3
                t_f32, t_bf16 = flops / f32_flops * 1e3, flops / BF16_FLOPS * 1e3
                t_o = t_bf16 if dtype == "bfloat16" else t_f32
                bound, by = max((t_b, "bytes"), (t_o, "operations"))
                line.update(kernel_ms=k_ms, kernel_eager_ms=k_eager,
                            plain_ms=p_ms,
                            library_ms=l_ms, library="autograd fwd+bwd of "
                            "the plain model (cuBLAS, complex64 matmul)",
                            bytes=n_bytes, flops=flops, bytes_ms=t_b,
                            f32_ops_ms=t_f32, bf16_tensor_core_ops_ms=t_bf16,
                            bound_ms=bound, bound_by=by)
                if dtype == "bfloat16":    # the main path's GEMM inputs
                    result = {"max_abs_err": err, "ms": k_ms,
                              "eager_ms": k_eager,
                              "plain_ms": p_ms, "bound_ms": bound,
                              "bound_by": by, "library_ms": l_ms,
                              "check": "pass"}
            log(f"dccn_fused_grads nbits {nbits} {dtype}, {b} frames: "
                f"kernel == plain version (forward e {e_err:.3g} of max, "
                f"max |dg| {err:.3g}, counts off by {dconf}, {ambiguous} "
                f"ambiguous bits)")
            print(json.dumps(line), flush=True)
    result["by_frames"] = model_sizes(tfm, dev, hbm_bps)
    result["library_bf16_gemms_ms"] = \
        result["by_frames"][TRAIN_FRAMES[1]]["bf16_gemms_ms"]
    return result


def bf16_gemms(spec, b: int, dev):
    """The model kernel's five GEMMs at b frames as bf16 `torch.mm` with
    float32 output where torch offers it (cuBLAS tensor cores): a yardstick
    timed here, never called by the port.  Returns (fn, output dtype)."""
    import torch
    s_, p_, f_, d_ = spec.nsymbol, spec.sps, spec.nfilter, spec.frame_size
    bs, x2w, e2 = b * s_, s_ * 2 * f_, 2 * d_
    bf = dict(device=dev, dtype=torch.bfloat16)
    x, wexp = torch.randn(bs, 2 * p_, **bf), torch.randn(2 * p_, 2 * f_, **bf)
    x2, we = torch.randn(b, x2w, **bf), torch.randn(e2, x2w, **bf)
    de, dx2 = torch.randn(b, e2, **bf), torch.randn(bs, 2 * f_, **bf)
    try:
        torch.mm(x[:8], wexp, out_dtype=torch.float32)
        kw = {"out_dtype": torch.float32}
    except (TypeError, RuntimeError):
        kw = {}

    def fn():
        torch.mm(x, wexp, **kw)
        torch.mm(x2, we.T, **kw)
        torch.mm(de.T, x2, **kw)
        torch.mm(de, we, **kw)
        torch.mm(x.T, dx2, **kw)
    return fn, "float32" if kw else "bfloat16"


def model_sizes(tfm, dev, hbm_bps) -> dict:
    """Phase 7, second part: the bf16 kernel at bench.py's four batch sizes
    (nbits 1, random planes) beside its bound, its plain version, the
    float32 autograd yardstick and the five GEMMs as bf16 cuBLAS calls."""
    import torch
    from dl_ofdm_tpu_torch.models.dccn import DCCNReceiver
    spec = tfm.ModelSpec(nsymbol=7, sps=80, nfilter=64, frame_size=320,
                         nbits=1, matmul_dtype="bfloat16")
    rx = DCCNReceiver(nbits=1, nfft=64, cp_len=16, nfilter=64,
                      frame_size=320).to(dev)
    rx.reset_parameters(torch.Generator(device=dev).manual_seed(70))
    params = {k: v.detach() for k, v in rx.state_dict().items()}
    n_params = sum(v.numel() for v in params.values())
    gen = torch.Generator(device=dev).manual_seed(71)
    out = {}
    for b in TRAIN_FRAMES:
        planes = [torch.randn(b, 560, device=dev, generator=gen)
                  for _ in range(4)]
        c = 0.5 + torch.rand(6, 560, device=dev, generator=gen)
        idx = torch.randint(0, 2, (b, 320), device=dev, generator=gen,
                            dtype=torch.int32)
        args = (spec, b, params, *planes, c, idx)
        x = torch.stack([planes[0] * c[0] + planes[2] * c[1] - c[2],
                         planes[1] * c[3] + planes[3] * c[4] - c[5]],
                        -1).reshape(b, 7, 80, 2)
        bits = idx.reshape(b, 320, 1).to(torch.int64)
        gemms, gemm_dtype = bf16_gemms(spec, b, dev)
        # the kernel and the cuBLAS GEMMs: device time from a CUDA graph,
        # and eager; the plain version and autograd: eager
        graphed = {"kernel": lambda: tfm.dccn_fused_grads_kernel(*args),
                   "bf16_gemms": gemms}
        runs = {"plain": lambda: tfm.dccn_fused_grads_ref(*args),
                "autograd_f32": lambda: library_step(params, x, bits)}
        iters = {"plain": 5, "autograd_f32": 10}
        times = {n: [] for n in (*graphed, *runs)}
        for n in ("kernel", "bf16_gemms", "plain", "autograd_f32",
                  "bf16_gemms", "kernel"):
            times[n].append(time_ms(graphed[n], 20) if n in graphed
                            else (events_ms(runs[n], iters[n]),) * 2)
        ms = {n: sum(t[0] for t in v) / len(v) for n, v in times.items()}
        eager = {n: sum(t[1] for t in v) / len(v) for n, v in times.items()}
        n_bytes, flops = model_work(spec, b, n_params)
        bound, by = max((n_bytes / hbm_bps * 1e3, "bytes"),
                        (flops / BF16_FLOPS * 1e3, "operations"))
        row = {"frames": b, "kernel_ms": ms["kernel"],
               "kernel_eager_ms": eager["kernel"],
               "plain_ms": ms["plain"], "autograd_f32_ms": ms["autograd_f32"],
               "bf16_gemms_ms": ms["bf16_gemms"],
               "bf16_gemms_eager_ms": eager["bf16_gemms"],
               "bf16_gemms_out_dtype": gemm_dtype, "bound_ms": bound,
               "bound_by": by, "bound_share": bound / ms["kernel"]}
        out[b] = row
        print(json.dumps({"phase": 7, "sizes": True, **row}), flush=True)
        log(f"dccn_fused_grads bf16 {b:6d} frames: kernel "
            f"{ms['kernel']:.4f} ms (eager {eager['kernel']:.4f}), five "
            f"bf16 cuBLAS GEMMs "
            f"{ms['bf16_gemms']:.4f} ({gemm_dtype} out), plain "
            f"{ms['plain']:.3f}, autograd f32 {ms['autograd_f32']:.3f}, "
            f"bound {bound:.4f} ({by})")
    return out


def phase_train(tfm, tfs, dev) -> dict:
    """Phase 8: the training step at full width; returns the kernels'
    launch counts on the fused main path."""
    import torch
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.ops.pallas_kernels import complex_dense_kernel
    from dl_ofdm_tpu_torch.train.loop import Trainer
    cfg = OFDMConfig(nbits=1)
    steps = 20
    trainers = {}
    for frames in TRAIN_FRAMES:
        tr = Trainer(cfg, TrainConfig(batch_size=frames * 7), channel="ETU")
        assert tr.batch_frames == frames and tr._use_fused_model
        trainers[frames] = tr
    torch.cuda.synchronize()
    tfs.fused_synthesize_kernel.launches = 0
    tfm.dccn_fused_grads_kernel.launches = 0
    complex_dense_kernel.launches = 0
    fused_steps = 0
    rows = []
    for frames, tr in trainers.items():
        gen = torch.Generator(device=dev).manual_seed(frames)
        state = tr.init_state(gen)
        snr = torch.full((frames,), 5.0, device=dev)
        state, aux = tr.train_step(state, gen, snr)      # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(steps):
            state, aux = tr.train_step(state, gen, snr)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3 / steps
        fused_steps += steps + 1
        if not torch.isfinite(aux["loss"]):
            raise AssertionError(f"train step at {frames} frames: loss "
                                 f"{float(aux['loss'])}")
        rows.append({"frames": frames, "route": "fused", "ms_per_step": ms,
                     "iq_samples_per_s": frames * 7 * 80 / (ms / 1e3),
                     "ce": float(aux["ce"]), "ber": float(aux["ber"])})
    torch.cuda.synchronize()
    launches = {"fused_synthesize": tfs.fused_synthesize_kernel.launches,
                "dccn_fused_grads": tfm.dccn_fused_grads_kernel.launches}
    log(f"training main path: {fused_steps} fused steps, launches "
        f"{launches}, complex_dense {complex_dense_kernel.launches}")
    for name, n in launches.items():
        if n != fused_steps:
            raise AssertionError(f"{name} launched {n} times in "
                                 f"{fused_steps} fused steps")
    for frames, tr in trainers.items():        # the autograd route
        gen = torch.Generator(device=dev).manual_seed(1)
        state = tr.init_state(gen)
        snr = torch.full((frames,), 5.0, device=dev)
        state, _ = tr.train_step(state, gen, snr, fused=False)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(steps):
            state, aux = tr.train_step(state, gen, snr, fused=False)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3 / steps
        rows.append({"frames": frames, "route": "autograd",
                     "ms_per_step": ms,
                     "iq_samples_per_s": frames * 7 * 80 / (ms / 1e3)})
    frames = TRAIN_FRAMES[1]
    snr = torch.full((frames,), 5.0, device=dev)
    # the model kernel twice on one synthesized batch: split-K partials are
    # summed in a fixed order, so the outputs are bit-identical
    tr = trainers[frames]
    gen = torch.Generator(device=dev).manual_seed(8)
    state = tr.init_state(gen)
    idx, yr, yi, nr, ni, stats = tfs.fused_synthesize(
        tr._fused_synth_spec, frames, gen, snr, raw=True)
    _, c, _, _ = tfs._combine_stats(stats.sum(0), frames)
    outs = [tfm.dccn_fused_grads_kernel(tr._fused_model_spec, frames,
                                        state.params, yr, yi, nr, ni, c, idx)
            for _ in range(2)]
    torch.cuda.synchronize()
    (g1, ce1, conf1), (g2, ce2, conf2) = outs
    if not (all(torch.equal(g1[k], g2[k]) for k in g1)
            and torch.equal(ce1, ce2) and torch.equal(conf1, conf2)):
        raise AssertionError("two calls of the model kernel on one batch "
                             "differ")
    log(f"dccn_fused_grads ({tr._fused_model_spec.matmul_dtype}), two calls "
        f"on one {frames}-frame batch: gradients, CE and counts "
        f"bit-identical")
    for row in rows:
        log(f"train step {row['route']:8s} {row['frames']:6d} frames: "
            f"{row['ms_per_step']:.3f} ms/step, "
            f"{row['iq_samples_per_s']:.4g} IQ samples/s")
        print(json.dumps({"phase": 8, **row}), flush=True)

    # the two routes from one init on the same batches (float32 products)
    tr = Trainer(cfg, TrainConfig(batch_size=frames * 7,
                                  fused_model_matmul_dtype="float32"),
                 channel="ETU")
    finals, first = {}, {}
    for fused in (True, False):
        state = tr.init_state(torch.Generator(device=dev).manual_seed(5))
        gen = torch.Generator(device=dev).manual_seed(6)
        for i in range(steps):
            state, aux = tr.train_step(state, gen, snr, fused=fused,
                                       return_grads=i == 0)
            if i == 0:
                first[fused] = aux["grads"]
        finals[fused] = state.params
    torch.cuda.synchronize()
    # two float32 routes with sums in other orders: a pre-activation within
    # ~1e-6 of a leaky kink takes the other slope, which moves a leaf by up
    # to ~1e-2 of its max at this batch size (phase 7's float32 plain
    # version against autograd: 1.3e-2 on an H100); a wrong layout, sign or
    # scale moves it by O(1)
    gerr = check_grads("step-1 gradients, fused vs autograd route",
                       first[True], first[False], 5e-2)
    pdiff = max(float((finals[True][k] - finals[False][k]).abs().max())
                for k in finals[True])
    log(f"fused vs autograd route: step-1 gradients max |dg| {gerr:.3g}; "
        f"after {steps} steps max |dparam| {pdiff:.3g}")
    print(json.dumps({"phase": 8, "routes_step1_grad_err": gerr,
                      "routes_param_diff_after_20": pdiff}), flush=True)

    # fit from init_state on AWGN at 5 dB
    tr = Trainer(cfg, TrainConfig(snr=5.0), channel="AWGN")
    t = time.time()
    _, info = tr.fit(max_epochs=3, log_fn=lambda m: log(f"  fit {m}"))
    hist = info["history"]
    print(json.dumps({"phase": 8, "fit_seconds": time.time() - t,
                      "fit_history": hist}), flush=True)
    if not hist[-1]["train_loss"] < hist[0]["train_loss"]:
        raise AssertionError(f"fit did not lower the train CE: {hist}")
    return launches


def bound_of(n_bytes, flops, hbm_bps, f32_flops, int_ops=0, sfu_ops=0):
    """(least ms, "bytes" or "operations"): the bytes over the memory rate
    against the operations over their peak rates.  A Hopper SM has 128
    float32 lanes (two operations an FMA), 64 for 32-bit integer
    arithmetic and logic and 16 for the special functions (CUDA C++
    Programming Guide, arithmetic throughput of compute capability 9.0),
    so integer operations run at a quarter of `f32_flops` and special
    functions at a sixteenth; every instruction also takes one of the
    SM's 128 issue slots a clock, FMAs counted two operations to one."""
    t_b = n_bytes / hbm_bps * 1e3
    t_o = max(flops / f32_flops, 4 * int_ops / f32_flops,
              16 * sfu_ops / f32_flops,
              (flops + 2 * int_ops + 2 * sfu_ops) / f32_flops) * 1e3
    return max((t_b, "bytes"), (t_o, "operations"))


def compare_synth(tfs, spec, seeds, std, want_h, tol, name):
    """The synth kernel against its plain version on the same words:
    indices equal, planes (and h) within `tol`.  Returns (kernel output,
    max |diff|, noise var/std^2, bit mean)."""
    import torch
    b = std.shape[0]
    got = tfs.fused_synthesize_kernel(spec, seeds, std, want_h=want_h)
    want = tfs.fused_synthesize_ref(spec, b, std, seeds=seeds, want_h=want_h)
    torch.cuda.synchronize()
    if not torch.equal(got[0], want[0]):
        raise AssertionError(f"fused_synth {name}: indices differ")
    pairs = list(zip(got[1:5], want[1:5])) + list(zip(got[6:], want[6:]))
    for a, w in pairs:
        if a.shape != w.shape:
            raise AssertionError(f"fused_synth {name}: shape {tuple(a.shape)}"
                                 f" != {tuple(w.shape)}")
    err = max(float((a - w).abs().max()) for a, w in pairs)
    if err > tol:
        raise AssertionError(f"fused_synth {name}: planes differ by "
                             f"{err:.3g} > {tol}")
    torch.testing.assert_close(got[5].sum(0), want[5][0], atol=1e-3,
                               rtol=1e-5)
    noise = torch.cat([got[3], got[4]])
    var = float(noise.var() / std[0] ** 2)
    bits = float(tfs._bits_from_idx(got[0], spec.nbits).float().mean())
    if abs(var - 1) > 0.01 or abs(bits - 0.5) > 0.01:
        raise AssertionError(f"fused_synth {name}: noise var/std^2 "
                             f"{var:.4f}, bit mean {bits:.4f}")
    return got, err, var, bits


def phase_synth_mobile(tfs, dev, hbm_bps, f32_flops) -> dict:
    """Phase 9: the synth kernel's Doppler rows and true channel against
    its plain version."""
    import torch
    out = {}
    seeds = torch.tensor([0x2468ACE0, 0x0BADF00D], dtype=torch.int64,
                         device=dev)
    for channel, nbits, b, want_h in MOBILE_CASES:
        spec = synth_spec(channel, nbits, mobile=True)
        std = tfs.noise_std(torch.full((b,), 5.0, device=dev))
        name = f"{channel} mobile nbits {nbits}{' want_h' if want_h else ''}"
        _, err, var, bits = compare_synth(tfs, spec, seeds, std, want_h,
                                          5e-6, name)
        n_dop = int(tfs.doppler_rows(spec, b).sum())
        line = {"phase": 9, "channel": channel, "nbits": nbits, "frames": b,
                "doppler_rows": n_dop, "want_h": want_h, "max_abs_err": err,
                "noise_var_over_std2": var, "bit_mean": bits}
        if channel == "mixRayleigh":
            k_ms = events_ms(lambda: tfs.fused_synthesize_kernel(
                spec, seeds, std), 50)
            p_ms = events_ms(lambda: tfs.fused_synthesize_ref(
                spec, b, std, seeds=seeds), 10)
            n_bytes, flops, int_ops, sfu = synth_work(spec, b, n_dop)
            bound, by = bound_of(n_bytes, flops, hbm_bps, f32_flops,
                                 int_ops, sfu)
            line.update(kernel_ms=k_ms, plain_ms=p_ms, bytes=n_bytes,
                        flops=flops, int_ops=int_ops, special_functions=sfu,
                        bound_ms=bound, bound_by=by)
            out["line"] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                           "bound_ms": bound, "bound_by": by,
                           "library_ms": None, "check": "pass"}
        out["max_abs_err"] = max(out.get("max_abs_err", 0.0), err)
        log(f"fused_synthesize {name}, {b} frames ({n_dop} Doppler rows): "
            f"kernel == plain version (indices equal, planes"
            f"{' and h' if want_h else ''} max |diff| {err:.3g}), noise "
            f"var/std^2 {var:.4f}, bit mean {bits:.4f}")
        print(json.dumps(line), flush=True)
    return out


def phase_long_frames(tfs, tfm, dev) -> None:
    """Phase 10: frames longer than 640 samples (nfft 128, both CP
    lengths) on the fused route."""
    import torch
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.train.loop import Trainer
    frames = TRAIN_FRAMES[0]
    for longcp in (True, False):
        cfg = OFDMConfig(nbits=1, nfft=128, longcp=longcp)
        tr = Trainer(cfg, TrainConfig(batch_size=frames * 7), channel="ETU")
        spec = tr._fused_synth_spec
        if not tr._use_fused_model:
            raise AssertionError(f"nfft 128 longcp={longcp}: no fused route")
        seeds = torch.tensor([77, 2**32 - 77], dtype=torch.int64, device=dev)
        std = tfs.noise_std(torch.full((frames,), 5.0, device=dev))
        _, err, _, _ = compare_synth(tfs, spec, seeds, std, False, 1e-4,
                                     f"nfft 128 longcp={longcp}")
        gen = torch.Generator(device=dev).manual_seed(3)
        state = tr.init_state(gen)
        snr = torch.full((frames,), 5.0, device=dev)
        n_s = tfs.fused_synthesize_kernel.launches
        n_m = tfm.dccn_fused_grads_kernel.launches
        state, aux = tr.train_step(state, gen, snr)      # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(5):
            state, aux = tr.train_step(state, gen, snr)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3 / 5
        launches = (tfs.fused_synthesize_kernel.launches - n_s,
                    tfm.dccn_fused_grads_kernel.launches - n_m)
        if launches != (6, 6) or not torch.isfinite(aux["loss"]):
            raise AssertionError(f"nfft 128 longcp={longcp}: launches "
                                 f"{launches}, loss {float(aux['loss'])}")
        line = {"phase": 10, "nfft": 128, "longcp": longcp, "sps": spec.sps,
                "frame_samples": spec.length, "fir_u": spec.fir_u,
                "plan": tfs.synth_launch_plan(spec, frames,
                                              dev.index or 0)._asdict(),
                "frames": frames, "max_abs_err": err, "ms_per_step": ms,
                "ce": float(aux["ce"])}
        log(f"nfft 128 longcp={longcp}: sps {spec.sps}, {spec.length} "
            f"samples, kernel == plain version (max |diff| {err:.3g}); "
            f"fused step {ms:.3f} ms at {frames} frames, CE "
            f"{float(aux['ce']):.4f}")
        print(json.dumps(line), flush=True)


def phase_train_mobile(tfm, tfs, dev) -> dict:
    """Phase 11: the mobile training path; returns the kernels' launch
    counts on it."""
    import torch
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.eval.sweep import ber_sweep
    from dl_ofdm_tpu_torch.ops.pallas_kernels import complex_dense_kernel
    from dl_ofdm_tpu_torch.train.loop import Trainer
    cfg = OFDMConfig(nbits=1)
    steps = 20
    trainers = {}
    for frames in TRAIN_FRAMES:
        tr = Trainer(cfg, TrainConfig(batch_size=frames * 7),
                     channel="mixRayleigh", mobile=True)
        assert tr.batch_frames == frames and tr._use_fused_model
        assert tr._fused_synth_spec.mobile
        trainers[frames] = tr
    torch.cuda.synchronize()
    tfs.fused_synthesize_kernel.launches = 0
    tfm.dccn_fused_grads_kernel.launches = 0
    complex_dense_kernel.launches = 0
    fused_steps = 0
    for frames, tr in trainers.items():
        gen = torch.Generator(device=dev).manual_seed(frames + 1)
        state = tr.init_state(gen)
        snr = torch.full((frames,), 5.0, device=dev)
        state, aux = tr.train_step(state, gen, snr)      # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(steps):
            state, aux = tr.train_step(state, gen, snr)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3 / steps
        fused_steps += steps + 1
        if not torch.isfinite(aux["loss"]):
            raise AssertionError(f"mobile train step at {frames} frames: "
                                 f"loss {float(aux['loss'])}")
        row = {"phase": 11, "frames": frames, "route": "fused",
               "channel": "mixRayleigh mobile", "ms_per_step": ms,
               "iq_samples_per_s": frames * 7 * 80 / (ms / 1e3),
               "ce": float(aux["ce"]), "ber": float(aux["ber"])}
        log(f"mobile train step fused {frames:6d} frames: {ms:.3f} ms/step, "
            f"{row['iq_samples_per_s']:.4g} IQ samples/s")
        print(json.dumps(row), flush=True)
    torch.cuda.synchronize()
    launches = {"fused_synthesize": tfs.fused_synthesize_kernel.launches,
                "dccn_fused_grads": tfm.dccn_fused_grads_kernel.launches}
    log(f"mobile training path: {fused_steps} fused steps, launches "
        f"{launches}, complex_dense {complex_dense_kernel.launches}")
    for name, n in launches.items():
        if n != fused_steps:
            raise AssertionError(f"{name} launched {n} times in "
                                 f"{fused_steps} mobile fused steps")

    tr = Trainer(cfg, TrainConfig(snr=5.0), channel="mixRayleigh",
                 mobile=True)
    t = time.time()
    state, info = tr.fit(max_epochs=3, log_fn=lambda m: log(f"  fit {m}"))
    hist = info["history"]
    print(json.dumps({"phase": 11, "fit_seconds": time.time() - t,
                      "fit_history": hist}), flush=True)
    if not hist[-1]["train_loss"] < hist[0]["train_loss"]:
        raise AssertionError(f"mobile fit did not lower the train CE: {hist}")

    sweeper = Trainer(cfg, TrainConfig(), channel="ETU", mobile=True)
    sweeper.model.load_state_dict(state.params)
    gen = torch.Generator(device=dev).manual_seed(41)
    torch.cuda.synchronize()
    t = time.time()
    res = ber_sweep(sweeper, gen, snrs=SNRS, frames_per_point=2000,
                    batch_frames=2000, log_fn=lambda *a: None)
    torch.cuda.synchronize()
    wall = time.time() - t
    ber = np.asarray(res.ber)
    i10 = SNRS.index(10)
    print(json.dumps({"phase": 11, "sweep": "ETU mobile interleaved",
                      "seconds": wall, "ber": ber.tolist()}), flush=True)
    log(f"ETU mobile sweep, 41 points x 2,000 frames: {wall:.3f} s; BER "
        f"{ber[0]:.4g} at -10 dB, {ber[i10]:.4g} at 10 dB, {ber[-1]:.4g} "
        f"at 30 dB")
    if not (np.all(np.isfinite(ber)) and ber[0] > ber[i10] >= ber[-1]):
        raise AssertionError(f"ETU mobile sweep BERs do not fall with SNR: "
                             f"{ber.tolist()}")
    return launches


def phase_probe(dev, hbm_bps, f32_flops) -> dict:
    """Phase 12: the PRNG probe on the card; its time from a CUDA graph
    (eager beside it) against max(bytes, integer operations)."""
    import torch
    from dl_ofdm_tpu_torch.ops import prng_probe as pp
    torch.cuda.synchronize()
    pp.probe_words_kernel.launches = 0
    q = pp.main()
    launches = pp.probe_words_kernel.launches
    if launches < 1:
        raise AssertionError("the probe's entry point did not launch its "
                             "kernel")
    seeds = torch.tensor(pp.SEEDS, dtype=torch.int64, device=dev)
    times = {"kernel": [], "plain": []}
    for n in ("kernel", "plain", "plain", "kernel"):
        times[n].append(time_ms(lambda: pp.probe_words_kernel(seeds), 100)
                        if n == "kernel" else
                        (events_ms(lambda: pp.probe_words_ref(seeds), 10),))
    k_ms = sum(t[0] for t in times["kernel"]) / 2
    k_eager = sum(t[1] for t in times["kernel"]) / 2
    p_ms = sum(t[0] for t in times["plain"]) / 2
    n_words = pp.N_STREAMS * pp.ROWS * pp.N_WORDS
    n_bytes = 16 + 4 * n_words
    int_ops = PHILOX_INT_OPS * n_words // 4
    bound, by = bound_of(n_bytes, 0, hbm_bps, f32_flops, int_ops)
    words = pp.probe_words_kernel(seeds).to(torch.int64) & 0xFFFFFFFF
    err = float((words - pp.probe_words_ref(seeds)).abs().max())
    line = {"phase": 12, **q, "kernel_ms": k_ms, "eager_ms": k_eager,
            "kernel_ms_runs": [t[0] for t in times["kernel"]],
            "plain_ms": p_ms, "bytes": n_bytes, "int_ops": int_ops,
            "bytes_ms": n_bytes / hbm_bps * 1e3,
            "int_ops_ms": 4 * int_ops / f32_flops * 1e3, "bound_ms": bound,
            "bound_by": by, "share_of_bound": bound / k_ms,
            "launches": launches,
            "timing": "CUDA graph of 100 calls; eager: events around 100 "
                      "calls"}
    print(json.dumps(line), flush=True)
    log(f"philox_probe: words == philox_words, checks pass; kernel "
        f"{k_ms:.4f} ms graph, {k_eager:.4f} eager; plain {p_ms:.3f} ms; "
        f"bound {bound:.4f} ms ({by}; integer work "
        f"{line['int_ops_ms']:.4f}): {100 * bound / k_ms:.0f} % of it")
    return {"launches": launches, "max_abs_err": err, "ms": k_ms,
            "eager_ms": k_eager, "plain_ms": p_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None, "check": "pass"}


# (channel, frames) of phase 13: one offset (ETU), four offsets and
# zero-padded short kernels (mixRayleigh); the sweep's batch and the
# equalizer stage's reference batch
FIR_CASES = (("ETU", 30000), ("mixRayleigh", 30000), ("ETU", 73),
             ("mixRayleigh", 73))
FIR_LEN = 560                      # samples of a frame (7 x 80)
# phase 14: the gate cells of `runs/resweep_claims.py`, its seed and the
# band each cell's BER must keep against `runs/p19_resweep_claims.json`
GATE_CHANS = ("EPA", "EVA", "ETU")
GATE_PTS = (20, 30)
GATE_SEED = 1919
GATE_BAND = (0.8, 1.25)
GATE_FRAMES = 30000                # frames a point, in one batch
EQ_FRAMES = (73, 9362)             # equalizer stage: reference batch, bench
EQ_STEPS = 20                      # timed steps a size and route (phase 15)
EQ_PROFILE_STEPS = {73: 20, 9362: 5}   # phase 17's steps, by frames
EQ_MOBILE_STEPS = 10               # timed steps a route (phase 16)


def fir_planes(channel: str, b: int, gen):
    """What `fir_same_iq` hands the kernel for `b` frames of `channel`:
    the pre-aligned planes of random frames and the channel's own FIR
    kernels (CN(0,1) tap gains through the profiles' alpha matrices), with
    the x and h it made them from and the rows' offsets."""
    import torch
    import torch.nn.functional as F
    from dl_ofdm_tpu_torch.channel import fir
    from dl_ofdm_tpu_torch.channel.rayleigh import RayleighChannel
    ch = RayleighChannel(channel)
    dev = gen.device
    prof = ch._frame_profiles(b)
    offsets = ch._offset_np[prof]
    coeff = torch.from_numpy(ch._coeff_np[prof]).to(dev)
    alpha = torch.from_numpy(ch._alpha_np[prof]).to(dev)
    zck = torch.randn(b, ch.max_taps, 2, device=dev, generator=gen) / 2 ** 0.5
    h = torch.einsum("btc,btf->bfc", zck * coeff[..., None], alpha)
    x = torch.randn(b, FIR_LEN, 2, device=dev, generator=gen)
    f = h.shape[1]
    xa = [fir._prealign_plane(F.pad(x[..., i], (f - 1, f - 1)), offsets,
                              FIR_LEN + f - 1).contiguous() for i in (0, 1)]
    hp = [h[..., i].contiguous() for i in (0, 1)]
    return x, h, offsets, xa, hp


def conv1d_fir(xa, hp):
    """The same complex FIR as one grouped `F.conv1d` (a yardstick, not
    the port): group b has channels (re, im) in and out, weight
    [[hr, -hi], [hi, hr]] flipped along the taps."""
    import torch
    import torch.nn.functional as F
    b = xa[0].shape[0]
    x = torch.stack(xa, 1).reshape(1, 2 * b, -1)
    hr, hi = hp
    w = torch.stack([torch.stack([hr, -hi], 1), torch.stack([hi, hr], 1)],
                    1).flip(-1).reshape(2 * b, 2, -1)
    return lambda: F.conv1d(x, w, groups=b)


def phase_fir(tpk, dev, hbm_bps, f32_flops) -> dict:
    """Phase 13: `fir_shift_accum` against its plain version, and
    `fir_same_iq` on the card against the plain loop."""
    import torch
    from dl_ofdm_tpu_torch.channel import fir
    gen = torch.Generator(device=dev).manual_seed(13)
    out = {"max_abs_err": 0.0}
    torch.cuda.synchronize()
    tpk.fir_shift_accum_kernel.launches = 0
    for channel, b in FIR_CASES:
        x, h, offsets, xa, hp = fir_planes(channel, b, gen)
        f = h.shape[1]
        yr, yi = tpk.fir_shift_accum_kernel(*xa, *hp, FIR_LEN)
        wr, wi = tpk.fir_shift_accum_ref(*xa, *hp, FIR_LEN)
        y = fir.fir_same_iq(x, h, offsets)
        torch.cuda.synchronize()
        scale = float(torch.maximum(wr.abs().max(), wi.abs().max()))
        err = max(float((yr - wr).abs().max()), float((yi - wi).abs().max()))
        err_same = float((y - torch.stack([wr, wi], -1)).abs().max())
        if err or err_same:     # the plain version's operations, in order
            raise AssertionError(
                f"fir_shift_accum {channel} {b}: kernel {err:.3g}, "
                f"fir_same_iq {err_same:.3g} from the plain version; want "
                "bit-equal")
        lib = conv1d_fir(xa, hp)
        yc = lib()
        err_lib = float((yc.reshape(b, 2, FIR_LEN).transpose(1, 2)
                         - torch.stack([wr, wi], -1)).abs().max())
        out["max_abs_err"] = max(out["max_abs_err"], err)
        line = {"phase": 13, "channel": channel, "frames": b, "taps": f,
                "offsets": sorted(set(int(o) for o in offsets)),
                "max_abs_err": err, "fir_same_iq_err": err_same,
                "max_abs_y": scale, "conv1d_err": err_lib}
        if b == 30000:
            runs = {"kernel": lambda: tpk.fir_shift_accum_kernel(
                        *xa, *hp, FIR_LEN),
                    "plain": lambda: tpk.fir_shift_accum_ref(
                        *xa, *hp, FIR_LEN),
                    "library": lib}
            times = {n: [] for n in runs}
            for n in ("plain", "kernel", "library", "library", "kernel",
                      "plain"):
                times[n].append(events_ms(runs[n],
                                          10 if n == "plain" else 50))
            ms = {n: sum(v) / len(v) for n, v in times.items()}
            n_bytes = 4 * (2 * b * (FIR_LEN + f - 1) + 2 * b * f
                           + 2 * b * FIR_LEN)
            flops = 8 * b * FIR_LEN * f
            bound, by = bound_of(n_bytes, flops, hbm_bps, f32_flops)
            line.update(kernel_ms=ms["kernel"], plain_ms=ms["plain"],
                        conv1d_ms=ms["library"], bytes=n_bytes, flops=flops,
                        bound_ms=bound, bound_by=by)
            if channel == "ETU":
                out.update(ms=ms["kernel"], plain_ms=ms["plain"],
                           library_ms=ms["library"], bound_ms=bound,
                           bound_by=by)
            log(f"fir_shift_accum {channel} {b} x {FIR_LEN}, {f} taps: "
                f"kernel {ms['kernel']:.4f} ms, plain {ms['plain']:.3f} ms, "
                f"grouped conv1d {ms['library']:.4f} ms, bound {bound:.4f} "
                f"ms ({by})")
        log(f"fir_shift_accum {channel} {b}: kernel == plain version (max "
            f"|diff| {err:.3g}, fir_same_iq {err_same:.3g}, max |y| "
            f"{scale:.3g}); conv1d differs by {err_lib:.3g}")
        print(json.dumps(line), flush=True)
    torch.cuda.synchronize()
    out["launches_compare"] = tpk.fir_shift_accum_kernel.launches
    out["check"] = "pass"
    return out


def phase_cdense_eq(tpk, dev, hbm_bps, f32_flops) -> None:
    """Phase 13, second part: `complex_dense` at the equalizer's shapes
    (`ToFreq`, `CorrT`, `ToTime`: K = F = 64 on B x 7 rows, B = 30,000
    when serving and 73 when training) against its plain version,
    atol = rtol = 1e-5 as in phase 3; times at the serving shape."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(64)
    for m in (30000 * 7, 73 * 7):
        x = torch.randn(m, 64, 2, device=dev, generator=gen)
        wr, wi = (torch.randn(64, 64, device=dev, generator=gen) / 8
                  for _ in range(2))
        with torch.no_grad():
            y = tpk.complex_dense_kernel(x, wr, wi)
            y_ref = tpk.complex_dense_ref(x, wr, wi)
        torch.cuda.synchronize()
        torch.testing.assert_close(y, y_ref, atol=1e-5, rtol=1e-5)
        line = {"phase": 13, "kernel": "complex_dense", "shape": [m, 64, 64],
                "max_abs_err": float((y - y_ref).abs().max())}
        if m > 10000:
            x_c, w_c = torch.view_as_complex(x), torch.complex(wr, wi)
            with torch.no_grad():
                ms = {n: events_ms(fn, 50) for n, fn in (
                    ("kernel", lambda: tpk.complex_dense_kernel(x, wr, wi)),
                    ("plain", lambda: tpk.complex_dense_ref(x, wr, wi)),
                    ("library", lambda: torch.matmul(x_c, w_c)))}
            n_bytes = 4 * (2 * m * 64 + 2 * 64 * 64 + 2 * m * 64)
            bound, by = bound_of(n_bytes, 8 * m * 64 * 64, hbm_bps,
                                 f32_flops)
            line.update(kernel_ms=ms["kernel"], plain_ms=ms["plain"],
                        library_ms=ms["library"], bound_ms=bound,
                        bound_by=by)
        log(f"complex_dense [{m},64,2]x[64,64]: kernel == plain version, "
            f"max |diff| {line['max_abs_err']:.3g}"
            + (f"; kernel {line['kernel_ms']:.4f} ms, plain "
               f"{line['plain_ms']:.4f}, complex64 matmul "
               f"{line['library_ms']:.4f}, bound {line['bound_ms']:.4f} ms"
               if "kernel_ms" in line else ""))
        print(json.dumps(line), flush=True)


def path_counts(tpk, tfs):
    """The launch counts of every kernel on the equalizer stage's paths."""
    return {"fir_shift_accum": tpk.fir_shift_accum_kernel.launches,
            "complex_dense": tpk.complex_dense_kernel.launches,
            "fused_synth": tfs.fused_synthesize_kernel.launches}


def zero_counts(tpk, tfs) -> None:
    import torch
    torch.cuda.synchronize()
    tpk.fir_shift_accum_kernel.launches = 0
    tpk.complex_dense_kernel.launches = 0
    tfs.fused_synthesize_kernel.launches = 0


def phase_serve_arms(tpk, tfs, dev) -> dict:
    """Phase 14: the nine committed equalizer arms on the gate cells, as
    `runs/resweep_claims.py:65-91` sweeps them; returns the launches."""
    import torch
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.eval.sweep import ber_sweep
    from dl_ofdm_tpu_torch.train.checkpoint import (load_params_npz,
                                                    params_from_flax)
    from dl_ofdm_tpu_torch.train.equalizer_loop import EqualizerTrainer
    arms = os.path.join(ROOT, "runs", "arms")
    manifest = json.load(open(os.path.join(arms, "MANIFEST.json")))
    claims = json.load(open(os.path.join(ROOT, "runs",
                                         "p19_resweep_claims.json")))
    eq_arms = sorted(k for k, v in manifest.items()
                     if v["kind"] == "equalizer")
    if len(eq_arms) != 9:
        raise AssertionError(f"MANIFEST.json lists {len(eq_arms)} "
                             "equalizer arms, not 9")
    zero_counts(tpk, tfs)
    t0 = time.time()
    bad, cells = [], []
    for name in eq_arms:
        info = manifest[name]
        nbits, mobile, opt = info["nbits"], info["mobile"], info["opt"]
        snr = 5.0 * nbits
        base = params_from_flax(load_params_npz(os.path.join(
            arms, f"OFDM_Dense3_{nbits}mod_snr{int(snr)}_cpTrue.npz")))
        params = params_from_flax(load_params_npz(os.path.join(
            arms, name + ".npz")))
        ref = claims["arms"][name]["cells"]
        for chan in GATE_CHANS:
            eq = EqualizerTrainer(
                OFDMConfig(nbits=nbits), TrainConfig(
                    snr=snr, batch_size=512, opt=opt),
                channel=chan, mobile=mobile, pretrained_rx=base)
            eq.model.load_state_dict(params, strict=True)
            gen = torch.Generator(device=dev).manual_seed(GATE_SEED)
            res = ber_sweep(eq, gen, snrs=GATE_PTS,
                            frames_per_point=GATE_FRAMES,
                            batch_frames=GATE_FRAMES, log_fn=lambda *a: None,
                            point_batch=True)
            for pt, ber in zip(GATE_PTS, res.ber):
                want = ref[chan][str(pt)]
                ratio = float(ber) / want
                ok = GATE_BAND[0] <= ratio <= GATE_BAND[1]
                cells.append({"arm": name, "channel": chan, "snr": pt,
                              "ber": float(ber), "jax_ber": want,
                              "ratio": ratio, "in_band": ok})
                log(f"  {name} {chan}{' mobile' if mobile else ''} {pt} dB: "
                    f"BER {float(ber):.6g}, JAX {want:.6g}, ratio "
                    f"{ratio:.4f}{'' if ok else '  OUT OF BAND'}")
                if not (ok and np.isfinite(ber)):
                    bad.append((name, chan, pt, ratio))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = path_counts(tpk, tfs)
    ratios = [c["ratio"] for c in cells]
    print(json.dumps({"phase": 14, "cells": cells, "seconds": wall,
                      "launches": launches}), flush=True)
    log(f"served {len(eq_arms)} arms on {len(cells)} cells in {wall:.2f} s; "
        f"ratio to JAX {min(ratios):.4f}..{max(ratios):.4f}; launches "
        f"{launches}")
    if len(cells) != 54:
        raise AssertionError(f"{len(cells)} cells, not 54")
    if bad:
        raise AssertionError(f"cells outside {GATE_BAND}: {bad}")
    for k in ("fir_shift_accum", "complex_dense"):
        if launches[k] < 1:
            raise AssertionError(f"serving the arms launched no {k}")
    return launches


def eq_trainer(nbits: int, opt: int, frames: int, mobile: bool = False):
    """An `EqualizerTrainer` on mixRayleigh with the committed AWGN base
    receiver of `nbits` grafted in, `frames` a step (the reference's
    `batch_size` 512 is 73 frames, as 7 x 73 is)."""
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.train.checkpoint import (load_params_npz,
                                                    params_from_flax)
    from dl_ofdm_tpu_torch.train.equalizer_loop import EqualizerTrainer
    snr = 5.0 * nbits
    base = params_from_flax(load_params_npz(os.path.join(
        ROOT, "runs", "arms",
        f"OFDM_Dense3_{nbits}mod_snr{int(snr)}_cpTrue.npz")))
    tr = EqualizerTrainer(
        OFDMConfig(nbits=nbits), TrainConfig(
            snr=snr, batch_size=7 * frames, opt=opt),
        channel="mixRayleigh", mobile=mobile,
        pretrained_rx=base)
    assert tr.batch_frames == frames
    return tr, base


def time_eq_steps(tr, state, gen, steps: int):
    """(state, aux, ms/step) of `steps` curriculum steps after one warm-up
    step, host clock around work that ends in a synchronize."""
    import torch
    state, aux = tr.train_step_curriculum(state, gen)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        state, aux = tr.train_step_curriculum(state, gen)
    torch.cuda.synchronize()
    return state, aux, (time.perf_counter() - t) * 1e3 / steps


def busy_us(events) -> float:
    """Length of the union of the device kernels' [start, end) intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def profile_eq_steps(tr, state, gen, steps: int) -> dict:
    """`steps` curriculum steps under `torch.profiler`: the wall ms a step
    with the profiler on, the device-busy ms a step (the union of kernel
    intervals), kernels a step, the host's waits on the device and copies
    a step, and the five kernels with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            state, _ = tr.train_step_curriculum(state, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / steps
    events = prof.events()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiler saw no kernel on the card")
    busy_ms = busy_us(kernels) / 1e3 / steps
    host = {n: sum(e.name == n for e in events) / steps
            for n in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                      "cudaMemcpyAsync")}
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"profiled_wall_ms_per_step": wall_ms,
            "busy_ms_per_step": busy_ms,
            "kernels_per_step": len(kernels) / steps,
            "host_calls_per_step": host,
            "top_kernels_us_per_step": [
                [n[:60], us / steps] for n, us in top]}


def phase_train_eq(tpk, tfs, dev) -> dict:
    """Phase 15: the equalizer stage's training at full width (nfft 64,
    opt 12, mixRayleigh, QPSK base receiver grafted); returns the
    launches."""
    import torch
    steps = EQ_STEPS
    zero_counts(tpk, tfs)
    fused_steps = 0
    for frames in EQ_FRAMES:
        tr, base = eq_trainer(2, 12, frames)
        for route in ("plain", "fused"):
            tr.fused_curriculum = route == "fused"
            gen = torch.Generator(device=dev).manual_seed(frames)
            state = tr.init_state(gen)
            n_s = tfs.fused_synthesize_kernel.launches
            state, aux, ms = time_eq_steps(tr, state, gen, steps)
            n_s = tfs.fused_synthesize_kernel.launches - n_s
            want = steps + 1 if route == "fused" else 0
            fused_steps += want
            if n_s != want:
                raise AssertionError(f"{route} equalizer steps at {frames} "
                                     f"frames launched fused_synth {n_s} "
                                     f"times, not {want}")
            for k, v in state.params.items():
                if k.startswith("receiver.") and not torch.equal(
                        v, base[k[len("receiver."):]].to(dev)):
                    raise AssertionError(f"frozen {k} moved")
            eq_keys = {k for k in state.params if k.startswith("Equalizer.")}
            if set(state.opt_state["mu"]) != eq_keys:
                raise AssertionError("Adam holds moments outside the "
                                     "Equalizer scope")
            vals = {k: float(aux[k]) for k in ("ce", "ber", "chan_mse",
                                               "snr_mse")}
            if not all(np.isfinite(v) for v in vals.values()):
                raise AssertionError(f"equalizer step {route} {frames}: "
                                     f"{vals}")
            row = {"phase": 15, "frames": frames, "route": route,
                   "ms_per_step": ms, "steps": steps + 1, **vals}
            log(f"equalizer step {route:5s} {frames:5d} frames: {ms:.3f} "
                f"ms/step; CE {vals['ce']:.4f}, chan_mse "
                f"{vals['chan_mse']:.4f}; receiver bit-identical, Adam "
                f"moments for {len(eq_keys)} Equalizer leaves only")
            print(json.dumps(row), flush=True)
    tr, _ = eq_trainer(2, 12, 73)
    t = time.time()
    _, info = tr.fit(max_epochs=3, log_fn=lambda m: log(f"  fit {m}"))
    hist = info["history"]
    torch.cuda.synchronize()
    launches = path_counts(tpk, tfs)
    print(json.dumps({"phase": 15, "fit_seconds": time.time() - t,
                      "fit_history": hist, "launches": launches}),
          flush=True)
    if not all(np.isfinite([h["train_loss"], h["val_ber"]]).all()
               for h in hist) \
            or not hist[-1]["train_loss"] < hist[0]["train_loss"]:
        raise AssertionError(f"equalizer fit: {hist}")
    log(f"equalizer training path: launches {launches}")
    if launches["fused_synth"] != fused_steps:
        raise AssertionError(f"fused_synth launched "
                             f"{launches['fused_synth']} times in "
                             f"{fused_steps} fused equalizer steps")
    for k in ("fir_shift_accum", "complex_dense"):
        if launches[k] < 1:
            raise AssertionError(f"equalizer training launched no {k}")
    return launches


def phase_train_eq_mobile(tpk, tfs, dev) -> None:
    """Phase 16: the mobile equalizer step (mixRayleigh with Jakes
    Doppler, opt 0, 8QAM as the `Equalizer0_mixRayleigh_mobile` arm) on
    both data planes."""
    import torch
    steps = EQ_MOBILE_STEPS
    tr, _ = eq_trainer(3, 0, 73, mobile=True)
    if not tr._fused_synth_spec.mobile:
        raise AssertionError("mobile equalizer trainer without Doppler rows")
    for route in ("plain", "fused"):
        tr.fused_curriculum = route == "fused"
        gen = torch.Generator(device=dev).manual_seed(16)
        state = tr.init_state(gen)
        n = path_counts(tpk, tfs)
        state, aux, ms = time_eq_steps(tr, state, gen, steps)
        torch.cuda.synchronize()
        d = {k: v - n[k] for k, v in path_counts(tpk, tfs).items()}
        vals = {k: float(aux[k]) for k in ("ce", "chan_mse", "snr_mse")}
        if d["fused_synth"] != (steps + 1 if route == "fused" else 0) \
                or not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"mobile equalizer {route}: launches {d}, "
                                 f"{vals}")
        print(json.dumps({"phase": 16, "route": route, "frames": 73,
                          "ms_per_step": ms, "launches": d, **vals}),
              flush=True)
        log(f"mobile equalizer step {route:5s} 73 frames: {ms:.3f} ms/step; "
            f"CE {vals['ce']:.4f}, chan_mse {vals['chan_mse']:.4f}; "
            f"launches {d}")


def phase_profile_eq(dev) -> None:
    """Phase 17: where the equalizer step's time goes (phase 15's trainers;
    the idle share is of the unprofiled ms/step of the same trainer)."""
    import torch
    for frames in EQ_FRAMES:
        tr, _ = eq_trainer(2, 12, frames)
        steps = EQ_PROFILE_STEPS[frames]
        for route in ("plain", "fused"):
            tr.fused_curriculum = route == "fused"
            gen = torch.Generator(device=dev).manual_seed(frames)
            state = tr.init_state(gen)
            state, _, ms = time_eq_steps(tr, state, gen, steps)
            prof = profile_eq_steps(tr, state, gen, steps)
            idle = 1 - prof["busy_ms_per_step"] / ms
            print(json.dumps({"phase": 17, "frames": frames, "route": route,
                              "ms_per_step": ms, "idle_share": idle,
                              **prof}), flush=True)
            log(f"equalizer step {route:5s} {frames:5d} frames: {ms:.3f} "
                f"ms/step, {prof['busy_ms_per_step']:.3f} busy, idle "
                f"{idle:.3f}; {prof['kernels_per_step']:.0f} kernels, host "
                f"{prof['host_calls_per_step']} a step")


# launches that every call of the bf16 model kernel makes, besides its
# packing and its five GEMMs (phase 18)
WHOLE_CALL = ("affine_bf16", "weights_bf16", "head_kernel", "head_finish",
              "reduce_fold")


def phase_model_breakdown(tfm, dev) -> None:
    """Phase 18: where the bf16 model kernel's time goes, at bench.py's four
    batch sizes: 6 calls under `torch.profiler` (last, as it slows the
    launches that follow it), each launch's device µs by part; the five
    tensor-core GEMMs are told apart by their order in a call.  The
    profiler misses the first launches after it starts and drops records
    under load, so only the calls with every launch recorded count, and a
    window with no such call is profiled again (at most 3 windows)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dl_ofdm_tpu_torch.models.dccn import DCCNReceiver
    spec = tfm.ModelSpec(nsymbol=7, sps=80, nfilter=64, frame_size=320,
                         nbits=1, matmul_dtype="bfloat16")
    rx = DCCNReceiver(nbits=1, nfft=64, cp_len=16, nfilter=64,
                      frame_size=320).to(dev)
    params = {k: v.detach() for k, v in rx.state_dict().items()}
    gen = torch.Generator(device=dev).manual_seed(18)
    for b in TRAIN_FRAMES:
        planes = [torch.randn(b, 560, device=dev, generator=gen)
                  for _ in range(4)]
        c = 0.5 + torch.rand(6, 560, device=dev, generator=gen)
        idx = torch.randint(0, 2, (b, 320), device=dev, generator=gen,
                            dtype=torch.int32)
        args = (spec, b, params, *planes, c, idx)
        tfm.dccn_fused_grads_kernel(*args)
        torch.cuda.synchronize()
        calls, windows = [], 0
        while not calls and windows < 3:
            windows += 1
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(6):
                    tfm.dccn_fused_grads_kernel(*args)
                torch.cuda.synchronize()
            kernels = sorted(
                (e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA),
                key=lambda e: e.time_range.start)
            # a call starts with its packing launch, or with its prologue
            # where the packing launch's record was dropped (so that a
            # dropped record does not merge two calls); keep the calls with
            # every launch of the route recorded
            starts = [i for i, e in enumerate(kernels)
                      if "pack_params" in e.name
                      or ("affine_bf16" in e.name and (
                          i == 0 or "pack_params" not in kernels[i - 1].name))]
            calls = [kernels[a:z] for a, z in zip(
                starts, starts[1:] + [len(kernels)])]
            calls = [c for c in calls
                     if sum("tc_gemm_kernel" in e.name for e in c) == 5
                     and all(any(n in e.name for e in c)
                             for n in WHOLE_CALL + ("pack_params",))]
        if not calls:
            seen = {}
            for e in kernels:
                n = e.name.split("(")[0].split("::")[-1]
                seen[n] = seen.get(n, 0) + 1
            raise AssertionError(f"the profiler recorded no whole call of "
                                 f"the model kernel at {b} frames in "
                                 f"{windows} windows; the last held {seen}")
        parts, busy = {}, 0.0
        for kernels in calls:
            n_gemm = 0
            for e in kernels:
                if "tc_gemm_kernel" in e.name:
                    part = f"gemm{(1, 2, 4, 5, 6)[n_gemm]}"
                    n_gemm += 1
                elif "affine_bf16" in e.name or "weights_bf16" in e.name:
                    part = "prologue"
                elif "head_kernel" in e.name:
                    part = "head"
                elif "pack_params" in e.name:
                    part = "packing"
                elif ("reduce_splits" in e.name or "colsum_splits" in e.name
                      or "reduce_fold" in e.name or "head_finish" in e.name):
                    part = "reductions"
                else:
                    part = "other: " + e.name[:40]
                parts[part] = parts.get(part, 0.0) + e.time_range.elapsed_us()
            busy += busy_us(kernels)
        n = len(calls)
        busy /= n
        us = {k: v / n for k, v in sorted(parts.items())}
        print(json.dumps({"phase": 18, "frames": b, "calls": n,
                          "windows": windows,
                          "busy_us_per_call": busy,
                          "launches_per_call": sum(map(len, calls)) / n,
                          "us_per_call": us,
                          "share": {k: v / busy for k, v in us.items()}}),
              flush=True)
        log(f"dccn_fused_grads bf16 {b:6d} frames: {busy:.1f} us busy a "
            f"call ({n} whole calls of 6); "
            + ", ".join(f"{k} {v:.1f}" for k, v in us.items()))


# phase 19: the multi-device path on virtual ranks of one card
MESH_DP = 4
MESH_STEPS = 10                    # timed dp steps after one warm-up step
HALO_B, HALO_FRAMES, HALO_TAPS = 64, 2048, 13   # streams, frames, ETU taps
HALO_PS = (4, 8)
HALO_OFFSETS = (6, 0)              # 'same' and causal


def phase_mesh_train(tpk, dev) -> dict:
    """Phase 19a: the dp training step, `bench.py`'s configuration on a
    4-rank mesh of virtual ranks; returns its `fir_shift_accum` launches."""
    import torch
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.parallel.mesh import make_mesh
    from dl_ofdm_tpu_torch.train.loop import Trainer
    mesh = make_mesh([dev] * MESH_DP, dp=MESH_DP)
    cfg, tc = OFDMConfig(nbits=1), TrainConfig(batch_size=65534)
    tr = Trainer(cfg, tc, channel="ETU", mesh=mesh)
    frames = tr.batch_frames
    if frames != 9364 or tr._use_fused_model:
        raise AssertionError(f"dp trainer: {frames} frames, fused "
                             f"{tr._use_fused_model}; want 9,364, autograd")
    gen = torch.Generator(device=dev).manual_seed(19)
    state = tr.init_state(gen)
    snr = torch.full((frames,), 5.0, device=dev)
    torch.cuda.synchronize()
    tpk.fir_shift_accum_kernel.launches = 0
    state, aux = tr.train_step(state, gen, snr)            # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(MESH_STEPS):
        state, aux = tr.train_step(state, gen, snr)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3 / MESH_STEPS
    launches = tpk.fir_shift_accum_kernel.launches
    if launches != MESH_DP * (MESH_STEPS + 1):
        raise AssertionError(f"fir_shift_accum launched {launches} times in "
                             f"{MESH_STEPS + 1} dp steps of {MESH_DP} ranks")
    if not torch.isfinite(aux["loss"]):
        raise AssertionError(f"dp step loss {float(aux['loss'])}")
    same = all(torch.equal(rep[k], state.params[k])
               for rep in state.replicas for k in rep)
    if not same or len(state.replicas) != MESH_DP:
        raise AssertionError("dp replicas differ after the steps")
    # step-1 gradients against the single-device autograd route on the
    # same four shards (phase 8's tolerance: leaky kinks)
    state = tr.init_state(torch.Generator(device=dev).manual_seed(20))
    bits, rx_in, _, npwr = tr._synth_mesh(
        torch.Generator(device=dev).manual_seed(21), snr)
    _, aux1 = tr._mesh_step(state, bits, rx_in, [{}] * MESH_DP, npwr,
                            return_grads=True)
    single = Trainer(cfg, tc, channel="ETU", device=dev)
    params = {k: v.clone().requires_grad_() for k, v in state.params.items()}
    loss, _ = single._loss_fn(params, torch.cat(bits), torch.cat(rx_in))
    want = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    gerr = check_grads("dp step-1 gradients vs single-device autograd",
                       aux1["grads"], want, 5e-2)
    line = {"phase": 19, "part": "dp train step", "dp": MESH_DP,
            "frames": frames, "ms_per_step": ms,
            "iq_samples_per_s": frames * 7 * 80 / (ms / 1e3),
            "fir_shift_accum_launches": launches,
            "steps": MESH_STEPS + 1, "step1_grad_err": gerr,
            "replicas_identical": same, "ce": float(aux["ce"])}
    log(f"dp step ({MESH_DP} virtual ranks, {frames} frames): {ms:.3f} "
        f"ms/step; fir_shift_accum {launches} launches in "
        f"{MESH_STEPS + 1} steps; step-1 gradients within {gerr:.3g} of "
        f"the single-device route; replicas bit-identical")
    print(json.dumps(line), flush=True)
    return {"fir_shift_accum": launches}


def phase_mesh_sweeps(tpk, dev, trainer, csv_ber) -> None:
    """Phase 19b: the 16QAM arm's sweeps on a 4-rank mesh: point_batch in
    2,000-frame batches (500 a rank) against the committed CSV, and
    interleaved at 7,872 frames a call (192 a point, 48 a point and rank,
    as the single-device call's 1,968 / 41) against JAX's curve."""
    import torch
    from dl_ofdm_tpu_torch.eval.sweep import ber_sweep
    from dl_ofdm_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh([dev] * MESH_DP, dp=MESH_DP)
    for protocol, batch, seed, ref, ref_name in (
            ("point_batch", 2000, 17, csv_ber, "CSV"),
            ("interleaved", 7872, 999, JAX_INTERLEAVED_BER, "JAX")):
        torch.cuda.synchronize()
        tpk.complex_dense_kernel.launches = 0
        logs = []
        t = time.time()
        res = ber_sweep(trainer, torch.Generator(device=dev).manual_seed(seed),
                        snrs=SNRS, frames_per_point=20000, batch_frames=batch,
                        log_fn=logs.append, mesh=mesh,
                        point_batch=protocol == "point_batch")
        torch.cuda.synchronize()
        wall = time.time() - t
        calls = (len(SNRS) * 10 if protocol == "point_batch"
                 else 20000 // 192)
        frames = (calls * batch)
        launches = tpk.complex_dense_kernel.launches
        if launches != calls * MESH_DP:
            raise AssertionError(f"mesh {protocol}: complex_dense launched "
                                 f"{launches} times, want {calls * MESH_DP}")
        check_curve(f"mesh {protocol}", res.ber, ref, ref_name)
        log(f"mesh {protocol} sweep ({MESH_DP} ranks): {calls} calls of "
            f"{batch} frames in {wall:.3f} s = {frames / wall:.0f} frames/s; "
            f"complex_dense launches {launches}")
        print(json.dumps({"phase": 19, "part": f"mesh {protocol} sweep",
                          "calls": calls, "frames": frames, "seconds": wall,
                          "frames_per_s": frames / wall,
                          "complex_dense_launches": launches}), flush=True)


def rings_equal(got, want) -> bool:
    """Two (recv_l, recv_r) results bit-equal, tensor by tensor, each on
    the same device."""
    import torch
    return all(a.device == b.device and torch.equal(a, b)
               for a, b in zip(got[0] + got[1], want[0] + want[1]))


def ring_graph_replays(halo, dev, x, replays: int = 100) -> None:
    """The ring at P = 1, 2, 4 and 8 on the halo path's slices, captured in
    one CUDA graph and replayed `replays` times, new shard contents copied
    in before each replay and nothing reset: every replay bit-equal to
    the plain version of those contents."""
    import torch
    block = x[:, :8 * FIR_LEN, :].clone()
    sets = []
    for p in (1, 2, 4, 8):
        shards = list(torch.chunk(block, p, dim=1))
        sets.append(([s[:, -6:, :] for s in shards],
                     [s[:, :6, :] for s in shards]))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [halo.ring_exchange_kernel(lt, rh) for lt, rh in sets]
    gen = torch.Generator(device=dev).manual_seed(193)
    for i in range(replays):
        block.normal_(generator=gen)
        graph.replay()
        for p, (lt, rh), got in zip((1, 2, 4, 8), sets, outs):
            if not rings_equal(got, halo.ring_exchange_ref(lt, rh)):
                raise AssertionError(f"ring_exchange graph replay {i} at "
                                     f"P = {p}: differs from the plain "
                                     "version")
    del graph
    log(f"ring_exchange at P = 1, 2, 4, 8 in one CUDA graph: {replays} "
        "replays with new shard contents, nothing reset, each bit-equal "
        "to the plain version")


def halo_fir_graph_replays(halo, fir_same_iq, dev, x, h,
                           replays: int = 3) -> None:
    """`halo_fir_same_iq(exchange='dma')` at full width captured in a CUDA
    graph as it stands, for each P and offset, and replayed `replays` times
    with new blocks and kernels: each replay bit-equal to `fir_same_iq` of
    the whole block."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(194)
    for p in HALO_PS:
        shards = list(torch.chunk(x, p, dim=1))
        for off in HALO_OFFSETS:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                y = halo.halo_fir_same_iq(shards, h, off, [dev] * p,
                                          exchange="dma")
            for i in range(replays):
                x.normal_(generator=gen)
                h.normal_(generator=gen)
                graph.replay()
                if not torch.equal(torch.cat(y, dim=1), fir_same_iq(
                        x, h, np.full(HALO_B, off))):
                    raise AssertionError(
                        f"graphed halo FIR P {p} offset {off}, replay {i}: "
                        "differs from fir_same_iq of the whole block")
            del graph, y
    torch.cuda.empty_cache()
    log(f"halo FIR ('dma') in a CUDA graph at {HALO_B} x {x.shape[1]}, P "
        f"{HALO_PS}, offsets {HALO_OFFSETS}: {replays} replays each with "
        "new blocks and kernels, bit-equal to fir_same_iq")


def ring_host_us(halo, lt, rh, iters: int = 1000) -> dict:
    """Host µs a call of the ring wrapper and of its parts, from the host
    clock over `iters` calls each, with nothing waiting on the card: the
    whole call, the launch plan's lookup (its cache key), the receive
    buffers, and an empty kernel launched through ctypes."""
    import torch
    lib = halo._ring_lib()

    def empty():
        lib.ring_empty_launch(torch.cuda.current_stream().cuda_stream)

    launch = halo._launch_of(lt, rh)
    parts = {"call": lambda: halo.ring_exchange_kernel(lt, rh),
             "plan_lookup": lambda: halo._launch_of(lt, rh),
             "receive_buffers": launch.alloc, "empty_launch": empty}
    out = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        out[name] = (time.perf_counter() - t) * 1e6 / iters
        torch.cuda.synchronize()
    return out


def phase_halo(tpk, dev, hbm_bps) -> dict:
    """Phase 19c: the sequence-parallel halo FIR at full width and the
    ring kernel; returns the kernels-line fields of `ring_exchange`."""
    import torch
    from dl_ofdm_tpu_torch.channel.fir import fir_same_iq
    from dl_ofdm_tpu_torch.parallel import halo
    length = HALO_FRAMES * FIR_LEN
    gen = torch.Generator(device=dev).manual_seed(191)
    x = torch.randn(HALO_B, length, 2, device=dev, generator=gen)
    h = torch.randn(HALO_B, HALO_TAPS, 2, device=dev, generator=gen)
    out = {"max_abs_err": 0.0}
    # the kernel against its plain version at P = 1, 2, 4, 8 on the halo
    # path's slices ([64, 6, 2] each way)
    torch.cuda.synchronize()
    halo.ring_exchange_kernel.launches = 0
    calls = 0
    for p in (1, 2, 4, 8):
        shards = list(torch.chunk(x, p, dim=1))
        lt = [s[:, -6:, :] for s in shards]
        rh = [s[:, :6, :] for s in shards]
        got = halo.ring_exchange_kernel(lt, rh)
        want = halo.ring_exchange_ref(lt, rh)
        calls += 1
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max())
                  for a, b in zip(got[0] + got[1], want[0] + want[1]))
        out["max_abs_err"] = max(out["max_abs_err"], err)
        if err:
            raise AssertionError(f"ring_exchange at P = {p}: {err:.3g} from "
                                 "its plain version; want bit-equal")
    if halo.ring_exchange_kernel.launches != calls:
        raise AssertionError(f"ring_exchange launched "
                             f"{halo.ring_exchange_kernel.launches} times "
                             f"in {calls} calls")
    log(f"ring_exchange at P = 1, 2, 4, 8 ([{HALO_B}, 6, 2] each way): "
        f"bit-equal to its plain version, {calls} launches")
    # the halo FIR against fir_same_iq of the whole block; the main path's
    # counts are zeroed just before and read just after
    wholes = {off: fir_same_iq(x, h, np.full(HALO_B, off))
              for off in HALO_OFFSETS}
    torch.cuda.synchronize()
    halo.ring_exchange_kernel.launches = 0
    tpk.fir_shift_accum_kernel.launches = 0
    runs = 0
    for p in HALO_PS:
        shards = list(torch.chunk(x, p, dim=1))
        for off in HALO_OFFSETS:
            for exchange in ("ppermute", "dma"):
                y = halo.halo_fir_same_iq(shards, h, off, [dev] * p,
                                          exchange=exchange)
                runs += 1
                if not torch.equal(torch.cat(y, dim=1), wholes[off]):
                    raise AssertionError(
                        f"halo FIR P {p} offset {off} {exchange}: differs "
                        "from fir_same_iq of the whole block")
    torch.cuda.synchronize()
    out["launches"] = halo.ring_exchange_kernel.launches
    out["fir_launches"] = tpk.fir_shift_accum_kernel.launches
    want_ring = len(HALO_PS) * len(HALO_OFFSETS)
    want_fir = sum(HALO_PS) * len(HALO_OFFSETS) * 2
    if out["launches"] != want_ring or out["fir_launches"] != want_fir:
        raise AssertionError(f"halo path: ring {out['launches']} launches "
                             f"(want {want_ring}), fir_shift_accum "
                             f"{out['fir_launches']} (want {want_fir})")
    log(f"halo FIR, {HALO_B} x {length} samples, {HALO_TAPS} taps, P "
        f"{HALO_PS}, offsets {HALO_OFFSETS}, both exchanges: {runs} runs "
        f"bit-equal to fir_same_iq; ring launches {out['launches']}, FIR "
        f"launches {out['fir_launches']}")
    ring_graph_replays(halo, dev, x)
    halo_fir_graph_replays(halo, fir_same_iq, dev, x, h)
    # device times from CUDA graphs of 100 calls, eager times from events
    # around 100 calls issued from Python
    lib = halo._ring_lib()

    def empty():
        err = lib.ring_empty_launch(torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"empty launch failed: CUDA error {err}")

    empty_ms, empty_eager = time_ms(empty, 100)
    for p in HALO_PS:
        shards = list(torch.chunk(x, p, dim=1))
        lt = [s[:, -6:, :] for s in shards]
        rh = [s[:, :6, :] for s in shards]
        dst = [torch.empty(HALO_B, 6, 2, device=dev) for _ in range(2 * p)]
        src = [lt[(r - 1) % p] for r in range(p)] + [
            rh[(r + 1) % p] for r in range(p)]
        fns = {"kernel": lambda: halo.ring_exchange_kernel(lt, rh),
               "plain": lambda: halo.ring_exchange_ref(lt, rh),
               "library": lambda: torch._foreach_copy_(dst, src)}
        times = {n: [] for n in fns}
        for n in ("plain", "kernel", "library", "library", "kernel",
                  "plain"):
            times[n].append(time_ms(fns[n], 100))
        ms = {n: sum(t[0] for t in v) / len(v) for n, v in times.items()}
        eager = {n: sum(t[1] for t in v) / len(v) for n, v in times.items()}
        n_bytes = 2 * 2 * p * HALO_B * 6 * 2 * 4    # read once, written once
        bound = n_bytes / hbm_bps * 1e3
        fir_ms = {ex: time_ms(lambda: halo.halo_fir_same_iq(
            shards, h, 6, [dev] * p, exchange=ex), 10)
            for ex in ("ppermute", "dma")}
        host = ring_host_us(halo, lt, rh)
        line = {"phase": 19, "part": "halo", "P": p, "ring_ms": ms["kernel"],
                "plain_ms": ms["plain"], "foreach_copy_ms": ms["library"],
                "empty_launch_ms": empty_ms, "eager_ms": eager,
                "empty_launch_eager_ms": empty_eager,
                "runs_ms": {n: v for n, v in times.items()},
                "bytes": n_bytes, "bound_ms": bound,
                "halo_fir_ms": {ex: t[0] for ex, t in fir_ms.items()},
                "halo_fir_eager_ms": {ex: t[1] for ex, t in fir_ms.items()},
                "host_us": host,
                "timing": "CUDA graphs of 100 calls (halo FIR: 10); eager: "
                          "events around the same calls"}
        log(f"ring_exchange P {p} (graph / eager ms): kernel "
            f"{ms['kernel']:.4f} / {eager['kernel']:.4f}, plain "
            f"{ms['plain']:.4f} / {eager['plain']:.4f}, one _foreach_copy_ "
            f"{ms['library']:.4f} / {eager['library']:.4f}, empty launch "
            f"{empty_ms:.4f} / {empty_eager:.4f}, bytes bound {bound:.7f}; "
            f"halo FIR ppermute {fir_ms['ppermute'][0]:.3f} / "
            f"{fir_ms['ppermute'][1]:.3f} ms, dma {fir_ms['dma'][0]:.3f} / "
            f"{fir_ms['dma'][1]:.3f} ms; host µs a call "
            + ", ".join(f"{k} {v:.1f}" for k, v in host.items()))
        print(json.dumps(line), flush=True)
        if p == HALO_PS[0]:
            out.update(ms=ms["kernel"], eager_ms=eager["kernel"],
                       plain_ms=ms["plain"], library_ms=ms["library"],
                       bound_ms=bound, bound_by="bytes",
                       empty_launch_ms=empty_ms)
    fir_whole = events_ms(lambda: fir_same_iq(x, h, np.full(HALO_B, 6)), 10)
    log(f"fir_same_iq of the whole block: {fir_whole:.3f} ms")
    out["fir_same_iq_whole_ms"] = fir_whole
    return out


def phase_halo_cross_card(calls: int = 20, replays: int = 100) -> None:
    """Phase 19d: the ring and the halo FIR with one rank a card, where
    the machine has two or more cards: the ring bit-equal to its plain
    version with one launch a card; `calls` eager calls back to back with
    new inputs and no host sync, each bit-equal; one CUDA graph a card
    holding that card's part, the graphs replayed together `replays`
    times with new inputs, each replay bit-equal; the halo FIR at phase
    19c's width bit-equal to `fir_same_iq` on card 0; times from the host
    clock around calls that end in a synchronize of every card."""
    import torch
    from dl_ofdm_tpu_torch.channel.fir import fir_same_iq
    from dl_ofdm_tpu_torch.parallel import halo
    n = torch.cuda.device_count()
    if n < 2:
        log(f"cross-card ring not run: this machine has {n} CUDA device; "
            "nothing is claimed for it")
        print(json.dumps({"phase": 19, "part": "cross-card",
                          "run": False, "devices": n}), flush=True)
        return
    devs = [torch.device("cuda", i) for i in range(n)]
    peers = {f"{i}->{j % n}": halo.enable_peer_access(i, j % n)
             for i in range(n) for j in (i - 1, i + 1) if j % n != i}
    log(f"cross-card ring over {n} cards, peer access {peers}")

    def sync():
        for d in devs:
            torch.cuda.synchronize(d)

    def host_ms(fn, iters=100):
        fn()
        sync()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        sync()
        return (time.perf_counter() - t) * 1e3 / iters

    gen = torch.Generator(device=devs[0]).manual_seed(192)
    x = torch.randn(HALO_B, HALO_FRAMES * FIR_LEN, 2, device=devs[0],
                    generator=gen)
    h = torch.randn(HALO_B, HALO_TAPS, 2, device=devs[0], generator=gen)
    shards = [s.to(d) for s, d in zip(torch.chunk(x, n, dim=1), devs)]
    lt = [s[:, -6:, :] for s in shards]
    rh = [s[:, :6, :] for s in shards]
    before = halo.ring_exchange_kernel.launches
    got = halo.ring_exchange_kernel(lt, rh)
    want = halo.ring_exchange_ref(lt, rh)
    sync()
    ring_equal = rings_equal(got, want)
    y = halo.halo_fir_same_iq(shards, h, 6, devs, exchange="dma")
    sync()
    fir_equal = torch.equal(torch.cat([t.to(devs[0]) for t in y], dim=1),
                            fir_same_iq(x, h, np.full(HALO_B, 6)))
    launches = halo.ring_exchange_kernel.launches - before
    if not (ring_equal and fir_equal) or launches != 2 * n:
        raise AssertionError(f"cross-card: ring equal {ring_equal}, halo "
                             f"FIR equal {fir_equal}, {launches} ring "
                             f"launches for 2 calls on {n} cards")
    # new inputs for every call or replay, on the ring's own slices
    small = [torch.empty(HALO_B, FIR_LEN, 2, device=d) for d in devs]
    s_lt = [s[:, -6:, :] for s in small]
    s_rh = [s[:, :6, :] for s in small]
    gens = [torch.Generator(device=d).manual_seed(195 + i)
            for i, d in enumerate(devs)]

    def refill():
        for s, g in zip(small, gens):
            s.normal_(generator=g)

    runs = []
    for _ in range(calls):
        refill()
        runs.append((halo.ring_exchange_kernel(s_lt, s_rh),
                     halo.ring_exchange_ref(s_lt, s_rh)))
    sync()
    if not all(rings_equal(g_, w_) for g_, w_ in runs):
        raise AssertionError(f"cross-card: {calls} eager calls back to back "
                             "differ from the plain version")
    recv = halo.ring_buffers(s_lt, s_rh)
    graphs = []
    for d in devs:
        with torch.cuda.device(d):
            graph = torch.cuda.CUDAGraph()
            # a capture stream of this card (torch's default one lives on
            # the card that first captured)
            with torch.cuda.graph(graph, stream=torch.cuda.Stream(d)):
                halo.ring_exchange_kernel(s_lt, s_rh, out=recv, device=d)
            graphs.append(graph)

    def replay_all():
        for d, graph in zip(devs, graphs):
            with torch.cuda.device(d):
                graph.replay()

    for i in range(replays):
        refill()
        replay_all()
        want = halo.ring_exchange_ref(s_lt, s_rh)
        sync()
        if not rings_equal(recv, want):
            raise AssertionError(f"cross-card: per-card graphs, replay {i}: "
                                 "differs from the plain version")
    log(f"cross-card ({n} cards): {calls} eager calls back to back and "
        f"{replays} replays of one graph a card, new inputs each, all "
        "bit-equal to the plain version")
    ms = {"kernel": host_ms(lambda: halo.ring_exchange_kernel(lt, rh)),
          "plain": host_ms(lambda: halo.ring_exchange_ref(lt, rh)),
          "graphs_one_a_card": host_ms(replay_all),
          "halo_fir_dma": host_ms(lambda: halo.halo_fir_same_iq(
              shards, h, 6, devs, exchange="dma"), 10),
          "halo_fir_ppermute": host_ms(lambda: halo.halo_fir_same_iq(
              shards, h, 6, devs, exchange="ppermute"), 10)}
    del graphs
    log(f"cross-card ({n} cards): ring bit-equal to its plain version, one "
        f"launch a card; halo FIR bit-equal to fir_same_iq; host-clock ms "
        f"{ms}")
    print(json.dumps({"phase": 19, "part": "cross-card", "run": True,
                      "devices": n, "peer_access": peers,
                      "ring_launches": launches, "eager_calls": calls,
                      "graph_replays": replays, "ms": ms,
                      "timing": "host clock around calls, all cards "
                                "synchronized"}), flush=True)


# -- 20-22: the bf16 receiver, the nfft-512 arm, the CLI ---------------------
BIG_ARM = os.path.join(ROOT, "runs", "arms", "OFDM_Big512_1mod.npz")
BIG_CSV = os.path.join(ROOT, "runs",
                       "Test_DCCN_OFDM_Big512_1mod_snr5_cpTrue_AWGN.csv")
BIG_SNRS = list(range(-10, 21))
# BER of the JAX package's own interleaved sweep of the arm, SNR -10..20
# dB, 20,000 frames a point in 1,000-frame batches, key 999 (the CSV's
# protocol, `scripts/biggrid_e2e.py:137-140`): `python
# scripts/sweep_big512_jax.py` (CPU, bf16 receiver GEMMs).  It meets the
# CSV (made on a TPU) from -10 to 15 dB and not at 16-20 dB, where the
# CSV's BER climbs to 0.176 and this curve keeps falling to 1.2e-5.
JAX_BIG512_BER = [
    0.2704692, 0.2468787, 0.221952725, 0.1958465, 0.169598225, 0.142971775,
    0.117345575, 0.09307995, 0.0712363, 0.05223705, 0.036692875, 0.02454035,
    0.01565895, 0.00957685, 0.005606225, 0.00316325, 0.001775275, 0.00097855,
    0.000542975, 0.000310825, 0.00017875, 0.000111675, 7.2125e-05, 4.9175e-05,
    3.575e-05, 2.67e-05, 2.2125e-05, 1.635e-05, 1.52e-05, 1.325e-05,
    1.1575e-05,
]
BIG_POINT_FRAMES = 1000 // len(BIG_SNRS)    # 32 frames a point and call
BIG_CALLS = 20000 // BIG_POINT_FRAMES       # 625 calls of 992 frames
# the sweep's frames/s with the FMA mode (three runs of this script on an
# NVIDIA H100 80GB HBM3 at 700.00 W, `PERF.md` §6), printed as the parent
FMA_BIG512_FRAMES_PER_S = (113681, 118276)
# the 128 bf16 values of `jax.random.normal(key, shape, bfloat16)` (jax
# 0.9 on the CPU), as bit patterns, for the 7 random bits 0..127 that
# pick them; the port's `channel.awgn.bf16_normal_table` must equal them
JAX_BF16_NORMALS = [
    0xC039, 0xC015, 0xC007, 0xBFFA, 0xBFEB, 0xBFDE, 0xBFD4, 0xBFCA, 0xBFC2,
    0xBFBB, 0xBFB4, 0xBFAD, 0xBFA7, 0xBFA1, 0xBF9C, 0xBF97, 0xBF92, 0xBF8D,
    0xBF88, 0xBF84, 0xBF80, 0xBF79, 0xBF70, 0xBF69, 0xBF61, 0xBF5A, 0xBF53,
    0xBF4C, 0xBF45, 0xBF3F, 0xBF38, 0xBF31, 0xBF2B, 0xBF25, 0xBF1F, 0xBF19,
    0xBF13, 0xBF0D, 0xBF07, 0xBF01, 0xBEF7, 0xBEEC, 0xBEE1, 0xBED6, 0xBECC,
    0xBEC0, 0xBEB5, 0xBEAB, 0xBEA0, 0xBE96, 0xBE8B, 0xBE81, 0xBE6E, 0xBE5A,
    0xBE45, 0xBE30, 0xBE1C, 0xBE08, 0xBDE6, 0xBDBF, 0xBD97, 0xBD5D, 0xBD0D,
    0xBC70, 0x3BA0, 0x3CC9, 0x3D34, 0x3D82, 0x3DAA, 0x3DD3, 0x3DFC, 0x3E12,
    0x3E26, 0x3E3B, 0x3E4E, 0x3E64, 0x3E77, 0x3E86, 0x3E91, 0x3E9C, 0x3EA5,
    0x3EB0, 0x3EBB, 0x3EC6, 0x3ED1, 0x3EDB, 0x3EE6, 0x3EF2, 0x3EFD, 0x3F04,
    0x3F0A, 0x3F10, 0x3F16, 0x3F1C, 0x3F22, 0x3F28, 0x3F2E, 0x3F34, 0x3F3B,
    0x3F42, 0x3F49, 0x3F50, 0x3F57, 0x3F5E, 0x3F65, 0x3F6C, 0x3F75, 0x3F7C,
    0x3F82, 0x3F86, 0x3F8B, 0x3F90, 0x3F94, 0x3F99, 0x3F9F, 0x3FA4, 0x3FAA,
    0x3FB1, 0x3FB8, 0x3FBF, 0x3FC6, 0x3FD0, 0x3FDA, 0x3FE5, 0x3FF2, 0x4001,
    0x400D, 0x4021,
]
# complex_dense's bf16 shapes: the nfft-512 sweep's call (992 frames x 7
# symbols, K = 640, F = 512) and the training step's at 73 frames
# (`--batch_size 512`) and 512 frames
CD_BF16_SHAPES = ((BIG_POINT_FRAMES * len(BIG_SNRS) * 7, 640, 512),
                  (73 * 7, 640, 512), (512 * 7, 640, 512))
# the bf16 mode before its tensor-core kernel (a template flag of the
# float32 FMA kernel) at those shapes, ms: the lowest and highest of three
# runs of this script on an NVIDIA H100 80GB HBM3 at 700.00 W (`PERF.md`
# §6), printed as the parent
FMA_BF16_MS = {"6944x640x512": (4.689, 4.708), "511x640x512": (0.342, 0.345),
                "3584x640x512": (2.384, 2.485)}
# the CLI's full-width run (phase 22)
CLI_ARGS = ["--nfft", "512", "--nfilter", "512", "--compute_dtype",
            "bfloat16", "--channel", "AWGN", "--SNR", "5", "--batch_size",
            "512", "--max_epoch_num", "3", "--ckpt_every", "1", "--token",
            "Big512"]


def big512_config():
    from dl_ofdm_tpu_torch.config import OFDMConfig
    return OFDMConfig(nbits=1, nfft=512, nfilter=512,
                      compute_dtype="bfloat16")


def bf16_library_gemm(x, wr, wi):
    """(call, label): one bf16 cuBLAS GEMM of the same work in stacked real
    form, x [M, K, 2] read as [M, 2K] times W [2K, 2F] laid out as y's IQ
    pairs (W[2k, 2f] = wr, W[2k, 2f+1] = wi, W[2k+1, 2f] = -wi,
    W[2k+1, 2f+1] = wr), with float32 output where `torch.mm` offers it.
    A yardstick only: the port never calls it."""
    import torch
    m, k, _ = x.shape
    w = torch.stack([torch.stack([wr, wi], -1), torch.stack([-wi, wr], -1)],
                    1)                                   # [K, 2, F, 2]
    a = x.reshape(m, 2 * k).to(torch.bfloat16)
    b = w.reshape(2 * k, -1).to(torch.bfloat16)
    try:
        torch.mm(a[:1], b, out_dtype=torch.float32)
    except (TypeError, RuntimeError):
        return (lambda: torch.mm(a, b)), "bf16 cuBLAS, bf16 output"
    return (lambda: torch.mm(a, b, out_dtype=torch.float32)), \
        "bf16 cuBLAS, float32 output"


def float64_error(x, wr, wi, y) -> float:
    """Largest |y - y64| for y64 the float64 products and sums of the
    bf16-rounded operands: how far a float32 result is from exact."""
    import torch
    from dl_ofdm_tpu_torch.ops.pallas_kernels import bf16_round
    xb, rb, ib = (bf16_round(t_).double() for t_ in (x, wr, wi))
    y64 = torch.stack([xb[..., 0] @ rb - xb[..., 1] @ ib,
                       xb[..., 0] @ ib + xb[..., 1] @ rb], -1)
    return float((y.double() - y64).abs().max())


def phase_cdense_bf16(tpk, dev, hbm_bps, peak_key) -> dict:
    """Phase 20: `complex_dense`'s bf16 mode (the pack kernel and the
    tensor-core GEMM of csrc/complex_dense_bf16.cu) against its plain
    version (atol = rtol = 1e-5) at the nfft-512 arm's sweep and training
    shapes, a ragged one with odd K (x by cp.async) and K = 5,000: the
    packed weight bit-equal to `pack_stacked_weight_ref`, a second call
    bit-equal to the first, the kernel's and the plain version's largest
    error against float64 sums, its gradients (rounded to bf16) within
    one bf16 ulp of float64 ones; then its times beside the float32
    mode's, the plain version's, one bf16 cuBLAS GEMM's and the FMA
    mode's it replaced (`FMA_BF16_MS`), and the pack's beside its plain
    version.
    Returns the kernels line's bf16 entries and the pack's entry."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(20)
    k_, p_ = tpk.complex_dense_kernel, tpk.pack_stacked_weight_kernel
    inputs, errs, f64 = {}, [], {}
    for m, k, f in CD_BF16_SHAPES + ((1001, 77, 50), (370, 5000, 64)):
        x = torch.randn(m, k, 2, device=dev, generator=gen)
        wr, wi = (torch.randn(k, f, device=dev, generator=gen) / k ** 0.5
                  for _ in range(2))
        n32, n16, npk = k_.launches, k_.launches_bf16, p_.launches
        with torch.no_grad():
            y = k_(x, wr, wi, "bfloat16")
            y2 = k_(x, wr, wi, "bfloat16")
            ws = p_(wr, wi)
            y_ref = tpk.complex_dense_ref(x, wr, wi, "bfloat16")
            y32 = tpk.complex_dense_ref(x, wr, wi)
        torch.cuda.synchronize()
        if (k_.launches, k_.launches_bf16, p_.launches) != (n32, n16 + 2,
                                                            npk + 3):
            raise AssertionError("the bf16 mode did not count one GEMM and "
                                 "one pack launch a call")
        if not torch.equal(ws.view(torch.int16), tpk.pack_stacked_weight_ref(
                wr, wi).view(torch.int16)):
            raise AssertionError(f"the pack kernel at {k}x{f} differs from "
                                 "pack_stacked_weight_ref")
        if not torch.equal(y, y2):
            raise AssertionError(f"two bf16 calls at {m}x{k}x{f} on the same "
                                 "inputs differ")
        err = float((y - y_ref).abs().max())
        f64[f"{m}x{k}x{f}"] = {"kernel": float64_error(x, wr, wi, y),
                               "plain": float64_error(x, wr, wi, y_ref)}
        log(f"complex_dense bf16 [{m},{k},2]x[{k},{f}]: against float64 "
            f"sums of the rounded operands, kernel "
            f"{f64[f'{m}x{k}x{f}']['kernel']:.3g}, plain version "
            f"{f64[f'{m}x{k}x{f}']['plain']:.3g}")
        torch.testing.assert_close(y, y_ref, atol=1e-5, rtol=1e-5)
        off = float((y - y32).abs().max())
        if off <= 1e-4:
            raise AssertionError(f"bf16 mode at {m}x{k}x{f} is within "
                                 f"{off:.3g} of float32 operands: no "
                                 "rounding")
        # the autograd op on the card: the kernel's forward, a backward of
        # float32 products rounded to bf16, against float64 products of
        # the rounded operands
        leaves = [t_.clone().requires_grad_() for t_ in (x, wr, wi)]
        g = torch.randn(m, f, 2, device=dev, generator=gen)
        tpk.complex_dense(*leaves, "bfloat16").backward(g)
        xb, rb, ib = (tpk.bf16_round(t_).double() for t_ in (x, wr, wi))
        gd = g.double()
        want = (torch.stack([gd[..., 0] @ rb.T + gd[..., 1] @ ib.T,
                             -gd[..., 0] @ ib.T + gd[..., 1] @ rb.T], -1),
                xb[..., 0].T @ gd[..., 0] + xb[..., 1].T @ gd[..., 1],
                xb[..., 0].T @ gd[..., 1] - xb[..., 1].T @ gd[..., 0])
        for t_, w in zip(leaves, want):
            if not torch.equal(t_.grad, tpk.bf16_round(t_.grad)):
                raise AssertionError("a bf16-mode gradient is not bf16")
            # one bf16 ulp (2^-7 of the value at most) where the float32
            # and float64 sums round alike; near zero the float32 sum's
            # own error, 1e-5 of the largest entry
            torch.testing.assert_close(
                t_.grad, w.float(), rtol=2 ** -7,
                atol=1e-5 * float(w.abs().max()))
        errs.append(err)
        inputs[(m, k, f)] = (x, wr, wi)
        log(f"complex_dense bf16 [{m},{k},2]x[{k},{f}]: kernel == plain "
            f"version, max |diff| {err:.3g} (float32 operands {off:.3g} "
            "away); repeat bit-equal; pack bit-equal; gradients bf16, "
            "within 1 ulp")
    print(json.dumps({"phase": 20, "float64_max_abs_err": f64}), flush=True)
    by_shape = {n: {} for n in ("ms", "f32_mode_ms", "plain_ms",
                                "library_ms", "bound_ms", "bound_by",
                                "pack_ms", "pack_plain_ms", "pack_bound_ms")}
    for m, k, f in CD_BF16_SHAPES:
        x, wr, wi = inputs[(m, k, f)]
        lib, label = bf16_library_gemm(x, wr, wi)
        with torch.no_grad():
            y_lib = lib().float().reshape(m, f, 2)
            lib_err = float((y_lib - tpk.complex_dense_ref(
                x, wr, wi, "bfloat16")).abs().max())
            runs = {"plain": lambda: tpk.complex_dense_ref(x, wr, wi,
                                                           "bfloat16"),
                    "bf16": lambda: k_(x, wr, wi, "bfloat16"),
                    "f32": lambda: k_(x, wr, wi),
                    "library": lib,
                    "pack": lambda: p_(wr, wi),
                    "pack_plain": lambda: tpk.pack_stacked_weight_ref(wr,
                                                                      wi)}
            times = {n: [] for n in runs}
            iters = 20 if m > 2000 else 100
            for n in ("plain", "bf16", "f32", "library", "pack",
                      "pack_plain", "pack_plain", "pack", "library", "f32",
                      "bf16", "plain"):
                times[n].append(time_ms(runs[n], iters))
        ms = {n: sum(t_[0] for t_ in v) / len(v) for n, v in times.items()}
        eager = {n: sum(t_[1] for t_ in v) / len(v) for n, v in times.items()}
        n_bytes = 4 * (2 * m * k + 2 * k * f + 2 * m * f)
        n_flops = 8 * m * k * f
        # bf16 products summed in float32 are the tensor cores' work
        bound_ms, bound_by = bound_of(n_bytes, n_flops, hbm_bps, BF16_FLOPS)
        # the pack reads wr and wi once and writes [2F, ldk] bf16
        pack_bytes = 8 * k * f + 2 * 2 * f * tpk.stacked_pitch(k)
        pack_bound = pack_bytes / hbm_bps * 1e3
        plan = tpk.complex_dense_bf16_plan(m, k, f, tpk._sm_count(
            dev.index or 0))
        key = f"{m}x{k}x{f}"
        for n, v in (("ms", ms["bf16"]), ("f32_mode_ms", ms["f32"]),
                     ("plain_ms", ms["plain"]), ("library_ms", ms["library"]),
                     ("bound_ms", bound_ms), ("bound_by", bound_by),
                     ("pack_ms", ms["pack"]),
                     ("pack_plain_ms", ms["pack_plain"]),
                     ("pack_bound_ms", pack_bound)):
            by_shape[n][key] = v
        print(json.dumps({
            "phase": 20, "kernel": "complex_dense", "mode": "bfloat16",
            "shape": [m, k, f], "kernel_ms": ms["bf16"],
            "parent_fma_mode_ms": FMA_BF16_MS[key],
            "f32_mode_ms": ms["f32"], "plain_ms": ms["plain"],
            "library_ms": ms["library"], "library": label,
            "library_max_abs_err": lib_err, "pack_ms": ms["pack"],
            "pack_plain_ms": ms["pack_plain"], "pack_bytes": pack_bytes,
            "pack_bound_ms": pack_bound, "eager_ms": eager,
            "timing": f"CUDA graph of {iters} calls", "plan": plan._asdict(),
            "bytes": n_bytes, "flops": n_flops, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_rate": "bf16 tensor cores",
            "share_of_bound": bound_ms / ms["bf16"],
            "over_library": ms["bf16"] / ms["library"],
            "peaks_of": peak_key}), flush=True)
        log(f"complex_dense bf16 [{m},{k},2]x[{k},{f}]: kernel "
            f"{ms['bf16']:.4f} ms (parent, the FMA mode, "
            f"{FMA_BF16_MS[key][0]}-{FMA_BF16_MS[key][1]}; float32 mode "
            f"{ms['f32']:.4f}), plain {ms['plain']:.4f}, {label} "
            f"{ms['library']:.4f}, bound {bound_ms:.4f} ms ({bound_by}, "
            f"{100 * bound_ms / ms['bf16']:.0f} %); pack {ms['pack']:.4f} "
            f"(plain {ms['pack_plain']:.4f}, bound {pack_bound:.4f}); "
            f"{plan.tiles} tiles on {plan.grid} blocks")
    key = "x".join(map(str, CD_BF16_SHAPES[0]))     # the sweep's call
    out = {"bf16_source": "dl_ofdm_tpu_torch/csrc/complex_dense_bf16.cu",
           "bf16_max_abs_err": max(errs), "bf16_float64_max_abs_err": f64,
           **{f"bf16_{n}": v[key] for n, v in by_shape.items()
              if not n.startswith("pack")},
           **{f"bf16_{n}_by_shape": v for n, v in by_shape.items()
              if not n.startswith("pack")}}
    pack = {"max_abs_err": 0.0, "ms": by_shape["pack_ms"][key],
            "plain_ms": by_shape["pack_plain_ms"][key],
            "bound_ms": by_shape["pack_bound_ms"][key], "bound_by": "bytes",
            "library_ms": None,
            "ms_by_shape": by_shape["pack_ms"],
            "plain_ms_by_shape": by_shape["pack_plain_ms"],
            "check": "bit-equal to pack_stacked_weight_ref"}
    return {"complex_dense": out, "pack": pack}


def check_bf16_noise(dev) -> None:
    """The plain data plane's bf16 unit noise on the card: the table equal
    to JAX's (`JAX_BF16_NORMALS`) bit for bit, and `awgn_channel` drawing
    through it (every unit normal one of its values, none of torch's
    Gaussian tails), with its moments."""
    import torch
    from dl_ofdm_tpu_torch.channel import awgn
    table = awgn.bf16_normal_table(dev)
    got = table.view(torch.int16).cpu().numpy().view(np.uint16).tolist()
    if got != JAX_BF16_NORMALS:
        raise AssertionError("the bf16 normal table differs from JAX's")
    gen = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn(64, 7, 640, 2, device=dev, generator=gen)
    y, _ = awgn.awgn_channel(x, torch.zeros(64, device=dev), gen)
    unit = ((y - x * torch.rsqrt((x ** 2).sum(-1).mean())) / 0.5 ** 0.5)
    dist = (unit.reshape(-1, 1) - table.float().reshape(1, -1)).abs()
    far = float(dist.min(1).values.max())
    var = float(unit.var())
    log(f"bf16 unit noise on the card: table == JAX's 128 values; "
        f"{unit.numel()} draws of awgn_channel within {far:.2g} of a table "
        f"value, variance {var:.5f} (JAX's 0.99417), largest "
        f"{float(unit.abs().max()):.4f}")
    if far > 1e-5 or float(unit.abs().max()) > 2.9 \
            or abs(var - 0.99417) > 0.01:
        raise AssertionError("awgn_channel's bf16 noise is not drawn "
                             "through JAX's table")


def phase_serve_big512(tpk, dev) -> dict:
    """Phase 21: the committed nfft-512 arm served at full width on AWGN,
    interleaved, SNR -10..20 dB, 20,000 frames a point in 1,000-frame
    batches (625 calls of 992 frames, key 999), held to the JAX package's
    own curve at every point and to the committed CSV wherever that curve
    meets it, each point's ratio printed; `complex_dense`'s bf16 launches
    (and the pack's) equal to the calls; frames/s beside the FMA mode's."""
    import torch
    from dl_ofdm_tpu_torch.config import TrainConfig
    from dl_ofdm_tpu_torch.eval.sweep import ber_sweep
    from dl_ofdm_tpu_torch.train.checkpoint import (load_params_npz,
                                                    params_from_flax)
    from dl_ofdm_tpu_torch.train.loop import Trainer
    tr = Trainer(big512_config(), TrainConfig(snr=5.0), channel="AWGN")
    tr.model.load_state_dict(params_from_flax(load_params_npz(BIG_ARM)))
    k_, p_ = tpk.complex_dense_kernel, tpk.pack_stacked_weight_kernel
    check_bf16_noise(dev)
    gen = torch.Generator(device=dev).manual_seed(999)
    torch.cuda.synchronize()
    k_.launches = k_.launches_bf16 = p_.launches = 0
    t = time.time()
    res = ber_sweep(tr, gen, snrs=BIG_SNRS, frames_per_point=20000,
                    batch_frames=1000, log_fn=lambda *a: None)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = {"bf16": k_.launches_bf16, "float32": k_.launches,
                "pack": p_.launches}
    frames = BIG_CALLS * BIG_POINT_FRAMES * len(BIG_SNRS)
    log(f"nfft-512 arm, interleaved sweep: {BIG_CALLS} calls, {frames} "
        f"frames in {wall:.3f} s = {frames / wall:.0f} frames/s (the FMA "
        f"mode: {FMA_BIG512_FRAMES_PER_S[0]}-{FMA_BIG512_FRAMES_PER_S[1]}); "
        f"complex_dense launches {launches}")
    if launches != {"bf16": BIG_CALLS, "float32": 0, "pack": BIG_CALLS}:
        raise AssertionError(f"complex_dense launches {launches} in "
                             f"{BIG_CALLS} calls of the bf16 sweep")
    csv_ber = np.loadtxt(BIG_CSV, delimiter=",", skiprows=1)[:, 1]
    held = [i for i, s_ in enumerate(BIG_SNRS)
            if meets(JAX_BIG512_BER[i], csv_ber[i])]
    rest = [BIG_SNRS[i] for i in range(len(BIG_SNRS)) if i not in held]
    check_curve("nfft-512", res.ber, JAX_BIG512_BER, "JAX", BIG_SNRS)
    check_curve("nfft-512", [res.ber[i] for i in held],
                [csv_ber[i] for i in held], "CSV",
                [BIG_SNRS[i] for i in held])
    for i, s_ in enumerate(BIG_SNRS):
        if s_ in rest:
            log(f"  nfft-512 SNR {s_:+3d} dB: BER {res.ber[i]:.6g}, CSV "
                f"{csv_ber[i]:.6g} (the TPU's), JAX on the CPU "
                f"{JAX_BIG512_BER[i]:.6g}: the port "
                f"{'meets' if meets(res.ber[i], csv_ber[i]) else 'misses'} "
                "the CSV here, as the JAX package does")
    print(json.dumps({
        "phase": 21, "sweep": "nfft-512 interleaved", "calls": BIG_CALLS,
        "frames": frames, "seconds": wall, "frames_per_s": frames / wall,
        "parent_fma_mode_frames_per_s": FMA_BIG512_FRAMES_PER_S,
        "launches": launches, "ber": [float(b) for b in res.ber],
        "ratio_to_jax": ratios(res.ber, JAX_BIG512_BER),
        "ratio_to_csv": ratios(res.ber, csv_ber),
        "loss": [float(v) for v in res.loss],
        "csv_points_held": [BIG_SNRS[i] for i in held],
        "csv_points_tpu_only": rest}), flush=True)
    return {"launches_bf16": launches["bf16"],
            "launches_pack": launches["pack"], "frames_per_s": frames / wall}


def phase_profile_big512(dev, calls: int = 3) -> None:
    """Phase 21, profiled (with the profiled phases at the end): one
    992-frame call of the nfft-512 sweep (a 1-frame-batch sweep of 32
    frames a point: the same call) under `torch.profiler`, `calls` times
    after a warm-up; the device-busy ms a call, the kernels a call and the
    ten kernels with the most device time, by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dl_ofdm_tpu_torch.config import TrainConfig
    from dl_ofdm_tpu_torch.eval.sweep import ber_sweep
    from dl_ofdm_tpu_torch.train.checkpoint import (load_params_npz,
                                                    params_from_flax)
    from dl_ofdm_tpu_torch.train.loop import Trainer
    tr = Trainer(big512_config(), TrainConfig(snr=5.0), channel="AWGN")
    tr.model.load_state_dict(params_from_flax(load_params_npz(BIG_ARM)))
    gen = torch.Generator(device=dev).manual_seed(999)

    def one_call():
        ber_sweep(tr, gen, snrs=BIG_SNRS, frames_per_point=BIG_POINT_FRAMES,
                  batch_frames=1000, log_fn=lambda *a: None)

    one_call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(calls):
            one_call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / calls
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiler saw no kernel on the card")
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    busy = busy_us(kernels) / 1e3 / calls
    line = {"phase": 21, "part": "profiled call", "frames": BIG_POINT_FRAMES
            * len(BIG_SNRS), "calls": calls,
            "profiled_wall_ms_per_call": wall_ms,
            "busy_ms_per_call": busy,
            "kernels_per_call": len(kernels) / calls,
            "top_kernels_us_per_call": [[n[:80], us / calls]
                                        for n, us in top]}
    print(json.dumps(line), flush=True)
    log(f"nfft-512 sweep call under the profiler: {wall_ms:.3f} ms wall, "
        f"{busy:.3f} ms busy, {len(kernels) / calls:.0f} kernels a call")
    for n, us in top:
        log(f"  {us / calls / 1e3:8.4f} ms  {n[:90]}")


def states_equal(a, b) -> list:
    """The leaves where two `TrainState`s differ (params, Adam's moments),
    bit for bit; step and count included."""
    import torch
    bad = [n for n, x, y in (("step", a.step, b.step),
                             ("count", a.opt_state["count"],
                              b.opt_state["count"])) if x != y]
    for part, x, y in (("params", a.params, b.params),
                       ("mu", a.opt_state["mu"], b.opt_state["mu"]),
                       ("nu", a.opt_state["nu"], b.opt_state["nu"])):
        bad += [f"{part}:{k}" for k in x if not torch.equal(x[k], y[k])]
    return bad


def resume_check(name: str, make, epochs: int, stop: int, every: int,
                 **fit) -> dict:
    """`make()`'s trainer fit for `epochs` straight against one stopped
    after `stop` epochs and resumed by a fresh trainer from its payload:
    the leaves that differ, and the two runs' seconds."""
    import torch

    def quiet(*a):
        return None

    t = time.time()
    sa, ia = make().fit(max_epochs=epochs, log_fn=quiet, **fit)
    torch.cuda.synchronize()
    t_straight = time.time() - t
    with tempfile.TemporaryDirectory() as d:
        make().fit(max_epochs=stop, ckpt_dir=d, ckpt_every=every,
                   log_fn=quiet, **fit)
        b = make()
        t = time.time()
        sb, ib = b.fit(max_epochs=epochs, ckpt_dir=d, ckpt_every=every,
                       log_fn=quiet, **fit)
        torch.cuda.synchronize()
        t_resumed = time.time() - t
        payload_mb = os.path.getsize(os.path.join(
            d, "resume", "state.npz")) / 2**20
    bad = states_equal(sa, sb)
    hist = {h["epoch"]: h for h in ia["history"]}
    if [h["epoch"] for h in ib["history"]] != list(range(stop, epochs)) \
            or any(h != hist[h["epoch"]] for h in ib["history"]):
        bad.append("history")
    out = {"check": name, "epochs": epochs, "resumed_at": stop,
           "straight_seconds": t_straight, "resumed_seconds": t_resumed,
           "payload_mb": payload_mb, "steps": sa.step, "differ": bad[:8],
           "n_differ": len(bad), "final_ce": ia["history"][-1]["train_loss"]}
    log(f"resume {name}: {epochs} epochs straight ({t_straight:.2f} s) "
        f"against {stop} + {epochs - stop} resumed ({payload_mb:.0f} MB "
        f"payload): " + ("params, Adam moments, step and history "
                         "bit-identical" if not bad else f"DIFFER at {bad[:8]}"))
    return out


def phase_cli_big512(tpk, tfs, tfm, dev) -> dict:
    """Phase 22: the CLI at full width (the nfft-512 bf16 receiver from
    scratch, `train` for 3 epochs with a resume payload each epoch, its
    final 41-point sweep, then `--test True` restoring the checkpoint and
    sweeping again: the same CSV); then resumed training bit-identical to
    uninterrupted on the bf16 autograd route, the fused route at
    `bench.py`'s configuration and the equalizer stage.  Returns the bf16
    `complex_dense` launches of the CLI run."""
    import torch
    from dl_ofdm_tpu_torch import cli
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.train.equalizer_loop import EqualizerTrainer
    from dl_ofdm_tpu_torch.train.loop import Trainer
    k_ = tpk.complex_dense_kernel
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            argv = CLI_ARGS + ["--save_dir", os.path.join(tmp, "out")]
            torch.cuda.synchronize()
            k_.launches = k_.launches_bf16 = 0
            tpk.pack_stacked_weight_kernel.launches = 0
            t = time.time()
            cli.main(["train"] + argv)
            torch.cuda.synchronize()
            t_train = time.time() - t
            launches = {"bf16": k_.launches_bf16, "float32": k_.launches,
                        "pack": tpk.pack_stacked_weight_kernel.launches}
            csv = "Test_DCCN_Big512_AWGN.csv"
            first = open(csv, "rb").read()
            table = np.loadtxt(csv, delimiter=",", skiprows=1)
            for p in ("out/Big512/state.npz",
                      "out/Big512.wip/resume/state.npz"):
                if not os.path.isfile(p):
                    raise AssertionError(f"the CLI wrote no {p}")
            os.remove(csv)
            t = time.time()
            cli.main(["train", "--test", "True"] + argv)
            torch.cuda.synchronize()
            t_test = time.time() - t
            second = open(csv, "rb").read()
        finally:
            os.chdir(cwd)
    if not first.startswith(b"SNR,BER,Loss\n") or table.shape != (41, 3) \
            or not np.all(np.isfinite(table[:, :2])):
        raise AssertionError(f"the CLI's CSV is malformed: {table.shape}")
    if second != first:
        raise AssertionError("--test on the saved checkpoint swept another "
                             "curve than the training run's final sweep")
    if launches["bf16"] < 1 or launches["float32"] != 0 \
            or launches["pack"] != launches["bf16"]:
        raise AssertionError(f"the CLI's bf16 run launched complex_dense "
                             f"{launches}")
    log(f"CLI train (nfft 512, bf16, 3 epochs, resume payload each epoch, "
        f"41-point sweep) {t_train:.1f} s, then --test {t_test:.1f} s: the "
        f"same CSV; complex_dense launches {launches}; BER at -10/0/10 dB "
        f"{table[0, 1]:.4g}/{table[10, 1]:.4g}/{table[20, 1]:.4g}")
    checks = []

    def big():
        return Trainer(big512_config(), TrainConfig(
            snr=5.0, batch_size=512, msg_length=512 * 14, early_stop=50),
            channel="AWGN")
    checks.append(resume_check("nfft-512 bf16, autograd route", big, 4, 2, 2))

    def fused():
        tr = Trainer(OFDMConfig(nbits=1), TrainConfig(
            snr=5.0, batch_size=TRAIN_FRAMES[0] * 7,
            msg_length=TRAIN_FRAMES[0] * 7 * 4, early_stop=50),
            channel="ETU")
        assert tr._use_fused_model
        return tr
    torch.cuda.synchronize()
    n_s, n_m = (tfs.fused_synthesize_kernel.launches,
                tfm.dccn_fused_grads_kernel.launches)
    checks.append(resume_check("bench.py's configuration, fused route",
                               fused, 4, 2, 2))
    torch.cuda.synchronize()
    n_s = tfs.fused_synthesize_kernel.launches - n_s
    n_m = tfm.dccn_fused_grads_kernel.launches - n_m
    if n_s < 1 or n_m < 1:
        raise AssertionError("the fused resume check launched no fused "
                             "kernel")

    def equalizer():
        return EqualizerTrainer(OFDMConfig(nbits=2), TrainConfig(
            snr=10.0, batch_size=73 * 7, msg_length=73 * 7 * 5, opt=12,
            early_stop=50), channel="mixRayleigh")
    checks.append(resume_check("equalizer stage (opt 12, mixRayleigh)",
                               equalizer, 4, 2, 2))
    for c in checks:
        print(json.dumps({"phase": 22, **c}), flush=True)
    bad = [c["check"] for c in checks if c["n_differ"]]
    if bad:
        raise AssertionError(f"resumed training differs from "
                             f"uninterrupted: {bad}")
    print(json.dumps({"phase": 22, "cli_train_seconds": t_train,
                      "cli_test_seconds": t_test, "launches": launches,
                      "ber": table[:, 1].tolist()}), flush=True)
    return {"launches_bf16": launches["bf16"],
            "launches_pack": launches["pack"]}


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; it runs the port "
                         "on an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.eval.sweep import ber_sweep
    from dl_ofdm_tpu_torch.ops import cuda_build
    from dl_ofdm_tpu_torch.ops import fused_model as tfm
    from dl_ofdm_tpu_torch.ops import fused_synth as tfs
    from dl_ofdm_tpu_torch.ops import pallas_kernels as tpk
    from dl_ofdm_tpu_torch.ops.pallas_kernels import (complex_dense,
                                                      complex_dense_kernel,
                                                      complex_dense_ref)
    from dl_ofdm_tpu_torch.train.checkpoint import (load_params_npz,
                                                    params_from_flax)
    from dl_ofdm_tpu_torch.train.loop import Trainer

    # -- 1. device ----------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    print(smi, flush=True)
    peak_key, (hbm_bps, f32_flops) = card_peaks(kind)
    log(f"device 0: {kind}; peaks of {peak_key}: {hbm_bps / 1e12} TB/s HBM, "
        f"{f32_flops / 1e12} TFLOP/s float32")
    dev = torch.device("cuda")

    # -- 2. build -----------------------------------------------------------
    t = time.time()
    cuda_build.build_all()
    log(f"built {sorted(cuda_build.SOURCES)} in {time.time() - t:.1f} s")
    for name, text in cuda_build.BUILD_LOGS.items():
        for line in text.strip().splitlines():
            log(f"  nvcc {name}: {line.strip()}")

    # -- 3. kernel against its plain version --------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    checks = {}
    # the sweep's shape, a ragged one, and K past the ring (x streamed in
    # K chunks)
    for m, k, f in ((1968 * 7, 80, 64), (1001, 77, 50), (370, 5000, 64)):
        x = torch.randn(m, k, 2, device=dev, generator=gen)
        wr = torch.randn(k, f, device=dev, generator=gen) / k ** 0.5
        wi = torch.randn(k, f, device=dev, generator=gen) / k ** 0.5
        with torch.no_grad():
            y = complex_dense_kernel(x, wr, wi)
            y_ref = complex_dense_ref(x, wr, wi)
        torch.cuda.synchronize()
        torch.testing.assert_close(y, y_ref, atol=1e-5, rtol=1e-5)
        err = float((y - y_ref).abs().max())
        # the autograd wrapper on the card: forward by the kernel, backward
        # by `_cdense_bwd`'s products, against autograd of the plain version
        xs = [t_.clone().requires_grad_() for t_ in (x, wr, wi)]
        xr = [t_.clone().requires_grad_() for t_ in (x, wr, wi)]
        g = torch.randn(m, f, 2, device=dev, generator=gen)
        complex_dense(*xs).backward(g)
        complex_dense_ref(*xr).backward(g)
        for a, b in zip(xs, xr):
            torch.testing.assert_close(a.grad, b.grad, atol=1e-4, rtol=1e-5)
        checks[(m, k, f)] = (x, wr, wi, err)
        log(f"complex_dense [{m},{k},2]x[{k},{f}]: kernel == plain version, "
            f"max |diff| {err:.3g}; gradients match")

    # times at the serving shape, the equalizer's and the autograd
    # training route's fft_like (9,362 frames x 7 symbols)
    cd_times = {}
    for m, k, f in CD_SHAPES:
        if (m, k, f) in checks:
            x, wr, wi, _ = checks[(m, k, f)]
        else:
            x = torch.randn(m, k, 2, device=dev, generator=gen)
            wr = torch.randn(k, f, device=dev, generator=gen) / k ** 0.5
            wi = torch.randn(k, f, device=dev, generator=gen) / k ** 0.5
            with torch.no_grad():
                torch.testing.assert_close(complex_dense_kernel(x, wr, wi),
                                           complex_dense_ref(x, wr, wi),
                                           atol=1e-5, rtol=1e-5)
        x_c = torch.view_as_complex(x)
        w_c = torch.complex(wr, wi)
        with torch.no_grad():
            runs = {"plain": lambda: complex_dense_ref(x, wr, wi),
                    "kernel": lambda: complex_dense_kernel(x, wr, wi),
                    "library": lambda: torch.matmul(x_c, w_c)}
            times = {n: [] for n in runs}
            iters = 100 if m < 100000 else 20
            for n in ("plain", "kernel", "library", "library", "kernel",
                      "plain"):
                times[n].append(time_ms(runs[n], iters))
        ms = {n: sum(t[0] for t in v) / len(v) for n, v in times.items()}
        eager_ms = {n: sum(t[1] for t in v) / len(v)
                    for n, v in times.items()}
        n_bytes = 4 * (2 * m * k + 2 * k * f + 2 * m * f)
        n_flops = 8 * m * k * f
        bound_ms, bound_by = bound_of(n_bytes, n_flops, hbm_bps, f32_flops)
        cd_times[(m, k, f)] = (ms, bound_ms, bound_by)
        plan = tpk.complex_dense_launch_plan(m, k, f, x.device.index)
        print(json.dumps({
            "phase": 3, "kernel": "complex_dense", "shape": [m, k, f],
            "kernel_ms": ms["kernel"], "plain_ms": ms["plain"],
            "library_ms": ms["library"], "eager_ms": eager_ms,
            "timing": f"CUDA graph of {iters} calls",
            "plan": plan._asdict(),
            "bytes": n_bytes, "flops": n_flops, "bound_ms": bound_ms,
            "bound_by": bound_by, "peaks_of": peak_key}), flush=True)
        log(f"complex_dense [{m},{k},2]x[{k},{f}]: kernel "
            f"{ms['kernel']:.4f} ms, plain {ms['plain']:.4f}, complex64 "
            f"matmul {ms['library']:.4f}, bound {bound_ms:.4f} ms "
            f"({bound_by}); {plan.row_tiles} row tiles on {plan.grid} "
            f"blocks")
    m, k, f = CD_SHAPES[0]
    err = checks[(m, k, f)][3]
    ms, bound_ms, bound_by = cd_times[(m, k, f)]

    # -- 4. serving path at full width ----------------------------------------
    trainer = Trainer(OFDMConfig(nbits=4), TrainConfig(), channel="AWGN")
    trainer.model.load_state_dict(params_from_flax(load_params_npz(ARM)))
    frames_per_call = 48 * len(SNRS)
    calls = {"interleaved": 20000 // 48, "point_batch": len(SNRS) * 10}
    csv_ber = np.loadtxt(CSV, delimiter=",", skiprows=1)[:, 1]
    launches = {}
    results = {}
    for protocol, seed in (("interleaved", 999), ("point_batch", 7)):
        gen = torch.Generator(device=dev).manual_seed(seed)
        torch.cuda.synchronize()
        complex_dense_kernel.launches = 0
        t = time.time()
        res = ber_sweep(trainer, gen, snrs=SNRS, frames_per_point=20000,
                        batch_frames=2000, log_fn=lambda *a: None,
                        point_batch=protocol == "point_batch")
        torch.cuda.synchronize()
        wall = time.time() - t
        launches[protocol] = complex_dense_kernel.launches
        frames = (calls["interleaved"] * frames_per_call
                  if protocol == "interleaved" else calls[protocol] * 2000)
        log(f"{protocol} sweep: {calls[protocol]} calls, {frames} frames in "
            f"{wall:.3f} s = {frames / wall:.0f} frames/s; complex_dense "
            f"launches {launches[protocol]}")
        if launches[protocol] != calls[protocol]:
            raise AssertionError(
                f"complex_dense launched {launches[protocol]} times in the "
                f"{protocol} sweep, expected {calls[protocol]}")
        with tempfile.TemporaryDirectory() as tmp:
            path = res.to_csv(os.path.join(tmp, "sweep.csv"))
            with open(path) as fh:
                header = fh.readline().strip()
            table = np.loadtxt(path, delimiter=",", skiprows=1)
        if header != "SNR,BER,Loss" or table.shape != (len(SNRS), 3) \
                or not np.all(np.isfinite(table)) \
                or not np.array_equal(table[:, 0], SNRS):
            raise AssertionError(f"{protocol} CSV malformed: {header!r}, "
                                 f"shape {table.shape}")
        results[protocol] = (res, wall, frames)
    check_curve("interleaved", results["interleaved"][0].ber,
                JAX_INTERLEAVED_BER, "JAX")
    check_curve("point_batch", results["point_batch"][0].ber, csv_ber, "CSV")
    res, wall, frames = results["interleaved"]
    print(json.dumps({
        "sweep": "interleaved", "calls": calls["interleaved"],
        "frames": frames, "seconds": wall, "frames_per_s": frames / wall,
        "ratio_to_jax": ratios(res.ber, JAX_INTERLEAVED_BER),
        "point_batch_ratio_to_csv": ratios(results["point_batch"][0].ber,
                                           csv_ber),
        "point_batch_seconds": results["point_batch"][1],
        "point_batch_frames_per_s":
            results["point_batch"][2] / results["point_batch"][1]}),
        flush=True)

    kernels = [{
        "name": "complex_dense", "route": "cuda",
        "source": "dl_ofdm_tpu_torch/csrc/complex_dense.cu",
        "replaces": "dl_ofdm_tpu/ops/pallas_kernels.py:80",
        "launches": launches["interleaved"], "max_abs_err": err,
        "ms": ms["kernel"], "plain_ms": ms["plain"],
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": ms["library"], "check": "pass",
        "ms_by_shape": {"x".join(map(str, sh)): v[0]["kernel"]
                        for sh, v in cd_times.items()},
        "library_ms_by_shape": {"x".join(map(str, sh)): v[0]["library"]
                                for sh, v in cd_times.items()}}]

    # -- 6-8. the training path ---------------------------------------------
    synth = phase_synth(tfs, dev, hbm_bps, f32_flops)
    model = phase_model(tfm, tfs, synth["planes"], dev, hbm_bps, f32_flops)
    launches_train = phase_train(tfm, tfs, dev)

    # -- 9-12. the mobile training path, long frames, the probe ---------------
    mobile = phase_synth_mobile(tfs, dev, hbm_bps, f32_flops)
    phase_long_frames(tfs, tfm, dev)
    launches_mobile = phase_train_mobile(tfm, tfs, dev)
    probe = phase_probe(dev, hbm_bps, f32_flops)

    # -- 13-17. the FIR kernel, the equalizer stage -------------------------
    fir_line = phase_fir(tpk, dev, hbm_bps, f32_flops)
    phase_cdense_eq(tpk, dev, hbm_bps, f32_flops)
    launches_serve = phase_serve_arms(tpk, tfs, dev)
    launches_eq = phase_train_eq(tpk, tfs, dev)
    phase_train_eq_mobile(tpk, tfs, dev)

    # -- 19. the multi-device path (before the profiled phases) -------------
    launches_mesh = phase_mesh_train(tpk, dev)
    phase_mesh_sweeps(tpk, dev, trainer, csv_ber)
    ring = phase_halo(tpk, dev, hbm_bps)
    phase_halo_cross_card()

    # -- 20-22. the bf16 receiver, the nfft-512 arm, the CLI ----------------
    bf16 = phase_cdense_bf16(tpk, dev, hbm_bps, peak_key)
    big = phase_serve_big512(tpk, dev)
    cli_run = phase_cli_big512(tpk, tfs, tfm, dev)

    # -- 17-18, 21. the profiled phases --------------------------------------
    phase_profile_eq(dev)
    phase_model_breakdown(tfm, dev)
    phase_profile_big512(dev)
    static = {f"static_{k}": v for k, v in synth["line"].items()
              if k in ("ms", "plain_ms", "bound_ms", "max_abs_err")}
    kernels += [
        {"name": "fused_synth", "route": "cuda",
         "source": "dl_ofdm_tpu_torch/csrc/fused_synth.cu",
         "replaces": "dl_ofdm_tpu/ops/fused_synth.py:763",
         "launches": launches_mobile["fused_synthesize"], **mobile["line"],
         "max_abs_err": max(mobile["max_abs_err"],
                            synth["line"]["max_abs_err"]),
         "launches_static_path": launches_train["fused_synthesize"],
         **static},
        {"name": "dccn_fused_grads", "route": "cuda",
         "source": "dl_ofdm_tpu_torch/csrc/fused_model.cu",
         "replaces": "dl_ofdm_tpu/ops/fused_model.py:417",
         "launches": launches_mobile["dccn_fused_grads"], **model,
         "launches_static_path": launches_train["dccn_fused_grads"]},
        {"name": "philox_probe", "route": "cuda",
         "source": "dl_ofdm_tpu_torch/csrc/philox_probe.cu",
         "replaces": "scripts/prng_quality_check.py:42", **probe},
        {"name": "fir_shift_accum", "route": "cuda",
         "source": "dl_ofdm_tpu_torch/csrc/fir_shift_accum.cu",
         "replaces": "dl_ofdm_tpu/ops/pallas_kernels.py:171",
         "launches": (launches_serve["fir_shift_accum"]
                      + launches_eq["fir_shift_accum"]
                      + launches_mesh["fir_shift_accum"]
                      + ring["fir_launches"]),
         "launches_serving": launches_serve["fir_shift_accum"],
         "launches_training": launches_eq["fir_shift_accum"],
         "launches_dp_training": launches_mesh["fir_shift_accum"],
         "launches_halo": ring["fir_launches"],
         **fir_line},
        {"name": "ring_exchange", "route": "cuda",
         "source": "dl_ofdm_tpu_torch/csrc/ring_exchange.cu",
         "replaces": "dl_ofdm_tpu/parallel/halo.py:62",
         **{k: v for k, v in ring.items() if k != "fir_launches"},
         "check": "pass"}]
    kernels[0].update(
        launches_equalizer_serving=launches_serve["complex_dense"],
        launches_equalizer_training=launches_eq["complex_dense"],
        launches_bf16=big["launches_bf16"],
        launches_bf16_cli=cli_run["launches_bf16"], **bf16["complex_dense"])
    kernels.insert(1, {
        "name": "pack_stacked_weight", "route": "cuda",
        "source": "dl_ofdm_tpu_torch/csrc/complex_dense_bf16.cu",
        "replaces": "dl_ofdm_tpu/ops/pallas_kernels.py:80",
        "launches": big["launches_pack"],
        "launches_cli": cli_run["launches_pack"], **bf16["pack"]})

    # -- 5. kernels line and the result ---------------------------------------
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
