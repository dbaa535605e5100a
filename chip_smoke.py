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
23. the classical-receiver baselines at the MATLAB protocol (nfft 64, 7
    symbols, CP 16, lte pilots, SNR -10:5:30, 20,000 frames a point in
    2,000-frame batches, seed 0), each curve through
    `cli.main(["baseline", ...])` in a temporary directory, with TF32 set
    on by the caller (the run must log float32 'highest' without TF32 and
    hand TF32 back): a. EVA static BPSK for estimators 1-10 against
    `runs/BER_OFDM_EVA_<name>_lte_64_Gray.csv`, one `fir_shift_accum`
    launch a batch (90 a curve, 99 for id 10: 909); b. AWGN, all four
    modulations, against `runs/BER_OFDM_AWGN_Perfect_lte_64_Gray.csv`;
    c. EVA mobile (70 Hz), estimator 10, symbol-averaged and per-sample
    fading, against `runs/BER_OFDM_EVA_LMMSE-Fast_lte_64_Gray_mobile.csv`;
    every point whose CSV BER is at least 1e-3 within [0.8, 1.25] of it
    (below, both printed); each curve's seconds and frames/s beside the
    card's name and power limit.  d. `fir_shift_accum` at the baseline's
    shape (2,000 x 570, EVA's 11 taps) bit-equal to its
    plain version and `fir_same_iq`, its device time (CUDA graph) beside
    phase 13's shape, the plain version, one grouped `F.conv1d` and the
    bound.  Profiled with the profiled phases at the end: one 2,000-frame
    LS-Quadeer batch (ms, busy ms, idle share, kernels and host waits a
    batch, top kernels).
24. the ablation and legacy paths: a. every function of the port's
    ablation and legacy modules (PAPR clipping, the three AWGN variants,
    the complex FFT FIRs, both legacy channels, both legacy transmitters,
    `DNNReceiver`, the four e2e blocks) on the card against itself on the
    CPU on the same inputs and draws (1e-5 of the largest value, 1e-4 for
    the FFT variants); both legacy channels at 30,000 x 7 x 80 samples
    (ETU: 6 taps at 0.96 MHz, 51 at 10 MHz), one `fir_shift_accum` launch
    a call, the FIR bit-equal to the plain version, the kernel and the
    whole call timed from CUDA graphs beside the plain version, one
    grouped `F.conv1d` and the bound; b. the DNN ablation at full width
    (`runs/run_experiments15.py:212-231`, cut to 20 epochs): its mean
    val_ber of epochs 15-19 within [0.5, 2.0] of the JAX trace's
    (`runs/p15_dnn_trace.json`), ms a step and launches a step.
25. tensor parallelism, on virtual ranks of card 0 (one rank a card with
    four cards): a. JAX's tp configuration (nfft 1,024, nfilter 1,024,
    ETU, float32) on dp 2 x tp 2 at 64 frames: `Dense_extract.weight`
    split on its in axis, gradients within rtol 2e-4 / atol 1e-6 of the
    single-device ones, three steps, `complex_dense` one launch a rank a
    step, ms a step against single-device at 64 and 256 frames, the
    kernel at a rank's shape; b. the nfft-512 bf16 arm on dp 1 x tp 2:
    gradients within 1e-2 of each leaf's max, the pack and the bf16 GEMM
    at N = 256 (each call within 1e-5 of `complex_dense_ref`), their
    times, then a 3-point `ber_sweep` (4,000 frames a point) on dp 2 x
    tp 2 bit-identical to dp 2; c. the opt-12 arm in `EqualizerTrainer`
    on dp 1 x tp 2: the tp gradients' worst error against float64 ones
    (the same trainer on the CPU) within twice the single-device float32
    gradients', the receiver frozen; d. a resumed fit on dp 2 x tp 2 at
    nfft 256 (2 + 2 epochs against 4) bit-identical; e.
    `SingleGraphEqualizedRx` (nbits 2, nfft 64) as a trainer's model on
    dp 1 x tp 2: its tp gradients' worst error against float64 ones within
    twice the single-device float32 gradients'.
26. multi-process data parallelism (`torch.multiprocessing`, spawn): on
    one card two processes sharing it over gloo, named explicitly after
    NCCL is shown to refuse two ranks on one card; on two or more cards
    NCCL, one process a card.  a. `bench.py`'s configuration at 9,362
    frames on dp 2 for 10 steps against the one-process dp-2 mesh from
    the same seeds: bit-identical or each leaf's worst difference, each
    step's loss within 1e-4, ms a step beside the one-process step, one
    `fir_shift_accum` and one `complex_dense` launch a process a step;
    b. the 16QAM arm's interleaved sweep (48 frames a point and rank, as
    4b) with counts equal to the one-process mesh's and the curve against
    JAX's; c. the halo FIR of 19c cut over the two processes, the ring
    through CUDA IPC (and 'ppermute' over NCCL), bit-equal to
    `fir_same_iq`, ms a call of the ring and the FIR from CUDA events and
    the host clock; d. with four cards, NCCL at 4 processes dp 4 and 2
    processes x 2 cards dp 2 x tp 2 against their one-process meshes;
    e. (run after 25) tp rows across processes: two processes (gloo on one
    card, NCCL on two or more) at dp 1 x tp 2, 25a's configuration
    (nfft 1,024, 64 frames) for 3 steps bit-identical to the one-process
    dp 1 x tp 2 mesh (leaf hashes), one `complex_dense` launch a rank a
    step in each process, ms a step and the per-step gather of the split
    leaves beside the one-process mesh; the nfft-512 bf16 arm's gradients
    on tp 2 across the processes within 1e-2 of each leaf's max of
    single-device and bit-identical to the one-process tp 2, one pack and
    one bf16 GEMM a process; f. with four cards, NCCL at 4 processes dp 2
    x tp 2 and dp 1 x tp 4, and 2 processes x 2 cards dp 1 x tp 4, each
    against its one-process mesh over the four cards.  A failed worker
    fails the run after every worker's error is printed.
27. the partitioned Doppler path (`RayleighChannel._partition_doppler`)
    on a mixRayleigh mobile batch of 9,363 frames: `y` and `h_freq`
    bit-equal to the general path's on the same draws, one
    `fir_shift_accum` launch a call in each (6,242 rows against 9,363),
    ms a call of each.
28. (run after phase 8) the optimizer kernel (`csrc/fused_adam.cu`): at
    nfft 64's ten leaves (0.58 M values) and the nfft-512 receiver's (29.3
    M), one launch against `fused_adam_ref` (parameters and moments
    bit-identical, the loss scalars within 1e-6), its time from a CUDA
    graph and eager, with and without the L2 term, beside its byte bound
    (28 bytes a value) and the `_foreach_*` path's (`Adam.update` and the
    parameter add); then the fused 1,024-frame step, 20 steps with the
    kernel bit-identical to 20 on the foreach path (forced in this
    process by turning off a second trainer's `Adam._kernel_leaves`), and
    ms/step of each in turns K F F K; PyTorch's `torch._fused_adam_` timed
    beside them.  Alone: `cs.phase_fused_adam(dev, hbm_bps)` after
    `cuda_build.build_all()`.
29. (run after phase 28) the equalizers' block convolution
    (`csrc/complex_conv2d.cu`): the arms' (7, 64) 'exact' convolution at 9,362
    and 1,024 frames, the kernels' forward, input gradient, weight and bias
    gradients against the plain versions in float64 (each error relative to the
    largest value), one launch for the forward and the input gradient and two
    for the weight gradient; then each pass's time from a CUDA graph beside the
    operations bound (909,312 FLOP a frame a pass at the float32 FMA peak), the
    plain versions' for the same three passes and cuDNN's for the same
    convolution as one 2-channel call under `deterministic_cudnn()` with TF32
    off (`library_ms`, never called by the port), and the layer's `F.conv2d`
    path (four real convolutions) forward and backward; then 20 equalizer steps
    of the benchmark's cell (opt 12, mobile mixRayleigh, 9,362 frames) twice
    from the same seeds, bit-identical, with 4 kernel launches a step (the
    counters set to 0 before them, so the kernels line's `launches` is these
    steps' 160). Alone: `cs.phase_block_conv(dev, f32_flops)` after
    `cuda_build.build_all()`.
30. (run before the profiled phases) the plain data plane of a static
    channel as two kernels (`csrc/synth_chain.cu`), which `Trainer.synthesize`
    takes on a card (phases 4, 14, 15, 19 and 26 run it: their static calls
    count the chain's launches, two a call, and `fir_shift_accum` runs only
    on their Doppler calls): at the two sweep cells' calls (1,968 x nfft 64
    ETU frames in 41 groups, 992 x nfft 512 AWGN frames in 31) against
    today's path on the same draws (rx_in within 1e-4 beyond today's own
    float32 error against a float64 normalization; h, waveform and noise
    power within 2e-6; the generator's state), two calls bit-identical;
    the kernels' device time (CUDA graph) beside their byte bound; both
    paths' host time a call; the launches and host-to-device copies a call
    under `torch.profiler`; a Doppler call counted as a fallback.  Alone:
    `cs.phase_synth_chain(dev, hbm_bps)` after `cuda_build.build_all()`.
 5. (printed last) one `{"kernels": [...]}` line with all nine kernels
    (launches of `fused_synth` and `dccn_fused_grads` from phase 11, of
    `complex_dense` from phase 4a (with its equalizer-path counts, and
    its bf16 mode's GEMM from phases 21 and 22 beside phase 20's
    numbers), of `pack_stacked_weight` from phases 21 and 22, of
    `philox_probe` from phase 12, of `fir_shift_accum` from phases 14, 15
    and 19 and 23 (with the baseline shape's numbers) and 24a
    (`launches_legacy`, with the legacy shapes' numbers), of
    `ring_exchange` from phase 19c, with its launches across processes
    and their times from phase 26c, of `fused_adam` from phase 8 with
    phase 28's times, of `complex_conv2d` from phase 29's 2 x 20 steps;
    `complex_dense` and
    `fir_shift_accum` with `launches_multiprocess` from phase 26;
    `complex_dense` and
    `pack_stacked_weight` with `launches_tp` from phases 25a-b and the tp
    shapes' numbers; `complex_dense` with `launches_tp_multiprocess` and
    `launches_bf16_tp_multiprocess` from phase 26e, summed over the
    processes), then as the last line
    `{"ok": true, "device": {...}}`.

Any failure raises and exits non-zero; so does a machine with no CUDA
device, or a directory that holds this script without the package.
"""
import contextlib
import copy
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
    from dl_ofdm_tpu_torch.ops import fused_adam as fa
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
    fa.fused_adam_kernel.launches = 0
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
                "dccn_fused_grads": tfm.dccn_fused_grads_kernel.launches,
                "fused_adam": fa.fused_adam_kernel.launches}
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


def adam_leaf_set(rx, dev, seed: int = 1):
    """(keys, parameters, gradients, moments) of `rx`'s leaves on `dev`,
    drawn from `seed`; at nfft 64 the head's gradients transposed and the
    fft_like biases' strided, as the fused model kernel hands them."""
    import torch
    shapes = {k: tuple(v.shape) for k, v in rx.state_dict().items()}
    g = torch.Generator(device=dev).manual_seed(seed)

    def draw(shape, scale):
        return scale * torch.randn(shape, device=dev, generator=g)

    ws = {k: draw(sh, 0.1) for k, sh in shapes.items()}
    gs = {k: draw(sh, 1e-3) for k, sh in shapes.items()}
    if rx.nfft == 64:
        for k in ("Dense_conv1x1.weight", "Dense_llr.weight"):
            gs[k] = draw(shapes[k][::-1], 1e-3).T
        dfb = draw((2 * shapes["fft_like.br"][0],), 1e-3)
        gs["fft_like.br"], gs["fft_like.bi"] = dfb[0::2], dfb[1::2]
    mus = {k: draw(sh, 1e-4) for k, sh in shapes.items()}
    nus = {k: draw(sh, 1e-4) ** 2 for k, sh in shapes.items()}
    return list(shapes), ws, gs, mus, nus


def phase_fused_adam(dev, hbm_bps) -> dict:
    """Phase 28: the optimizer kernel (`csrc/fused_adam.cu`): at nfft 64's
    ten leaves (0.58 M values) and the nfft-512 receiver's (29.3 M), one
    launch against `fused_adam_ref` (bit-identical; loss scalars within
    1e-6), then its time (CUDA graph, and eager: the host's pace) with
    and without the L2 term beside its byte bound (28 bytes a value) and
    the `_foreach_*` path's (`Adam.update` and the parameter add) and
    PyTorch's `torch._fused_adam_`'s (with and without the copies that
    keep the input state whole; its parameters against the plain
    version's); then the fused 1,024-frame step with the kernel and with
    the foreach path (a second trainer whose optimizer's
    `_kernel_leaves` is turned off): 20 steps bit-identical, and ms/step
    in turns K F F K."""
    import torch
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.models.dccn import DCCNReceiver
    from dl_ofdm_tpu_torch.ops import fused_adam as fa
    from dl_ofdm_tpu_torch.train.loop import Adam, Trainer
    result = {"leaf_sets": {}}
    for name, rx in (("nfft64", DCCNReceiver(1, 64, 16, 64, 320)),
                     ("nfft512", DCCNReceiver(1, 512, 128, 512, 2000,
                                              compute_dtype="bfloat16"))):
        keys, ws, gs, mus, nus = adam_leaf_set(rx, dev)
        args = [[d[k] for k in keys] for d in (ws, gs, mus, nus)]
        n = sum(w.numel() for w in args[0])
        lay = fa.AdamLayout.of({}, keys, *args)
        conf = torch.tensor([[3000, 200], [350, 2850]], device=dev)
        ce = torch.tensor([0.61], device=dev)
        hp = fa.AdamHyper(0.9, 0.999, 1e-8, 1e-3, 7)
        got = fa.fused_adam_kernel(lay, *args, hp, conf, ce, 1e-4)
        want = fa.fused_adam_ref(keys, *args, hp, conf, ce[0], 1e-4)
        torch.cuda.synchronize()
        for field in ("params", "mu", "nu"):
            for k, a, b in zip(keys, getattr(got, field),
                               getattr(want, field)):
                if not torch.equal(a, b):
                    raise AssertionError(f"fused_adam {name} {field} {k}: "
                                         f"kernel != plain version")
        gap = max(abs(float(got.scalars[k]) / float(v) - 1)
                  for k, v in want.scalars.items() if float(v) != 0)
        if gap > 1e-6:
            raise AssertionError(f"fused_adam {name} loss scalars: "
                                 f"relative gap {gap}")
        opt = Adam(TrainConfig())
        st = {"count": 6, "mu": dict(zip(keys, args[2])),
              "nu": dict(zip(keys, args[3]))}
        gd = dict(zip(keys, args[1]))

        def foreach():
            upd, _ = opt.update(gd, st)
            torch._foreach_add(args[0], [upd[k] for k in keys])

        # PyTorch's one-launch Adam (`torch.optim.Adam(fused=True)`): in
        # place on copies of its own, with dense gradients and no L2 fold;
        # "library" first copies parameters and moments (one multi-tensor
        # launch a plane), as a step that leaves its input state whole must
        lib = [[t.clone() for t in a] for a in (args[0], args[2], args[3])]
        dense_g = [g.contiguous() for g in args[1]]
        lib_steps = [torch.tensor(7.0, device=dev) for _ in keys]

        def library(copy=True):
            p, m, v = ([torch._foreach_mul(a, 1.0) for a in lib] if copy
                       else lib)
            torch._fused_adam_(p, dense_g, m, v, [], lib_steps, lr=1e-3,
                               beta1=0.9, beta2=0.999, weight_decay=0.0,
                               eps=1e-8, amsgrad=False, maximize=False)
            return p

        plain = fa.fused_adam_ref(keys, *args, hp).params
        lib_w = library()
        torch.cuda.synchronize()
        lib_diff = {"values_differing": sum(
            int((a != b).sum()) for a, b in zip(lib_w, plain)),
            "max_abs": max(float((a - b).abs().max())
                           for a, b in zip(lib_w, plain))}
        del plain, lib_w
        iters = 100 if n < 10 ** 7 else 20
        times = {"kernel": [], "kernel_l2": [], "foreach": [],
                 "library": [], "library_inplace": []}
        runs = {"kernel": lambda: fa.fused_adam_kernel(lay, *args, hp),
                "kernel_l2": lambda: fa.fused_adam_kernel(
                    lay, *args, hp, conf, ce, 1e-4),
                "foreach": foreach, "library": library,
                "library_inplace": lambda: library(False)}
        for r in ("kernel", "foreach", "library", "library_inplace",
                  "kernel_l2", "kernel_l2", "library_inplace", "library",
                  "foreach", "kernel"):
            times[r].append(time_ms(runs[r], iters))
        ms = {r: sum(t[0] for t in v) / len(v) for r, v in times.items()}
        eager = {r: sum(t[1] for t in v) / len(v) for r, v in times.items()}
        bound_ms = 28 * n / hbm_bps * 1e3
        line = {"values": n, "leaves": len(keys), "kernel_ms": ms["kernel"],
                "kernel_l2_ms": ms["kernel_l2"], "foreach_ms": ms["foreach"],
                "library_ms": ms["library"],
                "library_inplace_ms": ms["library_inplace"],
                "library_vs_plain_params": lib_diff,
                "eager_ms": eager, "bound_ms": bound_ms,
                "roofline_pct": 100 * bound_ms / ms["kernel"],
                "scalar_gap": gap, "timing": f"CUDA graph of {iters} calls"}
        result["leaf_sets"][name] = line
        print(json.dumps({"phase": 28, "kernel": "fused_adam",
                          "leaf_set": name, **line}), flush=True)
        log(f"fused_adam {name} ({n} values, {len(keys)} leaves): kernel == "
            f"plain version; {ms['kernel']:.4f} ms ({ms['kernel_l2']:.4f} "
            f"with the L2 term), bound {bound_ms:.4f} ms (bytes), foreach "
            f"path {ms['foreach']:.4f} ms, torch._fused_adam_ "
            f"{ms['library']:.4f} ms ({ms['library_inplace']:.4f} in place; "
            f"{lib_diff['values_differing']} of {n} parameters off the "
            f"plain version, by up to {lib_diff['max_abs']:.3g}); eager "
            f"{eager['kernel']:.4f} / {eager['foreach']:.4f} / "
            f"{eager['library']:.4f} ms a call")
        del args, ws, gs, mus, nus, got, want, lay, st, gd, lib, dense_g
        torch.cuda.empty_cache()

    # the fused 1k step with the kernel and with the foreach path
    trs = [Trainer(OFDMConfig(nbits=1), TrainConfig(batch_size=7 * 1024),
                   channel="ETU") for _ in range(2)]
    trs[1].optimizer._kernel_leaves = lambda *a, **k: None
    snr = torch.full((1024,), 5.0, device=dev)
    init = trs[0].init_state(torch.Generator(device=dev).manual_seed(0))

    def steps(count, foreach, keep=False):
        gen = torch.Generator(device=dev).manual_seed(9)
        state, out = init, []
        for _ in range(count):
            state, _ = trs[foreach].train_step(state, gen, snr)
            if keep:
                out.append(state)
        return out

    n0, f0 = fa.fused_adam_kernel.launches, Adam.foreach_steps
    ks = steps(20, False, keep=True)
    n1 = fa.fused_adam_kernel.launches
    fs = steps(20, True, keep=True)
    torch.cuda.synchronize()
    if (n1 - n0, Adam.foreach_steps - f0,
            fa.fused_adam_kernel.launches - n1) != (20, 20, 0):
        raise AssertionError(f"fused_adam launches {n1 - n0}, foreach "
                             f"steps {Adam.foreach_steps - f0}")
    for i, (a, b) in enumerate(zip(ks, fs)):
        for k in a.params:
            if not (torch.equal(a.params[k], b.params[k])
                    and torch.equal(a.opt_state["mu"][k], b.opt_state["mu"][k])
                    and torch.equal(a.opt_state["nu"][k],
                                    b.opt_state["nu"][k])):
                raise AssertionError(f"fused step {i + 1}, {k}: kernel and "
                                     f"foreach path differ")
    log("fused 1,024-frame steps: 20 with the kernel bit-identical to 20 on "
        "the foreach path (parameters and both moments)")
    del ks, fs
    step_ms = {"kernel": [], "foreach": []}
    for foreach in (False, True, True, False):
        steps(3, foreach)
        torch.cuda.synchronize()
        t = time.perf_counter()
        steps(200, foreach)
        torch.cuda.synchronize()
        step_ms["foreach" if foreach else "kernel"].append(
            (time.perf_counter() - t) * 1e3 / 200)
    result["step_ms"] = step_ms
    print(json.dumps({"phase": 28, "fused_step_1k_ms": step_ms,
                      "order": "K F F K, 200 steps each"}), flush=True)
    log(f"fused 1,024-frame step: kernel {step_ms['kernel']} ms, foreach "
        f"path {step_ms['foreach']} ms")
    return result


BLOCK_CONV = (7, 64)          # the arms' block conv: kernel = map (S, K)


def block_conv_case(dev, frames: int, seed: int):
    """The arms' one-channel (7, 64) 'exact' layer on the card with every
    parameter drawn (biases too), and x, g [frames, 7, 64, 2]."""
    import torch
    from dl_ofdm_tpu_torch.ops.complex_ops import ComplexConv2d
    gen = torch.Generator(device=dev).manual_seed(seed)
    layer = ComplexConv2d(1, 1, BLOCK_CONV, padding="same").to(dev)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, device=dev, generator=gen) * 0.05)
    x, g = (torch.randn(frames, *BLOCK_CONV, 2, device=dev, generator=gen)
            for _ in range(2))
    return layer, x, g


def phase_block_conv(dev, f32_flops) -> dict:
    """Phase 29: the block convolution's kernels against the plain
    versions in float64, their times beside the bound, the plain
    version's and cuDNN's, and 20 equalizer steps twice, bit-identical
    (see the module note)."""
    import torch
    import torch.nn.functional as F
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.ops import complex_conv2d as cc
    from dl_ofdm_tpu_torch.ops import complex_ops as tco
    from dl_ofdm_tpu_torch.train.equalizer_loop import EqualizerTrainer
    from dl_ofdm_tpu_torch.train.loop import deterministic_cudnn
    kern = cc.complex_conv2d_kernel
    s, k = BLOCK_CONV
    pt, pl = (s - 1) // 2, (k - 1) // 2
    flops = 8 * 37 * 3072                     # a frame a pass, in reach
    result = {"shapes": {}}
    for frames, seed in ((9362, 29), (1024, 30)):
        layer, x, g = block_conv_case(dev, frames, seed)
        w, b = layer.tap_weight().detach(), layer.tap_bias().detach()
        n0 = (kern.launches_fwd, kern.launches_dgrad, kern.launches_wgrad)
        with torch.no_grad():
            y = cc.complex_conv2d_kernel(x, w, b)
            dx = cc.complex_conv2d_kernel(g, w, flip=True)
            dw, db = cc.complex_conv2d_wgrad_kernel(x, g, s, k)
        torch.cuda.synchronize()
        counts = (kern.launches_fwd - n0[0], kern.launches_dgrad - n0[1],
                  kern.launches_wgrad - n0[2])
        if counts != (1, 1, 2):
            raise AssertionError(f"complex_conv2d launches {counts}")
        x64, g64, w64, b64 = (t.double() for t in (x, g, w, b))
        want = {"y": cc.complex_conv2d_ref(x64, w64, b64),
                "dx": cc.complex_conv2d_ref(g64, w64, flip=True)}
        want["dw"], want["db"] = cc.complex_conv2d_wgrad_ref(x64, g64, s, k)
        got = {"y": y, "dx": dx, "dw": dw, "db": db}
        errs = {n: float((got[n].double() - v).abs().max()
                         / v.abs().max()) for n, v in want.items()}
        del want, x64, g64
        # float32 sums of ~250 products an output, and of ~4,000 a lane
        # in the weight gradient's partials
        tol = {"y": 1e-5, "dx": 1e-5, "dw": 1e-4, "db": 1e-4}
        bad = {n: e for n, e in errs.items() if not e <= tol[n]}
        if bad:
            raise AssertionError(f"complex_conv2d at {frames} frames: "
                                 f"relative errors {bad} above {tol}")
        log(f"complex_conv2d (7, 64) at {frames} frames: kernels against "
            f"float64 plain versions, largest errors relative to the "
            f"largest value {errs}")

        # cuDNN: the same convolution as one 2-channel call, TF32 off
        xp = F.pad(x.permute(0, 3, 1, 2), (pl, k - 1 - pl, pt, s - 1 - pt))
        gn = g.permute(0, 3, 1, 2).contiguous()
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        aten_bwd = torch.ops.aten.convolution_backward

        def lib(mask):
            return lambda: aten_bwd(gn, xp, w_oihw, [2], [1, 1], [0, 0],
                                    [1, 1], False, [0, 0], 1, mask)

        # the layer's F.conv2d path (four real convolutions), forward and
        # backward, as the port ran it on the card before the kernels
        xr_, xi_ = (x[..., c:c + 1].detach().requires_grad_()
                    for c in (0, 1))

        def old_path():
            yr, yi = layer._recombine(
                lambda v, w_: tco.conv2d_nhwc(v, w_, "same"), xr_, xi_)
            torch.autograd.backward([yr, yi], [g[..., :1], g[..., 1:]])

        runs = {
            "forward": lambda: cc.complex_conv2d_kernel(x, w, b),
            "input_grad": lambda: cc.complex_conv2d_kernel(g, w, flip=True),
            "weight_grad": lambda: cc.complex_conv2d_wgrad_kernel(x, g, s,
                                                                   k),
            "plain_forward": lambda: cc.complex_conv2d_ref(x, w, b),
            "plain_input_grad": lambda: cc.complex_conv2d_ref(g, w,
                                                              flip=True),
            "plain_weight_grad": lambda: cc.complex_conv2d_wgrad_ref(x, g, s,
                                                                     k),
            "library_forward": lambda: F.conv2d(xp, w_oihw, b),
            "library_input_grad": lib([True, False, False]),
            "library_weight_grad": lib([False, True, True])}
        times = {n: [] for n in runs}
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            with deterministic_cudnn(), torch.no_grad():
                for order in (list(runs), list(runs)[::-1]):
                    for n in order:
                        iters = 2 if n.startswith("plain") else 20
                        times[n].append(time_ms(runs[n], iters))
            with deterministic_cudnn():
                for _ in range(2):
                    old_path()
                torch.cuda.synchronize()
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                for _ in range(5):
                    old_path()
                t1.record()
                torch.cuda.synchronize()
                old_ms = t0.elapsed_time(t1) / 5
        finally:
            torch.backends.cudnn.allow_tf32 = prev
        ms = {n: sum(t[0] for t in v) / len(v) for n, v in times.items()}
        eager = {n: sum(t[1] for t in v) / len(v) for n, v in times.items()}
        bound_ms = flops * frames / f32_flops * 1e3
        passes = ("forward", "input_grad", "weight_grad")
        line = {"frames": frames, "max_rel_err_vs_float64": errs,
                "kernel_ms": {p: ms[p] for p in passes},
                "kernel_ms_total": sum(ms[p] for p in passes),
                "roofline_pct": {p: 100 * bound_ms / ms[p] for p in passes},
                "bound_ms_a_pass": bound_ms, "bound_by": "operations",
                "plain_ms": {p: ms["plain_" + p] for p in passes},
                "plain_ms_total": sum(ms["plain_" + p] for p in passes),
                "library_ms": {p: ms["library_" + p] for p in passes},
                "library_ms_total": sum(ms["library_" + p] for p in passes),
                "conv2d_nhwc_path_fwd_bwd_ms": old_ms,
                "eager_ms": eager, "timing": "CUDA graph of 20 calls (the "
                "plain version 2), in turns; the F.conv2d path eager, CUDA "
                "events over 5", "launches": list(counts)}
        result["shapes"][frames] = line
        print(json.dumps({"phase": 29, "kernel": "complex_conv2d", **line}),
              flush=True)
        log(f"complex_conv2d at {frames} frames: forward "
            f"{ms['forward']:.4f} ms, input gradient {ms['input_grad']:.4f}"
            f", weight gradient {ms['weight_grad']:.4f} (bound "
            f"{bound_ms:.4f} ms a pass); cuDNN {line['library_ms']}; the "
            f"F.conv2d path forward and backward {old_ms:.3f} ms; plain "
            f"versions {line['plain_ms']}")
        del layer, x, g, xp, gn, xr_, xi_
        torch.cuda.empty_cache()

    # 20 steps of the benchmark's equalizer cell, twice from the same seeds
    def steps():
        tr = EqualizerTrainer(OFDMConfig(nbits=1), TrainConfig(
            opt=12, batch_size=9362 * 7, curriculum_tail=True),
            channel="mixRayleigh", mobile=True)
        gen = torch.Generator(device=dev).manual_seed(2929)
        state = tr.init_state(gen)
        out = []
        for _ in range(20):
            state, _ = tr.train_step_curriculum(state, gen)
            out.append(state)
        torch.cuda.synchronize()
        return out

    kern.launches = kern.launches_fwd = 0
    kern.launches_dgrad = kern.launches_wgrad = 0
    runs = [steps(), steps()]
    per_step = kern.launches / 40
    if per_step != 4:
        raise AssertionError(f"complex_conv2d launches a step {per_step}")
    differ = [(i, k_) for i, (a, b) in enumerate(zip(*runs))
              for k_ in a.params if not torch.equal(a.params[k_],
                                                    b.params[k_])]
    differ += [(i, k_) for i, (a, b) in enumerate(zip(*runs))
               for part in ("mu", "nu") for k_ in a.opt_state[part]
               if not torch.equal(a.opt_state[part][k_],
                                  b.opt_state[part][k_])]
    if differ:
        raise AssertionError(f"equalizer steps differ at {differ[:5]}")
    result["steps_bit_identical"] = 20
    result["launches"] = kern.launches
    result["launches_by_pass"] = {"forward": kern.launches_fwd,
                                  "input_grad": kern.launches_dgrad,
                                  "weight_grad": kern.launches_wgrad}
    print(json.dumps({"phase": 29, "equalizer_steps_bit_identical": 20,
                      "launches_a_step": per_step}), flush=True)
    log("20 equalizer steps (opt 12, mobile mixRayleigh, 9,362 frames) "
        "twice from the same seeds: parameters and both moments "
        "bit-identical; 4 complex_conv2d launches a step")
    return result


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
    """The launch counts of every kernel on the equalizer stage's paths
    (the plain data plane's chain: two a call)."""
    from dl_ofdm_tpu_torch.ops import synth_chain
    return {"fir_shift_accum": tpk.fir_shift_accum_kernel.launches,
            "complex_dense": tpk.complex_dense_kernel.launches,
            "fused_synth": tfs.fused_synthesize_kernel.launches,
            "synth_chain": synth_chain.synth_chain_kernel.launches}


def zero_counts(tpk, tfs) -> None:
    import torch
    from dl_ofdm_tpu_torch.ops import synth_chain
    torch.cuda.synchronize()
    tpk.fir_shift_accum_kernel.launches = 0
    tpk.complex_dense_kernel.launches = 0
    tfs.fused_synthesize_kernel.launches = 0
    synth_chain.synth_chain_kernel.launches = 0


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
    # the static arms' data plane is the chain, the mobile arms' the FIR
    for k in ("synth_chain", "fir_shift_accum", "complex_dense"):
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
    # static mixRayleigh: the plain data plane is the chain
    for k in ("synth_chain", "complex_dense"):
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
    4-rank mesh of virtual ranks; returns its launches of the plain data
    plane's kernels (static ETU: the chain's two a rank and step)."""
    import torch
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.ops import synth_chain
    from dl_ofdm_tpu_torch.parallel.mesh import make_mesh
    from dl_ofdm_tpu_torch.train.loop import Trainer
    chain = synth_chain.synth_chain_kernel
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
    chain.launches = 0
    state, aux = tr.train_step(state, gen, snr)            # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(MESH_STEPS):
        state, aux = tr.train_step(state, gen, snr)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3 / MESH_STEPS
    launches = chain.launches
    fir = tpk.fir_shift_accum_kernel.launches
    if launches != 2 * MESH_DP * (MESH_STEPS + 1) or fir:
        raise AssertionError(f"the chain launched {launches} kernels and "
                             f"fir_shift_accum {fir} in {MESH_STEPS + 1} dp "
                             f"steps of {MESH_DP} ranks")
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
            "synth_chain_launches": launches,
            "steps": MESH_STEPS + 1, "step1_grad_err": gerr,
            "replicas_identical": same, "ce": float(aux["ce"])}
    log(f"dp step ({MESH_DP} virtual ranks, {frames} frames): {ms:.3f} "
        f"ms/step; the chain's kernels {launches} launches in "
        f"{MESH_STEPS + 1} steps; step-1 gradients within {gerr:.3g} of "
        f"the single-device route; replicas bit-identical")
    print(json.dumps(line), flush=True)
    return {"fir_shift_accum": fir, "synth_chain": launches}


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


# -- 26. multi-process data parallelism ---------------------------------------

PROC_N = 2                          # processes of phase 26a-c
PROC_STEPS = 10                     # dp steps (the first one untimed)
# 48 frames a point and rank, as JAX's single-device call's 1,968 / 41
# (the per-point moments are taken over them: a wider group moves the curve)
PROC_SWEEP_BATCH = 48 * 41 * PROC_N
PROC_HALO_CALLS = 20
PROC_TIMEOUT_S = 180                # a collective waits this long, then fails


def proc_devices(rank: int, per_proc: int) -> list:
    """The cards of process `rank`: its own `per_proc` cards where the
    machine has one a process, else card 0 for every process."""
    import torch
    n = torch.cuda.device_count()
    first = rank * per_proc if n >= per_proc * (rank + 1) else 0
    return [torch.device("cuda", first + i if n > 1 else 0)
            for i in range(per_proc)]


def proc_train(mesh, dev) -> dict:
    """`bench.py`'s configuration (nbits 1, nfft 64, 64 filters, ETU
    static, 5 dB) at 9,362 frames on `mesh` for PROC_STEPS steps on the
    plain data plane from seed 26: this process's launches, ms a step
    (steps 2-10, host clock around a synchronize), each step's loss and
    the parameters (on the host)."""
    import torch
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.ops import pallas_kernels as tpk
    from dl_ofdm_tpu_torch.ops import synth_chain
    from dl_ofdm_tpu_torch.train.loop import Trainer
    tr = Trainer(OFDMConfig(nbits=1), TrainConfig(batch_size=65534),
                 channel="ETU", mesh=mesh)
    frames = tr.batch_frames
    want = 9362 + (-9362) % mesh.shape["dp"]
    if frames != want or tr._use_fused_model:
        raise AssertionError(f"dp trainer: {frames} frames; want {want}")
    gen = torch.Generator(device=dev).manual_seed(26)
    state = tr.init_state(gen)
    snr = torch.full((frames,), 5.0, device=dev)
    torch.cuda.synchronize(dev)
    tpk.fir_shift_accum_kernel.launches = 0
    tpk.complex_dense_kernel.launches = 0
    synth_chain.synth_chain_kernel.launches = 0
    losses = []
    for i in range(PROC_STEPS):
        if i == 1:
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
        state, aux = tr.train_step(state, gen, snr)
        losses.append(aux["loss"])
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t) * 1e3 / (PROC_STEPS - 1)
    if mesh.shape["tp"] == 1 and not all(
            torch.equal(rep[k].to(dev), state.params[k])
            for rep in state.replicas for k in rep):
        raise AssertionError("dp replicas differ after the steps")
    return {"frames": frames, "ms_per_step": ms,
            "losses": [float(v) for v in losses],
            "fir_shift_accum": tpk.fir_shift_accum_kernel.launches,
            "synth_chain": synth_chain.synth_chain_kernel.launches,
            "complex_dense": tpk.complex_dense_kernel.launches,
            "params": {k: v.cpu() for k, v in state.params.items()}}


def proc_sweep(mesh, dev) -> dict:
    """The 16QAM arm's interleaved sweep (-10..30 dB, 20,000 frames a
    point, PROC_SWEEP_BATCH frames a call, seed 999) on `mesh`."""
    import torch
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.eval.sweep import ber_sweep
    from dl_ofdm_tpu_torch.ops import pallas_kernels as tpk
    from dl_ofdm_tpu_torch.train.checkpoint import (load_params_npz,
                                                    params_from_flax)
    from dl_ofdm_tpu_torch.train.loop import Trainer
    tr = Trainer(OFDMConfig(nbits=4), TrainConfig(), channel="AWGN",
                 device=dev)
    tr.model.load_state_dict(params_from_flax(load_params_npz(ARM)))
    torch.cuda.synchronize(dev)
    tpk.complex_dense_kernel.launches = 0
    t = time.time()
    res = ber_sweep(tr, torch.Generator(device=dev).manual_seed(999),
                    snrs=SNRS, frames_per_point=20000,
                    batch_frames=PROC_SWEEP_BATCH, log_fn=lambda *a: None,
                    mesh=mesh)
    torch.cuda.synchronize(dev)
    return {"ber": res.ber, "loss": res.loss, "seconds": time.time() - t,
            "complex_dense": tpk.complex_dense_kernel.launches}


def proc_halo(mesh, dev, backend: str) -> dict:
    """Phase 19c's halo FIR (64 x 1,146,880 samples, 13 taps, offset 6)
    cut over the mesh's ranks across the processes, exchange 'dma' (and
    'ppermute' over NCCL): each process's output shards bit-equal to its
    slices of `fir_same_iq` of the whole block; the ring's launches; ms a
    call of the halo FIR and of the ring alone from CUDA events and from
    the host clock."""
    import torch
    from dl_ofdm_tpu_torch.channel.fir import fir_same_iq
    from dl_ofdm_tpu_torch.parallel import distributed as pd
    from dl_ofdm_tpu_torch.parallel import halo
    gen = torch.Generator(device=dev).manual_seed(191)
    x = torch.randn(HALO_B, HALO_FRAMES * FIR_LEN, 2, device=dev,
                    generator=gen)
    h = torch.randn(HALO_B, HALO_TAPS, 2, device=dev, generator=gen)
    p = mesh.devices.size
    whole = torch.chunk(fir_same_iq(x, h, np.full(HALO_B, 6)), p, dim=1)
    shards = list(torch.chunk(x, p, dim=1))
    local = [shards[r].to(d) for r, d in zip(
        mesh.local_ranks, [mesh.rank_devices[r] for r in mesh.local_ranks])]
    h = h.to(local[0].device)
    out = {"equal": {}}
    torch.cuda.synchronize(dev)
    halo.ring_exchange_across.launches = 0
    exchanges = ("dma", "ppermute") if backend == "nccl" else ("dma",)
    for ex in exchanges:
        y = halo.halo_fir_same_iq(local, h, 6, mesh, exchange=ex)
        out["equal"][ex] = all(torch.equal(a, whole[r].to(a.device))
                               for a, r in zip(y, mesh.local_ranks))
    torch.cuda.synchronize(dev)
    out["launches"] = halo.ring_exchange_across.launches
    lt = [s[:, -6:, :] for s in local]
    rh = [s[:, :6, :] for s in local]
    fns = {"halo_fir": lambda: halo.halo_fir_same_iq(local, h, 6, mesh,
                                                     exchange="dma"),
           "ring": lambda: halo.ring_exchange_across(lt, rh, mesh)}
    for name, fn in fns.items():
        pd.barrier(dev)
        out[f"{name}_ms"] = events_ms(fn, PROC_HALO_CALLS)
        pd.barrier(dev)
        t = time.perf_counter()
        for _ in range(PROC_HALO_CALLS):
            fn()
        torch.cuda.synchronize(dev)
        out[f"{name}_host_ms"] = (time.perf_counter() - t) * 1e3 \
            / PROC_HALO_CALLS
    # what the ring moved, read once and written once
    out["bytes"] = 2 * 2 * p * HALO_B * 6 * 2 * 4
    return out


def proc_worker(rank: int, world: int, port: int, work: str, backend: str,
                per_proc: int, tp: int, parts: tuple) -> None:
    """One process of phase 26: joins the group, builds its view of the
    mesh, runs `parts` and saves what it saw to `work/rank<r>.pt`; an
    error is written to `work/error<r>.txt` before it propagates."""
    import datetime
    import traceback
    import torch
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from dl_ofdm_tpu_torch.parallel import distributed as pd
        from dl_ofdm_tpu_torch.parallel import halo
        from dl_ofdm_tpu_torch.parallel.mesh import make_mesh
        devs = proc_devices(rank, per_proc)
        try:
            info = pd.initialize_multihost(
                f"127.0.0.1:{port}", world, rank, backend=backend,
                device=devs[0],
                timeout=datetime.timedelta(seconds=PROC_TIMEOUT_S))
        except RuntimeError as e:
            if "refusal" not in parts:
                raise
            torch.save({"refused": str(e)}, os.path.join(work,
                                                         f"rank{rank}.pt"))
            return
        if "refusal" in parts:
            raise AssertionError(f"{backend} with two ranks on {devs[0]} "
                                 "was not refused")
        mesh = make_mesh(devs, tp=tp)
        out = {"backend": info.backend, "devices": [str(d) for d in devs],
               "local_rows": mesh.local_rows}
        if "train" in parts:
            out["train"] = proc_train(mesh, devs[0])
        if "sweep" in parts:
            out["sweep"] = proc_sweep(mesh, devs[0])
        if "halo" in parts:
            out["halo"] = proc_halo(mesh, devs[0], info.backend)
            halo.release_rings()
        if "tp" in parts:
            out["tp"] = proc_tp(mesh, devs[0])
        if "tp_bf16" in parts:
            out["tp_bf16"] = proc_tp_bf16(mesh, devs[0], work)
        pd.barrier(devs[0])
        pd.shutdown()
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(work, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_procs(world: int, backend: str, per_proc: int = 1, tp: int = 1,
              parts: tuple = ("train",), work: str | None = None) -> list:
    """`world` processes of `proc_worker` (torch.multiprocessing, spawn,
    join=True), in the directory `work` (a temporary one where None);
    every worker's result.  A failed worker fails the phase after every
    worker's error has been printed."""
    import contextlib
    import socket
    import torch
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with (tempfile.TemporaryDirectory() if work is None
          else contextlib.nullcontext(work)) as work:
        try:
            mp.spawn(proc_worker, args=(world, port, work, backend, per_proc,
                                        tp, parts),
                     nprocs=world, join=True)
        except Exception as e:
            for r in range(world):
                path = os.path.join(work, f"error{r}.txt")
                if os.path.exists(path):
                    log(f"phase 26 worker {r} failed:\n{open(path).read()}")
                else:
                    log(f"phase 26 worker {r}: no error of its own "
                        "(stopped with the others)")
            raise AssertionError(f"phase 26: a worker of {world} failed "
                                 f"({backend}, parts {parts})") from e
        return [torch.load(os.path.join(work, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def compare_params(got: dict, want: dict) -> dict:
    """Each leaf's worst |difference| (0 where bit-identical)."""
    return {k: float((got[k] - want[k]).abs().max()) for k in want}


def phase_processes(dev) -> dict:
    """Phase 26: multi-process data parallelism.  One card: two
    processes on it with gloo named explicitly (NCCL refuses two ranks on
    one card, shown first); two or more cards: NCCL, one process a card.
    a. the dp-2 train step at 9,362 frames for 10 steps against the
    one-process dp-2 mesh from the same seeds (bit-identical or each
    leaf's worst difference, each step's loss within 1e-4, ms a step,
    each process's launches); b. the 16QAM arm's interleaved sweep
    against the one-process mesh's counts (equal) and JAX's curve; c. the
    halo FIR across the processes with the ring's IPC route, bit-equal to
    `fir_same_iq`; d. with four cards, NCCL at 4 processes dp 4 and 2
    processes x 2 cards at dp 2 x tp 2, each against its one-process
    mesh.  Returns the kernels-line fields."""
    import torch
    from dl_ofdm_tpu_torch.parallel.mesh import make_mesh
    n = torch.cuda.device_count()
    if n >= PROC_N:
        backend, why = "nccl", "one process a card"
    else:
        backend = "gloo"
        why = ("two processes share one card, which NCCL refuses; gloo "
               "takes card tensors in all_reduce and broadcast, and the "
               "halo's ring runs through CUDA IPC")
        refused = run_procs(PROC_N, "nccl", parts=("refusal",))
        if not all("same card" in r.get("refused", "") for r in refused):
            raise AssertionError(f"two NCCL ranks on one card: {refused}")
        log(f"phase 26: NCCL with two ranks on one card refused in both "
            f"processes: {refused[0]['refused']!r}")
    log(f"phase 26: {PROC_N} processes, backend {backend} ({why})")
    procs = run_procs(PROC_N, backend, parts=("train", "sweep", "halo"))
    # the one-process dp-2 mesh: virtual ranks of the card, or one rank a
    # card where there are two
    single_devs = [torch.device("cuda", r if n >= PROC_N else 0)
                   for r in range(PROC_N)]
    one = proc_train(make_mesh(single_devs, dp=PROC_N), dev)
    diffs = [compare_params(p["train"]["params"], one["params"])
             for p in procs]
    identical = all(v == 0 for d in diffs for v in d.values())
    loss_err = max(abs(a - b) / abs(b) for p in procs
                   for a, b in zip(p["train"]["losses"], one["losses"]))
    for d in diffs:
        if not all(np.isfinite(v) for v in d.values()):
            raise AssertionError(f"phase 26a: non-finite parameters {d}")
    if loss_err > 1e-4:
        raise AssertionError(f"phase 26a: a step's loss {loss_err:.3g} "
                             "from the one-process mesh's")
    want = {"synth_chain": 2 * PROC_STEPS, "fir_shift_accum": 0,
            "complex_dense": PROC_STEPS}
    for r, p in enumerate(procs):
        got = {k: p["train"][k] for k in want}
        if got != want:
            raise AssertionError(f"phase 26a process {r}: launches {got}, "
                                 f"want {want} (a local row's chain and "
                                 f"complex_dense a step)")
    ms = [p["train"]["ms_per_step"] for p in procs]
    log(f"26a dp-2 step at 9,362 frames over {PROC_N} processes "
        f"({backend}): {max(ms):.3f} ms/step (processes {ms}) against "
        f"{one['ms_per_step']:.3f} in one process; parameters after "
        f"{PROC_STEPS} steps bit-identical: {identical}; worst leaf "
        f"differences {max(diffs[0].values()):.3g}; losses within "
        f"{loss_err:.3g}; launches a process {want}")
    print(json.dumps({"phase": 26, "part": "dp train step",
                      "backend": backend, "processes": PROC_N,
                      "frames": one["frames"], "steps": PROC_STEPS,
                      "ms_per_step": ms,
                      "one_process_ms_per_step": one["ms_per_step"],
                      "bit_identical": identical,
                      "leaf_max_abs_diff": diffs,
                      "loss_rel_err": loss_err,
                      "launches": [{k: p["train"][k] for k in want}
                                   for p in procs]}), flush=True)
    # b. the sweep
    sweep_one = proc_sweep(make_mesh(single_devs, dp=PROC_N), dev)
    calls = 20000 // (48 * PROC_N)
    for r, p in enumerate(procs):
        s = p["sweep"]
        if not np.array_equal(s["ber"], sweep_one["ber"]):
            raise AssertionError(f"26b process {r}: counts differ from the "
                                 "one-process mesh's")
        if s["complex_dense"] != calls:
            raise AssertionError(f"26b process {r}: complex_dense "
                                 f"{s['complex_dense']} launches, want "
                                 f"{calls}")
    check_curve("2-process interleaved", procs[0]["sweep"]["ber"],
                JAX_INTERLEAVED_BER, "JAX")
    ce_equal = all(np.array_equal(p["sweep"]["loss"], sweep_one["loss"])
                   for p in procs)
    log(f"26b interleaved sweep over {PROC_N} processes: counts equal to "
        f"the one-process mesh's; CE equal {ce_equal}; "
        f"{procs[0]['sweep']['seconds']:.3f} s against "
        f"{sweep_one['seconds']:.3f} s; complex_dense {calls} launches a "
        "process")
    print(json.dumps({"phase": 26, "part": "interleaved sweep",
                      "processes": PROC_N, "calls": calls,
                      "seconds": [p["sweep"]["seconds"] for p in procs],
                      "one_process_seconds": sweep_one["seconds"],
                      "counts_equal": True, "ce_equal": ce_equal,
                      "ratio_to_jax": ratios(procs[0]["sweep"]["ber"],
                                             JAX_INTERLEAVED_BER)}),
          flush=True)
    # c. the halo FIR
    halos = [p["halo"] for p in procs]
    for r, hh in enumerate(halos):
        if not all(hh["equal"].values()):
            raise AssertionError(f"26c process {r}: halo FIR differs from "
                                 f"fir_same_iq: {hh['equal']}")
        if hh["launches"] != 1:                 # the 'dma' exchange
            raise AssertionError(f"26c process {r}: ring launched "
                                 f"{hh['launches']} times")
    ring = {"launches_across_processes": sum(hh["launches"] for hh in halos),
            "across_processes_ms": max(hh["ring_ms"] for hh in halos),
            "across_processes_host_ms": max(hh["ring_host_ms"]
                                            for hh in halos),
            "across_processes_halo_fir_ms": max(hh["halo_fir_ms"]
                                                for hh in halos),
            "across_processes_bound_ms": halos[0]["bytes"] / card_peaks(
                torch.cuda.get_device_name(0))[1][0] * 1e3,
            "across_processes_backend": backend}
    log(f"26c halo FIR across {PROC_N} processes, exchanges "
        f"{list(halos[0]['equal'])}: bit-equal to fir_same_iq; the ring "
        f"(IPC, handshake) {ring['across_processes_ms']:.4f} ms a call "
        f"(events; host clock {ring['across_processes_host_ms']:.4f}), the "
        f"halo FIR {ring['across_processes_halo_fir_ms']:.3f} ms; "
        f"{ring['launches_across_processes']} ring launches")
    print(json.dumps({"phase": 26, "part": "halo across processes",
                      "processes": PROC_N, "backend": backend,
                      "per_process": halos}), flush=True)
    # d. four cards
    if n >= 4:
        for world, per, tp in ((4, 1, 1), (2, 2, 2)):
            runs = run_procs(world, "nccl", per_proc=per, tp=tp)
            ref = proc_train(make_mesh([torch.device("cuda", i)
                                        for i in range(4)], tp=tp), dev)
            d = [compare_params(p["train"]["params"], ref["params"])
                 for p in runs]
            same = all(v == 0 for x in d for v in x.values())
            ms4 = [p["train"]["ms_per_step"] for p in runs]
            log(f"26d NCCL {world} processes x {per} card(s), dp "
                f"{4 // tp} x tp {tp}: {max(ms4):.3f} ms/step against "
                f"{ref['ms_per_step']:.3f} in one process; bit-identical "
                f"{same}, worst {max(max(x.values()) for x in d):.3g}")
            print(json.dumps({"phase": 26, "part": "four cards",
                              "processes": world, "cards_a_process": per,
                              "tp": tp, "ms_per_step": ms4,
                              "one_process_ms_per_step": ref["ms_per_step"],
                              "bit_identical": same}), flush=True)
    else:
        log(f"26d not run: {n} card(s)")
    return {"ring": ring,
            "fir_shift_accum": sum(p["train"]["fir_shift_accum"]
                                   for p in procs),
            "synth_chain": sum(p["train"]["synth_chain"] for p in procs),
            "complex_dense": sum(p["train"]["complex_dense"]
                                 + p["sweep"]["complex_dense"]
                                 for p in procs)}


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
    def same(u, v):       # a tensor, or a tp mesh's list of shards
        if isinstance(u, list):
            return len(u) == len(v) and all(map(torch.equal, u, v))
        return torch.equal(u, v)

    for part, x, y in (("params", a.params, b.params),
                       ("mu", a.opt_state["mu"], b.opt_state["mu"]),
                       ("nu", a.opt_state["nu"], b.opt_state["nu"])):
        bad += [f"{part}:{k}" for k in x if not same(x[k], y[k])]
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


# -- 23: the classical-receiver baselines ------------------------------------
# the MATLAB protocol (`runs/run_experiments.py:89-102`): nfft 64, 7
# symbols, CP 16, lte pilots, SNR -10:5:30, 20,000 frames a point in
# 2,000-frame batches, seed 0; each curve held to its committed CSV
BASE_SNRS = list(range(-10, 31, 5))
BASE_FRAMES = 20000
BASE_BATCH = 2000
BASE_IDS = tuple(range(1, 11))
BASE_BAND = (0.8, 1.25)            # phase 14's band, where the CSV's
BASE_MIN_BER = 1e-3                # BER is at least this
BASE_FIR = (BASE_BATCH, FIR_LEN, 11)   # EVA's FIR: rows, outputs, taps


class Tee:
    """A stdout that also keeps what is written."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def baseline_curve(tpk, args: list, rows, ref_csv: str, label: str,
                   want_launches: int, tag: str = "") -> dict:
    """`cli.main(["baseline", *args])` on the card, in a temporary
    directory: each row of `rows` of the CSV it writes (`ref_csv`'s name
    with `tag` before `.csv`) held to the same
    row of `runs/<ref_csv>` (ratio within `BASE_BAND` where that BER is
    at least `BASE_MIN_BER`, printed below it), `fir_shift_accum`
    launched `want_launches` times; seconds and frames/s of the curve.
    The caller's float32 setting is TF32 on, so that the run shows its
    own: it must log 'highest' without TF32 and hand TF32 back."""
    import contextlib
    import torch
    from dl_ofdm_tpu_torch import cli
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    tee = Tee(sys.stdout)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        tpk.fir_shift_accum_kernel.launches = 0
        t = time.time()
        with contextlib.redirect_stdout(tee):
            cli.main(["baseline", "--frames", str(BASE_FRAMES),
                      "--save_dir", tmp] + args)
        torch.cuda.synchronize()
        seconds = time.time() - t
        launches = tpk.fir_shift_accum_kernel.launches
        written = sorted(os.listdir(tmp))
        name = ref_csv[:-4] + tag + ".csv"
        table = np.loadtxt(os.path.join(tmp, name), delimiter=",")
    settings = (torch.backends.cuda.matmul.allow_tf32,
                torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    inside = [line for line in "".join(tee.text).splitlines()
              if "matmul precision" in line]
    if settings != (True, "high") or not inside \
            or "precision highest, allow_tf32 False" not in inside[0]:
        raise AssertionError(f"{label}: float32 setting inside the run "
                             f"{inside[:1]}, after it {settings}")
    stem = name[:-4]
    if written != sorted([name, stem + ".mat", "SER" + stem[3:] + ".csv"]):
        raise AssertionError(f"{label}: the CLI wrote {written}")
    ref = np.loadtxt(os.path.join(ROOT, "runs", ref_csv), delimiter=",")
    if table.shape != (5, len(BASE_SNRS)) \
            or not np.array_equal(table[0], BASE_SNRS) \
            or not np.all(np.isfinite(table)):
        raise AssertionError(f"{label}: CSV malformed, {table.shape}")
    bad, out_rows = [], {}
    for r in rows:
        ber, want = table[r], ref[r]
        rat = [float(b / w) if w > 0 else None for b, w in zip(ber, want)]
        for snr, b, w, q in zip(BASE_SNRS, ber, want, rat):
            held = w >= BASE_MIN_BER
            ok = not held or BASE_BAND[0] <= q <= BASE_BAND[1]
            log(f"  {label} row {r} SNR {snr:+3d} dB: BER {b:.6g}  CSV "
                f"{w:.6g}  " + (f"ratio {q:.4f}" if held else "(not held)")
                + ("" if ok else "  FAIL"))
            if not ok:
                bad.append((r, snr))
        out_rows[r] = {"ber": ber.tolist(), "csv": want.tolist(),
                       "ratio": rat}
    frames = BASE_FRAMES * len(BASE_SNRS) * len(rows)
    line = {"phase": 23, "curve": label, "args": args, "csv": ref_csv,
            "rows": out_rows, "seconds": seconds,
            "frames_per_s": frames / seconds,
            "fir_shift_accum_launches": launches,
            "setting_inside_run": inside[0].split(": ", 1)[-1],
            "tf32_and_precision_after_run": list(settings)}
    print(json.dumps(line), flush=True)
    log(f"{label}: {frames} frames in {seconds:.2f} s = "
        f"{frames / seconds:.0f} frames/s; fir_shift_accum launches "
        f"{launches}")
    if bad:
        raise AssertionError(f"{label} misses {ref_csv} at (row, SNR) {bad}")
    if launches != want_launches:
        raise AssertionError(f"{label}: fir_shift_accum launched {launches} "
                             f"times, expected {want_launches}")
    return line


def phase_baseline_fir(tpk, dev, hbm_bps, f32_flops) -> dict:
    """Phase 23d: `fir_shift_accum` at the baseline's shape (2,000 rows of
    570 samples, EVA's 11 taps) against its plain version, bit-equal as
    phase 13 holds it, and `fir_same_iq` on the card (one launch) against
    the plain loop; device times from CUDA graphs of the kernel, its plain
    version and one grouped `F.conv1d`, here and at phase 13's 30,000 x
    560 x 13, with each shape's bound."""
    import torch
    from dl_ofdm_tpu_torch.channel import fir
    gen = torch.Generator(device=dev).manual_seed(23)
    out = {}
    for label, channel, (b, l_out, f) in (
            ("baseline", "EVA", BASE_FIR),
            ("phase 13", "ETU", (30000, FIR_LEN, 13))):
        x, h, offsets, xa, hp = fir_planes(channel, b, gen)
        if hp[0].shape != (b, f) or xa[0].shape != (b, l_out + f - 1):
            raise AssertionError(f"{channel} planes {tuple(xa[0].shape)}")
        y = fir.fir_same_iq(x, h, offsets)
        yr, yi = tpk.fir_shift_accum_kernel(*xa, *hp, l_out)
        wr, wi = tpk.fir_shift_accum_ref(*xa, *hp, l_out)
        torch.cuda.synchronize()
        err = max(float((yr - wr).abs().max()), float((yi - wi).abs().max()))
        err_same = float((y - torch.stack([wr, wi], -1)).abs().max())
        if err or err_same:
            raise AssertionError(
                f"fir_shift_accum at {b} x {l_out}, {f} taps: kernel "
                f"{err:.3g}, fir_same_iq {err_same:.3g} from the plain "
                "version; want bit-equal")
        lib = conv1d_fir(xa, hp)
        runs = {"kernel": lambda: tpk.fir_shift_accum_kernel(*xa, *hp,
                                                             l_out),
                "plain": lambda: tpk.fir_shift_accum_ref(*xa, *hp, l_out),
                "library": lib}
        ms = {n: [] for n in runs}
        for n in ("plain", "kernel", "library", "library", "kernel",
                  "plain"):
            ms[n].append(time_ms(runs[n], 20 if n == "plain" else 100)[0])
        ms = {n: sum(v) / len(v) for n, v in ms.items()}
        n_bytes = 4 * (2 * b * (l_out + f - 1) + 2 * b * f + 2 * b * l_out)
        flops = 8 * b * l_out * f
        bound, by = bound_of(n_bytes, flops, hbm_bps, f32_flops)
        line = {"phase": 23, "kernel": "fir_shift_accum", "shape": label,
                "rows": b, "outputs": l_out, "taps": f, "max_abs_err": err,
                "fir_same_iq_err": err_same, "kernel_ms": ms["kernel"],
                "plain_ms": ms["plain"], "conv1d_ms": ms["library"],
                "timing": "CUDA graph", "bytes": n_bytes, "flops": flops,
                "bound_ms": bound, "bound_by": by}
        print(json.dumps(line), flush=True)
        log(f"fir_shift_accum {label} {b} x {l_out}, {f} taps: == plain "
            f"version; kernel {ms['kernel']:.4f} ms (graph), plain "
            f"{ms['plain']:.4f}, grouped conv1d {ms['library']:.4f}, bound "
            f"{bound:.4f} ms ({by})")
        out[label] = line
    return out


def phase_baselines(tpk, dev, smi: str) -> dict:
    """Phase 23a-c: the classical benchmark at the MATLAB protocol
    through `cli.main(["baseline", ...])`: EVA static BPSK for every
    estimator (one `fir_shift_accum` launch a batch: 90 a curve, 99 for
    id 10, whose long-term ensemble fades one more batch a point), AWGN
    with all four modulations (no FIR), EVA mobile with estimator 10 with
    both fading modes (the plain per-symbol FIR)."""
    from dl_ofdm_tpu_torch.baselines.estimators import ESTIMATOR_NAMES
    lines = []
    batches = len(BASE_SNRS) * BASE_FRAMES // BASE_BATCH
    for eq in BASE_IDS:
        csv = f"BER_OFDM_EVA_{ESTIMATOR_NAMES[eq]}_lte_64_Gray.csv"
        lines.append(baseline_curve(
            tpk, ["--channel", "EVA", "--opt", str(eq)], (1,), csv,
            f"EVA {ESTIMATOR_NAMES[eq]}",
            batches + (len(BASE_SNRS) if eq == 10 else 0)))
    lines.append(baseline_curve(
        tpk, ["--channel", "AWGN", "--opt", "1"], (1, 2, 3, 4),
        "BER_OFDM_AWGN_Perfect_lte_64_Gray.csv", "AWGN Perfect", 0))
    for per_sample in (False, True):
        lines.append(baseline_curve(
            tpk, ["--channel", "EVA", "--opt", "10", "--mobile", "True",
                  "--per_sample", str(per_sample)], (1,),
            "BER_OFDM_EVA_LMMSE-Fast_lte_64_Gray_mobile.csv",
            "EVA mobile LMMSE-Fast" + (" per-sample" if per_sample else ""),
            0, "_persample" if per_sample else ""))
    total = sum(ln["seconds"] for ln in lines)
    print(smi, flush=True)
    for ln in lines:
        log(f"  {ln['curve']:32s} {ln['seconds']:7.2f} s "
            f"{ln['frames_per_s']:10.0f} frames/s")
    log(f"classical benchmark: {len(lines)} curves in {total:.1f} s ({smi})")
    return {"launches": sum(ln["fir_shift_accum_launches"] for ln in lines),
            "seconds": total}


def phase_profile_baseline(dev, batches: int = 3) -> None:
    """Phase 23, profiled (with the profiled phases at the end): one
    2,000-frame LS-Quadeer batch on EVA at 10 dB (`classical_rx.one_batch`)
    `batches` times under `torch.profiler` after a warm-up: wall and busy
    ms a batch, its idle share, kernels a batch, the host's waits on the
    card, the five kernels with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dl_ofdm_tpu_torch.baselines import classical_rx as crx
    from dl_ofdm_tpu_torch.baselines.matlab_link import MatlabLink
    from dl_ofdm_tpu_torch.config import OFDMConfig
    from dl_ofdm_tpu_torch.ofdm.plan import build_plan
    plan = build_plan(OFDMConfig())
    link = MatlabLink(plan, 2, "EVA", device=dev)
    ctx = crx.get_context(plan, "EVA", dev)
    gen = torch.Generator(device=dev).manual_seed(5)

    def batch():
        return crx.one_batch(link, ctx, 5, None, 10.0, 1.0, BASE_BATCH, gen)

    with crx.full_float32():
        batch()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(batches):
            batch()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3 / batches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(batches):
                batch()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3 / batches
    events = prof.events()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiler saw no kernel on the card")
    busy = busy_us(kernels) / 1e3 / batches
    host = {n: sum(e.name == n for e in events) / batches
            for n in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                      "cudaMemcpyAsync")}
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    line = {"phase": 23, "part": "profiled LS-Quadeer batch",
            "frames": BASE_BATCH, "ms_per_batch": ms,
            "profiled_wall_ms_per_batch": wall_ms, "busy_ms_per_batch": busy,
            "idle_share": 1 - busy / ms,
            "kernels_per_batch": len(kernels) / batches,
            "host_calls_per_batch": host,
            "top_kernels_us_per_batch": [[n[:80], us / batches]
                                         for n, us in top]}
    print(json.dumps(line), flush=True)
    log(f"LS-Quadeer batch ({BASE_BATCH} frames): {ms:.3f} ms, "
        f"{busy:.3f} busy, idle {1 - busy / ms:.3f}; "
        f"{len(kernels) / batches:.0f} kernels, host {host} a batch")
    for n, us in top:
        log(f"  {us / batches / 1e3:8.4f} ms  {n[:90]}")


# -- 24: the ablation and legacy paths ----------------------------------------
LEGACY_ROWS = 30000                 # frames of the legacy channels (x 7 x 80)
# (function, profile, sample rate): 6 taps at 0.96 MHz, 51 at 10 MHz
LEGACY_FIRS = (("rayleigh_channel_legacy", "ETU", 0.96e6),
               ("rayleigh_channel_batch_coherent", "ETU", 1e7))
# the DNN ablation (`runs/run_experiments15.py:212-231`), cut to 20 epochs:
# its epochs 15-19 mean val_ber against the JAX trace's
# (`runs/p15_dnn_trace.json`, 0.006537), in distribution (the PRNG streams
# differ): within DNN_BAND of it
DNN_EPOCHS = 20
DNN_TRACE = os.path.join(ROOT, "runs", "p15_dnn_trace.json")
DNN_BAND = (0.5, 2.0)


def same_as_cpu(name, fn, args, tol, **kw):
    """`fn` on the card against `fn` on the CPU on the same inputs (moved
    there): every output within `tol` of the largest CPU value (absolute
    below 1).  Returns the largest difference."""
    import torch

    def on(dev, a):
        return a.to(dev) if isinstance(a, torch.Tensor) else a

    def leaves(out):
        out = out if isinstance(out, tuple) else (out,)
        return [o for o in out if isinstance(o, torch.Tensor)]

    got = leaves(fn(*args, **kw))
    want = leaves(fn(*[on("cpu", a) for a in args],
                     **{k: on("cpu", v) for k, v in kw.items()}))
    worst = 0.0
    for g, w in zip(got, want):
        g = torch.view_as_real(g) if g.is_complex() else g
        w = torch.view_as_real(w) if w.is_complex() else w
        diff = float((g.cpu().double() - w.double()).abs().max())
        scale = max(1.0, float(w.abs().max()))
        if not diff <= tol * scale:
            raise AssertionError(f"{name}: card differs from CPU by "
                                 f"{diff:.3g} > {tol} x {scale:.3g}")
        worst = max(worst, diff)
    return worst


def phase_legacy_cpu_parity(dev) -> dict:
    """Phase 24a, first part: every Part-A function of the ablation and
    legacy paths on the card against itself on the CPU, on the same
    inputs and injected draws: float32 paths within 1e-5 (1e-4 for the
    FFT variants) of the largest value."""
    import torch
    from dl_ofdm_tpu_torch.channel import awgn, fir, legacy
    from dl_ofdm_tpu_torch.config import OFDMConfig
    from dl_ofdm_tpu_torch.models import dccn, e2e_blocks
    from dl_ofdm_tpu_torch.ofdm import legacy_tx, papr
    from dl_ofdm_tpu_torch.ofdm.plan import build_plan
    g = torch.Generator(device=dev).manual_seed(24)

    def rn(*shape):
        return torch.randn(*shape, device=dev, generator=g)

    def cplx(*shape):
        return torch.complex(rn(*shape), rn(*shape))

    errs = {}
    x = rn(64, 7, 80, 2)
    snr = torch.rand(64, device=dev, generator=g) * 20
    errs["clip_papr"] = same_as_cpu("clip_papr", papr.clip_papr,
                                    (cplx(8, 560),), 1e-5)
    errs["clip_papr_iq"] = same_as_cpu("clip_papr_iq", papr.clip_papr_iq,
                                       (x,), 1e-5, peak=1.5)
    errs["awgn_channel_phase"] = same_as_cpu(
        "awgn_channel_phase", awgn.awgn_channel_phase, (x, snr), 1e-5,
        unit_amp=rn(64, 7, 80, 1),
        phase=torch.rand(64, 7, 80, 1, device=dev, generator=g) * 6.283)
    for norm in (True, False):
        errs[f"awgn_channel_norm_{norm}"] = same_as_cpu(
            "awgn_channel_norm", awgn.awgn_channel_norm, (x, snr), 1e-5,
            norm=norm, unit_noise=rn(64, 7, 80, 2))
    errs["awgn_channel_complex"] = same_as_cpu(
        "awgn_channel_complex", awgn.awgn_channel_complex,
        (cplx(64, 7, 80), snr), 1e-5, unit_noise=cplx(64, 7, 80))
    errs["fir_same_batched"] = same_as_cpu(
        "fir_same_batched", fir.fir_same_batched, (cplx(64, 560),
                                                   cplx(64, 13), 6), 1e-4)
    errs["fir_same_varlen"] = same_as_cpu(
        "fir_same_varlen", fir.fir_same_varlen,
        (cplx(64, 560), cplx(64, 13),
         torch.randint(0, 7, (64,), device=dev, generator=g)), 1e-4)
    errs["fir_per_symbol"] = same_as_cpu(
        "fir_per_symbol", fir.fir_per_symbol,
        (cplx(64, 7, 80), cplx(64, 7, 11), 20,
         torch.randint(0, 6, (64,), device=dev, generator=g)), 1e-4)
    for chan, rate in (("ETU", 0.96e6), ("EVA", 1e7)):
        n_fir = len(legacy.legacy_tap_coeff(chan, rate, 560))
        errs[f"rayleigh_channel_legacy_{chan}"] = same_as_cpu(
            "rayleigh_channel_legacy", legacy.rayleigh_channel_legacy,
            (x, 64, chan, rate), 1e-5, unit_taps=rn(64, n_fir, 2))
        errs[f"batch_coherent_{chan}"] = same_as_cpu(
            "rayleigh_channel_batch_coherent",
            legacy.rayleigh_channel_batch_coherent, (x, snr, chan, rate),
            1e-5, unit_taps=rn(n_fir, 2), unit_noise=rn(64, 560, 2))
    plan = build_plan(OFDMConfig(nbits=2))
    bits = torch.randint(0, 2, (14, len(plan.data_carriers), 2), device=dev,
                         generator=g, dtype=torch.int32)
    errs["ofdm_modulate_symbol_pilots"] = same_as_cpu(
        "ofdm_modulate_symbol_pilots", legacy_tx.ofdm_modulate_symbol_pilots,
        (bits, plan), 1e-5)
    lplan = legacy_tx.legacy_tx_plan(64, 8, 8)
    bits = torch.randint(0, 2, (16, 4, len(lplan.data_carriers), 2),
                         device=dev, generator=g, dtype=torch.int32)
    errs["ofdm_transmitter_iq"] = same_as_cpu(
        "ofdm_transmitter_iq", legacy_tx.ofdm_transmitter_iq,
        (bits, 64, 8, 8), 1e-5)
    plan = build_plan(OFDMConfig(nbits=1))
    models = {
        "DNNReceiver": (dccn.DNNReceiver(1, 64, plan.cp_len, 64,
                                         plan.frame_size), x),
        "DenseBlockTx": (e2e_blocks.DenseBlockTx(2, 3, 48, 2),
                         torch.randint(0, 2, (64, 7, 48, 2), device=dev,
                                       generator=g)),
        "ConvBlockTx": (e2e_blocks.ConvBlockTx(2, 48, 7),
                        torch.randint(0, 2, (64, 7, 48, 2), device=dev,
                                      generator=g)),
        "ConvBlockRx": (e2e_blocks.ConvBlockRx(2, 48, 7), rn(64, 7, 48, 2)),
        "DenseBlockRx": (e2e_blocks.DenseBlockRx(320, 2, 48, 4),
                         rn(64, 7, 48, 4))}
    for name, (m, inp) in models.items():
        m.reset_parameters(torch.Generator().manual_seed(1))
        card = copy.deepcopy(m).to(dev)
        with torch.no_grad():
            got, want = card(inp), m(inp.cpu())
        got = got[0] if isinstance(got, tuple) else got
        want = want[0] if isinstance(want, tuple) else want
        diff = float((got.cpu() - want).abs().max())
        if not diff <= 1e-5 * max(1.0, float(want.abs().max())):
            raise AssertionError(f"{name} on the card differs from the CPU "
                                 f"by {diff:.3g}")
        errs[name] = diff
    log(f"ablation and legacy paths: {len(errs)} card runs == CPU runs "
        f"(largest difference {max(errs.values()):.3g})")
    print(json.dumps({"phase": 24, "part": "card vs CPU", "max_abs_diff":
                      errs}), flush=True)
    return errs


def phase_legacy_fir(tpk, dev, hbm_bps, f32_flops) -> dict:
    """Phase 24a, second part: both legacy channels at 30,000 x 7 x 80
    samples (ETU: 6 taps at 0.96 MHz, 51 at 10 MHz): one `fir_shift_accum`
    launch a call, the FIR output bit-equal to the plain version on the
    same pre-aligned planes; the whole call and the kernel alone timed
    from CUDA graphs beside the plain version, one grouped `F.conv1d` and
    the kernel's bound.  Returns the launches and each shape's numbers."""
    import torch
    import torch.nn.functional as F
    from dl_ofdm_tpu_torch.channel import fir, legacy
    gen = torch.Generator(device=dev).manual_seed(241)
    b, l_out = LEGACY_ROWS, FIR_LEN
    x = torch.randn(b, 7, 80, 2, device=dev, generator=gen)
    snr = torch.full((b,), 10.0, device=dev)
    out = {"launches": 0, "shapes": {}}
    for fname, chan, rate in LEGACY_FIRS:
        coeff = torch.from_numpy(legacy.legacy_tap_coeff(chan, rate,
                                                         l_out)).to(dev)
        f = coeff.shape[0]
        if fname == "rayleigh_channel_legacy":
            taps = torch.randn(b, f, 2, device=dev, generator=gen)
            h = taps / 2 ** 0.5 * coeff[None, :, None]
            off = (f - 1) // 2

            def call():
                return legacy.rayleigh_channel_legacy(
                    x, 64, chan, rate, unit_taps=taps)[0]
        else:
            taps = torch.randn(f, 2, device=dev, generator=gen)
            zero = torch.zeros(b, l_out, 2, device=dev)
            h = torch.flip(taps / 2 ** 0.5 * coeff[:, None], (0,))[None] \
                .expand(b, f, 2)
            off = f - 1 - (f - 1) // 2

            def call():
                return legacy.rayleigh_channel_batch_coherent(
                    x, snr, chan, rate, unit_taps=taps, unit_noise=zero)[0]
        torch.cuda.synchronize()
        tpk.fir_shift_accum_kernel.launches = 0
        y = call().reshape(b, l_out, 2)
        torch.cuda.synchronize()
        n = tpk.fir_shift_accum_kernel.launches
        if n != 1:
            raise AssertionError(f"{fname}: {n} fir_shift_accum launches a "
                                 "call, want 1")
        out["launches"] += n
        flat = x.reshape(b, l_out, 2)
        xa = [fir._prealign_plane(F.pad(flat[..., i], (f - 1, f - 1)),
                                  np.full((b,), off), l_out + f - 1)
              .contiguous() for i in (0, 1)]
        hp = [h[..., i].contiguous() for i in (0, 1)]
        wr, wi = tpk.fir_shift_accum_ref(*xa, *hp, l_out)
        err = float((y - torch.stack([wr, wi], -1)).abs().max())
        if err:
            raise AssertionError(f"{fname}: the FIR output differs from the "
                                 f"plain version by {err:.3g}; want "
                                 "bit-equal")
        lib = conv1d_fir(xa, hp)
        runs = {"call": call,
                "kernel": lambda: tpk.fir_shift_accum_kernel(*xa, *hp,
                                                             l_out),
                "plain": lambda: tpk.fir_shift_accum_ref(*xa, *hp, l_out),
                "library": lib}
        ms = {n_: [] for n_ in runs}
        for n_ in ("plain", "kernel", "call", "library", "library", "call",
                   "kernel", "plain"):
            ms[n_].append(time_ms(runs[n_], 5 if n_ == "plain" else 50)[0])
        ms = {n_: sum(v) / len(v) for n_, v in ms.items()}
        n_bytes = 4 * (2 * b * (l_out + f - 1) + 2 * b * f + 2 * b * l_out)
        flops = 8 * b * l_out * f
        bound, by = bound_of(n_bytes, flops, hbm_bps, f32_flops)
        line = {"phase": 24, "kernel": "fir_shift_accum", "path": fname,
                "profile": chan, "rate_hz": rate, "rows": b,
                "outputs": l_out, "taps": f, "launches_a_call": n,
                "max_abs_err": err, "kernel_ms": ms["kernel"],
                "call_ms": ms["call"], "plain_ms": ms["plain"],
                "conv1d_ms": ms["library"], "timing": "CUDA graph",
                "bytes": n_bytes, "flops": flops, "bound_ms": bound,
                "bound_by": by}
        print(json.dumps(line), flush=True)
        log(f"{fname} ({chan}, {rate / 1e6:g} MHz, {f} taps) at {b} x "
            f"{l_out}: one launch, FIR == plain version; kernel "
            f"{ms['kernel']:.4f} ms, whole call {ms['call']:.4f} ms, plain "
            f"{ms['plain']:.4f}, grouped conv1d {ms['library']:.4f}, bound "
            f"{bound:.4f} ms ({by})")
        out["shapes"][f"{b}x{l_out}x{f}"] = line
    return out


def phase_dnn_ablation(tpk, tfs, dev) -> dict:
    """Phase 24b: the DNN ablation at full width (the recipe of
    `runs/run_experiments15.py:212-231`: `DNNReceiver`, nbits 1, AWGN,
    5 dB, batch_size 512, `fit` with batch growth), cut to `DNN_EPOCHS`
    epochs; the mean val_ber of epochs 15-19 within `DNN_BAND` of the JAX
    trace's; ms a step and the port's kernel launches a step."""
    import torch
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.models.dccn import DNNReceiver
    from dl_ofdm_tpu_torch.ofdm.plan import build_plan
    from dl_ofdm_tpu_torch.train.loop import Trainer
    cfg = OFDMConfig(nbits=1)
    plan = build_plan(cfg)
    tc = TrainConfig(snr=5.0, batch_size=512, max_epoch_num=DNN_EPOCHS,
                     early_stop=100, token="OFDM_DNN_1mod_snr5_cpTrue")
    tr = Trainer(cfg, tc, channel="AWGN", model=DNNReceiver(
        nbits=1, nfft=cfg.nfft, cp_len=plan.cp_len, nfilter=cfg.nfilter,
        frame_size=plan.frame_size))
    if tr._use_fused_model or not tr._use_fused_synth:
        raise AssertionError("the DNN trainer must take the autograd route "
                             "on the synth kernel's data plane")
    zero_counts(tpk, tfs)
    t = time.time()
    _, info = tr.fit(log_fn=lambda *a: None)
    torch.cuda.synchronize()
    wall = time.time() - t
    counts = path_counts(tpk, tfs)
    hist = info["history"]
    with open(DNN_TRACE) as fh:
        ref = json.load(fh)["history"]
    ours = float(np.mean([h["val_ber"] for h in hist[15:20]]))
    theirs = float(np.mean([h["val_ber"] for h in ref[15:20]]))
    ratio = ours / theirs
    gen = torch.Generator(device=dev).manual_seed(242)
    state = tr.init_state(gen)
    snr = torch.full((tr.batch_frames,), 5.0, device=dev)
    state, _ = tr.train_step(state, gen, snr)
    zero_counts(tpk, tfs)
    t = time.perf_counter()
    for _ in range(50):
        state, aux = tr.train_step(state, gen, snr)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3 / 50
    per_step = {k: v / 50 for k, v in path_counts(tpk, tfs).items()}
    line = {"phase": 24, "part": "DNN ablation", "epochs": len(hist),
            "cut": f"{DNN_EPOCHS} of 300 epochs", "fit_seconds": wall,
            "batch_frames_end": tr.batch_frames,
            "fit_launches": counts,
            "val_ber": [h["val_ber"] for h in hist],
            "val_ber_15_19": ours, "jax_val_ber_15_19": theirs,
            "ratio": ratio, "band": DNN_BAND, "ms_per_step": ms,
            "step_frames": tr.batch_frames,
            "kernel_launches_per_step": per_step}
    print(json.dumps(line), flush=True)
    log(f"DNN ablation: {len(hist)} epochs in {wall:.1f} s; val_ber of "
        f"epochs 15-19 {ours:.6f} against JAX's {theirs:.6f} (ratio "
        f"{ratio:.3f}, band {DNN_BAND}); {ms:.3f} ms a step at "
        f"{tr.batch_frames} frames, launches a step {per_step}")
    if not DNN_BAND[0] <= ratio <= DNN_BAND[1]:
        raise AssertionError(f"DNN ablation val_ber {ours:.6f} is "
                             f"{ratio:.3f}x JAX's, outside {DNN_BAND}")
    return line


# -- 25: tensor parallelism on the card ---------------------------------------
TP_DP, TP_TP = 2, 2
TP_FRAMES = (64, 256)               # frames a step timed (phase 25a)
TP_STEPS = 5                        # timed steps a size
TP_EQ_ARM = os.path.join(ROOT, "runs", "arms",
                         "OFDM_Dense3_2mod_snr10_cpTrue_Equalizer12_"
                         "mixRayleigh.npz")
TP_SWEEP_SNRS = (0, 5, 10)


def tp_mesh(dev, dp: int, tp: int):
    """A [dp, tp] mesh: one rank a card where the machine has dp * tp cards
    (four: the four-card call), else virtual ranks of card 0."""
    import torch
    from dl_ofdm_tpu_torch.parallel.mesh import make_mesh
    n = dp * tp
    devs = (list(range(n)) if torch.cuda.device_count() >= n and n > 1
            else [dev] * n)
    return make_mesh(devs, dp=dp, tp=tp)


def mesh_grads(tr, state, bits, rx):
    """The mesh step's gradients (split leaves gathered) on one batch
    sharded over the mesh's dp rows."""
    import torch
    from dl_ofdm_tpu_torch.parallel.mesh import shard_batch
    tb, tx = shard_batch(tr.mesh, (bits, rx))
    _, aux = tr._mesh_step(state, tb, tx, [{}] * len(tb),
                           torch.tensor(0.0, device=tr.device),
                           return_grads=True)
    return tr._gathered(aux["grads"])


def single_grads(tr, params, bits, rx, keys=None):
    """Single-device autograd gradients of `tr._loss_fn` over `keys`."""
    import torch
    keys = list(params) if keys is None else keys
    train = {k: params[k].detach().clone().requires_grad_() for k in keys}
    loss, _ = tr._loss_fn({**params, **train}, bits, rx)
    return dict(zip(train, torch.autograd.grad(loss, list(train.values()))))


def close_grads(name, got, want, rtol, atol) -> float:
    """Every leaf within rtol x |want| + atol; returns the largest
    difference relative to its leaf's largest value."""
    worst = 0.0
    for k, w in want.items():
        d = (got[k].to(w.device) - w).abs()
        if bool((d > rtol * w.abs() + atol).any()):
            raise AssertionError(
                f"{name}: {k} differs by up to {float(d.max()):.3g} "
                f"(rtol {rtol}, atol {atol}; max |g| "
                f"{float(w.abs().max()):.3g})")
        worst = max(worst, float(d.max() / w.abs().max().clamp_min(1e-30)))
    return worst


def step_ms(tr, frames: int, gen, steps: int = TP_STEPS) -> float:
    """ms a training step at `frames` frames (one warm-up step first)."""
    import torch
    tr.batch_frames = tr._round_to_dp(frames)
    state = tr.init_state(gen)
    snr = torch.full((tr.batch_frames,), 5.0, device=tr.device)
    state, aux = tr.train_step(state, gen, snr)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        state, aux = tr.train_step(state, gen, snr)
    torch.cuda.synchronize()
    if not torch.isfinite(aux["loss"]):
        raise AssertionError(f"step loss {float(aux['loss'])}")
    return (time.perf_counter() - t) * 1e3 / steps


def cdense_tp_times(tpk, x, wr, wi, mode, hbm_bps, peak_key):
    """`complex_dense` at one tp rank's shape: kernel (CUDA graph) beside
    the plain version and one library call (complex64 matmul in float32,
    one bf16 cuBLAS GEMM in bf16), and the bound; the kernel's output
    against the plain version at atol = rtol = 1e-5."""
    import torch
    m, k = x.shape[0], x.shape[1]
    f = wr.shape[1]
    with torch.no_grad():
        y = tpk.complex_dense_kernel(x, wr, wi, mode)
        torch.testing.assert_close(y, tpk.complex_dense_ref(x, wr, wi, mode),
                                   atol=1e-5, rtol=1e-5)
        if mode is None:
            xc, wc = torch.view_as_complex(x), torch.complex(wr, wi)
            lib = lambda: torch.matmul(xc, wc)          # noqa: E731
        else:
            lib, _ = bf16_library_gemm(x, wr, wi)
        runs = {"kernel": lambda: tpk.complex_dense_kernel(x, wr, wi, mode),
                "plain": lambda: tpk.complex_dense_ref(x, wr, wi, mode),
                "library": lib}
        ms = {n: [] for n in runs}
        for n in ("plain", "kernel", "library", "library", "kernel",
                  "plain"):
            ms[n].append(time_ms(runs[n], 50)[0])
    ms = {n: sum(v) / len(v) for n, v in ms.items()}
    n_bytes = 4 * (2 * m * k + 2 * m * f) + (2 if mode else 4) * 2 * k * f
    flops = 8 * m * k * f
    if mode is None:
        _, (_, f32) = card_peaks(peak_key)
        bound, by = bound_of(n_bytes, flops, hbm_bps, f32)
    else:
        bound = max(n_bytes / hbm_bps, flops / 989e12) * 1e3
        by = "bytes" if n_bytes / hbm_bps > flops / 989e12 else "operations"
    return {"shape": [m, k, f], "mode": mode or "float32",
            "kernel_ms": ms["kernel"], "plain_ms": ms["plain"],
            "library_ms": ms["library"], "bound_ms": bound, "bound_by": by}


def phase_tp_big(tpk, dev, hbm_bps, peak_key) -> dict:
    """Phase 25a: JAX's own tp configuration (`__graft_entry__.py:142-158`:
    nfft 1,024, nfilter 1,024, nbits 1, ETU, 5 dB, float32) on dp 2 x tp 2
    at 64 frames a step: `Dense_extract.weight` split on its in axis; the
    gradients on fixed data against the single-device ones (rtol 2e-4,
    atol 1e-6); three steps with a finite loss; `complex_dense` launches
    a step as the plan predicts (one a rank, forward only: the backward is
    plain matmuls); ms a step against the single-device step at 64 and
    256 frames."""
    import torch
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.train.loop import Trainer
    mesh = tp_mesh(dev, TP_DP, TP_TP)
    cfg = OFDMConfig(nbits=1, nfft=1024, nfilter=1024)
    tc = TrainConfig(snr=5.0, batch_size=7 * TP_FRAMES[0])
    tr = Trainer(cfg, tc, channel="ETU", mesh=mesh)
    single = Trainer(cfg, tc, channel="ETU", device=dev)
    gen = torch.Generator(device=dev).manual_seed(25)
    state = tr.init_state(gen)
    w = state.params["Dense_extract.weight"]
    shard = state.replicas[1]["Dense_extract.weight"]
    if tuple(shard.shape) != (w.shape[0], w.shape[1] // TP_TP):
        raise AssertionError(f"Dense_extract.weight shard {tuple(shard.shape)}"
                             f" of {tuple(w.shape)}: not split on its in axis")
    b = tr.batch_frames
    snr = torch.full((b,), 5.0, device=dev)
    bits, rx, _, _, _ = single.synthesize(b, snr, gen)
    g_tp = mesh_grads(tr, state, bits, rx)
    g_1d = single_grads(single, state.params, bits, rx)
    worst = close_grads("nfft-1024 tp gradients", g_tp, g_1d, 2e-4, 1e-6)
    torch.cuda.synchronize()
    k_ = tpk.complex_dense_kernel
    k_.launches = k_.launches_bf16 = 0
    for _ in range(3):
        state, aux = tr.train_step(state, gen, snr)
        if not torch.isfinite(aux["loss"]):
            raise AssertionError(f"tp step loss {float(aux['loss'])}")
    torch.cuda.synchronize()
    launches = k_.launches
    want = 3 * TP_DP * TP_TP
    if launches != want or k_.launches_bf16:
        raise AssertionError(f"complex_dense launched {launches} (bf16 "
                             f"{k_.launches_bf16}) times in 3 tp steps, "
                             f"want {want}")
    times = {}
    for frames in TP_FRAMES:
        for name, t_ in (("tp", tr), ("single", single), ("single", single),
                         ("tp", tr)):
            times.setdefault(f"{name}_{frames}", []).append(
                step_ms(t_, frames, gen))
    times = {k: sum(v) / len(v) for k, v in times.items()}
    x = rx[:b // TP_DP].reshape(-1, rx.shape[2], 2).contiguous()
    f_half = cfg.nfilter // TP_TP
    wr = state.replicas[0]["fft_like.wr"]
    shape = cdense_tp_times(tpk, x, wr, state.replicas[0]["fft_like.wi"],
                            None, hbm_bps, peak_key)
    if wr.shape[1] != f_half:
        raise AssertionError(f"fft_like shard {tuple(wr.shape)}")
    line = {"phase": 25, "part": "a", "config": "nfft 1024, nfilter 1024, "
            "nbits 1, ETU, float32", "dp": TP_DP, "tp": TP_TP,
            "ranks": [str(d) for d in mesh.rank_devices],
            "dense_extract": list(w.shape), "dense_extract_shard":
            list(shard.shape), "params_m": sum(v.numel() for v in
                                               state.params.values()) / 1e6,
            "grad_rel_err": worst, "tolerance": "rtol 2e-4, atol 1e-6",
            "complex_dense_launches_3_steps": launches,
            "ms_per_step": times, "complex_dense_tp_shape": shape}
    print(json.dumps(line), flush=True)
    log(f"nfft-1024 tp (dp {TP_DP} x tp {TP_TP}): Dense_extract "
        f"{tuple(w.shape)} split to {tuple(shard.shape)}; gradients within "
        f"rtol 2e-4 / atol 1e-6 of single-device (worst {worst:.3g} of a "
        f"leaf max); complex_dense {launches} launches in 3 steps; ms a "
        f"step {', '.join(f'{k} {v:.2f}' for k, v in times.items())}; "
        f"complex_dense at {shape['shape']}: kernel {shape['kernel_ms']:.4f}"
        f" ms, complex64 matmul {shape['library_ms']:.4f}, bound "
        f"{shape['bound_ms']:.4f} ({shape['bound_by']})")
    return {"launches": launches, "shape": shape}


def phase_tp_big512(tpk, dev, hbm_bps, peak_key) -> dict:
    """Phase 25b: the committed nfft-512 bf16 arm on dp 1 x tp 2: its
    gradients within 1e-2 of each leaf's max of the single-device ones
    (the bf16 tolerance of `tests/test_torch_bf16.py`); the pack and the
    bf16 GEMM launched at N = 256, one each a rank, each call's output
    against `complex_dense_ref` (atol = rtol = 1e-5, phase 20's rule);
    then a `ber_sweep` of the arm at 0, 5 and 10 dB (4,000 frames a
    point) on dp 2 x tp 2, bit-identical to the dp-2 mesh sweep from the
    same generator."""
    import torch
    from dl_ofdm_tpu_torch.config import TrainConfig
    from dl_ofdm_tpu_torch.eval.sweep import ber_sweep
    from dl_ofdm_tpu_torch.train.checkpoint import (load_params_npz,
                                                    params_from_flax)
    from dl_ofdm_tpu_torch.train.loop import Trainer
    params = {k: v.to(dev) for k, v in params_from_flax(
        load_params_npz(BIG_ARM)).items()}
    tc = TrainConfig(snr=5.0)
    tr = Trainer(big512_config(), tc, channel="AWGN",
                 mesh=tp_mesh(dev, 1, TP_TP))
    single = Trainer(big512_config(), tc, channel="AWGN", device=dev)
    single.model.load_state_dict(params)
    state = tr._new_state(params, list(params))
    gen = torch.Generator(device=dev).manual_seed(252)
    b = tr.batch_frames
    bits, rx, _, _, _ = single.synthesize(
        b, torch.full((b,), 5.0, device=dev), gen)
    k_, p_ = tpk.complex_dense_kernel, tpk.pack_stacked_weight_kernel
    torch.cuda.synchronize()
    k_.launches = k_.launches_bf16 = p_.launches = 0
    g_tp = mesh_grads(tr, state, bits, rx)
    torch.cuda.synchronize()
    launches = {"bf16": k_.launches_bf16, "pack": p_.launches,
                "float32": k_.launches}
    if launches != {"bf16": TP_TP, "pack": TP_TP, "float32": 0}:
        raise AssertionError(f"bf16 tp step: launches {launches}, want one "
                             "pack and one GEMM a rank")
    g_1d = single_grads(single, params, bits, rx)
    gerr = check_grads("nfft-512 bf16 tp gradients", g_tp, g_1d, 1e-2)
    x = rx.reshape(-1, rx.shape[2], 2).contiguous()
    errs = []
    for t in range(TP_TP):
        wr = state.replicas[t]["fft_like.wr"]
        wi = state.replicas[t]["fft_like.wi"]
        if wr.shape[1] != 256:
            raise AssertionError(f"rank {t}'s fft_like {tuple(wr.shape)}")
        with torch.no_grad():
            y = tpk.complex_dense_kernel(x, wr, wi, "bfloat16")
            want = tpk.complex_dense_ref(x, wr, wi, "bfloat16")
        torch.testing.assert_close(y, want, atol=1e-5, rtol=1e-5)
        errs.append(float((y - want).abs().max()))
    wr, wi = (state.replicas[0][f"fft_like.{n}"] for n in ("wr", "wi"))
    shape = cdense_tp_times(tpk, x, wr, wi, "bfloat16", hbm_bps, peak_key)
    if not torch.equal(p_(wr, wi).view(torch.int16),
                       tpk.pack_stacked_weight_ref(wr, wi).view(torch.int16)):
        raise AssertionError("the pack kernel at the tp shape differs from "
                             "pack_stacked_weight_ref")
    pack = {n: [] for n in ("kernel", "plain")}
    for n in ("plain", "kernel", "kernel", "plain"):
        pack[n].append(time_ms(
            (lambda: p_(wr, wi)) if n == "kernel"
            else (lambda: tpk.pack_stacked_weight_ref(wr, wi)), 100)[0])
    k, f = wr.shape
    shape["pack"] = {"shape": [k, f], "ms": sum(pack["kernel"]) / 2,
                     "plain_ms": sum(pack["plain"]) / 2,
                     "bound_ms": 16 * k * f / hbm_bps * 1e3,
                     "bound_by": "bytes"}
    t0 = time.time()
    res = {}
    for name, mesh in (("tp", tp_mesh(dev, TP_DP, TP_TP)),
                       ("dp", tp_mesh(dev, TP_DP, 1))):
        res[name] = ber_sweep(single, torch.Generator(device=dev)
                              .manual_seed(999), snrs=TP_SWEEP_SNRS,
                              frames_per_point=4000, batch_frames=3000,
                              log_fn=lambda *a: None, mesh=mesh)
    same = (np.array_equal(res["tp"].ber, res["dp"].ber)
            and np.array_equal(res["tp"].loss, res["dp"].loss))
    if not same:
        raise AssertionError(f"tp sweep {res['tp'].ber} differs from the dp "
                             f"sweep {res['dp'].ber}")
    line = {"phase": 25, "part": "b", "dp": 1, "tp": TP_TP,
            "frames": b, "launches": launches, "grad_err": gerr,
            "kernel_vs_plain_err": errs, "complex_dense_tp_shape": shape,
            "sweep_snrs": list(TP_SWEEP_SNRS), "sweep_ber": list(
                map(float, res["tp"].ber)), "sweep_bit_identical": same,
            "sweep_seconds": time.time() - t0}
    print(json.dumps(line), flush=True)
    log(f"nfft-512 bf16 tp (dp 1 x tp 2): gradients within 1e-2 of each "
        f"leaf's max (worst {gerr:.3g}); pack and bf16 GEMM at N = 256, "
        f"{launches}; kernel == plain within 1e-5 ({max(errs):.3g}); bf16 "
        f"at {shape['shape']}: kernel {shape['kernel_ms']:.4f} ms, bf16 "
        f"cuBLAS {shape['library_ms']:.4f}, bound {shape['bound_ms']:.4f}; "
        f"sweep on dp 2 x tp 2 == dp 2 bit for bit, BER "
        f"{[f'{v:.4g}' for v in res['tp'].ber]}")
    return {"launches_bf16": launches["bf16"], "launches_pack":
            launches["pack"], "shape": shape}


def phase_tp_equalizer(tpk, dev) -> dict:
    """Phase 25c: the committed opt-12 arm in `EqualizerTrainer` on dp 1 x
    tp 2: the Equalizer keys' gradients within rtol 2e-4 / atol 1e-6 of
    the single-device ones on one batch (`tests/test_parallel.py:312`);
    beside it, each one's worst error against the same trainer's float64
    gradients on the CPU (relative to a leaf's largest value: float32's
    own noise).  The receiver stays frozen over a step."""
    import torch
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.train.checkpoint import (load_params_npz,
                                                    params_from_flax)
    from dl_ofdm_tpu_torch.train.equalizer_loop import EqualizerTrainer
    arm = params_from_flax(load_params_npz(TP_EQ_ARM))
    cfg, tc = OFDMConfig(nbits=2), TrainConfig(snr=10.0, opt=12)

    def make(**kw):
        return EqualizerTrainer(cfg, tc, channel="mixRayleigh", **kw)

    tr = make(mesh=tp_mesh(dev, 1, TP_TP))
    single, ref = make(device=dev), make(device="cpu")
    params = {k: v.to(dev) for k, v in arm.items()}
    tr._set_trainable(params)
    single._set_trainable(params)
    ref._set_trainable(params)
    state = tr._new_state(params, tr._trainable)
    gen = torch.Generator(device=dev).manual_seed(253)
    b = tr.batch_frames
    bits, rx, _, _, _ = single.synthesize(
        b, torch.full((b,), 10.0, device=dev), gen)
    g_tp = mesh_grads(tr, state, bits, rx)
    g_1d = single_grads(single, params, bits, rx, tr._trainable)
    ref.model.double()
    g_64 = single_grads(ref, {k: v.double().cpu() for k, v in arm.items()},
                        bits.cpu(), rx.double().cpu(), tr._trainable)

    def worst(g):
        return max(float((g[k].double().cpu() - v).abs().max()
                         / v.abs().max()) for k, v in g_64.items())

    w_tp, w_1d = worst(g_tp), worst(g_1d)
    gerr = close_grads("equalizer tp gradients", g_tp, g_1d, 2e-4, 1e-6)
    new, aux = tr._mesh_step(state, *[[t] for t in (bits, rx)], [{}],
                             torch.tensor(0.0, device=dev))
    frozen = all(torch.equal(new.params[k], params[k]) for k in params
                 if k.startswith("receiver."))
    line = {"phase": 25, "part": "c", "arm": os.path.basename(TP_EQ_ARM),
            "frames": b, "worst_rel_err_tp_vs_float64": w_tp,
            "worst_rel_err_single_vs_float64": w_1d,
            "grad_rel_err_vs_single": gerr,
            "tolerance": "rtol 2e-4, atol 1e-6",
            "receiver_frozen": frozen, "loss": float(aux["loss"])}
    print(json.dumps(line), flush=True)
    log(f"equalizer opt 12 tp (dp 1 x tp 2): gradients within rtol 2e-4 "
        f"/ atol 1e-6 of single-device (worst {gerr:.3g} of a leaf max); "
        f"against float64 {w_tp:.3g} (single-device float32 {w_1d:.3g}); "
        f"receiver frozen: {frozen}")
    if not (frozen and np.isfinite(line["loss"])):
        raise AssertionError(f"equalizer tp: {line}")
    return line


def phase_tp_resume(dev) -> dict:
    """Phase 25d: a resumed fit on dp 2 x tp 2 at nfft 256 (2 + 2 epochs
    against 4) bit-identical, as phase 22 holds the others."""
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.train.loop import Trainer
    cfg = OFDMConfig(nbits=1, nfft=256, nfilter=256)
    tc = TrainConfig(snr=5.0, batch_size=7 * 64, msg_length=7 * 64 * 4,
                     early_stop=50)
    c = resume_check("nfft-256 dp 2 x tp 2", lambda: Trainer(
        cfg, tc, channel="ETU", mesh=tp_mesh(dev, TP_DP, TP_TP)), 4, 2, 1,
        grow_batch=False)
    print(json.dumps({"phase": 25, "part": "d", **c}), flush=True)
    if c["n_differ"]:
        raise AssertionError(f"tp resume differs at {c['differ']}")
    return c


# -- 26e-f. tp rows across processes ------------------------------------------
TP_PROC_STEPS = 3                   # checked steps (then as many timed)


def leaf_hashes(params: dict) -> dict:
    """sha256 of each leaf's bytes (on the host): bit-identity without
    carrying the tensors between processes."""
    import hashlib
    return {k: hashlib.sha256(v.detach().cpu().contiguous().numpy()
                              .tobytes()).hexdigest()
            for k, v in params.items()}


def proc_tp(mesh, dev) -> dict:
    """Phase 25a's configuration (JAX's tp configuration: nfft 1,024,
    nfilter 1,024, nbits 1, ETU, 5 dB, float32) at 64 frames a step on
    `mesh` from seed 26: TP_PROC_STEPS steps with this process's
    `complex_dense` launches (counts set to 0 just before, read just
    after) and the gathered parameters' hashes and losses; then as many
    steps timed (ms a step, host clock around a synchronize) and the
    per-step gather of the split leaves (`Trainer._gathered`) timed
    alone."""
    import torch
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.ops import pallas_kernels as tpk
    from dl_ofdm_tpu_torch.parallel import distributed as pd
    from dl_ofdm_tpu_torch.train.loop import Trainer
    tr = Trainer(OFDMConfig(nbits=1, nfft=1024, nfilter=1024),
                 TrainConfig(snr=5.0, batch_size=7 * TP_FRAMES[0]),
                 channel="ETU", mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(26)
    state = tr.init_state(gen)
    snr = torch.full((tr.batch_frames,), 5.0, device=dev)
    k_ = tpk.complex_dense_kernel
    torch.cuda.synchronize(dev)
    k_.launches = k_.launches_bf16 = 0
    losses = []
    for _ in range(TP_PROC_STEPS):
        state, aux = tr.train_step(state, gen, snr)
        losses.append(float(aux["loss"]))
    torch.cuda.synchronize(dev)
    launches = {"float32": k_.launches, "bf16": k_.launches_bf16}
    hashes = leaf_hashes(state.params)
    pd.barrier(dev)
    t = time.perf_counter()
    for _ in range(TP_PROC_STEPS):
        state, aux = tr.train_step(state, gen, snr)
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t) * 1e3 / TP_PROC_STEPS
    split = [k for k, d in tr._dims.items() if d is not None]
    leaves = tr._leaves(state.params, state.replicas, split)
    pd.barrier(dev)
    t = time.perf_counter()
    for _ in range(TP_PROC_STEPS):
        tr._gathered(leaves)
    torch.cuda.synchronize(dev)
    gather_ms = (time.perf_counter() - t) * 1e3 / TP_PROC_STEPS
    return {"frames": tr.batch_frames, "losses": losses,
            "launches": launches, "hashes": hashes, "ms_per_step": ms,
            "gather_ms": gather_ms, "ranks": len(mesh.local_ranks),
            "gather_bytes": sum(state.params[k].numel() * 4 for k in split),
            "finite": bool(torch.isfinite(aux["loss"]))}


def proc_tp_bf16(mesh, dev, work: str) -> dict:
    """Phase 25b's gradients on `mesh`: the committed nfft-512 bf16 arm,
    one batch drawn by the parent (`work/bf16_batch.pt`), this process's
    pack and bf16 GEMM launches, the gathered gradients' worst error
    against the single-device ones relative to each leaf's largest value,
    and their hashes."""
    import torch
    from dl_ofdm_tpu_torch.config import TrainConfig
    from dl_ofdm_tpu_torch.ops import pallas_kernels as tpk
    from dl_ofdm_tpu_torch.train.checkpoint import (load_params_npz,
                                                    params_from_flax)
    from dl_ofdm_tpu_torch.train.loop import Trainer
    params = {k: v.to(dev) for k, v in params_from_flax(
        load_params_npz(BIG_ARM)).items()}
    tc = TrainConfig(snr=5.0)
    tr = Trainer(big512_config(), tc, channel="AWGN", mesh=mesh)
    single = Trainer(big512_config(), tc, channel="AWGN", device=dev)
    single.model.load_state_dict(params)
    state = tr._new_state(params, list(params))
    bits, rx = (t.to(dev) for t in torch.load(
        os.path.join(work, "bf16_batch.pt")))
    k_, p_ = tpk.complex_dense_kernel, tpk.pack_stacked_weight_kernel
    torch.cuda.synchronize(dev)
    k_.launches = k_.launches_bf16 = p_.launches = 0
    g_tp = mesh_grads(tr, state, bits, rx)
    torch.cuda.synchronize(dev)
    launches = {"bf16": k_.launches_bf16, "pack": p_.launches,
                "float32": k_.launches}
    g_1d = single_grads(single, params, bits, rx)
    err = max(float((g_tp[k] - w).abs().max() / w.abs().max())
              for k, w in g_1d.items())
    return {"launches": launches, "grad_err": err,
            "hashes": leaf_hashes(g_tp)}


def tp_one_process(dev, dp: int, tp: int, cards: bool):
    """The one-process mesh of a grid: one rank a card where `cards`,
    else virtual ranks of card 0."""
    import torch
    from dl_ofdm_tpu_torch.parallel.mesh import make_mesh
    n = dp * tp
    devs = ([torch.device("cuda", i) for i in range(n)] if cards
            else [dev] * n)
    return make_mesh(devs, dp=dp, tp=tp)


def check_tp_procs(name: str, runs: list, ref: dict, want: dict) -> dict:
    """Every process's hashes equal the one-process mesh's and its
    launches `want`; returns the JSON line's fields."""
    same = all(r["tp"]["hashes"] == ref["hashes"] for r in runs)
    launches = [r["tp"]["launches"] for r in runs]
    if not same:
        bad = sorted(k for r in runs for k, v in r["tp"]["hashes"].items()
                     if ref["hashes"][k] != v)
        losses = [r["tp"]["losses"] for r in runs]
        raise AssertionError(f"{name}: parameters after {TP_PROC_STEPS} "
                             f"steps differ from the one-process mesh's at "
                             f"{bad}; losses {losses} against "
                             f"{ref['losses']}")
    if any(v != want for v in launches) or not all(
            r["tp"]["finite"] for r in runs):
        raise AssertionError(f"{name}: complex_dense launches {launches}, "
                             f"want {want} a process")
    return {"bit_identical": same, "launches": launches,
            "ms_per_step": [r["tp"]["ms_per_step"] for r in runs],
            "one_process_ms_per_step": ref["ms_per_step"],
            "gather_ms": [r["tp"]["gather_ms"] for r in runs],
            "one_process_gather_ms": ref["gather_ms"],
            "gather_bytes": ref["gather_bytes"], "losses": ref["losses"]}


def phase_tp_processes(dev) -> dict:
    """Phase 26e-f: tp rows across processes.  e. two processes (gloo on
    one card, NCCL one a card on two or more) at dp 1 x tp 2: phase 25a's
    configuration (nfft 1,024) for 3 steps bit-identical to the
    one-process dp 1 x tp 2 mesh, one `complex_dense` launch a rank a step
    in each process, ms a step and the per-step gather's ms beside the
    one-process mesh; then the nfft-512 bf16 arm's gradients on tp 2
    across the processes, within 1e-2 of each leaf's max of single-device
    (25b's rule), bit-identical to the one-process tp 2, one pack and one
    bf16 GEMM a process.  f. with four cards, NCCL at 4 processes dp 2 x
    tp 2 and dp 1 x tp 4 and 2 processes x 2 cards dp 1 x tp 4, each
    against its one-process mesh over the four cards.  Returns the
    kernels-line fields."""
    import torch
    n = torch.cuda.device_count()
    backend = "nccl" if n >= PROC_N else "gloo"
    cards = n >= PROC_N
    from dl_ofdm_tpu_torch.config import TrainConfig
    from dl_ofdm_tpu_torch.train.loop import Trainer
    gen = torch.Generator(device=dev).manual_seed(262)
    single = Trainer(big512_config(), TrainConfig(snr=5.0), channel="AWGN",
                     device=dev)
    b = single.batch_frames
    bits, rx, _, _, _ = single.synthesize(
        b, torch.full((b,), 5.0, device=dev), gen)
    with tempfile.TemporaryDirectory() as work:
        torch.save((bits.cpu(), rx.cpu()), os.path.join(work,
                                                        "bf16_batch.pt"))
        runs = run_procs(PROC_N, backend, tp=PROC_N,
                         parts=("tp", "tp_bf16"), work=work)
        mesh = tp_one_process(dev, 1, PROC_N, cards)
        ref = proc_tp(mesh, dev)
        ref_bf16 = proc_tp_bf16(mesh, dev, work)
    line = check_tp_procs("26e nfft-1024 tp 2 across processes", runs, ref,
                          {"float32": TP_PROC_STEPS, "bf16": 0})
    bf = [r["tp_bf16"] for r in runs]
    bf_same = all(r["hashes"] == ref_bf16["hashes"] for r in bf)
    bf_err = max(r["grad_err"] for r in bf)
    want = {"bf16": 1, "pack": 1, "float32": 0}
    if not bf_same or bf_err > 1e-2 or any(r["launches"] != want
                                           for r in bf):
        raise AssertionError(
            f"26e nfft-512 bf16 tp 2 across processes: bit-identical "
            f"{bf_same}, worst {bf_err:.3g} of a leaf max (1e-2), launches "
            f"{[r['launches'] for r in bf]} (want {want} a process)")
    out = {"float32": sum(v["float32"] for v in line["launches"]),
           "bf16": sum(r["launches"]["bf16"] for r in bf),
           "pack": sum(r["launches"]["pack"] for r in bf)}
    print(json.dumps({"phase": 26, "part": "e", "backend": backend,
                      "processes": PROC_N, "dp": 1, "tp": PROC_N,
                      "config": "nfft 1024, nfilter 1024, nbits 1, ETU, "
                      "float32", "frames": ref["frames"],
                      "steps": TP_PROC_STEPS, **line,
                      "bf16_bit_identical": bf_same, "bf16_grad_err": bf_err,
                      "bf16_launches": [r["launches"] for r in bf]}),
          flush=True)
    log(f"26e dp 1 x tp {PROC_N} over {PROC_N} processes ({backend}), "
        f"nfft 1,024 at {ref['frames']} frames: {TP_PROC_STEPS} steps "
        f"bit-identical to the one-process mesh; complex_dense "
        f"{line['launches']} launches a process; "
        f"{max(line['ms_per_step']):.3f} ms a step against "
        f"{ref['ms_per_step']:.3f} in one process; the per-step gather of "
        f"{ref['gather_bytes'] / 1e6:.1f} MB "
        f"{max(line['gather_ms']):.3f} ms (one process "
        f"{ref['gather_ms']:.3f}); nfft-512 bf16 gradients within "
        f"{bf_err:.3g} of single-device, bit-identical {bf_same}")
    if n < 4:
        log(f"26f not run: {n} card(s)")
        return out
    for world, per, tp in ((4, 1, 2), (4, 1, 4), (2, 2, 4)):
        runs4 = run_procs(world, "nccl", per_proc=per, tp=tp, parts=("tp",))
        ref4 = proc_tp(tp_one_process(dev, 4 // tp, tp, True), dev)
        line4 = check_tp_procs(f"26f {world} x {per} tp {tp}", runs4, ref4,
                               {"float32": TP_PROC_STEPS * per, "bf16": 0})
        print(json.dumps({"phase": 26, "part": "f", "processes": world,
                          "cards_a_process": per, "dp": 4 // tp, "tp": tp,
                          **line4}), flush=True)
        log(f"26f NCCL {world} processes x {per} card(s), dp {4 // tp} x tp "
            f"{tp}: bit-identical; {max(line4['ms_per_step']):.3f} ms a step "
            f"against {ref4['ms_per_step']:.3f} in one process; gather "
            f"{max(line4['gather_ms']):.3f} ms")
    return out


# -- 27. the partitioned Doppler path ---------------------------------------
PART_FRAMES = 9363                  # 3 x 3,121: mixRayleigh mobile


def phase_partition_doppler(tpk, dev) -> dict:
    """Phase 27: `RayleighChannel._partition_doppler` on a mixRayleigh
    mobile batch of 9,363 frames (every third frame Doppler): `y` and
    `h_freq` bit-equal to the general path's on the same draws, each
    path's `fir_shift_accum` launches (counts set to 0 just before, read
    just after: one a call, on 6,242 rows against 9,363) and ms a call
    (CUDA events, 20 calls, each path twice, interleaved)."""
    import torch
    from dl_ofdm_tpu_torch.channel.rayleigh import RayleighChannel
    ch = RayleighChannel("mixRayleigh", nfft=64, mobile=True, mix=True)
    gen = torch.Generator(device=dev).manual_seed(27)
    tx = torch.randn(PART_FRAMES, 7, 80, 2, device=dev, generator=gen)
    zck = torch.randn(PART_FRAMES, ch.max_taps, 2, device=dev,
                      generator=gen) / 2 ** 0.5
    from dl_ofdm_tpu_torch.channel.doppler import jakes_phases
    theta = jakes_phases(PART_FRAMES, ch.max_taps, gen, dev)
    outs, launches, ms = {}, {}, {"partitioned": [], "general": []}
    k_ = tpk.fir_shift_accum_kernel
    for name, part in (("partitioned", True), ("general", False)):
        ch._partition_doppler = part
        torch.cuda.synchronize()
        k_.launches = 0
        outs[name] = ch(tx, zck=zck, theta=theta)
        torch.cuda.synchronize()
        launches[name] = k_.launches
    for name in ("partitioned", "general", "general", "partitioned"):
        ch._partition_doppler = name == "partitioned"
        ms[name].append(events_ms(lambda: ch(tx, zck=zck, theta=theta), 20))
    ch._partition_doppler = False
    same = (torch.equal(outs["partitioned"].y, outs["general"].y)
            and torch.equal(outs["partitioned"].h_freq,
                            outs["general"].h_freq))
    ms = {k: sum(v) / len(v) for k, v in ms.items()}
    line = {"phase": 27, "frames": PART_FRAMES, "bit_equal": same,
            "fir_shift_accum_launches": launches, "ms_per_call": ms}
    print(json.dumps(line), flush=True)
    log(f"27 partitioned Doppler path at {PART_FRAMES} frames: y and "
        f"h_freq bit-equal to the general path {same}; fir_shift_accum "
        f"launches {launches}; ms a call {ms}")
    if not same or launches != {"partitioned": 1, "general": 1}:
        raise AssertionError(f"phase 27: {line}")
    return line


def phase_sg_tp(dev) -> dict:
    """Phase 25e: `SingleGraphEqualizedRx` (nbits 2, nfft 64, nfilter 64)
    as a trainer's model on dp 1 x tp 2 of the card: `fft_like`,
    `Dense_interp*` and `Dense_extract` split; its float32 tp gradients'
    worst error against the float64 ones of the same model on the CPU,
    relative to each leaf's largest value, within twice the single-device
    float32 gradients' (the rule of `tests/test_torch_tp.py` for the
    equalizer in float32)."""
    import torch
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.models.receiver import SingleGraphEqualizedRx
    from dl_ofdm_tpu_torch.ofdm.plan import build_plan
    from dl_ofdm_tpu_torch.train.loop import Trainer
    cfg, tc = OFDMConfig(nbits=2), TrainConfig(snr=10.0)
    plan = build_plan(cfg)

    def make(**kw):
        model = SingleGraphEqualizedRx(2, 64, plan.cp_len, 64,
                                       plan.frame_size, 7, plan.pilot_size)
        return Trainer(cfg, tc, channel="EPA", model=model, **kw)

    tr = make(mesh=tp_one_process(dev, 1, TP_TP, False))
    single, ref = make(device=dev), make(device="cpu")
    params = single.init_state(torch.Generator(device=dev)
                               .manual_seed(255)).params
    state = tr._new_state(params, list(params))
    b = tr.batch_frames
    bits, rx, _, _, _ = single.synthesize(
        b, torch.full((b,), 10.0, device=dev),
        torch.Generator(device=dev).manual_seed(256))
    g_tp = mesh_grads(tr, state, bits, rx)
    g_1d = single_grads(single, params, bits, rx)
    ref.model.double()
    g_64 = single_grads(ref, {k: v.double().cpu() for k, v in params.items()},
                        bits.cpu(), rx.double().cpu())
    split = sorted(k for k, d in tr._dims.items() if d is not None)

    def worst(g):
        return max(float((g[k].double().cpu() - v).abs().max()
                         / v.abs().max()) for k, v in g_64.items())

    w_tp, w_1d = worst(g_tp), worst(g_1d)
    line = {"phase": 25, "part": "e", "model": "SingleGraphEqualizedRx",
            "frames": b, "split": split,
            "worst_rel_err_tp_vs_float64": w_tp,
            "worst_rel_err_single_vs_float64": w_1d}
    print(json.dumps(line), flush=True)
    log(f"SingleGraphEqualizedRx tp (dp 1 x tp 2): {len(split)} split "
        f"leaves; gradients against float64 {w_tp:.3g} (single-device "
        f"float32 {w_1d:.3g})")
    if not w_tp <= 2 * w_1d:
        raise AssertionError(f"SingleGraphEqualizedRx tp gradients: {line}")
    return line


# -- 30. the plain data plane's chain ----------------------------------------
# (channel, nfft, SNR points, frames a point) of the two sweep cells' calls:
# bpsk64.sweep_etu's 1,968 frames and big512.sweep_awgn's 992
CHAIN_CALLS = (("ETU", 64, 41, 48), ("AWGN", 512, 31, 32))
CHAIN_HOST_CALLS = 50              # calls a path a turn, host clock
CHAIN_PROFILED_CALLS = 10


@contextlib.contextmanager
def todays_data_plane(sc):
    """`Trainer.synthesize` through its modules (`RayleighChannel`,
    `awgn_channel`, `batch_norm_ref`), as before the chain, on a card."""
    keep = sc.chain_for
    sc.chain_for = lambda *a, **k: None
    try:
        yield
    finally:
        sc.chain_for = keep


def f64_normalize(v, onehot):
    """`batch_norm_ref` of the noisy waveform v [B, S, sps, 2] per group in
    float64, two-pass: what both paths' float32 rx_in are held to."""
    import torch
    b = v.shape[0]
    x = v.double().reshape(b, -1)
    g = onehot.argmax(1)
    cnt = onehot.double().sum(0)[:, None]
    mean = torch.zeros(onehot.shape[1], x.shape[1], dtype=torch.float64,
                       device=v.device).index_add_(0, g, x) / cnt
    d = x - mean[g]
    var = torch.zeros_like(mean).index_add_(0, g, d * d) / cnt
    return (d / torch.sqrt(var[g] + 1e-9) / np.sqrt(2.0)).reshape(v.shape)


def launch_counts(prof, calls: int) -> dict:
    """Kernel-launch API events, host-to-device copies and each chain
    kernel's device µs a call in a profiler's window of `calls` calls."""
    launches = copies = 0
    us = {"chain_tx_kernel": 0.0, "chain_norm_kernel": 0.0}
    for e in prof.key_averages():
        if e.key.startswith(("cudaLaunch", "cuLaunch")):
            launches += e.count
        if "HtoD" in e.key:
            copies += e.count
        for name in us:
            if name in e.key:
                us[name] += getattr(e, "device_time_total",
                                    getattr(e, "cuda_time_total", 0.0))
    return {"launches": launches / calls, "htod_copies": copies / calls,
            **{f"{k}_us": v / calls for k, v in us.items()}}


def phase_synth_chain(dev, hbm_bps) -> dict:
    """Phase 30: the plain data plane of a static channel as two kernels
    (`ops/synth_chain.py`, `csrc/synth_chain.cu`) at the two sweep cells'
    calls (1,968 x nfft 64 ETU frames in 41 groups; 992 x nfft 512 AWGN
    frames in 31 groups), on the benchmark's kind of draws (bits and
    float32 unit noise given, tap gains from a generator): against today's
    path (rx_in within 1e-4 beyond today's own float32 error against a
    float64 normalization; h, waveform, noise power; the generator's
    state), two calls bit-identical, the counters; the kernels' device
    time (CUDA graph) beside their byte bound; both paths' host-clock time
    a call (turns T C C T); the launches and host-to-device copies a call
    of each path under `torch.profiler` (last: the profiler slows what
    follows).  Alone: `cs.phase_synth_chain(dev, hbm_bps)` after
    `cuda_build.build_all()`."""
    import torch
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.eval.sweep import interleaved_groups
    from dl_ofdm_tpu_torch.ops import synth_chain as sc
    from dl_ofdm_tpu_torch.train.loop import Trainer
    k = sc.synth_chain_kernel
    torch.cuda.synchronize()
    k.launches = k.fallbacks = 0
    lines, calls = {}, 0
    for chan, nfft, pts, per in CHAIN_CALLS:
        tr = Trainer(OFDMConfig(nbits=1, nfft=nfft, nfilter=nfft),
                     TrainConfig(), channel=chan, device=dev)
        plan = tr.plan
        snr, onehot = interleaved_groups(list(range(-10, -10 + pts)),
                                         pts * per, dev)
        b = snr.shape[0]
        g = torch.Generator(device=dev).manual_seed(30)
        bits = torch.randint(0, 2, (b, plan.frame_size, 1), generator=g,
                             dtype=torch.int32, device=dev)
        unit = torch.randn(b, plan.nsymbol, plan.samples_per_symbol, 2,
                           generator=g, device=dev)

        def call(normalize=True, seed=31):
            gen = torch.Generator(device=dev).manual_seed(seed)
            out = tr.synthesize(b, snr, gen, norm_groups=onehot, bits=bits,
                                unit_noise=unit, normalize=normalize)
            return out, gen.get_state()

        got, s_chain = call()
        again, _ = call()
        calls += 2
        with todays_data_plane(sc):
            want, s_today = call()
            noisy = call(normalize=False)[0][1]
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        err = float((got[1] - want[1]).abs().max())
        own = float((want[1].double() - f64_normalize(noisy, onehot)
                     ).abs().max())
        chain_own = float((got[1].double() - f64_normalize(
            noisy, onehot)).abs().max())
        errs = {"h_freq": float((got[2] - want[2]).abs().max()),
                "waveform": float((got[4] - want[4]).abs().max()),
                "noise_power_rel": abs(float(got[3] / want[3]) - 1)}
        if not (same and torch.equal(s_chain, s_today)
                and torch.equal(got[0], want[0]) and err <= 1e-4 + own
                and errs["h_freq"] <= 2e-6 and errs["waveform"] <= 2e-6
                and errs["noise_power_rel"] <= 2e-6):
            raise AssertionError(
                f"phase 30 {chan} {nfft}: bit-identical {same}, generator "
                f"states equal {torch.equal(s_chain, s_today)}, rx_in "
                f"{err:.3g} (today's own {own:.3g}), {errs}")
        # the kernels alone: device time from a CUDA graph
        c, cp = sc.chain_for(plan, tr.channel, 1, dev, b, onehot, True)
        zck = torch.randn(b, tr.channel.max_taps, 2, generator=g,
                          device=dev)
        n0 = k.launches
        graph_ms, eager_ms = time_ms(lambda: sc.synth_chain_kernel(
            c, cp, bits, zck, snr, onehot, unit), iters=100)
        calls += (k.launches - n0) // 2
        l2 = 2 * c.length
        n_bytes = 4 * (b * c.frame_size + 2 * b * tr.channel.max_taps
                       + b + b * pts + b * l2) + 4 * 2 * b * l2 \
            + 8 * b * c.nfft
        bound_ms = n_bytes / hbm_bps * 1e3
        # host clock a call, turns today / chain / chain / today
        host = {"today": [], "chain": []}
        for path in ("today", "chain", "chain", "today"):
            ctx = (todays_data_plane(sc) if path == "today"
                   else contextlib.nullcontext())
            with ctx:
                call()
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(CHAIN_HOST_CALLS):
                    call()
                torch.cuda.synchronize()
            host[path].append((time.perf_counter() - t) * 1e3
                              / CHAIN_HOST_CALLS)
        calls += 2 * (CHAIN_HOST_CALLS + 1)
        line = {"phase": 30, "call": f"{chan} nfft {nfft}", "frames": b,
                "groups": pts, "plan": cp._asdict(),
                "rx_in_max_abs_diff": err, "todays_own_err": own,
                "chains_own_err": chain_own, **errs,
                "bit_identical": same, "generator_state_equal": True,
                "kernel_ms": graph_ms, "kernel_eager_ms": eager_ms,
                "bytes": n_bytes, "bound_ms": bound_ms,
                "share_of_bound": bound_ms / graph_ms,
                "host_ms_a_call": host,
                "timing": "kernels: CUDA graph of 100 calls; host: "
                          f"{CHAIN_HOST_CALLS} calls of synthesize a turn"}
        lines[(chan, nfft)] = (line, tr, snr, onehot, bits, unit)
        log(f"chain {chan} nfft {nfft} x {b} frames: rx_in within {err:.3g} "
            f"of today's path (today's own float32 error {own:.3g}, the "
            f"chain's {chain_own:.3g}), bit-identical twice; kernels "
            f"{graph_ms:.4f} ms (graph; eager {eager_ms:.4f}), bound "
            f"{bound_ms:.4f} ms (bytes): {100 * bound_ms / graph_ms:.0f} %; "
            f"a call by host clock today {host['today']} ms, chain "
            f"{host['chain']} ms")
    torch.cuda.synchronize()
    launches, fallbacks = k.launches, k.fallbacks
    if launches != 2 * calls or fallbacks != 0:
        raise AssertionError(f"phase 30: {launches} chain launches for "
                             f"{calls} calls, {fallbacks} fallbacks")
    # launches and copies a call under the profiler, today's path and the
    # chain; then a Doppler call counts as a fallback
    for key, (line, tr, snr, onehot, bits, unit) in lines.items():
        per = {}
        for path in ("today", "chain"):
            ctx = (todays_data_plane(sc) if path == "today"
                   else contextlib.nullcontext())
            with ctx:
                gen = torch.Generator(device=dev).manual_seed(32)
                torch.cuda.synchronize()
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    for _ in range(CHAIN_PROFILED_CALLS):
                        tr.synthesize(snr.shape[0], snr, gen,
                                      norm_groups=onehot, bits=bits,
                                      unit_noise=unit)
                    torch.cuda.synchronize()
            per[path] = launch_counts(prof, CHAIN_PROFILED_CALLS)
        line["per_call"] = per
        if per["chain"]["htod_copies"]:
            raise AssertionError(f"phase 30 {key}: the chain copied from "
                                 f"the host: {per['chain']}")
        print(json.dumps(line), flush=True)
        log(f"chain {key}: a call under the profiler {per}")
    mob = Trainer(OFDMConfig(nbits=1), TrainConfig(), channel="mixRayleigh",
                  mobile=True, device=dev)
    n0 = (k.launches, k.fallbacks)
    mob.synthesize(30, torch.zeros(30, device=dev),
                   torch.Generator(device=dev).manual_seed(0))
    if (k.launches, k.fallbacks) != (n0[0], n0[1] + 1):
        raise AssertionError("phase 30: a Doppler call did not count as a "
                             "fallback")
    etu = lines[("ETU", 64)][0]
    return {"launches": launches, "fallbacks": k.fallbacks,
            "ms": etu["kernel_ms"], "bound_ms": etu["bound_ms"],
            "calls": {f"{c_} nfft {n_}": {
                f: v[0][f] for f in ("kernel_ms", "bound_ms",
                                     "rx_in_max_abs_diff", "host_ms_a_call",
                                     "per_call")}
                for (c_, n_), v in lines.items()}}


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
    adam = phase_fused_adam(dev, hbm_bps)
    conv = phase_block_conv(dev, f32_flops)

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

    # -- 26. multi-process data parallelism (before the profiled phases) -----
    procs = phase_processes(dev)

    # -- 20-22. the bf16 receiver, the nfft-512 arm, the CLI ----------------
    bf16 = phase_cdense_bf16(tpk, dev, hbm_bps, peak_key)
    big = phase_serve_big512(tpk, dev)
    cli_run = phase_cli_big512(tpk, tfs, tfm, dev)

    # -- 23. the classical baselines ------------------------------------------
    baseline = phase_baselines(tpk, dev, smi)
    base_fir = phase_baseline_fir(tpk, dev, hbm_bps, f32_flops)

    # -- 24-25. the ablation and legacy paths, tensor parallelism ----------
    phase_legacy_cpu_parity(dev)
    legacy = phase_legacy_fir(tpk, dev, hbm_bps, f32_flops)
    phase_dnn_ablation(tpk, tfs, dev)
    tp_big = phase_tp_big(tpk, dev, hbm_bps, peak_key)
    tp_512 = phase_tp_big512(tpk, dev, hbm_bps, peak_key)
    phase_tp_equalizer(tpk, dev)
    phase_tp_resume(dev)
    phase_sg_tp(dev)

    # -- 26e-f, 27. tp rows across processes, the partitioned Doppler path ---
    tp_procs = phase_tp_processes(dev)
    phase_partition_doppler(tpk, dev)

    # -- 30. the plain data plane's chain (its profiled part last) ----------
    chain = phase_synth_chain(dev, hbm_bps)

    # -- 17-18, 21, 23. the profiled phases -----------------------------------
    phase_profile_eq(dev)
    phase_model_breakdown(tfm, dev)
    phase_profile_big512(dev)
    phase_profile_baseline(dev)
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
                      + ring["fir_launches"] + baseline["launches"]
                      + legacy["launches"]),
         "launches_legacy": legacy["launches"],
         "legacy_shapes": {sh: {k: v[k] for k in (
             "path", "kernel_ms", "call_ms", "plain_ms", "conv1d_ms",
             "bound_ms", "bound_by", "max_abs_err")}
             for sh, v in legacy["shapes"].items()},
         "launches_serving": launches_serve["fir_shift_accum"],
         "launches_training": launches_eq["fir_shift_accum"],
         "launches_dp_training": launches_mesh["fir_shift_accum"],
         "launches_halo": ring["fir_launches"],
         "launches_baseline": baseline["launches"],
         "launches_multiprocess": procs["fir_shift_accum"],
         **fir_line,
         **{f"baseline_shape_{k}": base_fir["baseline"][k] for k in (
             "rows", "outputs", "taps", "kernel_ms", "plain_ms",
             "conv1d_ms", "bound_ms", "bound_by", "max_abs_err")},
         "graph_ms_phase13_shape": base_fir["phase 13"]["kernel_ms"]},
        {"name": "ring_exchange", "route": "cuda",
         "source": "dl_ofdm_tpu_torch/csrc/ring_exchange.cu",
         "replaces": "dl_ofdm_tpu/parallel/halo.py:62",
         **{k: v for k, v in ring.items() if k != "fir_launches"},
         **procs["ring"], "check": "pass"}]
    kernels[0].update(
        launches_equalizer_serving=launches_serve["complex_dense"],
        launches_equalizer_training=launches_eq["complex_dense"],
        launches_bf16=big["launches_bf16"],
        launches_bf16_cli=cli_run["launches_bf16"], **bf16["complex_dense"],
        launches_tp=tp_big["launches"],
        launches_multiprocess=procs["complex_dense"],
        launches_bf16_tp=tp_512["launches_bf16"],
        launches_tp_multiprocess=tp_procs["float32"],
        launches_bf16_tp_multiprocess=tp_procs["bf16"],
        tp_shapes={"x".join(map(str, sh["shape"])) + f" {sh['mode']}": {
            k: sh[k] for k in ("kernel_ms", "plain_ms", "library_ms",
                               "bound_ms", "bound_by")}
            for sh in (tp_big["shape"], tp_512["shape"])})
    big_set = adam["leaf_sets"]["nfft512"]
    kernels.append({
        "name": "fused_adam", "route": "cuda",
        "source": "dl_ofdm_tpu_torch/csrc/fused_adam.cu",
        "replaces": "none: optax's update, which XLA fuses on the TPU",
        "launches": launches_train["fused_adam"], "ms": big_set["kernel_ms"],
        "bound_ms": big_set["bound_ms"], "bound_by": "bytes",
        "library_ms": big_set["library_ms"],
        "foreach_ms": big_set["foreach_ms"],
        "leaf_sets": adam["leaf_sets"],
        "fused_step_1k_ms": adam["step_ms"], "check": "pass"})
    conv_9k = conv["shapes"][9362]
    kernels.append({
        "name": "complex_conv2d", "route": "cuda",
        "source": "dl_ofdm_tpu_torch/csrc/complex_conv2d.cu",
        "replaces": "none: XLA's conv on the TPU (cuDNN on the card)",
        "launches": conv["launches"], "ms": conv_9k["kernel_ms_total"],
        "bound_ms": 3 * conv_9k["bound_ms_a_pass"],
        "bound_by": "operations",
        "launches_by_pass": conv["launches_by_pass"],
        "plain_ms": conv_9k["plain_ms_total"],
        "library_ms": conv_9k["library_ms_total"],
        "shapes": conv["shapes"],
        "steps_bit_identical": conv["steps_bit_identical"],
        "check": "pass"})
    kernels.append({
        "name": "synth_chain", "route": "cuda",
        "source": "dl_ofdm_tpu_torch/csrc/synth_chain.cu",
        "replaces": "none: XLA's fusion of Trainer.synthesize on the TPU",
        "launches": chain["launches"],
        "launches_serving": launches_serve["synth_chain"],
        "launches_training": launches_eq["synth_chain"],
        "launches_dp_training": launches_mesh["synth_chain"],
        "launches_multiprocess": procs["synth_chain"],
        "ms": chain["ms"], "bound_ms": chain["bound_ms"],
        "bound_by": "bytes", "calls": chain["calls"], "check": "pass"})
    kernels.insert(1, {
        "name": "pack_stacked_weight", "route": "cuda",
        "source": "dl_ofdm_tpu_torch/csrc/complex_dense_bf16.cu",
        "replaces": "dl_ofdm_tpu/ops/pallas_kernels.py:80",
        "launches": big["launches_pack"],
        "launches_cli": cli_run["launches_pack"], **bf16["pack"],
        "launches_tp": tp_512["launches_pack"],
        "tp_shape": tp_512["shape"]["pack"]})

    # -- 5. kernels line and the result ---------------------------------------
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
