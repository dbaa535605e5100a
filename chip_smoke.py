#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`dl_ofdm_tpu_torch`) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases, each printed with its elapsed seconds:

 1. device: torch and CUDA versions, the card's name and power limit
    (nvidia-smi); TF32 off for matmuls and cuDNN.
 2. build: every CUDA kernel of the port, compiled by nvcc from the
    checkout's sources (`dl_ofdm_tpu_torch/ops/cuda_build.py`).
 3. kernel against its plain version: `complex_dense` at the sweep's shape
    (M = 1968*7, K = 80, F = 64) and at a ragged one, atol = rtol = 1e-5
    (float32 with reordered sums); its device time (CUDA graph replay), the
    plain version's, one PyTorch call's (complex64 matmul), the card's
    bound for the work, and each one's time when launched from Python.
 4. serving path at full width: the committed 16QAM arm
    (`runs/arms/OFDM_Dense3_4mod_snr20_cpTrue.npz`) through `ber_sweep` on
    the AWGN channel, SNR -10..30 dB, 20,000 frames per point, 2,000-frame
    batches:
      a. the interleaved protocol (416 calls of 1968 frames), held against
         the JAX package's own interleaved curve (`JAX_INTERLEAVED_BER`);
         the kernel's launch count must equal the number of calls;
      b. the point_batch protocol (410 calls of 2000 frames), held against
         the committed CSV `runs/Test_DCCN_OFDM_Dense3_4mod_snr20_cpTrue_AWGN.csv`.
 5. one `{"kernels": [...]}` line, then as the last line
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


def check_curve(name, ber, ref, ref_name):
    """|BER/ref - 1| <= 5% where ref >= 1e-3, else BER <= 3 ref + 1e-6."""
    bad = []
    for snr, b, r in zip(SNRS, ber, ref):
        if r >= 1e-3:
            ok = abs(b / r - 1.0) <= 0.05
            rule = f"ratio {b / r:.4f}"
        else:
            ok = b <= 3 * r + 1e-6
            rule = f"<= {3 * r + 1e-6:.3g}"
        log(f"  {name} SNR {snr:+3d} dB: BER {b:.6g}  {ref_name} {r:.6g}  "
            f"{rule}{'' if ok else '  FAIL'}")
        if not ok:
            bad.append(snr)
    if bad:
        raise AssertionError(f"{name} sweep misses {ref_name} at SNR {bad}")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; it runs the port "
                         "on an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.eval.sweep import ber_sweep
    from dl_ofdm_tpu_torch.ops import cuda_build
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
    for m, k, f in ((1968 * 7, 80, 64), (1001, 77, 50)):
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

    m, k, f = 1968 * 7, 80, 64
    x, wr, wi, err = checks[(m, k, f)]
    x_c = torch.view_as_complex(x)
    w_c = torch.complex(wr, wi)
    with torch.no_grad():
        runs = {"plain": lambda: complex_dense_ref(x, wr, wi),
                "kernel": lambda: complex_dense_kernel(x, wr, wi),
                "library": lambda: torch.matmul(x_c, w_c)}
        times = {n: [] for n in runs}
        for n in ("plain", "kernel", "library", "library", "kernel", "plain"):
            times[n].append(time_ms(runs[n]))
    ms = {n: sum(t[0] for t in v) / len(v) for n, v in times.items()}
    eager_ms = {n: sum(t[1] for t in v) / len(v) for n, v in times.items()}
    n_bytes = 4 * (2 * m * k + 2 * k * f + 2 * m * f)
    n_flops = 8 * m * k * f
    t_bytes, t_ops = n_bytes / hbm_bps * 1e3, n_flops / f32_flops * 1e3
    bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
    print(json.dumps({
        "kernel": "complex_dense", "shape": [m, k, f], "kernel_ms": ms["kernel"],
        "plain_ms": ms["plain"], "library_ms": ms["library"],
        "eager_ms": eager_ms, "timing": "CUDA graph of 100 calls",
        "bytes": n_bytes, "flops": n_flops, "bound_ms": bound_ms,
        "bound_by": bound_by, "peaks_of": peak_key}), flush=True)

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
        "point_batch_seconds": results["point_batch"][1],
        "point_batch_frames_per_s":
            results["point_batch"][2] / results["point_batch"][1]}),
        flush=True)

    # -- 5. kernels line and the result ---------------------------------------
    print(json.dumps({"kernels": [{
        "name": "complex_dense", "route": "cuda",
        "source": "dl_ofdm_tpu_torch/csrc/complex_dense.cu",
        "replaces": "dl_ofdm_tpu/ops/pallas_kernels.py:80",
        "launches": launches["interleaved"], "max_abs_err": err,
        "ms": ms["kernel"], "plain_ms": ms["plain"],
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": ms["library"], "check": "pass"}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
