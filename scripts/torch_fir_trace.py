#!/usr/bin/env python3
"""What holds the FIR kernel back, on one GPU: its copies or its arithmetic.

    python scripts/torch_fir_trace.py [--frames 30000] [--length 560]
        [--taps 13]

Builds three copies of `dl_ofdm_tpu_torch/csrc/fir_shift_accum.cu` beside
the real library (in the ignored build directory): `copy_only` stages
every unit's rows and taps but computes and stores nothing; `compute_only`
stages the first units only and computes and stores every unit from them
(wrong values, the real arithmetic and stores); `contracted` folds each
tap's multiply and add into FMAs (not bit-equal to the plain version: it
shows what the rounded operations cost).  Times the real kernel and each
copy through the wrapper (`fir_shift_accum_kernel`) on the same random
planes, by CUDA events around a CUDA graph of 50 calls, the least of three
rounds over the four in turn, beside the bytes bound at the card's
published HBM rate.  Prints one JSON line a variant and a summary with the
card's name and power limit.  The source keeps no switches: the copies are
made by replacing the lines named in `CUTS`.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# variant -> (line of the source, its replacement)
CUTS = {
    "copy_only": [(
        "    if (active && b < a.B && un.n0 + V * g < L && V * g < a.tile) {",
        "    if (a.B < 0) {")],
    "compute_only": [(
        "    if (ahead < units)\n      issue_unit(",
        "    if (ahead < 0)\n      issue_unit(")],
    "contracted": [(
        "            accr[v] = __fsub_rn(__fadd_rn(accr[v], __fmul_rn(s_r, "
        "hr[kk])),\n                                __fmul_rn(s_i, hi[kk]));\n"
        "            acci[v] = __fadd_rn(__fadd_rn(acci[v], __fmul_rn(s_r, "
        "hi[kk])),\n                                __fmul_rn(s_i, hr[kk]));",
        "            accr[v] = fmaf(-s_i, hi[kk], fmaf(s_r, hr[kk], accr[v]));"
        "\n            acci[v] = fmaf(s_i, hr[kk], fmaf(s_r, hi[kk], "
        "acci[v]));")],
}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=30000)
    p.add_argument("--length", type=int, default=560)
    p.add_argument("--taps", type=int, default=13)
    p.add_argument("--iters", type=int, default=50)
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_fir_trace.py: no CUDA device")
    sys.path.insert(0, ROOT)
    from dl_ofdm_tpu_torch.ops import cuda_build
    from dl_ofdm_tpu_torch.ops import pallas_kernels as tpk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    with open(os.path.join(cuda_build.CSRC_DIR, "fir_shift_accum.cu")) as f:
        src = f.read()
    work = os.path.join(cuda_build.BUILD_DIR,
                        f"fircuts-{cuda_build.source_digest('fir_shift_accum')}")
    os.makedirs(work, exist_ok=True)
    jobs = []
    for name, cuts in CUTS.items():
        text = src
        for old, new in cuts:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer has "
                                   f"{old!r}")
            text = text.replace(old, new)
        cu, so = (os.path.join(work, f"{name}{ext}") for ext in (".cu", ".so"))
        with open(cu, "w") as f:
            f.write(text)
        jobs.append((name, so, subprocess.Popen(
            [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    real = tpk._fir_lib()
    for name, _, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")

    b, l, f = args.frames, args.length, args.taps
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    xa = [torch.randn(b, l + f - 1, device=dev, generator=gen)
          for _ in range(2)]
    h = [torch.randn(b, f, device=dev, generator=gen) for _ in range(2)]
    ref = tpk.fir_shift_accum_ref(*xa, *h, l)

    def graph_of(lib):
        tpk._fir_lib = lambda: lib
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                tpk.fir_shift_accum_kernel(*xa, *h, l)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(args.iters):
                out = tpk.fir_shift_accum_kernel(*xa, *h, l)
        return graph, out

    todo = []
    for name, so in [("kernel", None)] + [(n, s) for n, s, _ in jobs]:
        lib = real
        if so is not None:
            lib = ctypes.CDLL(so)
            for k in ("fir_shift_accum_f32", "fir_shift_accum_blocks_per_sm"):
                getattr(lib, k).argtypes = getattr(real, k).argtypes
                getattr(lib, k).restype = getattr(real, k).restype
        todo.append((name,) + graph_of(lib))
    best = {}
    for _ in range(3):
        for name, graph, _ in todo:
            graph.replay()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / args.iters
            best[name] = min(best.get(name, ms), ms)
    n_bytes = 4 * (2 * b * (l + f - 1) + 2 * b * f + 2 * b * l)
    bound = n_bytes / 3.35e12 * 1e3
    for name, _, out in todo:
        print(json.dumps({"variant": name, "ms": best[name],
                          "bit_equal": bool(torch.equal(out[0], ref[0])
                                            and torch.equal(out[1], ref[1]))}),
              flush=True)
    print(json.dumps({"frames": b, "length": l, "taps": f, "card": smi,
                      "timing": f"CUDA graph of {args.iters} calls, the "
                      "least of 3 rounds", "bytes": n_bytes,
                      "bound_ms_at_3.35TBps": bound, "ms": best,
                      "share_of_bound": bound / best["kernel"]}), flush=True)


if __name__ == "__main__":
    main()
