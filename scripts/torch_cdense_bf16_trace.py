#!/usr/bin/env python3
"""What sets the pace of `complex_dense`'s bf16 GEMM, on one GPU: moving
its operands or its tensor-core work; and what its float32 sums a k tile
buy.

    python scripts/torch_cdense_bf16_trace.py [--shapes 6944x640x512 ...]

Builds four copies of `dl_ofdm_tpu_torch/csrc/complex_dense_bf16.cu`
beside the real library (in the ignored build directory): `no_mma` issues
no wgmma (the x and W_s tiles still arrive by TMA and the consumers still
load and round their A fragments); `no_a_loads` loads no A fragment from
the x tiles (constant A registers; the tiles still arrive, the wgmmas
run); `w_only` brings no x tile at all (the W_s tiles and the wgmmas
only); `tc_sums` keeps each output's sum in the tensor cores over all of
K instead of adding each 64-deep k tile's partial sums in float32.  The
first three compute wrong values.  Times the real GEMM and each copy, the
GEMM launch alone on a weight packed once, at each shape by CUDA events
around a CUDA graph of `--iters` calls, the least of three rounds over
the five in turn; prints each one's largest error against float64 sums
of the bf16-rounded operands beside the plain version's, checks the real
kernel (pack and GEMM) against the plain version (atol = rtol = 1e-5),
and prints the operand bytes the SMs pull from L2 for the call (x once
for each N tile, W_s once for each M tile).  Prints one JSON line a
shape and variant, and a summary with the card's name and power limit.
The source keeps no switches: the copies are made by replacing the lines
named in `CUTS`.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WGMMA = "        wgmma_rs(acc, a[kk], b_desc(sb + kk * 32), kk == 0);"
_A_LOAD = """          const float2 v = *reinterpret_cast<const float2*>(
              sa + a_offset(rw + 8 * (h & 1), 16 * kk + cq + 8 * (h >> 1)));
          a[kk][h] = bf16x2(v.x, v.y);"""
_X_TMA = """            tma_2d(&xmap, sa, bar, kt * BK, m0);
            tma_2d(&xmap, sa + A_BOX, bar, kt * BK + 32, m0);"""
_X_BYTES = '"r"(TMA_A ? STAGE_BYTES : B_BYTES)'
_PROMOTE = """#pragma unroll
        for (int i = 0; i < 64; ++i) tot[i] += acc[i];
        if (lane == 0)"""

# variant -> [(text of the source, its replacement)]
CUTS = {
    "no_mma": [(_WGMMA, "        if (n_tiles < 0)\n  " + _WGMMA)],
    "no_a_loads": [(_A_LOAD, "          a[kk][h] = 0x3F803F80u + kk + h;"
                    "\n          (void)sa;")],
    "w_only": [(_A_LOAD, "          a[kk][h] = 0x3F803F80u + kk + h;"
                "\n          (void)sa;"),
               (_X_TMA, ""), (_X_BYTES, '"r"(B_BYTES)')],
    "tc_sums": [(_WGMMA, _WGMMA.replace("kk == 0)", "kk == 0 && kt == 0)")),
                (_PROMOTE, "        if (lane == 0)")],
}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--shapes", nargs="+",
                   default=["6944x640x512", "511x640x512", "3584x640x512",
                            "370x5000x64"])
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_cdense_bf16_trace.py: no CUDA device")
    sys.path.insert(0, ROOT)
    from dl_ofdm_tpu_torch.ops import cuda_build
    from dl_ofdm_tpu_torch.ops import pallas_kernels as tpk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    with open(os.path.join(cuda_build.CSRC_DIR, "complex_dense_bf16.cu")) as f:
        src = f.read()
    work = os.path.join(
        cuda_build.BUILD_DIR,
        f"cdbcuts-{cuda_build.source_digest('complex_dense_bf16')}")
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
    real = tpk._cdb_lib()
    libs = {"kernel": real}
    for name, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(so)
        lib.cd_bf16_gemm.argtypes = real.cd_bf16_gemm.argtypes
        lib.cd_bf16_gemm.restype = real.cd_bf16_gemm.restype
        libs[name] = lib

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    summary = {}
    for shape in args.shapes:
        m, k, f = map(int, shape.split("x"))
        x = torch.randn(m, k, 2, device=dev, generator=gen)
        wr, wi = (torch.randn(k, f, device=dev, generator=gen) / k ** 0.5
                  for _ in range(2))
        with torch.no_grad():
            ok = torch.allclose(tpk.complex_dense_kernel(x, wr, wi,
                                                         "bfloat16"),
                                tpk.complex_dense_ref(x, wr, wi, "bfloat16"),
                                atol=1e-5, rtol=1e-5)
            xb, rb, ib = (tpk.bf16_round(t_).double() for t_ in (x, wr, wi))
            y64 = torch.stack([xb[..., 0] @ rb - xb[..., 1] @ ib,
                               xb[..., 0] @ ib + xb[..., 1] @ rb], -1)
            plain_err = float((tpk.complex_dense_ref(x, wr, wi, "bfloat16")
                               .double() - y64).abs().max())
        ws = tpk.pack_stacked_weight_kernel(wr, wi)
        plan = tpk.complex_dense_bf16_plan(m, k, f, tpk._sm_count(0))
        if not plan.tma_x:
            raise SystemExit(f"{shape}: odd K takes the cp.async path; the "
                             "cuts are of the TMA path")
        xmap = tpk._tensor_map(x.data_ptr(), False, 2 * k, m, 8 * k, 32,
                               tpk.CDB_BM)
        wmap = tpk._tensor_map(ws.data_ptr(), True, plan.ldk, 2 * f,
                               2 * plan.ldk, tpk.CDB_BK, tpk.CDB_BN)
        y = torch.empty(m, f, 2, device=dev)

        def graph_of(lib):
            def call():
                err = lib.cd_bf16_gemm(
                    xmap, wmap, x.data_ptr(), y.data_ptr(), m, 2 * k, 2 * f,
                    1, plan.grid, plan.smem_bytes,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                call()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(args.iters):
                    call()
            return graph

        graphs, errs = {}, {}
        for name, lib in libs.items():
            graphs[name] = graph_of(lib)
            graphs[name].replay()
            torch.cuda.synchronize()
            errs[name] = float((y.double() - y64).abs().max())
        best = {}
        for _ in range(3):
            for name, graph in graphs.items():
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
        l2_bytes = (plan.n_tiles * m * 8 * k
                    + plan.m_tiles * 2 * f * plan.ldk * 2)
        for name, ms in best.items():
            print(json.dumps({"shape": [m, k, f], "variant": name, "ms": ms,
                              "float64_max_abs_err": errs[name],
                              "l2_to_sm_tb_per_s": l2_bytes / ms / 1e9}),
                  flush=True)
        summary[shape] = {"kernel_matches_plain": ok, "ms": best,
                          "float64_max_abs_err": errs,
                          "plain_float64_max_abs_err": plain_err,
                          "l2_to_sm_bytes": l2_bytes,
                          "tiles": plan.tiles, "grid": plan.grid}
    print(json.dumps({"card": smi, "timing": f"CUDA graph of {args.iters} "
                      "GEMM launches, the least of 3 rounds",
                      "shapes": summary}), flush=True)


if __name__ == "__main__":
    main()
