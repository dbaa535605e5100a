#!/usr/bin/env python3
"""Where the fused synthesize kernel's time goes, stage by stage, on one GPU.

    python scripts/torch_synth_stage_trace.py [--root DIR] [--frames N]
        [--channel ETU] [--mobile] [--exit return|continue]

The kernel's source (`<root>/dl_ofdm_tpu_torch/csrc/fused_synth.cu`) marks
each stage with a comment line `// --- <n>. <name>`.  For every marker the
script writes a copy of the source that leaves the kernel just before that
stage (after a store that keeps the earlier stages' shared-memory results
alive), builds each copy with nvcc beside the real library, and times the
real wrapper (`<root>/dl_ofdm_tpu_torch/ops/fused_synth.py`) on each copy
by CUDA events around a CUDA graph of 50 calls (device time: the wrapper's
host cost is out of it), the least of three rounds over the copies in
turn, at `--frames` frames of the channel's spec.  A stage's time is the difference between the copies that
stop after and before it; the last line is the whole kernel.  `--exit
continue` leaves a stage by `continue` in place of `return`, for a kernel
whose stages run inside a loop over row groups.  The copies exist only in
the ignored build directory; the source keeps no stage switches.

Prints one JSON line a variant and one summary line, with the card's name
and power limit.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

MARK = re.compile(r"^(\s*)// --- (\d+)\. (.*)$")


def variants(src: str, exit_stmt: str):
    """(stage number, stage name, source that leaves before the stage)."""
    lines = src.splitlines(keepends=True)
    out = []
    for i, line in enumerate(lines):
        m = MARK.match(line)
        if not m:
            continue
        ind = m.group(1)
        # a store on data the earlier stages wrote keeps their work alive
        sink = (f"{ind}if (threadIdx.x == 0 && "
                f"reinterpret_cast<volatile float*>(smem)[0] == 1.2345e-30f)"
                f" a.stats[0] = reinterpret_cast<float*>(smem)[1];\n"
                f"{ind}{exit_stmt};\n")
        out.append((int(m.group(2)), m.group(3).strip(),
                    "".join(lines[:i]) + sink + "".join(lines[i:])))
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    p.add_argument("--frames", type=int, default=9362)
    p.add_argument("--channel", default="ETU")
    p.add_argument("--mobile", action="store_true")
    p.add_argument("--exit", default="return", choices=("return", "continue"))
    p.add_argument("--iters", type=int, default=50)
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_synth_stage_trace.py: no CUDA device")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.ops import cuda_build
    from dl_ofdm_tpu_torch.ops import fused_synth as tfs
    from dl_ofdm_tpu_torch.train.loop import Trainer
    assert cuda_build.PKG_DIR == os.path.join(root, "dl_ofdm_tpu_torch")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    with open(os.path.join(cuda_build.CSRC_DIR, "fused_synth.cu")) as f:
        src = f.read()
    work = os.path.join(cuda_build.BUILD_DIR,
                        f"stages-{cuda_build.source_digest('fused_synth')}")
    os.makedirs(work, exist_ok=True)
    jobs = []
    for n, name, text in variants(src, args.exit):
        cu = os.path.join(work, f"stage{n}.cu")
        so = os.path.join(work, f"stage{n}.so")
        with open(cu, "w") as f:
            f.write(text)
        cmd = [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-I",
               cuda_build.CSRC_DIR, "-o", so, cu]
        jobs.append((n, name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    real = tfs._synth_lib()        # builds the whole kernel
    for n, _, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for stage {n}:\n{log}")
    fns = [k for k, v in vars(real).items()
           if isinstance(v, ctypes._CFuncPtr)]

    tr = Trainer(OFDMConfig(nbits=1), TrainConfig(), channel=args.channel,
                 mobile=args.mobile, device="cpu")
    spec = tr._fused_synth_spec
    dev = torch.device("cuda")
    seeds = torch.tensor([0x1234ABCD, 0x9E3779B9], dtype=torch.int64,
                         device=dev)
    std = tfs.noise_std(torch.full((args.frames,), 5.0, device=dev))

    def graph_of(lib):
        """`iters` calls of the wrapper on `lib`, captured in one graph."""
        tfs._synth_lib = lambda: lib
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                tfs.fused_synthesize_kernel(spec, seeds, std)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(args.iters):
                tfs.fused_synthesize_kernel(spec, seeds, std)
        return graph

    def device_ms(graph) -> float:
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.iters

    todo = []
    for n, name, so, _ in jobs + [(None, "whole kernel", None, None)]:
        lib = real
        if so is not None:
            lib = ctypes.CDLL(so)
            for k in fns:
                getattr(lib, k).argtypes = getattr(real, k).argtypes
                getattr(lib, k).restype = getattr(real, k).restype
        todo.append((n, name.rstrip(" -"), graph_of(lib)))
    best = {}
    for _ in range(3):                  # rounds over every variant in turn
        for n, name, graph in todo:
            ms = device_ms(graph)
            best[n] = min(best.get(n, ms), ms)
    rows = []
    for n, name, _ in todo:
        row = {"leaves_before": n, "stage": name, "ms": best[n]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    stages = {}
    for a, b in zip(rows, rows[1:]):
        stages[a["stage"]] = b["ms"] - a["ms"]
    print(json.dumps({"root": root, "channel": args.channel,
                      "mobile": args.mobile, "frames": args.frames,
                      "card": smi, "timing": f"CUDA graph of {args.iters} "
                      "calls, the least of 3 rounds",
                      "setup_ms": rows[0]["ms"], "stage_ms": stages,
                      "whole_ms": rows[-1]["ms"]}), flush=True)


if __name__ == "__main__":
    main()
