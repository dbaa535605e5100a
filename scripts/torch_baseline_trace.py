#!/usr/bin/env python3
"""Where one batch of the port's classical receiver spends its time, on
one CUDA card, for two ways of solving its L x L systems.

    python scripts/torch_baseline_trace.py [--frames 2000] [--batches 5]

One LS-Quadeer batch (estimator 5: the CP-enhanced estimator, two
batched 32 x 32 real solves a symbol) on EVA at 10 dB,
`baselines.classical_rx.one_batch`, with `ops.cfloat.solve_iq` as the
package has it (`torch.linalg.solve_ex(..., check_errors=False)`) and
with an LU factorization and two triangular solves in its place
(`lu_trsm`: no status word of cuBLAS's `getrs` to read back), in turns
(package, lu_trsm, lu_trsm, package).  For each: ms a batch (host clock
around synchronized batches), then under `torch.profiler` the
device-busy ms a batch (the union of kernel intervals), the idle share
of the unprofiled ms, kernels a batch and the host's waits on the card
a batch.  Prints the card's name and power limit first and one JSON
line a run.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def lu_trsm_iq(a, b):
    """The block-real solve as an LU factorization with partial pivoting
    and two triangular solves."""
    import torch
    ar, ai = a[..., 0], a[..., 1]
    big = torch.cat([torch.cat([ar, -ai], dim=-1),
                     torch.cat([ai, ar], dim=-1)], dim=-2)
    rhs = torch.cat([b[..., 0], b[..., 1]], dim=-1)[..., None]
    lu, piv, _ = torch.linalg.lu_factor_ex(big)
    p, low, up = torch.lu_unpack(lu, piv)
    y = torch.linalg.solve_triangular(low, p.mT @ rhs, upper=False,
                                      unitriangular=True)
    sol = torch.linalg.solve_triangular(up, y, upper=True)[..., 0]
    n = a.shape[-2]
    return torch.stack([sol[..., :n], sol[..., n:]], dim=-1)


def busy_ms(kernels) -> float:
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return (total + (cur_e - cur_s if cur_e is not None else 0.0)) / 1e3


def run(route: str, frames: int, batches: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dl_ofdm_tpu_torch.baselines import classical_rx as crx
    from dl_ofdm_tpu_torch.baselines import cp_enhanced
    from dl_ofdm_tpu_torch.baselines.matlab_link import MatlabLink
    from dl_ofdm_tpu_torch.config import OFDMConfig
    from dl_ofdm_tpu_torch.ofdm.plan import build_plan
    from dl_ofdm_tpu_torch.ops import cfloat
    dev = torch.device("cuda")
    plan = build_plan(OFDMConfig())
    link = MatlabLink(plan, 2, "EVA", device=dev)
    ctx = crx.get_context(plan, "EVA", dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    package = cfloat.solve_iq
    cp_enhanced.cfloat.solve_iq = lu_trsm_iq if route == "lu_trsm" \
        else package
    try:
        with crx.full_float32():
            def batch():
                return crx.one_batch(link, ctx, 5, None, 10.0, 1.0, frames,
                                     gen)
            batch()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(batches):
                batch()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3 / batches
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(batches):
                    batch()
                torch.cuda.synchronize()
    finally:
        cp_enhanced.cfloat.solve_iq = package
    events = prof.events()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise SystemExit("the profiler saw no kernel on the card")
    busy = busy_ms(kernels) / batches
    return {"route": route, "frames": frames, "ms_per_batch": ms,
            "busy_ms_per_batch": busy, "idle_share": 1 - busy / ms,
            "kernels_per_batch": len(kernels) / batches,
            "host_waits_per_batch": {
                n: sum(e.name == n for e in events) / batches
                for n in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                          "cudaMemcpyAsync")}}


def main() -> None:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=2000)
    ap.add_argument("--batches", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_baseline_trace.py times the card; there is "
                         "no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    for route in ("package", "lu_trsm", "lu_trsm", "package"):
        print(json.dumps(run(route, args.frames, args.batches)), flush=True)


if __name__ == "__main__":
    main()
