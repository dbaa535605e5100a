"""Where the time of the port's interleaved BER sweep goes, on one GPU.

Runs `calls` interleaved sweep batches of the committed 16QAM arm
(`runs/arms/OFDM_Dense3_4mod_snr20_cpTrue.npz`, AWGN, 41 SNR points, 1968
frames a call) through `dl_ofdm_tpu_torch.eval.sweep.eval_batch` under
`torch.profiler`, after a warm-up, and prints one JSON object: wall ms per
call, device-busy ms per call (the union of kernel intervals), the idle
share, and the kernels with the most device time.  `--trace PATH` also
writes the Chrome trace there.

    python scripts/torch_sweep_trace.py [--calls 20] [--trace trace.json]

Needs a CUDA device; imports no JAX.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig  # noqa: E402
from dl_ofdm_tpu_torch.eval.sweep import eval_batch, interleaved_groups  # noqa: E402
from dl_ofdm_tpu_torch.train.checkpoint import (load_params_npz,  # noqa: E402
                                                params_from_flax)
from dl_ofdm_tpu_torch.train.loop import Trainer  # noqa: E402

ARM = os.path.join(ROOT, "runs", "arms", "OFDM_Dense3_4mod_snr20_cpTrue.npz")


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--trace", default=None,
                    help="write the Chrome trace to this path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_sweep_trace.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    trainer = Trainer(OFDMConfig(nbits=4), TrainConfig(), channel="AWGN")
    trainer.model.load_state_dict(params_from_flax(load_params_npz(ARM)))
    snr_vec, onehot = interleaved_groups(list(range(-10, 31)), 2000,
                                         trainer.device)
    gen = torch.Generator(device=trainer.device).manual_seed(0)
    for _ in range(5):
        eval_batch(trainer, snr_vec, onehot, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.calls):
            eval_batch(trainer, snr_vec, onehot, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.calls
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = busy_us(kernels) / 1e3 / args.calls
    by_name = {}
    for e in kernels:
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    if args.trace:
        prof.export_chrome_trace(args.trace)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "calls": args.calls,
        "frames_per_call": int(snr_vec.shape[0]),
        "wall_ms_per_call": wall_ms,
        "device_busy_ms_per_call": busy_ms if kernels else None,
        "idle_share": 1 - busy_ms / wall_ms if kernels else None,
        "kernels_per_call": len(kernels) / args.calls,
        "top_kernels_us_per_call": [
            [name[:80], tot / args.calls, n / args.calls]
            for name, (tot, n) in top]}))


if __name__ == "__main__":
    main()
