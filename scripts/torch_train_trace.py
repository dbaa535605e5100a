"""Where the time of the port's training step goes, on one GPU.

Runs `steps` training steps of `bench.py`'s configuration (nbits 1, ETU,
SNR 5 dB, `TrainConfig(batch_size=frames * 7)`) through
`dl_ofdm_tpu_torch.train.loop.Trainer.train_step` under `torch.profiler`,
after 3 warm-up steps, and prints one JSON object: wall ms per step,
device-busy ms per step (the union of kernel intervals), the idle share,
and the kernels with the most device time.  `--route autograd` profiles
the autograd route instead of the fused one; `--channel` and `--mobile`
pick the channel (`--channel mixRayleigh --mobile` is the mobile cell);
`--trace PATH` also writes the Chrome trace there.

    python scripts/torch_train_trace.py [--frames 9362] [--steps 20]
        [--route fused|autograd] [--channel ETU] [--mobile]
        [--trace trace.json]

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
from dl_ofdm_tpu_torch.train.loop import Trainer  # noqa: E402
from torch_sweep_trace import busy_us  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=9362)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--route", choices=("fused", "autograd"),
                    default="fused")
    ap.add_argument("--channel", default="ETU")
    ap.add_argument("--mobile", action="store_true",
                    help="Jakes Doppler on the channel's Doppler frames")
    ap.add_argument("--trace", default=None,
                    help="write the Chrome trace to this path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_train_trace.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    tr = Trainer(OFDMConfig(nbits=1), TrainConfig(batch_size=args.frames * 7),
                 channel=args.channel, mobile=args.mobile)
    fused = args.route == "fused"
    gen = torch.Generator(device=tr.device).manual_seed(0)
    state = tr.init_state(gen)
    snr = torch.full((tr.batch_frames,), 5.0, device=tr.device)
    for _ in range(3):
        state, _ = tr.train_step(state, gen, snr, fused=fused)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, _ = tr.train_step(state, gen, snr, fused=fused)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = busy_us(kernels) / 1e3 / args.steps
    by_name = {}
    for e in kernels:
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    if args.trace:
        prof.export_chrome_trace(args.trace)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "route": args.route,
        "channel": args.channel, "mobile": args.mobile,
        "frames": tr.batch_frames, "steps": args.steps,
        "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms if kernels else None,
        "idle_share": 1 - busy_ms / wall_ms if kernels else None,
        "kernels_per_step": len(kernels) / args.steps,
        "top_kernels_us_per_step": [
            [name[:80], tot / args.steps, n / args.steps]
            for name, (tot, n) in top]}))


if __name__ == "__main__":
    main()
