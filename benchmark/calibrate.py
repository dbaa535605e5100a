"""Read the numbers that decide a cell's `correct` over many seeds in one
process, for the program and for the control (the reference in fp8 put in
the program's place), at the cell's own size: the readings that the
cell's limits (`benchmark/limits/<cell>.json`) are set between.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1-12 \
        --control-seeds 101-103 [--seconds 0.5]

Each seed gives one JSON line; the last line holds each number's largest
program reading and smallest control reading.  The program's runs go
through the cell's whole run (set-up, a window of `--seconds`, the
check), on a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# added to every seed: large seeds, apart from the runs' own
SEED_OFFSET = 2 ** 32


def seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--seconds", type=float, default=0.5)
    ap.add_argument("--fault", default=None,
                    help="a fault of benchmark/faults.py planted under the "
                         "program's runs")
    args = ap.parse_args(argv)
    import torch
    from benchmark import harness
    from benchmark.run import run_cell
    if not torch.cuda.is_available():
        print("calibrate.py runs on a CUDA card", file=sys.stderr)
        return 2
    cell = harness.cell(args.workload)
    dev = torch.device("cuda", 0)
    worst, least = {}, {}
    for mode, group in (("program", args.seeds),
                        ("control", args.control_seeds)):
        for s in group:
            t = time.perf_counter()
            out, checks = run_cell(
                cell, s + SEED_OFFSET, args.seconds, False, dev, t_start=t,
                mode=mode, fault=args.fault if mode == "program" else None)
            r = {c.name: c.value for c in checks}
            for k, v in r.items():
                if mode == "program":
                    worst[k] = max(worst.get(k, 0.0), v)
                else:
                    least[k] = min(least.get(k, float("inf")), v)
            print(json.dumps({"mode": mode, "fault": args.fault,
                              "seed": s + SEED_OFFSET,
                              "readings": r,
                              "seconds": time.perf_counter() - t}),
                  flush=True)
    print(json.dumps({"cell": cell.name, "program_max": worst,
                      "control_min": least,
                      "kind": torch.cuda.get_device_name(0),
                      "power_limit_w": harness.power_limit_w(0)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
