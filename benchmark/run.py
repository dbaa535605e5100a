"""Run one cell of the benchmark of the PyTorch/CUDA port on the card(s) of
this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  `--trace 0` prints the cell's end-to-end
metrics, `--trace 1` its per-layer metrics, read from a `torch.profiler`
trace of the window.  The last line of standard output is the result
(`correct`, `attempted`, `failed`, `metrics`, `device`, with `--trace 1`
`breakdown`, then `checks`: each number compared with its limit); the
checks are also the last lines of standard error.  Without a CUDA card (or
with fewer than the cell asks for) it exits with code 2 and prints no
result.  Build and kernel caches stay inside the checkout.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
CACHE = os.path.join(ROOT, "benchmark", "_cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)


def layer_metric(name: str, run) -> float | None:
    path = os.path.join(ROOT, "benchmark", "layer_metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.layer_metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START, mode: str = "program",
             fault: str | None = None) -> tuple[dict, list]:
    """(result, checks) of one run of `cell` on `device` (for a cell of
    several cards, rank 0's card); `mode` 'control' puts the reference in
    fp8 in the program's place, `fault` plants one of `benchmark/faults.py`
    under the timed path."""
    import torch
    from benchmark import harness
    from benchmark.trace import Trace
    tr = Trace(trace, device.index or 0)
    if device.type == "cuda":
        # every kernel library at once (nvcc in parallel) into the
        # checkout's build directory; a later run finds them built
        from dl_ofdm_tpu_torch.ops import cuda_build
        cuda_build.build_all()
    driver = importlib.import_module(
        f"benchmark.drivers.{cell.traffic['kind']}")
    out = driver.run(cell, seed, seconds, tr, device, t_start, mode, fault)
    checks = harness.checks_of(out["readings"], cell.limits)
    if mode != "program":
        return out, checks
    print(json.dumps({"cell": cell.name, "seed": seed, "counts": {
        k: out[k] for k in ("steps", "calls", "attempted", "failed")
        if k in out}, "window_s": out["window_s"],
        "reference_s": out["reference_s"], "host": tr.host,
        "readings": out["readings"],
        **{k: out[k] for k in ("loss", "ber", "steps_per_s", "calls_per_s")
           if k in out}}), flush=True)
    metrics = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        view = types.SimpleNamespace(trace=tr, **out["layer"])
        for m in cell.per_layer:
            v = layer_metric(m["name"], view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    result = {"correct": all(c.ok for c in checks),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics}
    if device.type == "cuda":
        busy = out.get("busy_s")
        result["device"] = harness.device_line(
            torch, cell.chips, out["peak_bytes"],
            {"busy_s": tr.busy_s() if busy is None else busy,
             "window_s": tr.window_s} if trace else None)
    else:
        result["device"] = {"platform": "cpu", "count": 1}
    if trace:
        result["breakdown"] = {"device_ops": tr.top_device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from benchmark import harness
    cell = harness.cell(args.workload)
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine "
              f"has {cards}", file=sys.stderr)
        return 2
    if "H100" not in torch.cuda.get_device_name(0):
        print(f"{cell.name} measures an H100; this card is "
              f"{torch.cuda.get_device_name(0)}", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    result, checks = run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), dev)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"the run loaded {bad}: the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
