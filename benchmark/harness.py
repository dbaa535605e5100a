"""What every cell shares: the manifest and the files it names, seeds,
weights drawn from the seed, the checks that decide `correct`, the device
line and the result line."""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import subprocess
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# whole top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "dl_ofdm_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    """One workload of the manifest with the files it names."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list          # the manifest's metrics this cell reports
    per_layer: list


def cell(name: str, root: str = ROOT) -> Cell:
    """The manifest's workload `name` with its configuration, traffic and
    limits files (`benchmark/configs/`, `traffic/`, `limits/`)."""
    m = manifest(root)
    w = {x["name"]: x for x in m["workloads"]}.get(name)
    if w is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg = {c["name"]: c for c in m["configs"]}[w["config"]]
    e2e = [x for x in m["end_to_end"]
           if "workloads" not in x or name in x["workloads"]]
    per_layer = [x for x in m["per_layer"] if name in x["workloads"]]
    return Cell(name, w["chips"], load_json(os.path.join(root, cfg["file"])),
                load_json(os.path.join(BENCH_DIR, "traffic",
                                       w["traffic"] + ".json")),
                load_json(os.path.join(BENCH_DIR, "limits", name + ".json")),
                e2e, per_layer)


def per_second(marks: list) -> list[int]:
    """Work done in each whole second of a window, from (seconds since the
    window's start, work done so far) marks at each unit's end: how
    steady the rate was."""
    done, out, j = 0, [], 0
    for sec in range(1, int(marks[-1][0]) + 1 if marks else 1):
        while j < len(marks) and marks[j][0] <= sec:
            j += 1
        now = marks[j - 1][1] if j else 0
        out.append(now - done)
        done = now
    return out


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose, from the run's seed."""
    digest = hashlib.sha256(f"{seed}/{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def draw_weights(shapes: dict, seed: int, device):
    """Parameters of the DCCN's shapes from `seed`, on `device` in one
    draw: each kernel leaf a normal clipped at 2 std with flax's
    lecun_normal std, each bias zero."""
    import torch
    from benchmark.reference.dccn import lecun_scale
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device).clamp_(-2, 2)
    out, i = {}, 0
    for k, s in shapes.items():
        n = math.prod(s)
        out[k] = (flat[i:i + n] * lecun_scale(k, s)).reshape(s).contiguous()
        i += n
    return out


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def norm_gap(prog: dict, ref: dict, keys=None) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    keys = list(ref) if keys is None else list(keys)
    rn = {k: float(ref[k].double().norm()) for k in ref}
    med = sorted(rn.values())[len(rn) // 2]
    return max(abs(float(prog[k].double().norm()) - rn[k]) / max(rn[k], med)
               for k in keys)


def checks_of(readings: dict, limits: dict) -> list[Check]:
    return [Check(k, float(readings[k]), float(limits[k])) for k in limits]


def power_limit_w(index: int = 0):
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout.strip()
        return float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _gpu_clocks(index: int) -> dict:
    for reasons in ("clocks_event_reasons.active",
                    "clocks_throttle_reasons.active"):
        try:
            out = subprocess.run(
                ["nvidia-smi", f"--id={index}", "--format=csv,noheader,"
                 "nounits", "--query-gpu=clocks.sm,clocks.max.sm,"
                 f"power.draw,temperature.gpu,{reasons}"],
                capture_output=True, text=True, timeout=20)
        except (OSError, subprocess.SubprocessError):
            return {}
        if out.returncode == 0 and out.stdout.strip():
            v = [x.strip() for x in out.stdout.splitlines()[0].split(",")]
            return dict(zip(("sm_mhz", "max_sm_mhz", "power_w", "temp_c",
                             "clock_reasons"), v))
    return {}


class HostProbe:
    """What the host and the card did over a window, to tell the program's
    speed from the machine's: this process's CPU time over the window in
    cores (under 1 where it waited or was put off its core) and, read
    after the window, the card's clocks, power and the reasons its clocks
    are held down."""

    def __init__(self, device_index: int = 0):
        self.index = device_index
        self.start = (time.perf_counter(), _cpu_s())

    def read(self) -> dict:
        wall, cpu = time.perf_counter(), _cpu_s()
        out = {"own_cpu_cores": (cpu - self.start[1]) / (wall - self.start[0])}
        out.update(_gpu_clocks(self.index))
        return out


def _cpu_s() -> float:
    t = os.times()
    return t.user + t.system


def device_line(torch, count: int, peak_bytes: int, trace=None) -> dict:
    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
         "count": count, "memory_peak_bytes": int(peak_bytes),
         "power_limit_w": power_limit_w(0)}
    if trace is not None:
        d.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
    return d


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def emit(result: dict, checks: list[Check]) -> None:
    """The checks on standard error as its last lines, then the result as
    the last line of standard output, the checks under the last key."""
    for c in checks:
        print(f"check {c.name}: {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    result = dict(result)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    print(json.dumps(result), flush=True)
