"""Quality probe of the port's random words (Philox4x32-10).

Port of `scripts/prng_quality_check.py` (the TPU kernel `kernel`,
`pallas_call` at `:42`).  The JAX script drew raw words of the TPU's
hardware PRNG with the fused synthesize kernel's per-block seeding; this
probe draws raw words of the port's Philox4x32-10 with the layout of
`csrc/fused_synth.cu` (key = two seed words, counter = (j / 4, stream, row,
0), word j = lane j % 4) and applies the script's checks:

  * the low bit's mean, and its serial correlation within each stream
    (|r| < 4.5 sigma);
  * bit agreement between every pair of streams, |p - 0.5| < max(0.002,
    9 Monte Carlo sigma);
  * word collisions between streams at the same position (at most 1e-3).

`probe_words_kernel` launches `csrc/philox_probe.cu` and counts its
launches; its plain version is `ops.fused_synth.philox_words`, which the
kernel's words must equal bit for bit.

    python -m dl_ofdm_tpu_torch.ops.prng_probe          # on the card
"""
from __future__ import annotations

import ctypes
import functools
import itertools
import json
import sys

import numpy as np
import torch

from dl_ofdm_tpu_torch import resolve_device
from dl_ofdm_tpu_torch.ops import cuda_build
from dl_ofdm_tpu_torch.ops.fused_synth import philox_words

N_WORDS = 16384
ROWS = 32
N_STREAMS = 8
SEEDS = (12345, 2**32 - 987654321)     # the script's (12345, -987654321)


def probe_words_ref(seeds: torch.Tensor, n_streams: int = N_STREAMS,
                    rows: int = ROWS, n_words: int = N_WORDS) -> torch.Tensor:
    """The plain version: int64 [n_streams, rows, n_words] words in
    [0, 2^32)."""
    r = torch.arange(rows, device=seeds.device)
    return torch.stack([philox_words(seeds, r, st, n_words)
                        for st in range(n_streams)])


class _ProbeArgs(ctypes.Structure):
    """`ProbeArgs` of csrc/philox_probe.cu, field for field."""
    _fields_ = [("seeds", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("n_streams", ctypes.c_int), ("rows", ctypes.c_int),
                ("n_words", ctypes.c_int)]


@functools.cache
def _probe_fn():
    fn = cuda_build.load("philox_probe").philox_probe
    fn.argtypes = [ctypes.POINTER(_ProbeArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def probe_words_kernel(seeds: torch.Tensor, n_streams: int = N_STREAMS,
                       rows: int = ROWS,
                       n_words: int = N_WORDS) -> torch.Tensor:
    """Launch the CUDA kernel: seeds int64 [2] on a CUDA device -> int32
    [n_streams, rows, n_words] holding the words' 32 bits."""
    if not seeds.is_cuda or seeds.dtype != torch.int64 \
            or seeds.shape != (2,) or not seeds.is_contiguous():
        raise ValueError("probe_words_kernel takes contiguous int64 seeds "
                         "[2] on a CUDA device")
    if n_words % 4 or min(n_streams, rows, n_words) < 1:
        raise ValueError("probe_words_kernel: n_words must be a positive "
                         "multiple of 4")
    out = torch.empty(n_streams, rows, n_words, dtype=torch.int32,
                      device=seeds.device)
    args = _ProbeArgs(seeds.data_ptr(), out.data_ptr(), n_streams, rows,
                      n_words)
    with torch.cuda.device(seeds.device):
        err = _probe_fn()(ctypes.byref(args),
                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"philox_probe kernel launch failed: CUDA error "
                           f"{err}")
    probe_words_kernel.launches += 1
    return out


probe_words_kernel.launches = 0


def probe_words(seeds: torch.Tensor, n_streams: int = N_STREAMS,
                rows: int = ROWS, n_words: int = N_WORDS) -> np.ndarray:
    """uint32 [n_streams, rows, n_words]: the kernel's words where `seeds`
    lies on a CUDA device, the plain version's on the CPU."""
    if seeds.is_cuda:
        w = probe_words_kernel(seeds, n_streams, rows, n_words)
        return w.cpu().numpy().view(np.uint32)
    return probe_words_ref(seeds, n_streams, rows, n_words).numpy().astype(
        np.uint32)


_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def quality(words: np.ndarray) -> dict:
    """The script's measures of uint32 words [n_streams, ...]."""
    w = words.reshape(words.shape[0], -1)
    n = w.shape[1]
    lb = (w & 1).astype(np.float64)
    serial = [float(np.corrcoef(s[:-1], s[1:])[0, 1]) for s in lb]
    sigma = 1.0 / np.sqrt(n)
    worst, collisions = 0.0, 0.0
    for a, b in itertools.combinations(range(w.shape[0]), 2):
        diff = _POPCOUNT8[(w[a] ^ w[b]).view(np.uint8)].sum(dtype=np.int64)
        worst = max(worst, abs(1.0 - diff / (32.0 * n) - 0.5))
        collisions = max(collisions, float((w[a] == w[b]).mean()))
    mc_sigma = 0.5 / np.sqrt(32.0 * n)
    return {"low_bit_mean": float(lb.mean()),
            "low_bit_mean_per_stream": lb.mean(1).round(5).tolist(),
            "serial_corr_max": float(np.abs(serial).max()),
            "serial_corr_sigma": float(sigma),
            "cross_bit_agreement_max_dev": worst,
            "cross_bound": float(max(0.002, 9 * mc_sigma)),
            "collision_rate_max": collisions}


def check(q: dict) -> None:
    """Raise AssertionError where a measure misses the script's bound."""
    if not q["cross_bit_agreement_max_dev"] < q["cross_bound"]:
        raise AssertionError(f"cross-stream correlation: {q}")
    if not q["serial_corr_max"] < 4.5 * q["serial_corr_sigma"]:
        raise AssertionError(f"serial correlation: {q}")
    if not abs(q["low_bit_mean"] - 0.5) < 0.005:
        raise AssertionError(f"low-bit bias: {q}")
    if not q["collision_rate_max"] <= 1e-3:
        raise AssertionError(f"word collisions between streams: {q}")


def main(device: str | None = None) -> dict:
    """Draw the probe's words on the card, hold them against the plain
    version bit for bit, check their quality; print and return the
    measures."""
    dev = resolve_device(device)
    seeds = torch.tensor(SEEDS, dtype=torch.int64, device=dev)
    words = probe_words(seeds)
    want = probe_words_ref(seeds).cpu().numpy().astype(np.uint32)
    if not np.array_equal(words, want):
        raise AssertionError(f"probe words differ from philox_words at "
                             f"{int((words != want).sum())} places")
    q = quality(words)
    check(q)
    q["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu")
    print(json.dumps(q), flush=True)
    print("PRNG quality OK", flush=True)
    return q


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
