"""Build the port's CUDA sources into shared libraries and load them.

Each source under `dl_ofdm_tpu_torch/csrc/` exposes a plain C interface
(`extern "C"`, pointers and a stream as `void*`, sizes as `int`) and is
compiled by `nvcc` for Hopper (`sm_90a`) into its own `.so`, which is
loaded with `ctypes`.  No PyTorch header is included and nothing goes
through `torch.utils.cpp_extension`, so a build takes seconds and needs no
`ninja` and no lock file.

Libraries land in `dl_ofdm_tpu_torch/_build/` (listed in `.gitignore`),
named by a hash of the source, every header under `csrc/` and the flags, so
an edited source or header builds anew.  Each is compiled to a temporary name and moved into place with
`os.replace`: a killed build leaves no half-written library.  Nothing is
built on import; the first kernel launch, or `build_all()`, builds.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# library name -> its source under csrc/
SOURCES = {"complex_conv2d": "complex_conv2d.cu",
           "complex_dense": "complex_dense.cu",
           "complex_dense_bf16": "complex_dense_bf16.cu",
           "fused_synth": "fused_synth.cu",
           "fused_model": "fused_model.cu",
           "fused_adam": "fused_adam.cu",
           "philox_probe": "philox_probe.cu",
           "fir_shift_accum": "fir_shift_accum.cu",
           "ring_exchange": "ring_exchange.cu"}

_LOADED: dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each build, by name
BUILD_LOGS: dict[str, str] = {}


def find_nvcc() -> str:
    """`nvcc` from $CUDA_HOME/bin (or $CUDA_PATH/bin), else from PATH, else
    the toolkit's default prefix /usr/local/cuda."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME to the CUDA toolkit or put nvcc on "
        "PATH; the port's kernels are compiled at first use")


def source_digest(name: str) -> str:
    """Hash of library `name`'s source, of every header under `csrc/` (by
    name and bytes) and of the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
                     + glob.glob(os.path.join(CSRC_DIR, "*.h")))
    for path in [os.path.join(CSRC_DIR, SOURCES[name])] + headers:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return digest.hexdigest()[:16]


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"{name}-{source_digest(name)}.so")


def build_all(names=None) -> None:
    """Compile every library not yet built, all nvcc processes at once."""
    jobs = []
    try:
        for name in names or SOURCES:
            out = library_path(name)
            if os.path.isfile(out):
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.tmp{os.getpid()}"
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC_DIR, SOURCES[name])]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((name, tmp, out, proc))
        for name, tmp, out, proc in jobs:
            log, _ = proc.communicate()
            BUILD_LOGS[name] = log
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {SOURCES[name]} (exit "
                    f"{proc.returncode}):\n{' '.join(proc.args)}\n{log}")
            os.replace(tmp, out)
    finally:
        for _, tmp, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if need be."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(library_path(name))
        _LOADED[name] = lib
    return lib
