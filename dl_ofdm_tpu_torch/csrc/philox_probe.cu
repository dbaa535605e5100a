// philox_probe: raw random words of the port's Philox4x32-10 with the fused
// synthesize kernel's layout, for measuring the generator's quality.
//
// Replaces the TPU kernel `kernel` of scripts/prng_quality_check.py (line
// 34, pallas_call at 42), which drew raw words of the TPU's hardware PRNG
// with the fused kernel's per-block seeding.  Here word j of (stream, row)
// is lane j % 4 of Philox4x32-10 with key (seed0, seed1) and counter
// (j / 4, stream, row, 0) (philox.cuh), the layout of fused_synth.cu, so
// the probe sees exactly the words the synth kernel draws.  The plain
// version is dl_ofdm_tpu_torch/ops/fused_synth.py::philox_words.
//
// Bound on an H100: the output, 8 streams x 32 rows x 16,384 words = 16 MiB,
// takes 5 us at 3.35 TB/s; the 1 M Philox calls (10 rounds of two
// mul.wide.u32 and two 3-input XORs, 42 M integer operations) take 2.5 us
// at 64 integer operations a clock on each of 132 SMs, so the store bounds
// it.  Design: one thread per counter, four words stored as one 16-byte
// write; neighbouring threads write neighbouring addresses; 32-bit index
// arithmetic (64-bit division is a software routine).  It runs at 65 % of
// that bound on an H100 SXM (CUDA graph of 100 calls), so it stays as it is.
//
// Plain C interface for ctypes (dl_ofdm_tpu_torch/ops/cuda_build.py); the
// launch goes on the caller's stream and the function returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

// outside the anonymous namespace, so that the extern "C" entry point keeps
// external linkage
struct ProbeArgs {
  const long long* seeds;   // [2] seed words (values < 2^32)
  uint32_t* out;            // [n_streams, rows, n_words]
  int n_streams, rows, n_words;   // n_words a multiple of 4
};

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) philox_probe_kernel(ProbeArgs a) {
  const int nb = a.n_words / 4;
  const int total = a.n_streams * a.rows * nb;   // < 2^31 (host checks)
  const uint32_t k0 = static_cast<uint32_t>(a.seeds[0]);
  const uint32_t k1 = static_cast<uint32_t>(a.seeds[1]);
  for (int e = blockIdx.x * THREADS + threadIdx.x; e < total;
       e += gridDim.x * THREADS) {
    const int j4 = e % nb, row = (e / nb) % a.rows, stream = e / (nb * a.rows);
    reinterpret_cast<uint4*>(a.out)[e] = philox(j4, stream, row, 0u, k0, k1);
  }
}

}  // namespace

extern "C" int philox_probe(const ProbeArgs* args, void* stream) {
  const ProbeArgs& a = *args;
  if (a.n_streams < 1 || a.rows < 1 || a.n_words < 4 || a.n_words % 4 ||
      static_cast<long long>(a.n_streams) * a.rows * (a.n_words / 4) >=
          (1LL << 31) - THREADS * 132LL * 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int total = a.n_streams * a.rows * (a.n_words / 4);
  const int need = (total + THREADS - 1) / THREADS;
  const int blocks = need < 132 * 16 ? need : 132 * 16;
  philox_probe_kernel<<<blocks, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
