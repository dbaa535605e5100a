// Philox4x32-10 (Salmon et al., SC'11) and the uniform of a word, shared by
// the port's kernels that draw random words (fused_synth.cu,
// philox_probe.cu).  The plain PyTorch version of the same generator is
// dl_ofdm_tpu_torch/ops/fused_synth.py::philox4x32 / philox_words.
//
// Layout used by every kernel: key (seed0, seed1), counter
// (j / 4, stream, row, 0), word j = lane j % 4 of the output.
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint4 philox(uint32_t c0, uint32_t c1, uint32_t c2,
                                        uint32_t c3, uint32_t k0,
                                        uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ uint32_t lane(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// uniform (0, 1) from the top 24 bits, never 0 (fused_synth.py::_u01)
__device__ __forceinline__ float u01(uint32_t w) {
  return __fadd_rn(__fmul_rn(static_cast<float>(w >> 8), 0x1p-24f), 0x1p-25f);
}
