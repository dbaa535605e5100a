// The halo ring exchange of the sequence-parallel FIR, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_dma_ring_exchange`
// (dl_ofdm_tpu/parallel/halo.py:27-72, pallas_call at :62): every rank
// pushes its last samples (`left_tail`) into its right neighbour's recv_l
// and its first samples (`right_head`) into its left neighbour's recv_r
// with `make_async_remote_copy`, then waits on its own two receive
// semaphores.  Here:
//
//   * one block per (rank, direction) copies the rank's slice into the
//     neighbour's receive buffer (a peer address where the neighbour lives
//     on another card; peer access is enabled once, `ring_enable_peer`),
//     with 16-byte loads and stores where the addresses, the row stride and
//     the row length allow, 4-byte ones otherwise.  The source slices are
//     strided views (`x[:, -hl:, :]` of a [B, L, 2] shard): the row stride
//     is passed, nothing is copied first; receive buffers are contiguous;
//   * then every thread fences at system scope, and thread 0 stores the
//     call's epoch into the receiver's flag word with a release at system
//     scope (the send semaphore's signal), and spins with an acquire load
//     at system scope until the rank's own flag for that direction shows the
//     epoch (the receive semaphore's wait).  Flags are allocated once per
//     ring and never reset; the epoch grows with each call, so a stale
//     flag can never satisfy a wait;
//   * on one card all ranks are one launch of 2P blocks (P <= 16: far below
//     the resident limit, so every spinning block's partner is resident);
//     across cards one launch per card, issued back to back with no host
//     sync, each on its card's current stream.
//
// What bounds it: its bytes are a few kB (at the halo path's width 64 rows
// x 6 samples x 8 bytes each way and rank), a microsecond of HBM at most;
// the launch latency and the flag round trip set its time.  So the design
// spends nothing on bandwidth: one launch for every rank of a card, one
// pass of stores, one flag word a direction, and the wait folded into the
// same launch so that no second kernel or host sync follows.

#include <cuda_runtime.h>
#include <stdint.h>

#define RING_MAX_RANKS 16

// One block's work: a slice of `rows` rows of `cols` floats at `src`
// (rows `src_stride` floats apart) into `dst` (contiguous rows), then
// signal `flag_out` and wait for `flag_in`.
struct RingSide {
  const float* src;
  long long src_stride;
  float* dst;
  unsigned int* flag_out;
  unsigned int* flag_in;
};

struct RingArgs {
  int blocks;                  // (rank, direction) pairs in this launch
  int rows;
  int cols[2];                 // floats a row: [0] left tails, [1] right heads
  unsigned int epoch;
  RingSide side[2 * RING_MAX_RANKS];   // block 2j: a tail, 2j + 1: a head
};

namespace {

__device__ __forceinline__ void store_release_sys(unsigned int* p,
                                                  unsigned int v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned int load_acquire_sys(
    const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__global__ void ring_exchange_kernel(const RingArgs a) {
  const RingSide s = a.side[blockIdx.x];
  const int cols = a.cols[blockIdx.x & 1];
  const bool vec = cols % 4 == 0 && s.src_stride % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(s.src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(s.dst) % 16 == 0;
  if (vec) {
    const int c4 = cols / 4;
    const long long n = static_cast<long long>(a.rows) * c4;
    for (long long i = threadIdx.x; i < n; i += blockDim.x) {
      const long long r = i / c4;
      const int c = static_cast<int>(i - r * c4);
      const float4 v =
          *reinterpret_cast<const float4*>(s.src + r * s.src_stride + 4 * c);
      reinterpret_cast<float4*>(s.dst)[i] = v;
    }
  } else {
    const long long n = static_cast<long long>(a.rows) * cols;
    for (long long i = threadIdx.x; i < n; i += blockDim.x) {
      const long long r = i / cols;
      const int c = static_cast<int>(i - r * cols);
      s.dst[i] = s.src[r * s.src_stride + c];
    }
  }
  // each thread's stores reach every observer (a peer card included)
  // before the barrier; then one release store signals the receiver
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    store_release_sys(s.flag_out, a.epoch);
    // wait for this rank's own slice of the same direction; the signed
    // difference keeps the test right when the epoch wraps
    while (static_cast<int>(load_acquire_sys(s.flag_in) - a.epoch) < 0) {
      __nanosleep(32);
    }
  }
  __syncthreads();
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" int ring_exchange_f32(const RingArgs* a, int threads,
                                 void* stream) {
  if (a->blocks < 1 || a->blocks > 2 * RING_MAX_RANKS || a->rows < 1 ||
      a->cols[0] < 1 || a->cols[1] < 1 || threads < 32 || threads > 1024)
    return cudaErrorInvalidValue;
  ring_exchange_kernel<<<a->blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(*a);
  return cudaGetLastError();
}

// Let device `dev` reach `peer`'s memory; *can is 0 (and nothing is
// enabled) where the pair cannot.  Enabling twice is not an error.
extern "C" int ring_enable_peer(int dev, int peer, int* can) {
  cudaError_t err = cudaDeviceCanAccessPeer(can, dev, peer);
  if (err != cudaSuccess || !*can) return err;
  int prev = 0;
  err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(dev);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();
      err = cudaSuccess;
    }
  }
  const cudaError_t back = cudaSetDevice(prev);
  return err != cudaSuccess ? err : back;
}

// One launch of an empty kernel: the launch latency that the exchange's
// time is held against.
extern "C" int ring_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
