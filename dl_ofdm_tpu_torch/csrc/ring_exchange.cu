// The halo ring exchange of the sequence-parallel FIR, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_dma_ring_exchange`
// (dl_ofdm_tpu/parallel/halo.py:27-72, pallas_call at :62): every rank
// pushes its last samples (`left_tail`) into its right neighbour's recv_l
// and its first samples (`right_head`) into its left neighbour's recv_r
// with `make_async_remote_copy`, then waits on its own two receive
// semaphores.  Here one block per (rank, direction) side copies the rank's
// slice into the neighbour's receive buffer (a peer address where the
// neighbour lives on another card; peer access is enabled once,
// `ring_enable_peer`), with 16-byte loads and stores where the addresses,
// the row stride and the row length allow, 4-byte ones otherwise.  The
// source slices are strided views (`x[:, -hl:, :]` of a [B, L, 2] shard):
// the row stride is passed, nothing is copied first; receive buffers are
// contiguous.  Two template instances, chosen by the host, not by a
// branch in the kernel:
//
//   * Copy (every rank on one card, one launch of 2P blocks).  The end of
//     the launch orders every push before any later reader on that stream,
//     so the blocks copy and nothing else: no flag, no fence, no spin.
//   * Handshake (ranks on two or more cards, one launch a card, each on
//     its card's current stream).  Each side owns three words on its own
//     card: its epoch (read and advanced only by its block), its credit
//     word (set by its destination: "my receive buffer for epoch e is
//     free") and its data word (set by its source: "your halo for epoch e
//     has landed").  Each block
//       1. reads its epoch e_old and takes e = e_old + 1;
//       2. releases the credit of its own receive side into its source's
//          credit word: the launch has begun on this card's stream, so all
//          earlier work of that stream, the buffer's last readers
//          included, is done;
//       3. spins (acquire) until its own credit word shows e;
//       4. pushes its slice;
//       5. after a barrier, one thread fences at system scope and stores e
//          into its destination's data word (release), the pattern of a
//          grid sync, not a fence in every thread;
//       6. spins (acquire) until its own data word shows e;
//       7. stores e back to its epoch word.
//     Every side runs exactly once an exchange, so all epochs stay equal;
//     the state lives in device memory, so a CUDA graph of the exchange
//     replays with fresh epochs and no host counter or reset.  Waits test
//     a signed difference, which stays right when the epoch wraps.  The
//     credit replaces any cross-card event: each card's launch depends on
//     nothing but its own stream.  Peer words over NVLink need system
//     scope (.sys); .gpu would not order them.
//
// Deadlock: a card's 2 x (its ranks) <= 32 blocks are all resident (they
// spin on each other when neighbouring ranks share a card), and no stream
// may wait on another card's ring launch before issuing its own.  A card's
// part captured in its own CUDA graph hangs unless every card's graph
// replays as many times.  A spin that outlasts RING_SPIN_LIMIT_NS traps
// (a partner never launched), so a broken caller gets an error, not a
// hung card.
//
// Across processes (each process one or more "cards" of the ring, two
// processes possibly on one physical card) the handshake template serves
// as it stands: each process launches its own cards' blocks on its own
// stream.  The receive buffers and handshake words a partner writes must
// then live in memory the partner can map, so the host allocates them
// here (`ring_ipc_alloc`, zeroed, with its `cudaIpcMemHandle_t`) rather
// than from PyTorch's caching allocator, whose handles would cover a
// block's base, not a tensor; each partner maps them with
// `ring_ipc_open`.  Two processes on one card are two contexts that the
// card time-slices, so a side's spin waits for its partner's slice.
//
// What bounds it: its bytes are a few kB (at the halo path's width 64 rows
// x 6 samples x 8 bytes each way and rank), far under a microsecond of
// HBM; the launch latency sets the copy template's time, the launch and
// the flag round trips over NVLink the handshake's.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#define RING_MAX_RANKS 16
#define RING_SPIN_LIMIT_NS 10000000000ull   // 10 s

// One block's work.  Copy: a slice of `rows` rows of `cols` floats at
// `src` (rows `src_stride` floats apart) into `dst` (contiguous rows).
// Handshake: the words of the protocol above, `*_in` on this block's card,
// `*_out` its partners' (where a partner is on another card, a peer
// address).  The copy template reads none of them.
struct RingSide {
  const float* src;
  long long src_stride;
  float* dst;
  unsigned int* epoch;
  unsigned int* credit_in;    // set by the destination's side
  unsigned int* data_in;      // set by the source's side
  unsigned int* credit_out;   // the source side's credit_in
  unsigned int* data_out;     // the destination side's data_in
};

struct RingArgs {
  int blocks;                  // (rank, direction) sides in this launch
  int rows;
  int cols[2];                 // floats a row: [0] left tails, [1] right heads
  RingSide side[2 * RING_MAX_RANKS];   // block 2j: a tail, 2j + 1: a head
};

namespace {

constexpr int THREADS = 256;

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

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// spin until *p reaches e (a signed difference: right across a wrap)
__device__ __forceinline__ void wait_for(const unsigned int* p,
                                         unsigned int e, const char* what) {
  if (static_cast<int>(load_acquire_sys(p) - e) >= 0) return;
  const unsigned long long t0 = global_ns();
  while (static_cast<int>(load_acquire_sys(p) - e) < 0) {
    __nanosleep(20);
    if (global_ns() - t0 > RING_SPIN_LIMIT_NS) {
      printf("ring_exchange: block %d waited 10 s for its %s of epoch %u; "
             "every card's part must run once an exchange\n",
             static_cast<int>(blockIdx.x), what, e);
      __trap();
    }
  }
}

__device__ __forceinline__ void copy_slice(const RingSide& s, int rows,
                                           int cols) {
  const bool vec = cols % 4 == 0 && s.src_stride % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(s.src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(s.dst) % 16 == 0;
  // 32-bit index arithmetic: the host holds rows x cols < 2^31
  if (vec) {
    const int c4 = cols / 4, n = rows * c4;
    const long long stride4 = s.src_stride / 4;
    const float4* src = reinterpret_cast<const float4*>(s.src);
    float4* dst = reinterpret_cast<float4*>(s.dst);
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int r = i / c4;
      dst[i] = src[r * stride4 + (i - r * c4)];
    }
  } else {
    const int n = rows * cols;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int r = i / cols;
      s.dst[i] = s.src[r * s.src_stride + (i - r * cols)];
    }
  }
}

template <bool kHandshake>
__global__ void __launch_bounds__(THREADS)
    ring_exchange_kernel(const RingArgs a) {
  const RingSide s = a.side[blockIdx.x];
  const int cols = a.cols[blockIdx.x & 1];
  if constexpr (!kHandshake) {
    copy_slice(s, a.rows, cols);
  } else {
    const unsigned int e = *s.epoch + 1u;
    if (threadIdx.x == 0) {
      store_release_sys(s.credit_out, e);
      wait_for(s.credit_in, e, "destination's credit");
    }
    __syncthreads();
    copy_slice(s, a.rows, cols);
    __syncthreads();
    if (threadIdx.x == 0) {
      // the block's pushes, ordered by the barrier, reach every observer
      // (a peer card included) before the data word does
      __threadfence_system();
      store_release_sys(s.data_out, e);
      wait_for(s.data_in, e, "source's halo");
      *s.epoch = e;
    }
  }
}

__global__ void empty_kernel() {}

}  // namespace

// Launch one card's part on `device`, whose stream `stream` is: the copy
// template (handshake = 0, every rank on this card) or the handshake.
extern "C" int ring_exchange_f32(const RingArgs* a, int handshake,
                                 int device, void* stream) {
  if (a->blocks < 1 || a->blocks > 2 * RING_MAX_RANKS || a->rows < 1 ||
      a->cols[0] < 1 || a->cols[1] < 1 ||
      static_cast<long long>(a->rows) *
              (a->cols[0] > a->cols[1] ? a->cols[0] : a->cols[1]) >=
          (1LL << 31))
    return cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (handshake)
    ring_exchange_kernel<true><<<a->blocks, THREADS, 0, st>>>(*a);
  else
    ring_exchange_kernel<false><<<a->blocks, THREADS, 0, st>>>(*a);
  err = cudaGetLastError();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return err;
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

// -- memory shared across processes (CUDA IPC) --------------------------------

// Allocate `bytes` on `device`, zeroed (and the zeros landed before this
// returns, so no partner's first store can be overwritten), and write its
// IPC handle (CUDA_IPC_HANDLE_SIZE = 64 bytes) to `handle`.
extern "C" int ring_ipc_alloc(int device, long long bytes, void** ptr,
                              void* handle) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  *ptr = nullptr;
  err = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (err == cudaSuccess) err = cudaMemset(*ptr, 0, static_cast<size_t>(bytes));
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *ptr);
  if (err != cudaSuccess && *ptr != nullptr) {
    cudaFree(*ptr);
    *ptr = nullptr;
  }
  const cudaError_t back = cudaSetDevice(prev);
  return err != cudaSuccess ? err : back;
}

// Map another process's allocation (its `ring_ipc_alloc` handle) into
// this one, reached from `device` (peer access enabled where it lives on
// another card).
extern "C" int ring_ipc_open(int device, const void* handle, void** ptr) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  err = cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
  const cudaError_t back = cudaSetDevice(prev);
  return err != cudaSuccess ? err : back;
}

// Unmap a partner's allocation (`ring_ipc_open`).
extern "C" int ring_ipc_close(void* ptr) { return cudaIpcCloseMemHandle(ptr); }

// Free an allocation of `ring_ipc_alloc`, once every partner has closed it.
extern "C" int ring_ipc_free(int device, void* ptr) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaFree(ptr);
  const cudaError_t back = cudaSetDevice(prev);
  return err != cudaSuccess ? err : back;
}
