// K3: stable compaction of keep-flagged elements over one or two int64
// planes.
//
// Replaces the Pallas kernels orion_kmer_tpu/ops/sort_pallas.py::
// _compact_window_kernel and ::_placement_kernel (public entry
// compact_left_pallas, behind orion_kmer_tpu/ops/count.py::_compact_left).
// The TPU has no cheap scatter, so those move every element through
// log2(n) conditional fixed-offset shift passes.  Hopper scatters well, so
// this is a scan plus one scatter.
//
// Bound on the H100: bytes.  Pass 1 reads the 1-byte flags; pass 2 reads
// flags and planes and writes the kept elements: ~9-17 bytes per element
// plus 8-16 per kept one.  Design:
//   pass 1: one count of kept elements per kTile-element block
//           (__syncthreads_count), no atomics;
//   between: an exclusive scan of the block counts -- few enough
//           (n / 2048) that the wrapper does it with torch.cumsum;
//   pass 2: each block walks its tile in kItems steps of kThreads
//           consecutive elements; a warp ranks its kept elements with
//           __ballot_sync + __popc, the warps' totals are combined through
//           shared memory, and each kept element is stored at its block
//           offset + running count + rank.
// The destination of every element follows from the flags alone, so the
// output is stable and deterministic.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;

__global__ void count_kernel(const uint8_t* __restrict__ keep, int64_t n,
                             int64_t* __restrict__ block_counts) {
  const int64_t base = (int64_t)blockIdx.x * kTile;
  int64_t total = 0;
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int64_t i = base + it * kThreads + threadIdx.x;
    total += __syncthreads_count(i < n && keep[i]);
  }
  if (threadIdx.x == 0) block_counts[blockIdx.x] = total;
}

__global__ void scatter_kernel(const uint8_t* __restrict__ keep, int64_t n,
                               const int64_t* __restrict__ x0, const int64_t* __restrict__ x1,
                               const int64_t* __restrict__ block_offsets,
                               int64_t* __restrict__ out0, int64_t* __restrict__ out1) {
  __shared__ int warp_totals[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base = (int64_t)blockIdx.x * kTile;
  int64_t running = block_offsets[blockIdx.x];
  for (int it = 0; it < kItems; ++it) {
    const int64_t i = base + it * kThreads + threadIdx.x;
    const bool f = i < n && keep[i];
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, f);
    if (lane == 0) warp_totals[warp] = __popc(ballot);
    __syncthreads();
    int before = __popc(ballot & ((1u << lane) - 1u));
    int step_total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int t = warp_totals[w];
      if (w < warp) before += t;
      step_total += t;
    }
    if (f) {
      const int64_t dst = running + before;
      out0[dst] = x0[i];
      if (x1) out1[dst] = x1[i];
    }
    running += step_total;
    __syncthreads();  // warp_totals is rewritten by the next step
  }
}

}  // namespace

extern "C" int64_t okt_compact_blocks(int64_t n) { return (n + kTile - 1) / kTile; }

// block_counts: int64[okt_compact_blocks(n)], written by pass 1.
extern "C" int okt_compact_count(const void* keep, int64_t n, void* block_counts, void* stream) {
  const int64_t blocks = okt_compact_blocks(n);
  if (blocks == 0) return 0;
  count_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)keep, n, (int64_t*)block_counts);
  return (int)cudaGetLastError();
}

// block_offsets: the exclusive scan of pass 1's counts.  x1/out1 are null
// for a single plane.
extern "C" int okt_compact_scatter(const void* keep, int64_t n, const void* x0, const void* x1,
                                   const void* block_offsets, void* out0, void* out1,
                                   void* stream) {
  const int64_t blocks = okt_compact_blocks(n);
  if (blocks == 0) return 0;
  scatter_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)keep, n, (const int64_t*)x0, (const int64_t*)x1,
      (const int64_t*)block_offsets, (int64_t*)out0, (int64_t*)out1);
  return (int)cudaGetLastError();
}
