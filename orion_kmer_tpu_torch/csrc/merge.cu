// K2: stable merge of two ascending int64 key runs, with an optional int64
// payload.
//
// Replaces the Pallas kernels orion_kmer_tpu/ops/sort_pallas.py::
// _ce_fused_kernel and ::_merge_tail_kernel (reached through _merge_halves
// from merge_sorted_streams, merge_sorted_single and merge_sorted_planes).
// Those run the log2(n) all-ascending stages of a bitonic merge over u32
// planes and need a power-of-two total; this kernel merges runs of any
// lengths, stably (a before b on equal keys), so payload order is
// deterministic.
//
// Bound on the H100: bytes.  A merge reads every key (and payload) once and
// writes it once -- 16 bytes per key, 32 with a payload; a 2^28-key forest
// merge moves ~4.3 GB.  Design (merge path):
//   1. a partition kernel finds, for the first output index of every
//      kTile-sized output tile, how many elements come from a, by a binary
//      search along that diagonal; all searches run in parallel, so the
//      tile kernel never waits on a dependent chain of global loads;
//   2. the tile kernel loads its two input slices (kTile elements together)
//      into shared memory with coalesced loads, each thread finds its own
//      kItems-wide sub-diagonal by a second search in shared memory, merges
//      kItems elements sequentially, and the tile is written back through
//      shared memory with coalesced stores.
// Offsets are int64: forest runs reach FLUSH_WINDOWS + one batch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;

// Number of elements of a among the first `diag` outputs of the stable
// merge of a and b (a first on ties).
template <typename I>
__device__ __forceinline__ I merge_path(const int64_t* a, I na, const int64_t* b, I nb, I diag) {
  I lo = diag > nb ? diag - nb : 0;
  I hi = diag < na ? diag : na;
  while (lo < hi) {
    const I mid = (lo + hi) >> 1;
    if (a[mid] <= b[diag - 1 - mid]) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void partition_kernel(const int64_t* __restrict__ a, int64_t na,
                                 const int64_t* __restrict__ b, int64_t nb, int64_t n_tiles,
                                 int64_t* __restrict__ split) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t > n_tiles) return;
  const int64_t diag = t * kTile < na + nb ? t * kTile : na + nb;
  split[t] = merge_path<int64_t>(a, na, b, nb, diag);
}

__global__ void __launch_bounds__(kThreads)
merge_tile_kernel(const int64_t* __restrict__ a, int64_t na, const int64_t* __restrict__ b,
                  int64_t nb, const int64_t* __restrict__ pa, const int64_t* __restrict__ pb,
                  const int64_t* __restrict__ split, int64_t* __restrict__ out,
                  int64_t* __restrict__ pout) {
  __shared__ int64_t sk[kTile];
  __shared__ int64_t sp[kTile];
  const bool payload = pout != nullptr;  // pa or pb is null when its run is empty
  const int64_t d0 = (int64_t)blockIdx.x * kTile;
  const int64_t d1 = d0 + kTile < na + nb ? d0 + kTile : na + nb;
  const int64_t a0 = split[blockIdx.x];
  const int64_t b0 = d0 - a0;
  const int la = (int)(split[blockIdx.x + 1] - a0);
  const int len = (int)(d1 - d0);
  const int lb = len - la;

  for (int x = threadIdx.x; x < len; x += kThreads) {
    if (x < la) {
      sk[x] = a[a0 + x];
      if (payload) sp[x] = pa[a0 + x];
    } else {
      sk[x] = b[b0 + x - la];
      if (payload) sp[x] = pb[b0 + x - la];
    }
  }
  __syncthreads();

  const int diag = (int)threadIdx.x * kItems < len ? (int)threadIdx.x * kItems : len;
  int i = merge_path<int>(sk, la, sk + la, lb, diag);
  int j = diag - i;
  int64_t rk[kItems];
  int64_t rp[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    if (diag + it < len) {
      const bool take_a = i < la && (j >= lb || sk[i] <= sk[la + j]);
      const int src = take_a ? i++ : la + j++;
      rk[it] = sk[src];
      rp[it] = payload ? sp[src] : 0;
    }
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    if (diag + it < len) {
      sk[diag + it] = rk[it];
      if (payload) sp[diag + it] = rp[it];
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < len; x += kThreads) {
    out[d0 + x] = sk[x];
    if (payload) pout[d0 + x] = sp[x];
  }
}

int64_t n_tiles_of(int64_t n) { return (n + kTile - 1) / kTile; }

}  // namespace

// int64 scratch elements okt_merge needs for a merged length n.
extern "C" int64_t okt_merge_scratch(int64_t n) { return n_tiles_of(n) + 1; }

// out = stable merge of a[0:na] and b[0:nb]; pout (and pa, pb) are null for
// a keys-only merge.  split: int64[okt_merge_scratch(na + nb)].
extern "C" int okt_merge(const void* a, int64_t na, const void* b, int64_t nb, const void* pa,
                         const void* pb, void* split, void* out, void* pout, void* stream) {
  const int64_t n_tiles = n_tiles_of(na + nb);
  if (n_tiles == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  partition_kernel<<<(unsigned)((n_tiles + kThreads) / kThreads), kThreads, 0, s>>>(
      (const int64_t*)a, na, (const int64_t*)b, nb, n_tiles, (int64_t*)split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_tile_kernel<<<(unsigned)n_tiles, kThreads, 0, s>>>(
      (const int64_t*)a, na, (const int64_t*)b, nb, (const int64_t*)pa, (const int64_t*)pb,
      (const int64_t*)split, (int64_t*)out, (int64_t*)pout);
  return (int)cudaGetLastError();
}
