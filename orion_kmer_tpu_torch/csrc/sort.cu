// K4: ascending sort of up to 2^14 int64 keys by one thread block cluster.
//
// Replaces the Pallas kernel orion_kmer_tpu/ops/sort_pallas.py::_sort_kernel
// (reached through _run_network from sort_pairs), which runs a full bitonic
// network over (hi, lo) u32 pairs held in one VMEM block and needs a
// power-of-two n <= MAX_SORT_N = 2^14.  Here a key is one flipped int64 (u64
// ^ 2^63, so signed order is u64 order) and any n <= 2^14 is taken: the
// keys are padded to a power of two of at least 2^11 with INT64_MAX, which
// sorts last (a pad that ties with a real all-ones key is indistinguishable
// from it, so the first n outputs are right either way).
//
// Bound on the H100: not device memory (256 KB at 2^14, 0.00008 ms) but the
// exchanges of the network.  A 2^14 network has 105 compare-exchange
// stages; run by one block through shared memory, every stage moves all
// 2^14 keys through one SM's shared memory (105 x 2^14 x 16 B = 27.5 MB,
// ~0.12 ms at 128 B per clock).  Design: a cluster of n_pad / 2^11 CTAs
// (1 to 8, the portable cluster size), each holding 2^11 keys in
// registers, 8 per thread, key j of CTA r at global index r * 2^11 + j with
// thread j / 8 holding slot j % 8.  A stage of stride s exchanges
//   s = 1..4          inside a thread (registers),
//   s = 8..128        across the lanes of a warp (__shfl_xor_sync),
//   s = 256..1024     through the CTA's shared memory (2 x 16 KB, static),
//   s = 2048..8192    with partner CTA rank ^ (s / 2^11) through distributed
//                     shared memory, a cluster barrier on each side.
// Of the 105 stages at 2^14 that is 39, 45, 15 and 6; each CTA does 1/8 of
// the work of the one-block design, and only 21 stages touch shared memory.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxN = 1 << 14;
constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;  // keys per CTA, 2^11

// The element at global index i of a pair (i, i ^ stride) keeps the smaller
// key when it is the lower of the two in an ascending run, or the upper in
// a descending one.
__device__ __forceinline__ bool keeps_min(int i, int size, int stride) {
  return ((i & stride) == 0) == ((i & size) == 0);
}

__device__ __forceinline__ int64_t pick(bool want_min, int64_t a, int64_t b) {
  return want_min ? (a < b ? a : b) : (a < b ? b : a);
}

// Strides 1, 2, 4: both keys of a pair are in this thread.
template <int S>
__device__ __forceinline__ void thread_stage(int64_t (&k)[kPerThread], int base, int size) {
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    if (r & S) continue;
    const int64_t a = k[r], b = k[r | S];
    const bool asc = ((base + r) & size) == 0;  // r is the lower index
    k[r] = pick(asc, a, b);
    k[r | S] = pick(!asc, a, b);
  }
}

__global__ void __launch_bounds__(kThreads)
cluster_sort_kernel(const int64_t* __restrict__ in, int n, int n_pad, int64_t* __restrict__ out) {
  __shared__ __align__(16) int64_t buf[2][kTile];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int t = threadIdx.x;
  const int base = rank * kTile + t * kPerThread;  // global index of slot 0

  int64_t k[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) k[r] = base + r < n ? in[base + r] : INT64_MAX;

  int parity = 0;  // shared-memory exchanges alternate between the two buffers
  for (int size = 2; size <= n_pad; size <<= 1) {
    int stride = size >> 1;
    for (; stride >= kTile; stride >>= 1) {
      // the whole CTA keeps the min or the max of its pairs with the partner
      int64_t* mine = buf[parity];
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) mine[r * kThreads + t] = k[r];
      cluster.sync();
      const int64_t* theirs = cluster.map_shared_rank(mine, rank ^ (stride / kTile));
      const bool want_min = keeps_min(base, size, stride);
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) k[r] = pick(want_min, k[r], theirs[r * kThreads + t]);
      cluster.sync();  // the partner has read this CTA's keys
      parity ^= 1;
    }
    for (; stride >= 32 * kPerThread; stride >>= 1) {
      int64_t* s = buf[parity];
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) s[r * kThreads + t] = k[r];
      __syncthreads();
      const int partner = t ^ (stride / kPerThread);
      const bool want_min = keeps_min(base, size, stride);
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) k[r] = pick(want_min, k[r], s[r * kThreads + partner]);
      parity ^= 1;
    }
    for (; stride >= kPerThread; stride >>= 1) {
      const int lane_mask = stride / kPerThread;
      const bool want_min = keeps_min(base, size, stride);
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) {
        const int64_t other = (int64_t)__shfl_xor_sync(0xffffffffu, (long long)k[r], lane_mask);
        k[r] = pick(want_min, k[r], other);
      }
    }
    if (stride >= 4) thread_stage<4>(k, base, size);
    if (stride >= 2) thread_stage<2>(k, base, size);
    thread_stage<1>(k, base, size);
  }

#pragma unroll
  for (int r = 0; r < kPerThread; ++r)
    if (base + r < n) out[base + r] = k[r];
}

}  // namespace

// Largest n okt_sort takes.
extern "C" int64_t okt_sort_max_n() { return kMaxN; }

// out[0:n] = in[0:n] sorted ascending, 1 <= n <= okt_sort_max_n().  One
// cluster of n_pad / 2^11 CTAs; a launch the card refuses is an error.
// Shared memory is static and the cluster size is a launch attribute, so
// nothing is configured per device: the launch goes to the current device,
// which the caller sets to the operands'.
extern "C" int okt_sort(const void* in, int64_t n, void* out, void* stream) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  int n_pad = kTile;
  while (n_pad < n) n_pad <<= 1;
  const unsigned ctas = (unsigned)(n_pad / kTile);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, cluster_sort_kernel, (const int64_t*)in, (int)n, n_pad,
                                             (int64_t*)out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
