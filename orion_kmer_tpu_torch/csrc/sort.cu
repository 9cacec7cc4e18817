// K4: ascending sort of up to 2^14 int64 keys in one thread block.
//
// Replaces the Pallas kernel orion_kmer_tpu/ops/sort_pallas.py::_sort_kernel
// (reached through _run_network from sort_pairs), which runs a full bitonic
// network over (hi, lo) u32 pairs held in one VMEM block and needs a
// power-of-two n <= MAX_SORT_N = 2^14.  Here a key is one flipped int64 (u64
// ^ 2^63, so signed order is u64 order) and any n <= 2^14 is taken: the
// block pads to the next power of two with INT64_MAX, which sorts last (a
// pad that ties with a real all-ones key is indistinguishable from it, so
// the first n outputs are right either way).
//
// Bound on the H100: the work is one block, so one SM's shared memory, not
// device memory, limits it.  A 2^14 network runs log2(n) (log2(n) + 1) / 2 =
// 105 compare-exchange stages, each reading and writing all 2^14 keys of
// shared memory: 105 x 2^14 x 16 B = 27.5 MB through one SM (about 0.1 ms at
// ~128 B per clock), against 256 KB of device memory traffic.  torch.sort
// spreads the same work over many SMs, so this kernel is expected to lose
// to it.  Design: the keys live in dynamic shared memory (128 KB at 2^14,
// past the 48 KB static limit, so the entry raises the block's limit first);
// each stage is one pass of the block's threads over the n/2 pairs, and
// __syncthreads() separates the stages.  A faster design (register-resident
// low strides, or a batched segmented tile sort) is left for later.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 1 << 14;
constexpr int kMaxThreads = 1024;

__global__ void __launch_bounds__(kMaxThreads)
bitonic_sort_kernel(const int64_t* __restrict__ in, int n, int n_pad, int64_t* __restrict__ out) {
  extern __shared__ int64_t s[];
  for (int i = threadIdx.x; i < n_pad; i += blockDim.x) s[i] = i < n ? in[i] : INT64_MAX;
  __syncthreads();
  for (int size = 2; size <= n_pad; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < n_pad / 2; t += blockDim.x) {
        // pair t: lo has the `stride` bit clear, hi = lo + stride
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool ascending = (lo & size) == 0;
        const int64_t a = s[lo];
        const int64_t b = s[hi];
        if ((a > b) == ascending) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = s[i];
}

}  // namespace

// Largest n okt_sort takes.
extern "C" int64_t okt_sort_max_n() { return kMaxN; }

// out[0:n] = in[0:n] sorted ascending, 1 <= n <= okt_sort_max_n().
extern "C" int okt_sort(const void* in, int64_t n, void* out, void* stream) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  int n_pad = 1;
  while (n_pad < n) n_pad <<= 1;
  const int threads = n_pad / 2 < 32 ? 32 : (n_pad / 2 > kMaxThreads ? kMaxThreads : n_pad / 2);
  cudaError_t err = cudaFuncSetAttribute(
      bitonic_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxN * (int)sizeof(int64_t));
  if (err != cudaSuccess) return (int)err;
  bitonic_sort_kernel<<<1, threads, n_pad * sizeof(int64_t), (cudaStream_t)stream>>>(
      (const int64_t*)in, (int)n, n_pad, (int64_t*)out);
  return (int)cudaGetLastError();
}
