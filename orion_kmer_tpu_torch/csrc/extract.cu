// K1: canonical k-mer extraction from the 2-bit wire format.
//
// Replaces the Pallas kernel orion_kmer_tpu/ops/kmers_pallas.py::_kernel
// (public entry extract_canonical_lanes_pallas), whose math is
// orion_kmer_tpu/ops/kmers_lanes.py::extract_canonical_lane_math.  In the
// JAX package `count` ran the same math through XLA; here it feeds `count`
// and `query`.
//
// What it computes: for every position p of a batch (16 bases per u32
// lane, LSB-first), the window of k bases starting at p, its canonical
// value min(forward, reverse complement) as a u64, and whether it is valid
// (no invalid base in the window, and p <= n_positions - k).  The output is
// the flipped int64 key (u64 ^ 2^63, so signed order is u64 order) in
// position order, INT64_MAX where the window is invalid, plus one valid
// count per block so the caller needs no second pass for n_valid.  Lanes
// past the end read as invalid bases.
//
// Bound on the H100: bytes.  It reads 4 bytes of lanes + 2 bytes of invalid
// flags per 16 positions and writes 8 bytes per position: 140.5 MB at 2^24
// positions, 0.042 ms at 3.35 TB/s.  Building a window from its lanes takes
// ~160 SASS instructions, mostly integer ones, which at Hopper's 64 INT32
// operations per clock per SM is more than the byte bound; rolled, a
// position takes ~27, the run's setup included.  Design:
//   - each thread owns a run of kRun = 33 consecutive positions; it builds
//     the run's first window with the full math once and then rolls
//     base by base (fwd = fwd << 2 | b, rc = rc >> 2 | (3 - b) << 2k - 2);
//     the valid bits of the whole run come from one doubling OR over its
//     64 invalid flags, and k is a template parameter, so masks and shifts
//     are constants;
//   - keys are staged in shared memory in position order and leave as one
//     TMA bulk store per tile (cp.async.bulk ... bulk_group).  The run
//     length is odd so that the 32 lanes of a warp, storing the j-th key
//     of their runs at 8 * (33 * lane + j) bytes, fall into distinct banks;
//   - a persistent grid of kBlocksPerSm blocks per SM walks the tiles with
//     two tile buffers, so one tile's store overlaps the next one's compute;
//   - valid counts are summed with warp shuffles, once per block.

#include <array>
#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

namespace {

constexpr int kThreads = 128;
constexpr int kRun = 33;                          // positions per thread and tile
constexpr int kTile = kThreads * kRun;            // 4224 positions per tile
constexpr int kSmemBytes = 2 * kTile * 8;         // two tile buffers, 67,584 B
constexpr int kBlocksPerSm = 3;                   // 3 x 67,584 B of the SM's 227 KB

// Reverse the 32 2-bit groups of x: bit-reverse, then swap the two bits of
// every group back into place.
__device__ __forceinline__ uint64_t reverse_2bit_groups(uint64_t x) {
  x = __brevll(x);
  return ((x >> 1) & 0x5555555555555555ull) | ((x & 0x5555555555555555ull) << 1);
}

__device__ __forceinline__ uint64_t lane_at(const uint32_t* lanes, int64_t w, int64_t n_lanes) {
  return w < n_lanes ? __ldg(lanes + w) : 0u;
}

__device__ __forceinline__ uint64_t lane_mask(const uint32_t* inv, int64_t w, int64_t n_lanes) {
  if (w >= n_lanes) return 0xFFFFull;  // past the end: every base invalid
  return (__ldg(inv + (w >> 1)) >> ((w & 1) * 16)) & 0xFFFFu;
}

// Bit i set where any of bits i .. i + K - 1 of m is set.
template <int K>
__device__ __forceinline__ uint64_t window_any(uint64_t m) {
  constexpr int P = K >= 16 ? 16 : K >= 8 ? 8 : K >= 4 ? 4 : K >= 2 ? 2 : 1;
  if constexpr (P >= 2) m |= m >> 1;
  if constexpr (P >= 4) m |= m >> 2;
  if constexpr (P >= 8) m |= m >> 4;
  if constexpr (P >= 16) m |= m >> 8;
  return m | (m >> (K - P));  // two windows of P cover K in [P, 2P)
}

template <int K>
__global__ void __launch_bounds__(kThreads)
extract_kernel(const uint32_t* __restrict__ lanes, const uint32_t* __restrict__ inv,
               int64_t n_lanes, int64_t n_positions, int64_t* __restrict__ keys,
               int32_t* __restrict__ block_valid) {
  extern __shared__ __align__(128) int64_t tiles[];  // [2][kTile]
  __shared__ int warp_valid[kThreads / 32];
  constexpr uint64_t kMask = K == 32 ? ~0ull : (1ull << (2 * K)) - 1;
  const int t = threadIdx.x;
  const int64_t total = n_lanes * 16;
  const int64_t n_tiles = (total + kTile - 1) / kTile;
  int valid = 0;
  int buf = 0;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    const int64_t start = tile * kTile;
    const int64_t p0 = start + (int64_t)t * kRun;

    // bases p0 .. p0 + 63 (LSB-first, lo then hi) and their invalid flags,
    // from lanes w .. w + 4
    const int64_t w = p0 >> 4;
    const int o = (int)(p0 & 15);
    const uint64_t l01 = lane_at(lanes, w, n_lanes) | lane_at(lanes, w + 1, n_lanes) << 32;
    const uint64_t l23 = lane_at(lanes, w + 2, n_lanes) | lane_at(lanes, w + 3, n_lanes) << 32;
    uint64_t m = lane_mask(inv, w, n_lanes) | lane_mask(inv, w + 1, n_lanes) << 16 |
                 lane_mask(inv, w + 2, n_lanes) << 32 | lane_mask(inv, w + 3, n_lanes) << 48;
    uint64_t lo = l01, hi = l23;
    if (o) {
      const uint64_t l4 = lane_at(lanes, w + 4, n_lanes);
      lo = (l01 >> (2 * o)) | (l23 << (64 - 2 * o));
      hi = (l23 >> (2 * o)) | (l4 << (64 - 2 * o));
      m = (m >> o) | (lane_mask(inv, w + 4, n_lanes) << (64 - o));
    }

    // valid bit j: window p0 + j has no invalid base and ends inside n_positions
    const int64_t room = n_positions - K - p0 + 1;
    const int lim = room < 0 ? 0 : (room > kRun ? kRun : (int)room);
    const uint64_t ok = ~window_any<K>(m) & ((1ull << lim) - 1);
    valid += __popcll(ok);

    // the first window from the lanes; then bases K .. K + 31 roll in
    uint64_t fwd = reverse_2bit_groups(lo) >> (64 - 2 * K);
    uint64_t rc = ~lo & kMask;
    uint64_t next;
    if constexpr (K == 32) {
      next = hi;
    } else {
      next = (lo >> (2 * K)) | (hi << (64 - 2 * K));
    }

    int64_t* tile_keys = tiles + buf * kTile;
    if (t == 0) {
      // the store issued two tiles ago from this buffer has read it
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    }
    __syncthreads();
    int64_t* run = tile_keys + t * kRun;
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      if (j) {
        const uint64_t b = next & 3;
        next >>= 2;
        fwd = ((fwd << 2) | b) & kMask;
        rc = (rc >> 2) | ((b ^ 3) << (2 * K - 2));
      }
      const uint64_t canon = fwd < rc ? fwd : rc;
      run[j] = (ok >> j) & 1 ? (int64_t)(canon ^ 0x8000000000000000ull) : INT64_MAX;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (t == 0) {
      const int64_t left = total - start;
      const uint32_t bytes = (uint32_t)((left < kTile ? left : kTile) * 8);  // a multiple of 128
      const uint32_t src = (uint32_t)__cvta_generic_to_shared(tile_keys);
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                   :: "l"(keys + start), "r"(src), "r"(bytes) : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");

#pragma unroll
  for (int off = 16; off; off >>= 1) valid += __shfl_xor_sync(0xffffffffu, valid, off);
  if ((t & 31) == 0) warp_valid[t >> 5] = valid;
  __syncthreads();
  if (t == 0) {
    int sum = 0;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) sum += warp_valid[i];
    block_valid[blockIdx.x] = sum;
  }
}

using KernelFn = void (*)(const uint32_t*, const uint32_t*, int64_t, int64_t, int64_t*, int32_t*);

template <int... I>
constexpr std::array<KernelFn, sizeof...(I)> kernel_table(std::integer_sequence<int, I...>) {
  return {{&extract_kernel<I + 1>...}};
}

const std::array<KernelFn, 32> kKernels = kernel_table(std::make_integer_sequence<int, 32>{});
// cudaFuncSetAttribute holds for one device, so the opt-in to kSmemBytes of
// dynamic shared memory is remembered per (device, k); a device past the
// table is configured on every call.
constexpr int kMaxDevices = 64;
bool g_configured[kMaxDevices][32] = {};

}  // namespace

// Blocks of the persistent grid for n_lanes lanes on the current device (the
// length of the block_valid array okt_extract fills there).  The caller makes
// the operands' device current before either entry.
extern "C" int64_t okt_extract_blocks(int64_t n_lanes) {
  const int64_t n_tiles = (n_lanes * 16 + kTile - 1) / kTile;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  const int64_t resident = (int64_t)sms * kBlocksPerSm;
  return n_tiles < resident ? n_tiles : resident;
}

// keys: int64[16 * n_lanes]; block_valid: int32[okt_extract_blocks(n_lanes)].
extern "C" int okt_extract(const void* lanes, const void* inv, int64_t n_lanes, int64_t k,
                           int64_t n_positions, void* keys, void* block_valid, void* stream) {
  if (k < 1 || k > 32) return (int)cudaErrorInvalidValue;
  const int64_t blocks = okt_extract_blocks(n_lanes);
  if (blocks < 0) return (int)cudaErrorInvalidDevice;
  if (blocks == 0) return 0;
  const KernelFn fn = kKernels[k - 1];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return (int)cudaErrorInvalidDevice;
  const bool remembered = dev >= 0 && dev < kMaxDevices;
  if (!remembered || !g_configured[dev][k - 1]) {
    cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    if (remembered) g_configured[dev][k - 1] = true;
  }
  fn<<<(unsigned)blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const uint32_t*)lanes, (const uint32_t*)inv, n_lanes, n_positions, (int64_t*)keys,
      (int32_t*)block_valid);
  return (int)cudaGetLastError();
}

extern "C" const char* okt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
