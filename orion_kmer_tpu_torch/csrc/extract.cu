// K1: canonical k-mer extraction from the 2-bit wire format.
//
// Replaces the Pallas kernel orion_kmer_tpu/ops/kmers_pallas.py::_kernel
// (public entry extract_canonical_lanes_pallas), whose math is
// orion_kmer_tpu/ops/kmers_lanes.py::extract_canonical_lane_math.  In the
// JAX package `count` ran the same math through XLA; here it feeds `count`.
//
// What it computes: for every position p = 16 * lane + offset of a batch,
// the window of k bases starting at p, its canonical value
// min(forward, reverse complement) as a u64, and whether it is valid (no
// invalid base in the window, and p <= n_positions - k).  The output is the
// flipped int64 key (u64 ^ 2^63, so signed order is u64 order) in position
// order, INT64_MAX where the window is invalid, plus one valid count per
// block so the caller needs no second pass for n_valid.
//
// Bound on the H100: bytes.  It reads 4 bytes of lanes + 2 bytes of invalid
// flags per 16 positions and writes 8 bytes per position, so a 2^24-position
// batch moves ~140 MB; the arithmetic is a few dozen 64-bit integer ops per
// window.  Design: one thread per position, so the 8-byte key stores of a
// warp are contiguous (fully coalesced), while the 16 threads that share a
// lane read the same word (one transaction).  The window is built as one
// u64 from lanes w..w+2 -- Hopper has 64-bit integer lanes, so the TPU's
// (hi, lo) u32 planes are gone.  Lanes past the end read as invalid bases
// instead of wrapping.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Reverse the 32 2-bit groups of x: bit-reverse, then swap the two bits of
// every group back into place.
__device__ __forceinline__ uint64_t reverse_2bit_groups(uint64_t x) {
  x = __brevll(x);
  return ((x >> 1) & 0x5555555555555555ull) | ((x & 0x5555555555555555ull) << 1);
}

__device__ __forceinline__ uint64_t lane_mask(const uint32_t* inv, int64_t w, int64_t n_lanes) {
  if (w >= n_lanes) return 0xFFFFull;  // past the end: every base invalid
  return (inv[w >> 1] >> ((w & 1) * 16)) & 0xFFFFu;
}

__global__ void extract_kernel(const uint32_t* __restrict__ lanes,
                               const uint32_t* __restrict__ inv, int64_t n_lanes,
                               int k, int64_t n_positions, int64_t* __restrict__ keys,
                               int32_t* __restrict__ block_valid) {
  const int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int valid = 0;
  if (p < n_lanes * 16) {
    const int64_t w = p >> 4;
    const int o = (int)(p & 15);
    const uint64_t A = lanes[w];
    const uint64_t B = w + 1 < n_lanes ? lanes[w + 1] : 0;
    const uint64_t C = w + 2 < n_lanes ? lanes[w + 2] : 0;
    // bases o..o+31 of lanes (w, w+1, w+2), LSB-first
    uint64_t win = (A | (B << 32)) >> (2 * o);
    if (o) win |= C << (64 - 2 * o);
    const uint64_t m = (lane_mask(inv, w, n_lanes) | (lane_mask(inv, w + 1, n_lanes) << 16) |
                        (lane_mask(inv, w + 2, n_lanes) << 32)) >> o;
    const uint64_t mask2k = k == 32 ? ~0ull : ((1ull << (2 * k)) - 1);
    const uint64_t rc = ~win & mask2k;  // the LSB-first window, complemented
    const uint64_t fwd = reverse_2bit_groups(win) >> (64 - 2 * k);
    const uint64_t canon = fwd < rc ? fwd : rc;
    valid = (m & ((1ull << k) - 1)) == 0 && p <= n_positions - k;
    keys[p] = valid ? (int64_t)(canon ^ 0x8000000000000000ull) : INT64_MAX;
  }
  const int n_valid = __syncthreads_count(valid);
  if (threadIdx.x == 0) block_valid[blockIdx.x] = n_valid;
}

}  // namespace

extern "C" int64_t okt_extract_blocks(int64_t n_lanes) {
  return (n_lanes * 16 + kThreads - 1) / kThreads;
}

// keys: int64[16 * n_lanes]; block_valid: int32[okt_extract_blocks(n_lanes)].
extern "C" int okt_extract(const void* lanes, const void* inv, int64_t n_lanes, int64_t k,
                           int64_t n_positions, void* keys, void* block_valid, void* stream) {
  const int64_t blocks = okt_extract_blocks(n_lanes);
  if (blocks == 0) return 0;
  extract_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)lanes, (const uint32_t*)inv, n_lanes, (int)k, n_positions,
      (int64_t*)keys, (int32_t*)block_valid);
  return (int)cudaGetLastError();
}

extern "C" const char* okt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
