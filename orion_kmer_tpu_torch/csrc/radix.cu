// Keys-only LSD radix sort of int64 keys over their low key_bits bits, in
// one histogram launch, one scan launch and one onesweep launch a digit.
//
// Replaces no Pallas kernel: the JAX package sorts a batch with lax.sort
// (orion_kmer_tpu/ops/count.py, narrowed to a (u32, u16) pair for k = 17..24).
// On the card it takes the place of torch.sort(keys).values, which sorts
// (key, int64 index) pairs and drops the indices: 32 bytes a key a pass, 8
// passes of 8 bits, plus a copy of the input and the index fill.
//
// What it computes: keys ascending in signed int64 order, reading only bits
// [0, key_bits) of each key (bit 63 flipped, so that at 64 bits signed order
// is unsigned order).  The caller proves that those bits decide the order:
// K1's canonical keys are u64 values below 2^(2k) - 1 with bit 63 flipped,
// and the sentinel INT64_MAX is all ones there, so 2k bits sort them exactly
// as 64 do (ops/radix.py).
//
// Bound on the H100: bytes.  Every pass reads every key once and writes it
// once: 16 bytes a key a pass, ceil(key_bits / digit bits) passes (at 2^24
// keys and 62 bits in 9-bit digits, 7 passes, 1.88 GB: 0.561 ms at 3.35
// TB/s), plus one read of the keys by the histogram.  Design (onesweep, the
// structure of CUB's DeviceRadixSort, with this file's own kernels and
// launches around CUB's block-level agents):
//   - the histogram kernel reads the keys once and counts the digit of every
//     pass at once (AgentRadixSortHistogram); one block a pass turns each
//     pass's counts into exclusive digit offsets (BlockScan);
//   - a onesweep pass ranks one tile a block in shared memory
//     (AgentRadixSortOnesweep: warp-match ranking, early counts), finds the
//     tile's global offset of each digit by decoupled look-back over the
//     tiles before it, and scatters the tile; tiles take their order from an
//     atomic ticket, so a block waits only on tiles already running;
//   - keys only, no index plane: the passes ping-pong between two buffers
//     (CUB's DoubleBuffer);
//   - the look-back words of a pass must start at zero: one memset clears
//     the tickets, the histogram and the first pass's words, and each pass
//     clears the words of the next (two alternating sets), so no pass needs
//     a memset of its own;
//   - one digit width and tile, measured on the H100 at 2^24 keys (PERF.md's
//     kernel table): 9-bit digits in tiles of 512 x 24 keys led at 62 bits,
//     count's k = 31 (7 passes against 8 of 8 bits; larger tiles write
//     longer runs of each digit; 11-bit digits ran three times slower).
// Offsets are int32 (CUB's look-back packs a count into 30 bits): n < 2^30.

#include <cstdint>
#include <cuda_runtime.h>

#include <cub/agent/agent_radix_sort_histogram.cuh>
#include <cub/agent/agent_radix_sort_onesweep.cuh>
#include <cub/block/block_scan.cuh>

namespace {

#if CUB_VERSION >= 200800
namespace agents = cub::detail::radix_sort;
#else
namespace agents = cub;
#endif

constexpr int64_t kMaxN = (1 << 30) - 1;
constexpr int kMaxPasses = 8;  // 64 bits in 9-bit digits
constexpr int kScanThreads = 256;
constexpr int kStaticSmem = 48 * 1024;

// The block and items as given: CUB's own scaling caps a tile at the 48 KB
// of static shared memory, and these kernels take theirs dynamically.
template <int kThreads, int kItems>
struct Fixed {
  static constexpr int BLOCK_THREADS = kThreads;
  static constexpr int ITEMS_PER_THREAD = kItems;
};

// One digit width with its onesweep block: kThreads threads of kItems keys.
// The look-back's warp ballots need every warp to hold all of its bins or
// none.  The histogram runs CUB's sm_90 tuning, 128 threads of 16 keys.
template <int Bits, int Threads, int Items>
struct Digits {
  static constexpr int kBits = Bits, kDigits = 1 << Bits, kThreads = Threads, kTile = Threads * Items;
  static constexpr int kHistThreads = 128;
  using Policy = cub::AgentRadixSortOnesweepPolicy<Threads, Items, int64_t, 1, cub::RADIX_RANK_MATCH_EARLY_COUNTS_ANY,
                                                   cub::BLOCK_SCAN_RAKING_MEMOIZE, cub::RADIX_SORT_STORE_DIRECT, Bits,
                                                   Fixed<Threads, Items>>;
  using Onesweep = agents::AgentRadixSortOnesweep<Policy, false, int64_t, cub::NullType, int, int>;
  using Histogram = agents::AgentRadixSortHistogram<
      cub::AgentRadixSortHistogramPolicy<kHistThreads, 16, 1, int64_t, Bits>, false, int64_t, int>;
  static constexpr int kBinsPerThread = (kDigits + Threads - 1) / Threads;
  static_assert(kDigits % kBinsPerThread == 0 && (kDigits / kBinsPerThread) % 32 == 0,
                "a warp holds all of its bins or none");
};

template <class C>
__global__ void __launch_bounds__(C::kHistThreads)
radix_histogram_kernel(int* bins, const int64_t* keys, int n, int key_bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  using Agent = typename C::Histogram;
  Agent(*reinterpret_cast<typename Agent::TempStorage*>(smem), bins, keys, n, 0, key_bits).Process();
}

// One block a pass: that pass's digit counts -> exclusive digit offsets.
template <int kDigits>
__global__ void __launch_bounds__(kScanThreads) radix_scan_kernel(int* bins) {
  constexpr int kPer = (kDigits + kScanThreads - 1) / kScanThreads;
  using Scan = cub::BlockScan<int, kScanThreads>;
  __shared__ typename Scan::TempStorage tmp;
  int* pass = bins + blockIdx.x * kDigits;
  int v[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int bin = threadIdx.x * kPer + u;
    v[u] = bin < kDigits ? pass[bin] : 0;
  }
  Scan(tmp).ExclusiveSum(v, v);
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int bin = threadIdx.x * kPer + u;
    if (bin < kDigits) pass[bin] = v[u];
  }
}

// One digit pass.  lookback: this pass's zeroed words; next: the next pass's,
// which this launch zeroes (null on the last pass).  The agent may end its
// threads early (a tile of one digit), so the clearing comes first.
template <class C>
__global__ void __launch_bounds__(C::kThreads)
radix_onesweep_kernel(int* lookback, int* next, int* ticket, const int* offsets, int64_t* out,
                      const int64_t* in, int n, int bit, int num_bits) {
  if (next != nullptr) {
    for (int i = threadIdx.x; i < C::kDigits; i += C::kThreads) next[(int64_t)blockIdx.x * C::kDigits + i] = 0;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  using Agent = typename C::Onesweep;
  Agent(*reinterpret_cast<typename Agent::TempStorage*>(smem), lookback, ticket, nullptr, offsets, out, in,
        nullptr, nullptr, n, bit, num_bits)
      .Process();
}

int passes_of(int key_bits, int bits) { return (key_bits + bits - 1) / bits; }

// int32 words of scratch: [tickets: kMaxPasses | offsets: passes x digits |
// look-back: 2 x tiles x digits].  The memset clears all but the second
// look-back set.
struct Layout {
  int64_t offsets, lookback, cleared, words;
};

template <class C>
Layout layout(int64_t n, int key_bits) {
  const int64_t tiles = (n + C::kTile - 1) / C::kTile;
  const int64_t offsets = kMaxPasses;
  const int64_t lookback = offsets + passes_of(key_bits, C::kBits) * (int64_t)C::kDigits;
  return {offsets, lookback, lookback + tiles * C::kDigits, lookback + 2 * tiles * C::kDigits};
}

constexpr int kMaxDevices = 64;

template <typename Kernel>
cudaError_t allow_smem(Kernel fn, size_t bytes) {
  if (bytes <= (size_t)kStaticSmem) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <class C>
int launch(const int64_t* in, int64_t* buf0, int64_t* buf1, int64_t n, int key_bits, int* scratch,
           cudaStream_t stream) {
  constexpr size_t kHistSmem = sizeof(typename C::Histogram::TempStorage);
  constexpr size_t kSweepSmem = sizeof(typename C::Onesweep::TempStorage);
  // Per device: dynamic shared memory opted in where a kernel needs more
  // than 48 KB, and the histogram's grid (its resident blocks).  A device
  // past the table is configured on every call.
  static int hist_grids[kMaxDevices] = {};

  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return (int)cudaErrorInvalidDevice;
  const bool remembered = dev >= 0 && dev < kMaxDevices;
  int hist_grid = remembered ? hist_grids[dev] : 0;
  if (hist_grid == 0) {
    cudaError_t err = allow_smem(radix_histogram_kernel<C>, kHistSmem);
    if (err == cudaSuccess) err = allow_smem(radix_onesweep_kernel<C>, kSweepSmem);
    int sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, radix_histogram_kernel<C>, C::kHistThreads,
                                                          kHistSmem);
    if (err != cudaSuccess) return (int)err;
    hist_grid = sms * (per_sm > 0 ? per_sm : 1);
    if (remembered) hist_grids[dev] = hist_grid;
  }

  const int passes = passes_of(key_bits, C::kBits);
  const int tiles = (int)((n + C::kTile - 1) / C::kTile);
  const Layout at = layout<C>(n, key_bits);
  int* lookback[2] = {scratch + at.lookback, scratch + at.cleared};
  int64_t* bufs[2] = {buf0, buf1};

  cudaError_t err = cudaMemsetAsync(scratch, 0, at.cleared * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  radix_histogram_kernel<C><<<hist_grid, C::kHistThreads, kHistSmem, stream>>>(scratch + at.offsets, in, (int)n,
                                                                               key_bits);
  radix_scan_kernel<C::kDigits><<<passes, kScanThreads, 0, stream>>>(scratch + at.offsets);
  for (int p = 0; p < passes; ++p) {
    const int bit = p * C::kBits;
    const int num_bits = key_bits - bit < C::kBits ? key_bits - bit : C::kBits;
    radix_onesweep_kernel<C><<<tiles, C::kThreads, kSweepSmem, stream>>>(
        lookback[p & 1], p + 1 < passes ? lookback[(p + 1) & 1] : nullptr, scratch + p,
        scratch + at.offsets + (int64_t)p * C::kDigits, bufs[p & 1], p == 0 ? in : bufs[(p - 1) & 1], (int)n, bit,
        num_bits);
  }
  return (int)cudaGetLastError();
}

// The one width the port instantiates.
using Digits9 = Digits<9, 512, 24>;

bool valid(int64_t n, int64_t key_bits) { return n >= 1 && n <= kMaxN && key_bits >= 1 && key_bits <= 64; }

}  // namespace

// Bytes of scratch okt_radix_sort needs for n keys; -1 for arguments it
// refuses (n outside [1, 2^30), key_bits outside [1, 64]).
extern "C" int64_t okt_radix_scratch(int64_t n, int64_t key_bits) {
  if (!valid(n, key_bits)) return -1;
  return layout<Digits9>(n, (int)key_bits).words * (int64_t)sizeof(int);
}

// in[0:n] sorted ascending on bits [0, key_bits) in 9-bit digits, pass p
// writing buf[p % 2] (pass 0 reads in, pass p > 0 reads buf[(p-1) % 2]):
// the result is in buf[(passes - 1) % 2].  buf1 is unused with one pass.
// scratch: of okt_radix_scratch(n, key_bits) bytes, any contents.  Launches
// on the current device, which the caller sets to the operands'.
extern "C" int okt_radix_sort(const void* in, void* buf0, void* buf1, int64_t n, int64_t key_bits, void* scratch,
                              void* stream) {
  if (!valid(n, key_bits)) return (int)cudaErrorInvalidValue;
  return launch<Digits9>((const int64_t*)in, (int64_t*)buf0, (int64_t*)buf1, n, (int)key_bits, (int*)scratch,
                         (cudaStream_t)stream);
}
