// K3: stable compaction in one pass, with decoupled look-back.
//
// Replaces the Pallas kernels orion_kmer_tpu/ops/sort_pallas.py::
// _compact_window_kernel and ::_placement_kernel (public entry
// compact_left_pallas, behind orion_kmer_tpu/ops/count.py::_compact_left),
// and the JAX route that splits a shard's keys by owner
// (orion_kmer_tpu/parallel/sharded.py::route_to_owners: lax.sort by owner,
// _compact_left, a merge into slots).  The TPU has no cheap scatter, so those
// move every element through log2(n) conditional shift passes; Hopper
// scatters well, and one pass over the input is enough.
//
// What it computes, one template in three modes:
//   - mask: the elements of one or two int64 planes whose 1-byte flag is
//     set move to the front of their output, in order, with their count;
//   - positions: the same over one key plane, and the second output plane
//     is each kept element's own index, which nobody has to build or read;
//     an optional device-side limit drops every index at or past it;
//   - route: each int64 key goes to the output row of its owner among
//     n_dest destinations, ((mix32(key) >> 16) * n_dest) >> 16 (the port's
//     ops/hash.py::owner_of, the JAX package's _owner_of), in position
//     order; SENTINEL_KEY (INT64_MAX) is dropped.
// The count of each destination is left on the device, in the workspace.
//
// Bound on the H100: bytes.  The masks must read the flags and, of each
// plane, every 32-byte sector that holds a kept element (all of it from a
// density of about a half), and write kept * 8 bytes a plane out; the
// route reads n * 8 and writes valid * 8.  Design:
//   - one block per 2048-element tile; the tile id comes from an atomic
//     ticket, so a block waits only on tiles whose blocks already run, under
//     any scheduling and on any card;
//   - the masks read their flags first, one 16-byte vector a thread (each
//     thread ranks 16 consecutive elements), and count the tile's kept
//     elements; a tile that keeps at least 1/8 of them then copies its
//     planes into shared memory with cp.async, coalesced, 16 bytes a thread
//     (8 where a tile is ragged or its view misaligned), while warp 0 looks
//     back; a sparser tile copies nothing and reads each kept element where
//     it lies;
//   - the route needs its keys to know their owners: it loads them through
//     registers into shared memory first, then ranks;
//   - staged planes sit in a swizzled layout, so the striped copies and the
//     blocked reads both hit distinct banks;
//   - per thread, the kept count of each destination of a group of four is a
//     16-bit field of one u64, so one block scan (warp shuffles, warp totals
//     in shared memory) ranks four destinations at once;
//   - each tile publishes, per destination, a 64-bit status word (2-bit
//     flag: none, aggregate, inclusive prefix; 62-bit count) with release
//     semantics as soon as its aggregate is known; warp 0 looks back over
//     the predecessors' words (acquire loads, __nanosleep back-off), 32 tiles
//     a step for one destination, 8 tiles for four;
//   - kept elements are ranked in shared memory (destination-major, then in
//     position order) and leave as contiguous, coalesced runs, one per
//     destination;
//   - more than four destinations: the same tile loops over groups of four,
//     reusing its staged keys.  The status words and shared memory hold
//     one group; S is bounded only by the workspace (S words a tile).
// Each element's place follows from the flags (or keys) alone, so the
// output is stable and bit-identical from run to run whatever the
// scheduling.  Measured slower on the H100: a persistent grid with the next
// tile's copies double-buffered (every block then looks back over a whole
// round of tiles), several 32-tile windows read per look-back round trip,
// and more resident blocks (the route spills; tools/torch_k3_variants.py).

#include <cstdint>
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                  // consecutive elements a thread ranks
constexpr int kTile = kThreads * kItems;    // 2048 elements a block
constexpr int kMinBlocks = 6;               // resident blocks an SM asked of the register allocator
constexpr int kGatherBelow = kTile / 8;     // mask tiles keeping fewer read their kept keys alone
constexpr int kGroup = 4;                   // destinations ranked together
constexpr uint32_t kDrop = 0xFFFFFFFFu;
constexpr u64 kAggregate = 1ull << 62;
constexpr u64 kInclusive = 2ull << 62;
constexpr u64 kValue = kAggregate - 1;
constexpr int64_t kSentinel = INT64_MAX;

// Word of element e in a staged tile.  16-byte chunk c is stored at
// c ^ ((c >> 3) & 7): the striped loads (thread t, chunk t + 128 i) and the
// blocked reads (thread t, chunks 8t .. 8t + 7) both touch eight distinct
// 16-byte bank groups per quarter warp.
__device__ __forceinline__ int slot(int e) {
  const int c = e >> 1;
  return ((c ^ ((c >> 3) & 7)) << 1) | (e & 1);
}

__device__ __forceinline__ uint32_t field(u64 packed, uint32_t f) {
  return (uint32_t)(packed >> (16 * f)) & 0xFFFFu;
}

__device__ __forceinline__ uint32_t owner_of(int64_t key, uint32_t n_dest) {
  const uint64_t x = (uint64_t)key ^ 0x8000000000000000ull;
  uint32_t h = ((uint32_t)(x >> 32) * 0x85EBCA6Bu) ^ ((uint32_t)x * 0xC2B2AE35u);
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return (uint32_t)(((uint64_t)(h >> 16) * n_dest) >> 16);
}

__device__ __forceinline__ void publish(u64* word, u64 v) {
  cuda::atomic_ref<u64, cuda::thread_scope_device>(*word).store(v, cuda::std::memory_order_release);
}

__device__ __forceinline__ u64 load_status(u64* word) {
  return cuda::atomic_ref<u64, cuda::thread_scope_device>(*word).load(cuda::std::memory_order_acquire);
}

// Warp 0: the exclusive prefix of this tile for destination d0 + lane % F,
// summed over the predecessors back to the nearest inclusive prefix.  Lane
// (p, f) = (lane / F, lane % F) reads destination d0 + f of tile
// tile - 1 - p - (32 / F) step; every lane of field f returns its sum.
template <int F>
__device__ u64 look_back(u64* status, int64_t tile, uint32_t n_dest, uint32_t d0, int lane) {
  constexpr int kWindow = 32 / F;
  const uint32_t f = lane % F;
  const unsigned field_lanes = (0xFFFFFFFFu / ((1u << F) - 1u)) << f;
  bool done = d0 + f >= n_dest;
  u64 sum = 0;
  for (int64_t pred = tile - 1 - lane / F;; pred -= kWindow) {
    u64 w = kInclusive;  // before tile 0, and for a finished destination: 0
    if (!done && pred >= 0) {
      u64* word = status + pred * n_dest + d0 + f;
      unsigned ns = 32;
      while (((w = load_status(word)) >> 62) == 0) {
        __nanosleep(ns);
        if (ns < 1024) ns <<= 1;
      }
    }
    const unsigned mine = __ballot_sync(0xFFFFFFFFu, (w >> 62) == 2) & field_lanes;
    const int first = mine ? __ffs(mine) - 1 : 32;
    u64 v = lane <= first ? (w & kValue) : 0;
#pragma unroll
    for (int off = F; off < 32; off <<= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
    if (!done) sum += v;
    done = done || mine != 0;
    if (__all_sync(0xFFFFFFFFu, done)) return sum;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"((unsigned)__cvta_generic_to_shared(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"((unsigned)__cvta_generic_to_shared(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// kPlanes: int64 planes staged and moved (1 or 2).  kPositions: the second
// output plane is the kept element's index.  kRoute: destinations are the
// keys' owners among n_dest, else one destination, the set flags.
// ws: [0] ticket, [1, 1 + n_dest) counts, then n_dest status words a tile.
template <int kPlanes, bool kPositions, bool kRoute>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
compact_kernel(const uint8_t* __restrict__ keep, const int64_t* __restrict__ limit, int64_t n,
               const int64_t* __restrict__ x0, const int64_t* __restrict__ x1,
               int64_t* __restrict__ out0, int64_t* __restrict__ out1, uint32_t n_dest,
               u64* __restrict__ ws) {
  constexpr int kFields = kRoute ? kGroup : 1;
  __shared__ __align__(16) int64_t tile_s[kPlanes][kTile];  // swizzled, see slot()
  __shared__ uint16_t src_s[kTile];                         // staged rank -> element of the tile
  __shared__ u64 warp_s[kWarps];
  __shared__ u64 prefix_s[kFields];
  __shared__ int64_t tile_id_s;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) tile_id_s = (int64_t)atomicAdd(ws, 1ull);
  __syncthreads();
  const int64_t tile = tile_id_s;
  const int64_t base = tile * kTile;
  int64_t end = n;
  if (limit != nullptr && *limit < end) end = *limit;
  const int64_t left = end - base;
  const int m = left <= 0 ? 0 : left < kTile ? (int)left : kTile;  // elements that may be kept

  // stage the planes: 16-byte copies where the tile is whole and aligned,
  // 8-byte ones at a ragged or misaligned tile.  The masks copy
  // asynchronously and look back meanwhile; the route needs its keys first
  // and loads them through registers.
  auto stage = [&]() {
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      const int64_t* x = (p == 0 ? x0 : x1) + base;
      if (m == kTile && ((uintptr_t)x & 15) == 0) {
        constexpr int kVecs = kTile / 2 / kThreads;
        if constexpr (!kRoute) {
#pragma unroll
          for (int i = 0; i < kVecs; ++i) cp_async16(&tile_s[p][slot(2 * (tid + i * kThreads))], x + 2 * (tid + i * kThreads));
        } else {
          longlong2 v[kVecs];
#pragma unroll
          for (int i = 0; i < kVecs; ++i) v[i] = __ldcs(reinterpret_cast<const longlong2*>(x) + tid + i * kThreads);
#pragma unroll
          for (int i = 0; i < kVecs; ++i) *reinterpret_cast<longlong2*>(&tile_s[p][slot(2 * (tid + i * kThreads))]) = v[i];
        }
      } else {
        for (int e = tid; e < m; e += kThreads) {
          if constexpr (!kRoute) {
            cp_async8(&tile_s[p][slot(e)], x + e);
          } else {
            tile_s[p][slot(e)] = __ldcs(reinterpret_cast<const long long*>(x) + e);
          }
        }
      }
    }
    cp_async_commit();
  };

  uint32_t dest[kItems];  // the destination of each of the thread's 16 elements, or kDrop
  if constexpr (kRoute) {
    stage();
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kItems / 2; ++q) {
      const int e = tid * kItems + 2 * q;
      const longlong2 v = *reinterpret_cast<const longlong2*>(&tile_s[0][slot(e)]);
      dest[2 * q] = e < m && v.x != kSentinel ? owner_of(v.x, n_dest) : kDrop;
      dest[2 * q + 1] = e + 1 < m && v.y != kSentinel ? owner_of(v.y, n_dest) : kDrop;
    }
  } else {
    // the thread's 16 flags, as one 16-byte vector where it can
    const uint8_t* f = keep + base + tid * kItems;
    if (m == kTile && ((uintptr_t)(keep + base) & 15) == 0) {
      const uint4 v = __ldcs(reinterpret_cast<const uint4*>(f));
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < kItems; ++j) dest[j] = (words[j >> 2] >> (8 * (j & 3))) & 0xFFu ? 0u : kDrop;
    } else {
#pragma unroll
      for (int j = 0; j < kItems; ++j) dest[j] = tid * kItems + j < m && f[j] ? 0u : kDrop;
    }
  }

  u64* counts = ws + 1;
  u64* status = ws + 1 + n_dest;
  const int64_t last = (int64_t)gridDim.x - 1;
  for (uint32_t d0 = 0; d0 < n_dest; d0 += kGroup) {
    // kept elements of the group's destinations, a 16-bit field each
    u64 cnt = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const uint32_t f = dest[j] - d0;
      if (f < (uint32_t)kFields) cnt += 1ull << (16 * f);
    }
    u64 incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const u64 y = __shfl_up_sync(0xFFFFFFFFu, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) warp_s[warp] = incl;
    __syncthreads();
    u64 excl = incl - cnt, agg = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const u64 a = warp_s[w];
      if (w < warp) excl += a;
      agg += a;
    }
    if (tid < kFields && d0 + tid < n_dest)
      publish(status + tile * n_dest + d0 + tid, (tile == 0 ? kInclusive : kAggregate) | field(agg, tid));
    // a mask tile with few kept elements reads them where they lie (a
    // sector each) instead of staging the whole tile
    bool gather = false;
    if constexpr (!kRoute) {
      gather = field(agg, 0) < kGatherBelow;
      if (!gather) stage();
    }
    // destination-major staging: field f starts after the fields before it
    u64 seg = agg << 16;
    seg += seg << 16;
    seg += seg << 32;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const uint32_t f = dest[j] - d0;
      if (f < (uint32_t)kFields) {
        src_s[field(seg, f) + field(excl, f)] = (uint16_t)(tid * kItems + j);
        excl += 1ull << (16 * f);
      }
    }
    if (warp == 0) {
      const u64 prefix = tile == 0 ? 0 : look_back<kFields>(status, tile, n_dest, d0, lane);
      if (lane < kFields && d0 + lane < n_dest) {
        const u64 total = prefix + field(agg, lane);
        if (tile > 0) publish(status + tile * n_dest + d0 + lane, kInclusive | total);
        if (tile == last) counts[d0 + lane] = total;
        prefix_s[lane] = prefix;
      }
    }
    cp_async_wait<0>();  // the masks' planes, copied meanwhile
    __syncthreads();
    for (uint32_t f = 0; f < (uint32_t)kFields && d0 + f < n_dest; ++f) {
      const int a = (int)field(agg, f);
      const int s = (int)field(seg, f);
      const int64_t at = (int64_t)prefix_s[f];
      int64_t* o0 = out0 + (kRoute ? (int64_t)(d0 + f) * n : 0) + at;
      for (int r = tid; r < a; r += kThreads) {
        const int e = src_s[s + r];
        if (gather) {
          o0[r] = __ldcs(reinterpret_cast<const long long*>(x0) + base + e);
          if constexpr (kPlanes == 2) out1[at + r] = __ldcs(reinterpret_cast<const long long*>(x1) + base + e);
        } else {
          o0[r] = tile_s[0][slot(e)];
          if constexpr (kPlanes == 2) out1[at + r] = tile_s[1][slot(e)];
        }
        if constexpr (kPositions) out1[at + r] = base + e;
      }
    }
    __syncthreads();  // src_s, warp_s and prefix_s serve the next group
  }
}

int64_t tiles(int64_t n) { return (n + kTile - 1) / kTile; }

template <int kPlanes, bool kPositions, bool kRoute>
int launch(const void* keep, const void* limit, int64_t n, const void* x0, const void* x1, void* out0,
           void* out1, int64_t n_dest, void* ws, void* stream) {
  const int64_t blocks = tiles(n);
  if (blocks == 0) return 0;
  compact_kernel<kPlanes, kPositions, kRoute><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)keep, (const int64_t*)limit, n, (const int64_t*)x0, (const int64_t*)x1,
      (int64_t*)out0, (int64_t*)out1, (uint32_t)n_dest, (u64*)ws);
  return (int)cudaGetLastError();
}

}  // namespace

// int64 words of the zeroed workspace for n elements and n_dest
// destinations: [0] the ticket, [1, 1 + n_dest) the counts, written by the
// last tile, then n_dest status words a tile.
extern "C" int64_t okt_compact_workspace(int64_t n, int64_t n_dest) {
  return 1 + n_dest + tiles(n) * n_dest;
}

// Mask and positions modes.  x1/out1: the second plane, or null; with
// positions set, x1 is null and out1 receives the kept indices.  limit:
// null, or a device int64 past which nothing is kept.  ws: zeroed, of
// okt_compact_workspace(n, 1) words; ws[1] receives the kept count.
extern "C" int okt_compact(const void* keep, const void* limit, int64_t n, const void* x0, const void* x1,
                           int64_t positions, void* out0, void* out1, void* ws, void* stream) {
  if (positions && x1 != nullptr) return (int)cudaErrorInvalidValue;
  if (positions) return launch<1, true, false>(keep, limit, n, x0, nullptr, out0, out1, 1, ws, stream);
  if (x1 != nullptr) return launch<2, false, false>(keep, limit, n, x0, x1, out0, out1, 1, ws, stream);
  return launch<1, false, false>(keep, limit, n, x0, nullptr, out0, nullptr, 1, ws, stream);
}

// Route mode: keys[n] -> out[n_dest][n], row d starting with the keys that
// destination d owns, in position order.  ws: zeroed, of
// okt_compact_workspace(n, n_dest) words; ws[1 + d] receives row d's count.
extern "C" int okt_compact_route(const void* keys, int64_t n, int64_t n_dest, void* out, void* ws,
                                 void* stream) {
  if (n_dest < 1 || n_dest > 0xFFFFFFFELL) return (int)cudaErrorInvalidValue;
  return launch<1, false, true>(nullptr, nullptr, n, keys, nullptr, out, nullptr, n_dest, ws, stream);
}
