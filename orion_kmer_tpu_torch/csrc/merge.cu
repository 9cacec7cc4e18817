// K2: stable merge of two ascending int64 key runs in one launch, in three
// modes: keys only, keys with an int64 payload, and the count-table fold
// (keys with int64 counts, the counts of equal neighbours summed into the
// first, and the keep mask key[i] != key[i-1]).
//
// Replaces the Pallas kernels orion_kmer_tpu/ops/sort_pallas.py::
// _ce_fused_kernel and ::_merge_tail_kernel (reached through _merge_halves
// from merge_sorted_streams, merge_sorted_single, merge_sorted_pairs and
// merge_sorted_planes), and, in the fold mode, the elementwise tail of
// orion_kmer_tpu/ops/count.py::_combine_merged_unique before its compaction.
// Those run the log2(n) all-ascending stages of a bitonic merge over u32
// planes and need a power-of-two total; this kernel merges runs of any
// lengths, stably (a before b on equal keys), so payload order is
// deterministic.
//
// Bound on the H100: bytes.  A merge reads every key (and payload) once and
// writes it once: 16 bytes a key, 32 with a payload, 33 in the fold (the
// keep mask).  Design (merge path):
//   - one launch: the block of output tile t finds the tile's two ends on
//     the merge path itself, each by one warp in a 32-ary search (32 lanes
//     probe 32 evenly spaced candidates, a ballot keeps the gap that holds
//     the answer: ~5 rounds of dependent loads at 2^25 elements instead of
//     ~25 for a binary search);
//   - the tile's a-slice and b-slice are each contiguous in device memory:
//     one thread loads each with a 1-D bulk copy (cp.async.bulk, completion
//     on an mbarrier), the 16-byte-aligned body only, and copies the odd
//     element at either end itself;
//   - each thread finds its own window of the tile (kItemsKeys or
//     kItemsPayload outputs) by a binary search in shared memory and merges it into
//     registers; the window is odd, so the windows of a half warp start on
//     16 distinct bank pairs and the write-back into shared memory is free
//     of bank conflicts;
//   - the contiguous output tile leaves by a 1-D bulk store
//     (cp.async.bulk ... bulk_group); a ragged last tile by plain stores;
//   - the mode is a template parameter: the keys-only merge (the whole merge
//     forest) allocates no payload buffer and takes a larger tile;
//   - the fold reads the merged element before its tile and the one after it
//     from the split itself (max(a[a0 - 1], b[b0 - 1]) and min(a[a1],
//     b[b1]), a first on ties), so a pair split by a tile edge is summed and
//     flagged like any other.
// One tile a block: measured faster on the H100 at every main-path shape
// than a persistent grid of resident blocks walking contiguous tiles with
// the next tile's copies in flight (two buffers): 8+ resident blocks an SM
// hide each block's search and copy latency, and no tile waits on another.
// Offsets are int64: forest runs reach FLUSH_WINDOWS + one batch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kItemsKeys = 41;     // outputs a thread merges, keys only: odd, conflict-free windows
constexpr int kItemsPayload = 15;  // the same with a payload (registers bound it)
static_assert(kItemsKeys % 2 == 1 && kItemsPayload % 2 == 1, "items per thread must be odd");
static_assert(kThreads % 16 == 0, "the fold's keep tile leaves as whole 16-byte chunks");
static_assert(kThreads >= 64, "two warps search the tile's ends");

enum Mode : int { kKeys = 0, kPayload = 1, kCombine = 2 };

template <int M>
constexpr int kItemsOf = M == kKeys ? kItemsKeys : kItemsPayload;
template <int M>
constexpr int kTileOf = kThreads * kItemsOf<M>;  // outputs a tile
template <int M>
constexpr int kSlotsOf = kTileOf<M> + 4;  // a tile's slices with a lead element each, and one past b's end
// bytes of the tile's buffer: the key plane, the payload plane, the keep flags
template <int M>
constexpr int kBufferBytes = (M == kKeys ? 1 : 2) * kSlotsOf<M> * 8 + (M == kCombine ? kTileOf<M> : 0);

struct Operands {
  const int64_t* a;
  const int64_t* b;
  const int64_t* pa;  // payload or counts of a (null in the keys-only mode)
  const int64_t* pb;
  int64_t na, nb;
  int64_t* out;
  int64_t* pout;      // payload, or the summed counts of the fold
  uint8_t* keep;      // the fold's keep mask, else null
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(smem_addr(src)),
               "r"(bytes)
               : "memory");
}

// Elements of a among the first diag outputs of the stable merge of a and b
// (a first on ties), by one warp.  P(i) = a[i] <= b[diag - 1 - i] holds for
// i below the answer and fails from it on; each round the lanes probe 32
// evenly spaced i and the ballot's count keeps the gap with the first
// failure.
__device__ int64_t warp_merge_path(const int64_t* __restrict__ a, int64_t na, const int64_t* __restrict__ b,
                                   int64_t nb, int64_t diag, int lane) {
  int64_t lo = diag > nb ? diag - nb : 0;
  int64_t hi = diag < na ? diag : na;
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) >> 5;
    const int64_t i = lo + lane * step;
    const bool holds = i < hi && a[i] <= b[diag - 1 - i];
    const int c = __popc(__ballot_sync(0xFFFFFFFFu, holds));
    if (c == 0) {
      hi = lo;
    } else {
      const int64_t end = lo + c * step;
      lo += (int64_t)(c - 1) * step + 1;
      hi = end < hi ? end : hi;
    }
  }
  return lo;
}

// The same search inside a tile, by one thread, over shared memory.
__device__ __forceinline__ int smem_merge_path(const int64_t* sa, int la, const int64_t* sb, int lb, int diag) {
  int lo = diag > lb ? diag - lb : 0;
  int hi = diag < la ? diag : la;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sa[mid] <= sb[diag - 1 - mid]) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Slot of a slice's first element in its region: 1 where the slice starts
// 8 bytes past a 16-byte boundary, so that its aligned body lands on one.
__device__ __forceinline__ int lead_of(const int64_t* g) {
  return ((uintptr_t)g & 15) ? 1 : 0;
}

// Where tile t's slices sit in a buffer, per plane.
struct Layout {
  int64_t d0, a0, b0;
  int len, la, lb, ra;  // ra: slots of a's region
};

template <int M>
__device__ __forceinline__ Layout layout_of(int64_t t, int64_t a0, int64_t a1, int64_t n) {
  Layout l;
  l.d0 = t * kTileOf<M>;
  const int64_t d1 = l.d0 + kTileOf<M> < n ? l.d0 + kTileOf<M> : n;
  l.a0 = a0;
  l.b0 = l.d0 - a0;
  l.len = (int)(d1 - l.d0);
  l.la = (int)(a1 - a0);
  l.lb = l.len - l.la;
  l.ra = (l.la + 2) & ~1;
  return l;
}

// Thread 0: copies of one slice of m elements from g into region (16-byte
// aligned): its aligned body in bulk, a lead and a trailing element by hand.
__device__ __forceinline__ uint32_t body_bytes(const int64_t* g, int m) {
  const int lead = lead_of(g);
  return m > lead ? (uint32_t)((m - lead) & ~1) * 8u : 0u;
}

__device__ __forceinline__ void copy_slice(const int64_t* g, int m, int64_t* region, uint64_t* bar) {
  const int lead = lead_of(g);
  int64_t* dst = region + lead;
  if (m == 0) return;
  const int body = m > lead ? (m - lead) & ~1 : 0;
  if (body) bulk_load(dst + lead, g + lead, (uint32_t)body * 8u, bar);
  if (lead) dst[0] = g[0];
  if (lead + body < m) dst[lead + body] = g[lead + body];
}

// Thread 0: start tile t's copies into buf, and for the fold record the key
// before the tile and the element after it.
template <int M>
__device__ void start_tile(const Operands& o, const Layout& l, char* buf, uint64_t* bar, int64_t* edge) {
  int64_t* k_s = reinterpret_cast<int64_t*>(buf);
  int64_t* p_s = k_s + kSlotsOf<M>;
  const int64_t* ga = o.a + l.a0;
  const int64_t* gb = o.b + l.b0;
  uint32_t bytes = body_bytes(ga, l.la) + body_bytes(gb, l.lb);
  if constexpr (M != kKeys) bytes += body_bytes(o.pa + l.a0, l.la) + body_bytes(o.pb + l.b0, l.lb);
  mbar_arrive_expect(bar, bytes);
  copy_slice(ga, l.la, k_s, bar);
  copy_slice(gb, l.lb, k_s + l.ra, bar);
  if constexpr (M != kKeys) {
    copy_slice(o.pa + l.a0, l.la, p_s, bar);
    copy_slice(o.pb + l.b0, l.lb, p_s + l.ra, bar);
  }
  if constexpr (M == kCombine) {
    // the merged element before the tile is the larger of the two
    // predecessors, the one after it the smaller successor (a first on
    // ties); every candidate is loaded at once, so the edges cost one
    // round trip
    const int64_t a1 = l.a0 + l.la, b1 = l.b0 + l.lb;
    const bool has_a = a1 < o.na, has_b = b1 < o.nb;
    const int64_t pa = l.a0 > 0 ? o.a[l.a0 - 1] : INT64_MIN;
    const int64_t pb = l.b0 > 0 ? o.b[l.b0 - 1] : INT64_MIN;
    const int64_t ka = has_a ? o.a[a1] : 0, ca = has_a ? o.pa[a1] : 0;
    const int64_t kb = has_b ? o.b[b1] : 0, cb = has_b ? o.pb[b1] : 0;
    const bool from_a = has_a && (!has_b || ka <= kb);
    edge[0] = pa > pb ? pa : pb;
    edge[1] = from_a ? ka : kb;
    edge[2] = from_a ? ca : cb;
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads) merge_kernel(Operands o) {
  constexpr int kItems = kItemsOf<M>;
  constexpr int kTile = kTileOf<M>;
  constexpr int kSlots = kSlotsOf<M>;
  extern __shared__ __align__(128) char smem[];
  __shared__ uint64_t bar_s;
  __shared__ int64_t ends_s[2];  // a's share of the tile's start and of its end
  __shared__ int64_t edge_s[3];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t n = o.na + o.nb;
  const int64_t t = blockIdx.x;

  if (tid == 0) {
    mbar_init(&bar_s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (warp < 2) {  // warp 0 finds the tile's start, warp 1 its end
    const int64_t d = (t + warp) * kTile;
    const int64_t s = warp_merge_path(o.a, o.na, o.b, o.nb, d < n ? d : n, lane);
    if (lane == 0) ends_s[warp] = s;
  }
  __syncthreads();
  const Layout l = layout_of<M>(t, ends_s[0], ends_s[1], n);
  if (tid == 0) start_tile<M>(o, l, smem, &bar_s, edge_s);
  __syncthreads();  // the hand-copied elements and the edges
  int64_t* k_s = reinterpret_cast<int64_t*>(smem);
  int64_t* p_s = k_s + kSlots;
  const int64_t* sa = k_s + lead_of(o.a + l.a0);
  const int64_t* sb = k_s + l.ra + lead_of(o.b + l.b0);
  const int64_t* spa = p_s + (M != kKeys ? lead_of(o.pa + l.a0) : 0);
  const int64_t* spb = p_s + l.ra + (M != kKeys ? lead_of(o.pb + l.b0) : 0);
  mbar_wait(&bar_s, 0);

  // merge this thread's window into registers
  const int diag = tid * kItems < l.len ? tid * kItems : l.len;
  int i = smem_merge_path(sa, l.la, sb, l.lb, diag);
  int j = diag - i;
  int64_t ka = sa[i], kb = sb[j];  // one past a slice's end is still inside the buffer
  int64_t rk[kItems], rp[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    if (diag + it < l.len) {
      const bool take_a = i < l.la && (j >= l.lb || ka <= kb);
      if (take_a) {
        rk[it] = ka;
        if constexpr (M != kKeys) rp[it] = spa[i];
        ka = sa[++i];
      } else {
        rk[it] = kb;
        if constexpr (M != kKeys) rp[it] = spb[j];
        kb = sb[++j];
      }
    }
  }
  __syncthreads();  // every window is merged: the buffer takes the output tile
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    if (diag + it < l.len) {
      k_s[diag + it] = rk[it];
      if constexpr (M != kKeys) p_s[diag + it] = rp[it];
    }
  }
  if constexpr (M == kCombine) {
    // sum each key's count with an equal successor's, flag each key unlike
    // its predecessor; the neighbours outside the window are a thread's
    // neighbours' or the tile's edges
    __syncthreads();
    uint8_t* keep_s = reinterpret_cast<uint8_t*>(p_s + kSlots);
    const int after = diag + kItems < l.len ? diag + kItems : l.len;  // first element past the window
    const bool after_in_tile = after < l.len;
    const int64_t after_k = after_in_tile ? k_s[after] : edge_s[1];
    const int64_t after_c = after_in_tile ? p_s[after] : edge_s[2];
    const bool has_after = after_in_tile || l.d0 + l.len < n;
    int64_t prev = diag > 0 ? k_s[diag - 1] : edge_s[0];
    bool has_prev = diag > 0 || l.d0 > 0;
    uint8_t flag[kItems];
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      if (diag + it < l.len) {
        const bool inner = it + 1 < kItems && diag + it + 1 < l.len;  // the successor is this window's
        const int64_t nk = inner ? rk[it + 1 < kItems ? it + 1 : it] : after_k;
        const int64_t nc = inner ? rp[it + 1 < kItems ? it + 1 : it] : after_c;
        flag[it] = !has_prev || rk[it] != prev;
        prev = rk[it];
        has_prev = true;
        if ((inner || has_after) && nk == rk[it]) rp[it] += nc;
      }
    }
    __syncthreads();  // neighbours read: the counts become sums
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      if (diag + it < l.len) {
        p_s[diag + it] = rp[it];
        keep_s[diag + it] = flag[it];
      }
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (l.len == kTile) {
    if (tid == 0) {
      bulk_store(o.out + l.d0, k_s, kTile * 8);
      if constexpr (M != kKeys) bulk_store(o.pout + l.d0, p_s, kTile * 8);
      if constexpr (M == kCombine) bulk_store(o.keep + l.d0, p_s + kSlots, kTile);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  } else {  // the ragged last tile
    for (int x = tid; x < l.len; x += kThreads) {
      o.out[l.d0 + x] = k_s[x];
      if constexpr (M != kKeys) o.pout[l.d0 + x] = p_s[x];
      if constexpr (M == kCombine) o.keep[l.d0 + x] = reinterpret_cast<const uint8_t*>(p_s + kSlots)[x];
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int M>
int launch(const Operands& o, cudaStream_t stream) {
  static_assert(kBufferBytes<M> + 64 <= 48 * 1024, "a tile's buffer fits the default dynamic shared memory");
  const int64_t n_tiles = (o.na + o.nb + kTileOf<M> - 1) / kTileOf<M>;
  if (n_tiles == 0) return 0;
  merge_kernel<M><<<(unsigned)n_tiles, kThreads, kBufferBytes<M>, stream>>>(o);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// out = stable merge of a[0:na] and b[0:nb], a first on equal keys.
//   keys only:  pa, pb, pout and keep null;
//   payload:    pout = the payloads pa, pb in the same order, keep null;
//   fold:       a and b sorted unique, pa and pb their counts; pout = each
//               merged key's count plus its successor's where the successor
//               has the same key, keep[i] = (i == 0 || out[i] != out[i - 1]).
// out, pout and keep must be 16-byte aligned (fresh allocations); a, b, pa
// and pb need only 8.
extern "C" int okt_merge(const void* a, int64_t na, const void* b, int64_t nb, const void* pa, const void* pb,
                         void* out, void* pout, void* keep, void* stream) {
  if (na < 0 || nb < 0 || (keep != nullptr && pout == nullptr)) return (int)cudaErrorInvalidValue;
  if (!aligned16(out) || !aligned16(pout) || !aligned16(keep)) return (int)cudaErrorMisalignedAddress;
  const Operands o{(const int64_t*)a, (const int64_t*)b, (const int64_t*)pa, (const int64_t*)pb, na, nb,
                   (int64_t*)out, (int64_t*)pout, (uint8_t*)keep};
  cudaStream_t s = (cudaStream_t)stream;
  if (keep != nullptr) return launch<kCombine>(o, s);
  if (pout != nullptr) return launch<kPayload>(o, s);
  return launch<kKeys>(o, s);
}
