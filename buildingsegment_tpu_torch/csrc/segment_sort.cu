// segment_sort: the stable order of the live rows by id, in which the
// segment sums (segment_sum.cu) fold each id's rows.
//
// Replaces no TPU kernel: it stands in for the general sort the port
// first took for this permutation (torch.sort(stable=True) over a key
// per row, the dead rows included, then a gather).  The plain version is
// ops/segsum.py segment_order_reference (torch.argsort, stable, over the
// live rows); kernels.segment_order_cuda exposes the order alone.
//
// Function: the rows r with 0 <= idx[r] < size, ordered by (idx[r], r):
// the permutation torch.sort(key, stable=True) gives over the live rows.
// Each live row's slot j in that order receives its C floats of `rows`
// (the segment sums' staged rows) or its row index (the order alone),
// and each id gets its run [start, end) of slots; an id without rows
// gets [-1, -1).
//
// What bounds it on the H100: bytes and latency, not operations.  A pass
// reads and writes 8 B a live row (its key and row index), the last one
// the rows' C floats; at the slice's 223,232 rows that is ~2 MB a pass
// and ~29 MB for 16 columns, a few microseconds at 3.35 TB/s.  Between
// the passes sit the tiles' look-back waits and the launches.
//
// Design: an LSD radix sort over only the bits the ids need
// (bit_length(size - 1)), in passes of at most kMaxDigitBits bits:
// kernels.segment_sort_plan picks the fewest passes and splits the bits
// evenly (one pass up to 2,048 ids, two up to 2^22, three above).
// Eleven bits is where a tile's per-warp digit counters (8 warps x 2,048
// x 16 bits = 32 KB of shared memory) and its look-back tables (2,048
// words a tile) stay small; more bits a pass would cost shared memory
// and look-back traffic on every tile, fewer would cost a pass.
//   hist: one read of idx counts the live rows of every digit of every
//     pass (a shared-memory atomic a live row and pass: on the H100 these
//     cost little even when a warp's rows share one digit); the last
//     block to finish turns the counts into each pass's digit offsets,
//     and the grid sets every id's run to empty;
//   pass (one launch a pass): a block takes the next 4,096-row tile (an
//     atomic counter, so the tiles a block waits on are already
//     running).  The first pass reads idx itself (int32 or int64) and
//     drops the dead rows; the later ones read the previous pass's
//     (key, row) pairs.  Each warp ranks its 256 rows in row order: the
//     lanes of equal digits find each other (one ballot a digit bit: the
//     function of __match_any_sync, at a cost that does not grow with
//     the distinct digits), count the lanes below them (popc) and add the
//     warp's running count of that digit; the warps' counts are then
//     scanned in warp order.  So
//     equal digits keep their row order inside the tile.  The tile
//     publishes its digit counts, then looks back (decoupled look-back:
//     warp 0 reads 32 predecessors' flags at a time, back to the nearest
//     one that published its inclusive prefix, and the block adds their
//     counts digit by digit), so across tiles the order is digit-major
//     and then tile order: the pass is stable.  The rows go through
//     shared memory in their local order, so the writes of a digit's
//     rows are consecutive slots.  The last pass writes each live row's
//     floats (or its index) at its slot, and marks the runs: in its
//     input the rows of one top digit come in order of the lower bits,
//     so each id's rows sit together in a tile's local order; the first
//     and last of them set start (atomicMin) and end (atomicMax).
// Launches: a memset of the header, hist, one per pass.  Row indices and
// keys are int32 (m < 2^31 - 1).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "segment_sort.cuh"

namespace segsort {
namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                 // rows a thread
constexpr int kTile = kThreads * kItems;  // rows a tile: 4,096
constexpr int kFlagAgg = 1;     // the tile's own digit counts are out
constexpr int kFlagPrefix = 2;  // its inclusive prefix is out
constexpr int kInFlight = 8;    // loads a thread keeps in flight
constexpr int kRunsAThread = 32;  // run bounds a histogram thread clears
constexpr int kScanSlots = 24;    // a block scan's warp sums and two words
constexpr int kSlotTile = 20;     // ... of which: the block's tile
constexpr int kSlotPrefix = 21;   // ... and the tile whose prefix it adds
static_assert(4 * kThreads == 1 << kMaxDigitBits,
              "a thread's int4 loads of the look-back hit fixed digits");

struct Layout {  // offsets in ints from the start of the scratch
  int tiles, nbins;
  size_t offsets, done, n_live, tile_ctr, flags, header;
  size_t bufs, buf_stride, agg, prefix, total;
};

size_t align64(size_t n) { return (n + 63) & ~static_cast<size_t>(63); }

int id_bits(int size) {
  int b = 0;
  while (b < 31 && (static_cast<int64_t>(1) << b) < size) ++b;
  return b;
}

bool plan_ok(int size, int passes, int digit_bits) {
  return passes >= 1 && passes <= kMaxPasses && digit_bits >= 0 &&
         digit_bits <= kMaxDigitBits &&
         passes * digit_bits >= id_bits(size);
}

Layout make_layout(int m, int passes, int digit_bits) {
  Layout L;
  L.nbins = 1 << digit_bits;
  L.tiles = static_cast<int>((static_cast<int64_t>(m) + kTile - 1) / kTile);
  size_t o = 0;
  L.offsets = o;  // [passes][nbins]: counts, then digit offsets
  o += static_cast<size_t>(passes) * L.nbins;
  L.done = o++;
  L.n_live = o++;
  L.tile_ctr = o;  // [passes]
  o += passes;
  L.flags = o;  // [passes][tiles]
  o += static_cast<size_t>(passes) * L.tiles;
  L.header = align64(o);
  // (key, row) pairs between passes: pass p < passes - 1 writes buffer
  // p & 1, keys then rows
  L.buf_stride = align64(2 * static_cast<size_t>(m));
  L.bufs = L.header;
  o = L.bufs + L.buf_stride * (passes > 2 ? 2 : passes - 1);
  L.agg = o;  // [tiles][nbins]: a tile's own counts (reused by each pass)
  o += align64(static_cast<size_t>(L.tiles) * L.nbins);
  L.prefix = o;  // [tiles][nbins]: a tile's inclusive prefix
  o += align64(static_cast<size_t>(L.tiles) * L.nbins);
  L.total = o;
  return L;
}

size_t pass_smem(int nbins) {
  return static_cast<size_t>(2 * kTile + 4 * nbins + kScanSlots) *
             sizeof(int) +
         static_cast<size_t>(kWarps) * nbins * sizeof(unsigned short);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// The lanes whose `live` equals this lane's and, where live, whose low
// `bits` bits of d equal this lane's: __match_any_sync built from one
// ballot a bit.  The hardware match takes longer the more distinct
// values a warp holds; the ballots cost the same for any digits.
__device__ __forceinline__ unsigned match_digit(unsigned d, int bits,
                                                bool live) {
  const unsigned alive = __ballot_sync(0xffffffffu, live);
  unsigned peers = alive;
  for (int b = 0; b < bits; ++b) {  // every lane takes every ballot
    const unsigned set = __ballot_sync(0xffffffffu, (d >> b) & 1u);
    peers &= (d >> b) & 1u ? set : ~set;
  }
  return live ? peers : ~alive;
}

// out[b] = in[0] + ... + in[b - 1] for b < n (in and out may be one
// array); returns the total.  Each thread scans a run of consecutive
// entries; `slots` holds the warp sums.  Ends with a block barrier.
__device__ int block_exclusive_scan(const int* in, int* out, int n,
                                    int* slots) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int per = (n + kThreads - 1) / kThreads;
  const int b0 = min(t * per, n), b1 = min(b0 + per, n);
  int own = 0;
  for (int b = b0; b < b1; ++b) own += in[b];
  int x = own;  // inclusive scan over the warp's lanes
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) slots[w] = x;
  __syncthreads();
  if (t == 0) {
    int run = 0;
    for (int v = 0; v < kWarps; ++v) {
      const int s = slots[v];
      slots[v] = run;
      run += s;
    }
    slots[kWarps] = run;
  }
  __syncthreads();
  int run = slots[w] + x - own;
  for (int b = b0; b < b1; ++b) {
    const int v = in[b];
    out[b] = run;
    run += v;
  }
  const int total = slots[kWarps];
  __syncthreads();
  return total;
}

// Counts the live rows of every digit of every pass into `offsets`
// (zeroed), sets every run to [-1, -1) and *zero to 0; the last block to
// finish turns each pass's counts into its digit offsets and writes the
// live count.  Block b counts rows [b kTile, (b + 1) kTile), its loads
// all issued before the counting.
template <typename Id>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const Id* __restrict__ idx, int m, int size, int passes,
            int digit_bits, int* __restrict__ offsets, int* __restrict__ done,
            int* __restrict__ n_live, int* __restrict__ runs,
            int* __restrict__ zero) {
  extern __shared__ int hist[];  // [passes][nbins], then the scan's slots
  __shared__ int last;
  const int nbins = 1 << digit_bits;
  const int nb = passes * nbins;
  int* slots = hist + nb;
  const unsigned dmask = static_cast<unsigned>(nbins - 1);
  const int t = threadIdx.x;
  int64_t v[kItems];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kTile + t;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t r = r0 + static_cast<int64_t>(i) * kThreads;
    v[i] = r < m ? static_cast<int64_t>(idx[r]) : -1;
  }
  for (int b = t; b < nb; b += kThreads) hist[b] = 0;
  if (zero != nullptr && blockIdx.x == 0 && t == 0) *zero = 0;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (v[i] < 0 || v[i] >= size) continue;
    for (int p = 0; p < passes; ++p)
      atomicAdd(&hist[p * nbins +
                      ((static_cast<unsigned>(v[i]) >> (p * digit_bits)) &
                       dmask)],
                1);
  }
  __syncthreads();
  for (int b = t; b < nb; b += kThreads)
    if (hist[b] != 0) atomicAdd(&offsets[b], hist[b]);
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + t;
       j < 2 * static_cast<int64_t>(size);
       j += static_cast<int64_t>(gridDim.x) * kThreads)
    runs[j] = -1;
  __syncthreads();  // the block's counts are out: one fence, one ticket
  if (t == 0) {
    __threadfence();
    last = atomicAdd(done, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int b = t; b < nb; b += kThreads) hist[b] = __ldcg(&offsets[b]);
  __syncthreads();
  int total = 0;
  for (int p = 0; p < passes; ++p)
    total = block_exclusive_scan(hist + p * nbins, hist + p * nbins, nbins,
                                 slots);
  for (int b = t; b < nb; b += kThreads) offsets[b] = hist[b];
  if (t == 0) *n_live = total;  // each pass counts every live row once
}

struct PassArgs {
  const void* idx;     // the first pass: the ids
  const int* in_key;   // a later pass: the previous pass's pairs
  const int* in_row;
  int m;               // the first pass: rows of idx
  const int* n_live;   // a later pass: rows of the pairs
  int size;
  int shift;           // this pass's digit: (key >> shift) & (nbins - 1)
  int digit_bits;
  const int* offsets;  // this pass's digit offsets
  int* tile_ctr;       // this pass's tile counter and flags
  int* flags;
  int* agg;            // [tiles][nbins]
  int* prefix;
  int* out_key;        // a pass before the last: the next pass's pairs
  int* out_row;
  int* start;          // the last pass: runs, and rows or indices
  int* end;
  const float* rows;
  int cols;
  bool vec4;           // cols % 4 == 0, rows and staged 16-byte aligned
  float* staged;
  int* perm;
};

// staged[slot(lp) * q + c] = rows[lrow[lp] * q + c] for the tile's local
// positions lp < n_tile and c < q (T: float or float4).
template <typename T>
__device__ __forceinline__ void gather_rows(
    const T* __restrict__ rows, T* __restrict__ staged, int q, int n_tile,
    const int* lkey, const int* lrow, const int* delta, int shift,
    unsigned dmask) {
  const int ne = n_tile * q;
  for (int e0 = threadIdx.x; e0 < ne; e0 += kInFlight * kThreads) {
    T v[kInFlight];
    int64_t dst[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e = e0 + u * kThreads;
      dst[u] = -1;
      if (e < ne) {
        const int lp = e / q, c = e - lp * q;
        const int k = lkey[lp];
        const int slot = delta[(static_cast<unsigned>(k) >> shift) & dmask] +
                         lp;
        dst[u] = static_cast<int64_t>(slot) * q + c;
        v[u] = __ldg(rows + static_cast<int64_t>(lrow[lp]) * q + c);
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      if (dst[u] >= 0) staged[dst[u]] = v[u];
  }
}

// Src: 0 int32 ids, 1 int64 ids, 2 the previous pass's pairs.  Dst: 0 the
// next pass's pairs, 1 the rows' floats and the runs, 2 the row indices
// and the runs.
template <int Src, int Dst>
__global__ void __launch_bounds__(kThreads) pass_kernel(const PassArgs a) {
  extern __shared__ __align__(16) int sm[];
  const int nbins = 1 << a.digit_bits;
  const unsigned dmask = static_cast<unsigned>(nbins - 1);
  int* lkey = sm;              // the tile's live rows in local order
  int* lrow = lkey + kTile;
  int* cnt = lrow + kTile;     // the tile's rows a digit
  int* base = cnt + nbins;     // a digit's local start
  int* delta = base + nbins;   // the earlier tiles' rows, then slot - local
  int* offs = delta + nbins;   // the pass's digit offsets
  int* slots = offs + nbins;   // kScanSlots
  // a warp's rows a digit, then the rows of the warps before it
  unsigned short* wcount =
      reinterpret_cast<unsigned short*>(slots + kScanSlots);
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;

  if (t == 0) slots[kSlotTile] = atomicAdd(a.tile_ctr, 1);
  const int64_t n_in = Src == 2 ? *a.n_live : a.m;
  for (int j = t; j < kWarps * nbins / 2; j += kThreads)
    reinterpret_cast<int*>(wcount)[j] = 0;
  for (int b = t; b < nbins; b += kThreads) offs[b] = a.offsets[b];
  __syncthreads();
  const int tile = slots[kSlotTile];
  const int64_t tile0 = static_cast<int64_t>(tile) * kTile;
  if (tile0 >= n_in) return;  // past the live rows: no tile reads this one

  // 1. load: warp w takes rows [tile0 + 256 w, tile0 + 256 (w + 1)), 32 a
  // step; a dead or absent row carries key -1
  int key[kItems], row[kItems];
  const int64_t r0 = tile0 + w * (32 * kItems) + lane;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t r = r0 + 32 * i;
    key[i] = -1;
    row[i] = 0;
    if (r < n_in) {
      if constexpr (Src == 2) {
        key[i] = a.in_key[r];
        row[i] = a.in_row[r];
      } else {
        using Id = typename std::conditional<Src == 1, int64_t, int>::type;
        const int64_t v = static_cast<const Id*>(a.idx)[r];
        if (v >= 0 && v < a.size) {
          key[i] = static_cast<int>(v);
          row[i] = static_cast<int>(r);
        }
      }
    }
  }

  // 2. rank: a row's rank among the warp's earlier rows of its digit
  unsigned short* wc = wcount + w * nbins;
  const unsigned below = (1u << lane) - 1;
  int rank[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool live = key[i] >= 0;
    const unsigned d =
        live ? (static_cast<unsigned>(key[i]) >> a.shift) & dmask : 0u;
    const unsigned peers = match_digit(d, a.digit_bits, live);
    const int before = live ? wc[d] : 0;
    __syncwarp();
    rank[i] = before + __popc(peers & below);
    if (live && lane == 31 - __clz(peers))
      wc[d] = static_cast<unsigned short>(before + __popc(peers));
    __syncwarp();
  }
  __syncthreads();
  for (int b = t; b < nbins; b += kThreads) {
    int run = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const int c = wcount[v * nbins + b];
      wcount[v * nbins + b] = static_cast<unsigned short>(run);
      run += c;
    }
    cnt[b] = run;
  }
  __syncthreads();

  // 3. publish the tile's counts (tile 0: its inclusive prefix)
  int* own = (tile == 0 ? a.prefix : a.agg) + static_cast<size_t>(tile) *
                                                  nbins;
  for (int b = t; b < nbins; b += kThreads) own[b] = cnt[b];
  const int n_tile = block_exclusive_scan(cnt, base, nbins, slots);
  if (t == 0) {  // after the scan's barrier: every thread's counts are out
    __threadfence();
    st_release(a.flags + tile, tile == 0 ? kFlagPrefix : kFlagAgg);
  }

  // 4. the live rows into local order: digit, then warp, then rank
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (key[i] < 0) continue;
    const unsigned d = (static_cast<unsigned>(key[i]) >> a.shift) & dmask;
    const int lp = base[d] + wcount[w * nbins + d] + rank[i];
    lkey[lp] = key[i];
    lrow[lp] = row[i];
  }

  // 5. look back: the rows of each digit in the tiles before this one
  if (tile > 0) {
    if (w == 0) {
      int hi = tile;  // the tiles [hi - 32, hi) are read at once
      for (;;) {
        const int tt = hi - 1 - lane;
        const int f = tt >= 0 ? ld_acquire(a.flags + tt) : kFlagPrefix;
        const unsigned ready = __ballot_sync(0xffffffffu, f != 0);
        const unsigned pref = __ballot_sync(0xffffffffu, f == kFlagPrefix);
        if (pref != 0) {
          const int np = __ffs(pref) - 1;  // the nearest prefix
          const unsigned need = np == 31 ? 0xffffffffu : (2u << np) - 1;
          if ((ready & need) == need) {
            if (lane == 0) slots[kSlotPrefix] = hi - 1 - np;
            break;
          }
        } else if (ready == 0xffffffffu) {
          hi -= 32;  // 32 counts out, no prefix among them: further back
          continue;
        }
        __nanosleep(64);
      }
    }
    __syncthreads();
    // the prefix, plus the counts of the tiles after it: one contiguous
    // run of `agg`, read by the whole block, many loads in flight
    const int pt = slots[kSlotPrefix];
    for (int b = t; b < nbins; b += kThreads)
      delta[b] = __ldcg(a.prefix + static_cast<size_t>(pt) * nbins + b);
    __syncthreads();
    const int* run = a.agg + static_cast<size_t>(pt + 1) * nbins;
    const int n = (tile - pt - 1) * nbins;
    if (nbins >= 4) {
      // int4 j covers digits 4j mod nbins: thread t's are fixed, 4t mod
      // nbins, for 4 kThreads is a multiple of nbins
      const int4* run4 = reinterpret_cast<const int4*>(run);
      int4 sum = make_int4(0, 0, 0, 0);
      int j = t;
      for (; j + (kInFlight - 1) * kThreads < (n >> 2);
           j += kInFlight * kThreads) {
        int4 q[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u)
          q[u] = __ldcg(run4 + j + u * kThreads);
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          sum.x += q[u].x;
          sum.y += q[u].y;
          sum.z += q[u].z;
          sum.w += q[u].w;
        }
      }
      for (; j < (n >> 2); j += kThreads) {
        const int4 q = __ldcg(run4 + j);
        sum.x += q.x;
        sum.y += q.y;
        sum.z += q.z;
        sum.w += q.w;
      }
      if (t < (n >> 2)) {
        const int b = (4 * t) & (nbins - 1);
        atomicAdd(delta + b, sum.x);
        atomicAdd(delta + b + 1, sum.y);
        atomicAdd(delta + b + 2, sum.z);
        atomicAdd(delta + b + 3, sum.w);
      }
    } else {
      int sum = 0;
      for (int j = t; j < n; j += kThreads) sum += __ldcg(run + j);
      if (t < n) atomicAdd(delta + (t & (nbins - 1)), sum);
    }
    __syncthreads();
    for (int b = t; b < nbins; b += kThreads) {
      a.prefix[static_cast<size_t>(tile) * nbins + b] = delta[b] + cnt[b];
      delta[b] = offs[b] + delta[b] - base[b];
    }
    __syncthreads();
    if (t == 0) {
      __threadfence();
      st_release(a.flags + tile, kFlagPrefix);
    }
  } else {
    for (int b = t; b < nbins; b += kThreads) delta[b] = offs[b] - base[b];
    __syncthreads();
  }

  // 6. write: a row's slot is delta[digit] + its local position
  if constexpr (Dst == 0) {
    for (int lp = t; lp < n_tile; lp += kThreads) {
      const int k = lkey[lp];
      const int slot =
          delta[(static_cast<unsigned>(k) >> a.shift) & dmask] + lp;
      a.out_key[slot] = k;
      a.out_row[slot] = lrow[lp];
    }
  } else {
    for (int lp = t; lp < n_tile; lp += kThreads) {
      const int k = lkey[lp];
      const int slot =
          delta[(static_cast<unsigned>(k) >> a.shift) & dmask] + lp;
      if (lp == 0 || lkey[lp - 1] != k)
        atomicMin(reinterpret_cast<unsigned*>(a.start + k),
                  static_cast<unsigned>(slot));
      if (lp == n_tile - 1 || lkey[lp + 1] != k)
        atomicMax(a.end + k, slot + 1);
      if constexpr (Dst == 2) a.perm[slot] = lrow[lp];
    }
    if constexpr (Dst == 1) {
      // one thread a float4 (or a float) of the staged rows: consecutive
      // threads write consecutive ones; kInFlight loads a thread in
      // flight, for a tile's gather runs on one SM
      if (a.vec4) {
        const int q = a.cols >> 2;
        gather_rows(reinterpret_cast<const float4*>(a.rows),
                    reinterpret_cast<float4*>(a.staged), q, n_tile, lkey,
                    lrow, delta, a.shift, dmask);
      } else {
        gather_rows(a.rows, a.staged, a.cols, n_tile, lkey, lrow, delta,
                    a.shift, dmask);
      }
    }
  }
}

using PassFn = void (*)(PassArgs);
const PassFn kPass[3][3] = {
    {pass_kernel<0, 0>, pass_kernel<0, 1>, pass_kernel<0, 2>},
    {pass_kernel<1, 0>, pass_kernel<1, 1>, pass_kernel<1, 2>},
    {pass_kernel<2, 0>, pass_kernel<2, 1>, pass_kernel<2, 2>}};

}  // namespace

size_t scratch_bytes(int m, int size, int passes, int digit_bits) {
  if (m < 0 || size < 1 || !plan_ok(size, passes, digit_bits)) return 0;
  return make_layout(m, passes, digit_bits).total * sizeof(int);
}

int sort(const void* idx, bool idx64, int m, int size, int passes,
         int digit_bits, void* scratch, size_t scratch_size, int* runs,
         const float* rows, int cols, float* staged, int* perm, int* zero,
         cudaStream_t stream) {
  if (m < 0 || size < 1 || !plan_ok(size, passes, digit_bits) ||
      runs == nullptr || (m > 0 && staged == nullptr && perm == nullptr) ||
      (staged != nullptr && cols < 1))
    return cudaErrorInvalidValue;
  const Layout L = make_layout(m, passes, digit_bits);
  if (scratch == nullptr || scratch_size < L.total * sizeof(int))
    return cudaErrorInvalidValue;
  int* s = static_cast<int*>(scratch);
  cudaError_t err =
      cudaMemsetAsync(s, 0, L.header * sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = passes * L.nbins;
  const int64_t per_block = static_cast<int64_t>(kThreads) * kRunsAThread;
  const int blocks = static_cast<int>(std::max<int64_t>(
      {1, L.tiles, (2 * static_cast<int64_t>(size) + per_block - 1) /
                       per_block}));
  const size_t hsmem = (nb + kScanSlots) * sizeof(int);
  if (idx64)
    hist_kernel<int64_t><<<blocks, kThreads, hsmem, stream>>>(
        static_cast<const int64_t*>(idx), m, size, passes, digit_bits,
        s + L.offsets, s + L.done, s + L.n_live, runs, zero);
  else
    hist_kernel<int><<<blocks, kThreads, hsmem, stream>>>(
        static_cast<const int*>(idx), m, size, passes, digit_bits,
        s + L.offsets, s + L.done, s + L.n_live, runs, zero);
  err = cudaGetLastError();
  if (err != cudaSuccess || m == 0) return static_cast<int>(err);
  PassArgs a = {};
  a.idx = idx;
  a.m = m;
  a.n_live = s + L.n_live;
  a.size = size;
  a.digit_bits = digit_bits;
  a.agg = s + L.agg;
  a.prefix = s + L.prefix;
  a.start = runs;
  a.end = runs + size;
  a.rows = rows;
  a.cols = cols;
  a.vec4 = cols % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(staged) % 16 == 0;
  a.staged = staged;
  a.perm = perm;
  const size_t smem = pass_smem(L.nbins);
  for (int p = 0; p < passes; ++p) {
    a.shift = p * digit_bits;
    a.offsets = s + L.offsets + static_cast<size_t>(p) * L.nbins;
    a.tile_ctr = s + L.tile_ctr + p;
    a.flags = s + L.flags + static_cast<size_t>(p) * L.tiles;
    if (p > 0) {
      const int* in = s + L.bufs + L.buf_stride * ((p - 1) & 1);
      a.in_key = in;
      a.in_row = in + m;
    }
    if (p + 1 < passes) {
      int* out = s + L.bufs + L.buf_stride * (p & 1);
      a.out_key = out;
      a.out_row = out + m;
    }
    const int src = p > 0 ? 2 : idx64 ? 1 : 0;
    const int dst = p + 1 < passes ? 0 : staged != nullptr ? 1 : 2;
    void* args[] = {&a};
    err = cudaLaunchKernel(reinterpret_cast<const void*>(kPass[src][dst]),
                           dim3(L.tiles), dim3(kThreads), args, smem, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

int init() {
  const int smem = static_cast<int>(pass_smem(1 << kMaxDigitBits));
  for (auto& by_dst : kPass)
    for (PassFn fn : by_dst) {
      const cudaError_t err = cudaFuncSetAttribute(
          reinterpret_cast<const void*>(fn),
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  return 0;
}

}  // namespace segsort

extern "C" {

// The order alone (kernels.segment_order_cuda): perm i32[m], its first
// n_live entries the live rows in order; runs i32[2, size].
int bst_segment_order(const void* idx, int idx64, int m, int size,
                      int passes, int digit_bits, void* scratch,
                      size_t scratch_size, int* perm, int* runs,
                      void* stream_ptr) {
  return segsort::sort(idx, idx64 != 0, m, size, passes, digit_bits, scratch,
                       scratch_size, runs, nullptr, 0, nullptr, perm, nullptr,
                       static_cast<cudaStream_t>(stream_ptr));
}

}  // extern "C"
