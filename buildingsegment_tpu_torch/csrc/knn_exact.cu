// knn_exact: the exact scan of the brute-force kNN (kernel #14).
//
// Replaces the TPU kernel buildingsegment_tpu/ops/pallas_knn.py _kernel
// (wrapper knn_pallas -> _dispatch, pallas_call at :777); its opt-in
// variant _kernel_resident computes the same function.
//
// For each query row q it keeps the kk = k-1 nearest candidates c with
// |c - q| > w_excl in sorted rank (the rank window is the seeds'
// territory), merged with q's window-kNN seed list, ordered by
// (d^2, index); d^2 = dx*dx + dy*dy + dz*dz in f32 diff form.  Rows at
// the -3e7 sentinel are invalid as queries and as candidates.
//
// What bounds it on the H100: operations.  Each (query, candidate) pair
// in a tile that must be visited costs a d^2 and a compare, ~9 f32
// operations, and the box pruning leaves a few candidate tiles per
// query tile; the bytes (positions, seeds, visit lists, outputs) are a
// few tens of MB.  The first design (one thread a query, the list in
// shared memory, one candidate at a time) ran at about a tenth of the
// card's instruction rate: three separate shared loads, the rank and
// validity tests and a branch a pair, a 49-slot rescan of the list after
// every insert, run one lane at a time (a quarter of its time on the
// H100: tools/ab_kernels.py --knn-probe), a serial tau between two
// barriers, staging not overlapped, and 62 KB of shared memory a 4-warp
// block at k = 50.
//
// Design (kk <= 64, a query tile of 64 or 128 rows, a candidate tile a
// multiple of 32): a pass packs the positions as float4 (x, y, z, 0),
// invalid rows as NaN, so the d^2 of an invalid pair is NaN and fails
// every key compare without a validity test.  A block is one warp and
// owns 64 queries of a query tile, two a lane (lane l: queries l and
// l + 32), so one broadcast float4 load feeds two distances.  Each
// query's list is kept sorted by the 64-bit key (d^2 bits << 32 | index:
// non-negative floats order as their bits, and a NaN key is above all),
// slot-major in shared memory [kk][64], its worst key in a register.  The
// seeds are read coalesced and sorted in place; the output is written
// coalesced from the sorted list.  A listed candidate tile is streamed in
// chunks of 256 candidates through two shared buffers with cp.async: the
// next chunk, or the first of the next listed tile while its box bound
// is at or below tau, is in flight while the current one is scanned.  A
// scan of 32 candidates is branch-free: it sets a bit for each candidate
// whose d^2 may lie at or below the worst's d^2 as it stood at the start
// of the 32 (the queue: a stale worst is an upper bound); then the set
// bits are taken in order, each candidate's d^2 recomputed with the plain
// version's operations, its key tested against the current worst and
// inserted by shifting the larger keys down one slot, four slots read at
// a time.  The filter's d^2 takes two FMAs (six instructions, not
// eight) and is held against wd * (1 + 2^-20) + 2^-100: the plain d^2
// and the FMA form each lie within three roundings of the exact sum of
// the three non-negative squares, so the FMA form of a pair whose plain
// d^2 is <= wd is at most wd (1 + 2^-24)^6 plus a few subnormal ulps,
// below the margin; the filter drops no member.  The
// rank-window test |c - q| > w_excl runs only on a chunk that overlaps
// the rank window of one of the block's queries.  tau, the largest worst
// d^2 over the block's valid queries, is a warp max after each visited
// tile; the block stops at the first listed tile whose box bound exceeds
// it, or after counts[tile] tiles.  tau over 64 queries is at most the
// tile's, and the box bound of the tile's 128 queries is a lower bound
// for any 64 of them, so no skipped tile holds a member.  The kept set is
// the kk smallest keys of seeds U visited candidates whatever the visit
// order: the plain version's set, sorted the same way, so the output
// equals it bit for bit.  Built with -fmad=false, so d^2 rounds as in the
// plain PyTorch version.
//
// Lists longer than 64 entries, and tiles the warp design does not take,
// go to the first design's kernel (knn_exact_kernel below): one block a
// query tile, one thread a query, the list unsorted in shared memory with
// its worst entry rescanned after each insert and sorted at the end.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kMaxQt = 128;
constexpr int kMaxCt = 1024;
constexpr float kValidGt = -1e7f;

constexpr int kTileQueries = 64;  // queries a warp block owns
constexpr int kTileR = 2;         // queries a lane (kTileQueries / 32)
constexpr int kChunk = 256;       // candidates a staged chunk
constexpr int kTileMaxKk = 64;    // longest list the warp design keeps

__device__ __forceinline__ uint64_t knn_key(float d, int c) {
  return (static_cast<uint64_t>(__float_as_uint(d)) << 32) |
         static_cast<uint32_t>(c);
}

// Positions as float4 (x, y, z, 0); an invalid row as NaN.
__global__ void knn_pack_kernel(const float* __restrict__ px,
                                const float* __restrict__ py,
                                const float* __restrict__ pz,
                                float4* __restrict__ pk, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float qnan = __int_as_float(0x7fc00000);
  const float x = px[i];
  pk[i] = x > kValidGt ? make_float4(x, py[i], pz[i], 0.f)
                       : make_float4(qnan, qnan, qnan, 0.f);
}

// Inserts key x (below the worst) into the sorted column `col` (stride
// kTileQueries): the worst drops out, larger keys shift down a slot.  The
// walk from the end reads four slots at a time, so a long shift costs a
// quarter of the dependent shared loads.  Returns the new worst key.
__device__ __forceinline__ uint64_t list_insert(uint64_t* col, int kk,
                                                uint64_t x) {
  int p = kk - 1;  // the slot x takes if no key above it is left
  bool open = true;
  while (open && p >= 4) {
    const uint64_t a = col[(p - 1) * kTileQueries];
    const uint64_t b = col[(p - 2) * kTileQueries];
    const uint64_t c = col[(p - 3) * kTileQueries];
    const uint64_t d = col[(p - 4) * kTileQueries];
    // sorted: x < d implies x < c < ... so the shifts form a prefix
    const bool sa = x < a, sb = x < b, sc = x < c, sd = x < d;
    if (sa) col[p * kTileQueries] = a;
    if (sb) col[(p - 1) * kTileQueries] = b;
    if (sc) col[(p - 2) * kTileQueries] = c;
    if (sd) col[(p - 3) * kTileQueries] = d;
    p -= static_cast<int>(sa) + sb + sc + sd;
    open = sd;
  }
  while (open && p > 0) {
    const uint64_t y = col[(p - 1) * kTileQueries];
    if (!(x < y)) break;
    col[p * kTileQueries] = y;
    --p;
  }
  col[p * kTileQueries] = x;
  return col[(kk - 1) * kTileQueries];
}

struct Queries {
  float x[kTileR], y[kTileR], z[kTileR];
  int row[kTileR];
  bool valid[kTileR];
  uint64_t worst[kTileR];  // 0 for an invalid query: nothing passes
};

// The largest worst d^2 over the warp's valid queries (0 if none).
__device__ __forceinline__ float warp_tau(const Queries& q) {
  float m = 0.f;
#pragma unroll
  for (int r = 0; r < kTileR; ++r)
    if (q.valid[r]) m = fmaxf(m, __uint_as_float(q.worst[r] >> 32));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// One staged chunk of `chunk` candidates, the first at index cb.
template <bool kWin>
__device__ __forceinline__ void scan_chunk(const float4* __restrict__ cand,
                                           int cb, int chunk, Queries& q,
                                           uint64_t* list, int lane, int kk,
                                           int w_excl) {
  for (int c0 = 0; c0 < chunk; c0 += 32) {
    unsigned m[kTileR];
    float wd[kTileR];
#pragma unroll
    for (int r = 0; r < kTileR; ++r) {
      m[r] = 0u;
      wd[r] = __uint_as_float(static_cast<unsigned>(q.worst[r] >> 32)) *
                  (1.f + 0x1p-20f) +
              0x1p-100f;
    }
    // the filter: every candidate against the worst as it stood, with
    // the margin
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float4 b = cand[c0 + j];
      const int c = cb + c0 + j;  // used by the rank test alone
#pragma unroll
      for (int r = 0; r < kTileR; ++r) {
        const float dx = q.x[r] - b.x;
        const float dy = q.y[r] - b.y;
        const float dz = q.z[r] - b.z;
        // the filter's d^2 with two FMAs, against the worst's d^2 with a
        // margin: a superset of key < worst (see the note); NaN fails
        const float d = __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, dx * dx));
        bool pass = d <= wd[r];
        if (kWin) pass = pass && abs(c - q.row[r]) > w_excl;
        if (pass) m[r] |= 1u << j;
      }
    }
    // the queue: the passing candidates in order, against the current
    // worst
#pragma unroll
    for (int r = 0; r < kTileR; ++r) {
      while (m[r]) {
        const int j = __ffs(m[r]) - 1;
        m[r] &= m[r] - 1u;
        const float4 b = cand[c0 + j];
        const float dx = q.x[r] - b.x;
        const float dy = q.y[r] - b.y;
        const float dz = q.z[r] - b.z;
        const uint64_t key = knn_key(dx * dx + dy * dy + dz * dz, cb + c0 + j);
        if (key < q.worst[r])
          q.worst[r] = list_insert(list + r * 32 + lane, kk, key);
      }
    }
  }
}

__global__ void __launch_bounds__(32) knn_tile_kernel(
    const float4* __restrict__ pk, const float* __restrict__ seed_d,
    const int* __restrict__ seed_i, const int* __restrict__ visit,
    const float* __restrict__ visit_d2, const int* __restrict__ counts,
    float* __restrict__ out_d, int* __restrict__ out_i, int kk, int qt,
    int ct, int num_c, int w_excl) {
  extern __shared__ float4 tile_smem[];
  const int chunk = min(ct, kChunk);
  float4* stage = tile_smem;  // [2][chunk]
  uint64_t* list =
      reinterpret_cast<uint64_t*>(tile_smem + 2 * chunk);  // [kk][64]
  const int lane = threadIdx.x;
  const int q0 = blockIdx.x * kTileQueries;
  const int qtile = q0 / qt;
  const size_t vrow = static_cast<size_t>(qtile) * num_c;

  // the seeds, read coalesced into slot-major columns, then each column
  // sorted in place
  const int nkey = kTileQueries * kk;
  const size_t sbase = static_cast<size_t>(q0) * kk;
  for (int e = lane; e < nkey; e += 32) {
    const int ql = e / kk;
    list[(e - ql * kk) * kTileQueries + ql] =
        knn_key(seed_d[sbase + e], seed_i[sbase + e]);
  }
  __syncwarp();
  Queries q;
#pragma unroll
  for (int r = 0; r < kTileR; ++r) {
    uint64_t* col = list + r * 32 + lane;
    for (int s = 1; s < kk; ++s) {
      const uint64_t x = col[s * kTileQueries];
      int p = s;
      while (p > 0) {
        const uint64_t y = col[(p - 1) * kTileQueries];
        if (!(x < y)) break;
        col[p * kTileQueries] = y;
        --p;
      }
      col[p * kTileQueries] = x;
    }
    const int row = q0 + r * 32 + lane;
    const float4 a = pk[row];
    q.x[r] = a.x;
    q.y[r] = a.y;
    q.z[r] = a.z;
    q.row[r] = row;
    q.valid[r] = a.x == a.x;
    q.worst[r] = q.valid[r] ? col[(kk - 1) * kTileQueries] : 0ull;
  }
  float tau = warp_tau(q);

  // the listed tiles, chunk by chunk, the next chunk in flight
  const int count = counts[qtile];
  const int nch = ct / chunk;
  auto fetch = [&](int v, int h, int buf) {
    const float4* src = pk + static_cast<size_t>(visit[vrow + v]) * ct +
                        h * chunk;
    float4* dst = stage + buf * chunk;
    for (int e = lane; e < chunk; e += 32)
      cp_async::copy16(dst + e, src + e);
    cp_async::commit();
  };
  int v = 0, h = 0, buf = 0;
  fetch(0, 0, 0);
  while (true) {
    bool ahead = true;
    if (h + 1 < nch)
      fetch(v, h + 1, buf ^ 1);
    else if (v + 1 < count && visit_d2[vrow + v + 1] <= tau)
      fetch(v + 1, 0, buf ^ 1);  // may be skipped once tau shrinks
    else
      ahead = false;
    if (ahead)
      cp_async::wait<1>();
    else
      cp_async::wait<0>();
    __syncwarp();
    const int cb = visit[vrow + v] * ct + h * chunk;
    const float4* cand = stage + buf * chunk;
    if (cb <= q0 + kTileQueries - 1 + w_excl && cb + chunk - 1 >= q0 - w_excl)
      scan_chunk<true>(cand, cb, chunk, q, list, lane, kk, w_excl);
    else
      scan_chunk<false>(cand, cb, chunk, q, list, lane, kk, w_excl);
    __syncwarp();  // every lane is done with this buffer
    buf ^= 1;
    if (++h < nch) continue;
    h = 0;
    tau = warp_tau(q);
    if (++v >= count || !(visit_d2[vrow + v] <= tau)) break;
  }
  cp_async::wait<0>();  // a chunk fetched ahead may be in flight

  // the sorted rows, written coalesced
  __syncwarp();
  for (int e = lane; e < nkey; e += 32) {
    const int ql = e / kk;
    const uint64_t key = list[(e - ql * kk) * kTileQueries + ql];
    out_d[sbase + e] = __uint_as_float(static_cast<unsigned>(key >> 32));
    out_i[sbase + e] = static_cast<int>(static_cast<uint32_t>(key));
  }
}

// The first design, for lists longer than kTileMaxKk and tiles the warp
// design does not take.
__device__ __forceinline__ bool key_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

__global__ void knn_exact_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ seed_d,
    const int* __restrict__ seed_i, const int* __restrict__ visit,
    const float* __restrict__ visit_d2, const int* __restrict__ counts,
    float* __restrict__ out_d, int* __restrict__ out_i, int kk, int ct,
    int num_c, int w_excl) {
  extern __shared__ float smem[];
  const int qt = blockDim.x;
  float* cx = smem;
  float* cy = cx + ct;
  float* cz = cy + ct;
  float* bd = cz + ct;                              // [kk][qt]
  int* bi = reinterpret_cast<int*>(bd + kk * qt);  // [kk][qt]
  __shared__ float red[kMaxQt];
  __shared__ float tau;

  const int t = threadIdx.x;
  const int qtile = blockIdx.x;
  const int q = qtile * qt + t;
  const float qx = px[q], qy = py[q], qz = pz[q];
  const bool qvalid = qx > kValidGt;

  // the seed list, and its worst entry by (d^2, index)
  float wd = 0.f;
  int wi = 0, ws = 0;
  for (int s = 0; s < kk; ++s) {
    const float d = seed_d[(size_t)q * kk + s];
    const int i = seed_i[(size_t)q * kk + s];
    bd[s * qt + t] = d;
    bi[s * qt + t] = i;
    if (s == 0 || key_less(wd, wi, d, i)) {
      wd = d;
      wi = i;
      ws = s;
    }
  }
  red[t] = qvalid ? wd : 0.f;
  __syncthreads();
  if (t == 0) {
    float m = 0.f;
    for (int s = 0; s < qt; ++s) m = fmaxf(m, red[s]);
    tau = m;
  }
  __syncthreads();

  const int count = counts[qtile];
  for (int v = 0; v < count; ++v) {
    const size_t row = (size_t)qtile * num_c + v;
    if (v > 0 && !(visit_d2[row] <= tau)) break;
    const int base = visit[row] * ct;
    for (int j = t; j < ct; j += qt) {
      cx[j] = px[base + j];
      cy[j] = py[base + j];
      cz[j] = pz[base + j];
    }
    __syncthreads();
    if (qvalid) {
      for (int j = 0; j < ct; ++j) {
        const int c = base + j;
        const float x = cx[j];
        if (abs(c - q) <= w_excl || !(x > kValidGt)) continue;
        const float dx = qx - x;
        const float dy = qy - cy[j];
        const float dz = qz - cz[j];
        const float d = dx * dx + dy * dy + dz * dz;
        if (!key_less(d, c, wd, wi)) continue;
        bd[ws * qt + t] = d;
        bi[ws * qt + t] = c;
        wd = bd[t];
        wi = bi[t];
        ws = 0;
        for (int s = 1; s < kk; ++s) {
          const float ds = bd[s * qt + t];
          const int is = bi[s * qt + t];
          if (key_less(wd, wi, ds, is)) {
            wd = ds;
            wi = is;
            ws = s;
          }
        }
      }
    }
    red[t] = qvalid ? wd : 0.f;
    __syncthreads();  // also: every thread is done with the staged tile
    if (t == 0) {
      float m = 0.f;
      for (int s = 0; s < qt; ++s) m = fmaxf(m, red[s]);
      tau = m;
    }
    __syncthreads();
  }

  // write the row ascending by (d^2, index): selection sort in place
  for (int r = 0; r < kk; ++r) {
    int m = r;
    for (int s = r + 1; s < kk; ++s) {
      if (key_less(bd[s * qt + t], bi[s * qt + t], bd[m * qt + t],
                   bi[m * qt + t]))
        m = s;
    }
    const float dm = bd[m * qt + t];
    const int im = bi[m * qt + t];
    bd[m * qt + t] = bd[r * qt + t];
    bi[m * qt + t] = bi[r * qt + t];
    out_d[(size_t)q * kk + r] = dm;
    out_i[(size_t)q * kk + r] = im;
  }
}

}  // namespace

extern "C" int bst_knn_exact(const float* px, const float* py,
                             const float* pz, const float* seed_d,
                             const int* seed_i, const int* visit,
                             const float* visit_d2, const int* counts,
                             float* out_d, int* out_i, float* packed, int n,
                             int kk, int qt, int ct, int w_excl,
                             void* stream) {
  if (n <= 0 || kk <= 0 || qt <= 0 || qt > kMaxQt || ct <= 0 ||
      ct > kMaxCt || n % qt || n % ct)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const bool tile = kk <= kTileMaxKk && qt % kTileQueries == 0 &&
                    ct % 32 == 0 && (ct < kChunk || ct % kChunk == 0);
  if (tile) {
    if (packed == nullptr) return cudaErrorInvalidValue;
    auto pk = reinterpret_cast<float4*>(packed);
    knn_pack_kernel<<<(n + 255) / 256, 256, 0, st>>>(px, py, pz, pk, n);
    const int chunk = ct < kChunk ? ct : kChunk;
    // at most 2 x 256 x 16 B + 64 x 64 x 8 B = 40 KB: no attribute needed
    const size_t smem = (size_t)2 * chunk * sizeof(float4) +
                        (size_t)kk * kTileQueries * sizeof(uint64_t);
    knn_tile_kernel<<<n / kTileQueries, 32, smem, st>>>(
        pk, seed_d, seed_i, visit, visit_d2, counts, out_d, out_i, kk, qt,
        ct, n / ct, w_excl);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = (size_t)3 * ct * sizeof(float) +
                      (size_t)kk * qt * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      knn_exact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  knn_exact_kernel<<<n / qt, qt, smem, st>>>(
      px, py, pz, seed_d, seed_i, visit, visit_d2, counts, out_d, out_i, kk,
      ct, n / ct, w_excl);
  return static_cast<int>(cudaGetLastError());
}
