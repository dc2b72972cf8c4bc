// refine_sweep: one full-resolution refinement sweep of the multigrid
// solver against the [P] plane table.
//
// Replaces the TPU kernel buildingsegment_tpu/ops/window_sweep.py
// _refine_table_kernel_pair (wrapper refine_table_sweep_pair, called from
// seg/coarse.py step 3).
//
// Per row i with plane id pid_i (0 = none) and plane p's model (unit
// normal n_p, offset b_p = n_p·c_p):
//   accept(i, p):  |p_i·n_p - b_p| <= th and |n_i·n_p| >= cos;
//   eff(i)      :  pid_i if row i is valid, has a plane and (with
//                  `clean`) its own plane still accepts it, else 0;
//   out(i)      :  eff(i) if > 0, else (with `adopt`) the smallest eff(j)
//                  over valid window candidates j within the edge gate
//                  whose plane accepts row i, else 0.
//
// What bounds it on the H100: latency at the path's sizes, bytes at the
// largest.  Every row reads its 29 B (position, normal, id, mask) and
// writes 4 B: about 7 MB, 2 us of HBM time, at the slice's 223k rows and
// 39 MB, 12 us, at 1,179,648.  Only the hole rows (valid, no kept plane)
// search their 2w candidates, and a search is a chain of dependent
// reads: one thread walking all 2w candidates alone (a candidate's mask,
// id, position, then its plane) kept its warp, and so the kernel,
// waiting on that chain.  The design below leaves two rounds of global
// reads a tile and a hole search about four candidates long.
//
// Design: a block owns 256 consecutive rows and stages rows
// [b0 - w, b0 + 256 + w) once: position and eff, computed once per
// staged row (halo rows too, from their own normals), the model (n, b)
// of eff's plane, read from the table (ids up to ceil128(n_live) see it;
// the TPU kernel built it with a one-hot matmul), and the normals a hole
// row will need: two rounds of global reads in all.  Rows that
// keep a plane, invalid rows and all rows without `adopt` write their
// result at once; hole rows are appended to a shared list by a ballot,
// and groups of 8 lanes take one hole row each (four to a warp): a
// group's lanes split its 2w candidates (four each at the path's
// w = 16), each tests its own without a branch, and three shuffles join
// the lanes' minima.  A candidate's plane is a shared read beside its
// position, not a second read after it.  An integer min is exact in any
// order and split, and each test is the exact f32 operations of the
// plain version (-fmad=false): the output equals it bit for bit.  A
// window too wide for the tile (w > 3072) takes the per-row kernel: one
// thread a row, the table's live rows in shared memory, the candidates'
// eff recomputed where they are read.  Ids are int32 (the TPU kernel
// carried them as floats).
#include <climits>

#include "sweep_common.cuh"

namespace {

constexpr int kRefineRows = 256;       // rows a tile block owns (= threads)
constexpr int kRefineGroup = 8;        // lanes that search one hole row
constexpr int kRefineTileMaxW = 3072;  // widest window the tile takes

struct RefineParams {
  float th, cth, eg2;
  int sgn, clean, adopt;
};

__device__ __forceinline__ float4 plane_of(const float4* tab, int pid,
                                           int ntab) {
  return (pid > 0 && pid <= ntab) ? tab[pid - 1]
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
}

// does plane m accept row i: |p·n - b| <= th and |n_i·n| >= cos
__device__ __forceinline__ bool accepts(float4 m, float x, float y, float z,
                                        float ux, float uy, float uz,
                                        const RefineParams& p) {
  const float d = fabsf(x * m.x + y * m.y + z * m.z - m.w);
  const float c = cmag(ux * m.x + uy * m.y + uz * m.z, p.sgn);
  return d <= p.th && c >= p.cth;
}

// The tile kernel: see the design note above.  Shared memory: the staged
// rows [256 + 2w] (x, y, z, eff as int bits: > 0 a kept id, 0 none, -1 an
// invalid row or one outside [0, n)) and the model of eff's plane
// [256 + 2w], the block rows' normals [256] (where a row may be a hole
// or `clean` tests it) and the hole list [256] (x, y, z, row as int bits).
__global__ void __launch_bounds__(kRefineRows) refine_tile_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ nx,
    const float* __restrict__ ny, const float* __restrict__ nz,
    const uint8_t* __restrict__ mask, const int* __restrict__ pid,
    const float4* __restrict__ table, int ntab, int* __restrict__ out,
    int n, int w, RefineParams p) {
  extern __shared__ float4 sm[];
  const int span = kRefineRows + 2 * w;
  float4* tile = sm;
  float4* plane = tile + span;
  float4* rnrm = plane + span;
  float4* hole = rnrm + kRefineRows;
  __shared__ int nhole;
  const int t = threadIdx.x;
  if (t == 0) nhole = 0;
  const int b0 = blockIdx.x * kRefineRows;
  // two rounds of global reads: mask, id and position together, then the
  // plane and, where needed, the normal
  for (int s = t; s < span; s += kRefineRows) {
    const int j = b0 - w + s;
    float4 v = make_float4(0.f, 0.f, 0.f, __int_as_float(-1));
    float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j >= 0 && j < n) {
      const bool ok = mask[j] != 0;
      const int id = pid[j];
      const float x = px[j], y = py[j], z = pz[j];
      int e = ok && id > 0 ? id : 0;
      m = plane_of(table, e, ntab);
      if (ok && (p.clean || e == 0))
        u = make_float4(nx[j], ny[j], nz[j], 0.f);
      if (e > 0 && p.clean && !accepts(m, x, y, z, u.x, u.y, u.z, p)) e = 0;
      v = make_float4(x, y, z, __int_as_float(ok ? e : -1));
    }
    tile[s] = v;
    plane[s] = m;
    if (s >= w && s < w + kRefineRows) rnrm[s - w] = u;
  }
  __syncthreads();

  const int i = b0 + t;
  const int lane = t & 31;
  const float4 me = tile[t + w];
  const int keep = __float_as_int(me.w);
  const bool is_hole = i < n && keep == 0 && p.adopt;
  if (i < n && !is_hole) out[i] = max(keep, 0);
  const unsigned holes = __ballot_sync(0xffffffffu, is_hole);
  if (holes) {
    int base = 0;
    if (lane == 0) base = atomicAdd(&nhole, __popc(holes));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (is_hole)
      hole[base + __popc(holes & ((1u << lane) - 1u))] =
          make_float4(me.x, me.y, me.z, __int_as_float(t));
  }
  __syncthreads();

  // groups of kRefineGroup lanes, a hole row each; a warp's groups run
  // their rows together, so every lane of the warp reaches the shuffles
  const int count = nhole;
  const int gl = lane & (kRefineGroup - 1);
  constexpr int kGroups = kRefineRows / kRefineGroup;
  for (int h0 = (t >> 5) * (32 / kRefineGroup); h0 < count; h0 += kGroups) {
    const int h = h0 + lane / kRefineGroup;
    int best = INT_MAX;
    int r = 0;  // the hole's row within the block
    if (h < count) {
      const float4 q = hole[h];
      r = __float_as_int(q.w);
      const float4 u = rnrm[r];
      const int sr = r + w;
#pragma unroll 4
      for (int slot = gl; slot < 2 * w; slot += kRefineGroup) {
        const int s = sr + (slot < w ? slot - w : slot - w + 1);
        const float4 c = tile[s];
        const int cp = __float_as_int(c.w);
        const float dx = q.x - c.x;
        const float dy = q.y - c.y;
        const float dz = q.z - c.z;
        const bool gate = dx * dx + dy * dy + dz * dz <= p.eg2;
        if (cp > 0 && gate &&
            accepts(plane[s], q.x, q.y, q.z, u.x, u.y, u.z, p))
          best = min(best, cp);
      }
    }
    for (int o = kRefineGroup / 2; o > 0; o >>= 1)
      best = min(best, __shfl_xor_sync(0xffffffffu, best, o));
    if (h < count && gl == 0) out[b0 + r] = best < INT_MAX ? best : 0;
  }
}

// The per-row kernel, for windows the tile cannot hold: one thread a
// row, the table alone in shared memory.
__global__ void refine_row_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ nx,
    const float* __restrict__ ny, const float* __restrict__ nz,
    const uint8_t* __restrict__ mask, const int* __restrict__ pid,
    const float4* __restrict__ table, int ntab, int* __restrict__ out,
    int n, int w, RefineParams p) {
  extern __shared__ float4 tab[];  // [ntab] rows (n_x, n_y, n_z, b)
  for (int k = threadIdx.x; k < ntab; k += blockDim.x) tab[k] = table[k];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = px[i], y = py[i], z = pz[i];
  const float ux = nx[i], uy = ny[i], uz = nz[i];
  const bool valid = mask[i] != 0;
  int keep = (valid && pid[i] > 0) ? pid[i] : 0;
  if (keep > 0 && p.clean &&
      !accepts(plane_of(tab, keep, ntab), x, y, z, ux, uy, uz, p))
    keep = 0;
  if (keep > 0 || !p.adopt || !valid) {
    out[i] = keep;
    return;
  }
  int best = INT_MAX;
  for (int slot = 0; slot < 2 * w; ++slot) {
    const int j = i + (slot < w ? slot - w : slot - w + 1);
    if (j < 0 || j >= n || !mask[j]) continue;
    const int cp = pid[j];
    if (cp <= 0 || cp >= best) continue;
    const float cx = px[j], cy = py[j], cz = pz[j];
    const float dx = x - cx;
    const float dy = y - cy;
    const float dz = z - cz;
    if (!(dx * dx + dy * dy + dz * dz <= p.eg2)) continue;
    const float4 m = plane_of(tab, cp, ntab);
    if (p.clean && !accepts(m, cx, cy, cz, nx[j], ny[j], nz[j], p)) continue;
    if (accepts(m, x, y, z, ux, uy, uz, p)) best = cp;
  }
  out[i] = best < INT_MAX ? best : 0;
}

std::atomic<int> tile_smem_limit{0};
std::atomic<int> row_smem_limit{0};

}  // namespace

extern "C" int bst_refine_sweep(const float* px, const float* py,
                                const float* pz, const float* nx,
                                const float* ny, const float* nz,
                                const uint8_t* mask, const int* pid,
                                const float* table, int ntab, int* out, int n,
                                int w, float th, float cth, float eg2, int sgn,
                                int clean, int adopt, void* stream) {
  if (n <= 0 || ntab < 0 || w < 0) return cudaErrorInvalidValue;
  RefineParams p{th, cth, eg2, sgn, clean, adopt};
  const auto st = static_cast<cudaStream_t>(stream);
  const auto tab = reinterpret_cast<const float4*>(table);
  const int f4 = static_cast<int>(sizeof(float4));
  cudaError_t err;
  if (w <= kRefineTileMaxW) {
    const int smem = (2 * (kRefineRows + 2 * w) + 2 * kRefineRows) * f4;
    err = raise_smem_limit(refine_tile_kernel, smem, tile_smem_limit);
    if (err != cudaSuccess) return static_cast<int>(err);
    refine_tile_kernel<<<(n + kRefineRows - 1) / kRefineRows, kRefineRows,
                         smem, st>>>(px, py, pz, nx, ny, nz, mask, pid, tab,
                                     ntab, out, n, w, p);
  } else {
    const int smem = ntab * f4;
    err = raise_smem_limit(refine_row_kernel, smem, row_smem_limit);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int threads = 256;
    refine_row_kernel<<<(n + threads - 1) / threads, threads, smem, st>>>(
        px, py, pz, nx, ny, nz, mask, pid, tab, ntab, out, n, w, p);
  }
  return static_cast<int>(cudaGetLastError());
}
