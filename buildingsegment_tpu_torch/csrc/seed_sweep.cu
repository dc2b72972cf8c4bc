// seed_sweep: the depth-0 seed rule over a +-w Morton window.
//
// Replaces the TPU kernel buildingsegment_tpu/ops/window_sweep.py
// _seed_kernel_sym (wrapper seed_sweep_pair(sym=True), called from
// seg/region_grow.py window_seeds); its twin _seed_kernel_pair computes
// the same function bit for bit.
//
// Row i is a seed iff it is valid and no valid window candidate j inside
// its k-th-NN ball (|p_j - p_i|^2 <= dk_i) fails the plane test on row
// i's normal: |(p_j - p_i)·n_i| <= th and |n_j·n_i| >= cos.
//
// What bounds it on the H100: instruction throughput, not bytes.  The sweep
// moves about 30 B a row (35 MB, about 0.011 ms of HBM time, at config
// 5's 1,179,648 rows), but it makes 2w pair tests a row, each a d², a
// ball test and, inside the ball, two dot products.  One thread a row
// testing its 2w candidates from L1 spent about 20 instructions on each
// (row, candidate) pair, loads, bounds and masks included; the design
// below spends about 37 on each unordered pair, both ends, all from
// shared memory.
//
// Design: the TPU kernel's symmetric form, from shared memory.  d² and
// the normal cos are the same bits from either end of a pair (f32
// subtraction is antisymmetric, products commute, -fmad=false rounds
// each product on its own), and so is |Δ·n| up to the sign Δ takes; only
// the ball and the plane normal differ per direction.  A block owns 512
// consecutive rows and stages rows [b0 - w, b0 + 512 + w) once as
// (x, y, z, dk) and (n_x, n_y, n_z, valid), with x = NaN for an invalid
// row or one outside [0, n): a NaN d² fails every ball test, as the
// plain version's mask and padding do, without a branch.  Thread t tests
// the unordered pairs {i, i + d}, i = b0 + t, d = 1..w, once each: d² and
// the cos once, then both directions' ball and plane-band tests.  Row
// i's failure stays in a register; row i + d's, where it is one of the
// block's rows, is a store of 1 to its shared flag (every writer stores
// the same value, so no atomic is needed).  The pairs whose left end lies
// in the halo [b0 - w, b0) and right end in the block are tested for the
// right end alone, spread over all threads.  The path's w = 16 has an
// instance with the window fixed at compile time.  The plain version's
// test is an OR over pairs, exact in any order.  A window too wide for
// the tile (w > 3072) takes the per-row kernel: one thread a row, its 2w
// candidates in the plain order, stopping at the first failure.
#include "sweep_common.cuh"

namespace {

constexpr int kSeedRows = 512;        // rows a tile block owns (= threads)
constexpr int kSeedTileMaxW = 3072;   // widest window the tile takes

// Shared memory: (x, y, z, dk) [512 + 2w], (n_x, n_y, n_z, valid)
// [512 + 2w], one fail flag a block row [512].  kW > 0 fixes the window
// half-width at compile time (the path's w = 16: loops unrolled, offsets
// constant); kW = 0 takes w at run time.
template <int kW>
__global__ void __launch_bounds__(kSeedRows) seed_tile_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ nx,
    const float* __restrict__ ny, const float* __restrict__ nz,
    const uint8_t* __restrict__ mask, const float* __restrict__ dk,
    uint8_t* __restrict__ seed, int n, int w_run, float th, float cth,
    int sgn) {
  const int w = kW > 0 ? kW : w_run;
  extern __shared__ float4 sm[];
  const int span = kSeedRows + 2 * w;
  float4* sp = sm;
  float4* sn = sm + span;
  uint8_t* fail = reinterpret_cast<uint8_t*>(sn + span);
  const int t = threadIdx.x;
  const int b0 = blockIdx.x * kSeedRows;
  const float qnan = __int_as_float(0x7fc00000);  // fails every compare
  for (int s = t; s < span; s += kSeedRows) {
    const int j = b0 - w + s;
    float4 a = make_float4(qnan, 0.f, 0.f, 0.f);
    float4 an = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j >= 0 && j < n && mask[j]) {
      a = make_float4(px[j], py[j], pz[j], dk[j]);
      an = make_float4(nx[j], ny[j], nz[j], 1.f);
    }
    sp[s] = a;
    sn[s] = an;
  }
  fail[t] = 0;
  __syncthreads();

  // the block's rows against the right-hand halves of their windows:
  // both ends of each pair
  const float4 a = sp[t + w], an = sn[t + w];
  bool bad = false;
#pragma unroll(kW > 0 ? kW : 4)
  for (int d = 1; d <= w; ++d) {
    const float4 b = sp[t + w + d], bn = sn[t + w + d];
    const float dx = b.x - a.x;
    const float dy = b.y - a.y;
    const float dz = b.z - a.z;
    const float d2 = dx * dx + dy * dy + dz * dz;
    const bool cos_ok =
        cmag(bn.x * an.x + bn.y * an.y + bn.z * an.z, sgn) >= cth;
    const float pa = fabsf(dx * an.x + dy * an.y + dz * an.z);
    const float pb = fabsf(dx * bn.x + dy * bn.y + dz * bn.z);
    bad |= d2 <= a.w && !(pa <= th && cos_ok);
    if (d2 <= b.w && !(pb <= th && cos_ok) && t + d < kSeedRows)
      fail[t + d] = 1;
  }
  // the block's first rows against the left halo: row b0 + r and
  // candidate b0 + r - d for d in (r, w], for the block row alone
  const int heads = min(w, kSeedRows);
  for (int q = t; q < heads * w; q += kSeedRows) {
    const int r = q / w;
    const int d = q - r * w + 1;
    if (d <= r) continue;
    const float4 b = sp[r + w], bn = sn[r + w];
    const float4 c = sp[r + w - d], cn = sn[r + w - d];
    const float dx = c.x - b.x;
    const float dy = c.y - b.y;
    const float dz = c.z - b.z;
    const float d2 = dx * dx + dy * dy + dz * dz;
    const float pd = fabsf(dx * bn.x + dy * bn.y + dz * bn.z);
    const float pc = cmag(cn.x * bn.x + cn.y * bn.y + cn.z * bn.z, sgn);
    if (d2 <= b.w && !(pd <= th && pc >= cth)) fail[r] = 1;
  }
  __syncthreads();
  const int i = b0 + t;
  if (i < n) seed[i] = an.w != 0.f && !bad && !fail[t];
}

// The per-row kernel, for windows the tile cannot hold.
__global__ void seed_row_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ nx,
    const float* __restrict__ ny, const float* __restrict__ nz,
    const uint8_t* __restrict__ mask, const float* __restrict__ dk,
    uint8_t* __restrict__ seed, int n, int w, float th, float cth, int sgn) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool ok = mask[i] != 0;
  if (ok) {
    const float qx = px[i], qy = py[i], qz = pz[i];
    const float qnx = nx[i], qny = ny[i], qnz = nz[i];
    const float ball = dk[i];
    for (int slot = 0; slot < 2 * w; ++slot) {
      const int j = i + (slot < w ? slot - w : slot - w + 1);
      if (j < 0 || j >= n || !mask[j]) continue;
      const float dx = px[j] - qx;
      const float dy = py[j] - qy;
      const float dz = pz[j] - qz;
      if (!(dx * dx + dy * dy + dz * dz <= ball)) continue;
      const float pd = fabsf(dx * qnx + dy * qny + dz * qnz);
      const float pc = cmag(nx[j] * qnx + ny[j] * qny + nz[j] * qnz, sgn);
      if (!(pd <= th && pc >= cth)) {
        ok = false;
        break;
      }
    }
  }
  seed[i] = ok;
}

template <int kW>
cudaError_t launch_tile(const float* px, const float* py, const float* pz,
                        const float* nx, const float* ny, const float* nz,
                        const uint8_t* mask, const float* dk, uint8_t* seed,
                        int n, int w, float th, float cth, int sgn,
                        cudaStream_t st) {
  const int smem =
      2 * (kSeedRows + 2 * w) * static_cast<int>(sizeof(float4)) + kSeedRows;
  static std::atomic<int> limit{0};  // this instance's shared-memory limit
  const cudaError_t err = raise_smem_limit(seed_tile_kernel<kW>, smem, limit);
  if (err != cudaSuccess) return err;
  seed_tile_kernel<kW><<<(n + kSeedRows - 1) / kSeedRows, kSeedRows, smem,
                         st>>>(px, py, pz, nx, ny, nz, mask, dk, seed, n, w,
                               th, cth, sgn);
  return cudaSuccess;
}

}  // namespace

extern "C" int bst_seed_sweep(const float* px, const float* py,
                              const float* pz, const float* nx,
                              const float* ny, const float* nz,
                              const uint8_t* mask, const float* dk,
                              uint8_t* seed, int n, int w, float th,
                              float cth, int sgn, void* stream) {
  if (n <= 0 || w < 0) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (w <= kSeedTileMaxW) {
    const cudaError_t err =
        w == 16 ? launch_tile<16>(px, py, pz, nx, ny, nz, mask, dk, seed, n,
                                  w, th, cth, sgn, st)
                : launch_tile<0>(px, py, pz, nx, ny, nz, mask, dk, seed, n,
                                 w, th, cth, sgn, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    const int threads = 256;
    seed_row_kernel<<<(n + threads - 1) / threads, threads, 0, st>>>(
        px, py, pz, nx, ny, nz, mask, dk, seed, n, w, th, cth, sgn);
  }
  return static_cast<int>(cudaGetLastError());
}
