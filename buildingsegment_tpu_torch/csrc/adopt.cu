// adopt: the multigrid finalize's hole adoption against the top 128
// merged planes.
//
// Replaces the TPU kernel buildingsegment_tpu/ops/adopt.py _adopt_kernel
// (wrapper plane_adopt, called from seg/coarse.py step 4); its opt-in
// twin _adopt_kernel_t computes the same function transposed.
//
// Per hole row i (valid, unlabeled), with payload [1, n^, p, |p|^2], and
// per plane lane l (unit normal n_l, center c_l, offset b_l = n_l·c_l,
// h_l = |c_l|^2 / 2, squared reach r2_l, lane_ok_l):
//   off = p·n_l - b_l,  cos = n^·n_l,  pc2 = p·c_l - h_l,
//   ok  = |off| <= th and |cos| >= cos_th and (|p|^2 - 2 pc2) - off^2 <= r2_l
//         and lane_ok_l;
// the row adopts the first lane of least |off| among the ok lanes, takes
// that lane's merged-root row, and its payload is summed per lane.
//
// What bounds it on the H100: bytes.  Every row reads its hole flag and
// writes 5 B (about 1.3 MB at the slice's 223k rows); only hole rows read
// their 32 B payload and test the live planes (about 24 flops a plane).
// Morton order leaves the holes clustered, so most blocks hold none and
// only write zeros.
//
// Design: the TPU kernel did the three dot products as one [T,8]x[8,384]
// matmul and the selection on [T,128] vectors.  Here one thread owns one
// row and loops over the 128 lanes of a table held in shared memory,
// keeping the running least |off| (strict <, so the first lane wins a
// tie).  The per-lane sums take the fixed order of csrc/compact_sweep.cu:
// block b (kAdoptRows rows) sums its adopted rows in row order into a
// [128, 8] table in shared memory (thread c owns column c), the tables
// land in device memory, and a second kernel adds them in block order.
// The plain version computes each dot product in the same order, built
// here with -fmad=false, and sums in the same order: both agree bit for
// bit.  A block without holes writes zeros and returns.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 128;
constexpr int kAdoptRows = 256;
// table rows: n_x n_y n_z b c_x c_y c_z h r2 lane_ok
constexpr int kTabRows = 10;

__global__ void adopt_kernel(const float* __restrict__ payload,
                             const uint8_t* __restrict__ holes,
                             const float* __restrict__ table,
                             const int* __restrict__ rowlut,
                             uint8_t* __restrict__ adopted,
                             int* __restrict__ row_out,
                             float* __restrict__ partial, int n, float th,
                             float cth, int sgn) {
  __shared__ float st[kTabRows * kK];
  __shared__ float acc[kK * 8];
  __shared__ int slane[kAdoptRows];
  const int t = threadIdx.x;
  const int i = blockIdx.x * kAdoptRows + t;
  const bool hole = i < n && holes[i];
  float* part = partial + static_cast<size_t>(blockIdx.x) * kK * 8;
  if (!__syncthreads_or(hole)) {
    if (i < n) {
      adopted[i] = 0;
      row_out[i] = 0;
    }
    for (int k = t; k < kK * 8; k += kAdoptRows) part[k] = 0.f;
    return;
  }
  for (int k = t; k < kTabRows * kK; k += kAdoptRows) st[k] = table[k];
  for (int k = t; k < kK * 8; k += kAdoptRows) acc[k] = 0.f;
  __syncthreads();
  int lane = -1;
  if (hole) {
    const float* a = payload + static_cast<size_t>(i) * 8;
    const float ux = a[1], uy = a[2], uz = a[3];
    const float x = a[4], y = a[5], z = a[6], sq = a[7];
    float best = 0.f;
    for (int l = 0; l < kK; ++l) {
      if (!(st[9 * kK + l] > 0.f)) continue;
      const float mx = st[l], my = st[kK + l], mz = st[2 * kK + l];
      const float off = x * mx + y * my + z * mz - st[3 * kK + l];
      const float aoff = fabsf(off);
      if (!(aoff <= th) || (lane >= 0 && !(aoff < best))) continue;
      const float c = ux * mx + uy * my + uz * mz;
      if (!((sgn ? c : fabsf(c)) >= cth)) continue;
      const float pc2 = x * st[4 * kK + l] + y * st[5 * kK + l] +
                        z * st[6 * kK + l] - st[7 * kK + l];
      if (!((sq - 2.f * pc2) - off * off <= st[8 * kK + l])) continue;
      best = aoff;
      lane = l;
    }
  }
  if (i < n) {
    adopted[i] = lane >= 0;
    row_out[i] = lane >= 0 ? rowlut[lane] : 0;
  }
  slane[t] = lane;
  __syncthreads();
  if (t < 8) {
    const int r0 = blockIdx.x * kAdoptRows;
    for (int r = 0; r < kAdoptRows; ++r) {
      const int l = slane[r];
      if (l >= 0)
        acc[l * 8 + t] += payload[static_cast<size_t>(r0 + r) * 8 + t];
    }
  }
  __syncthreads();
  for (int k = t; k < kK * 8; k += kAdoptRows) part[k] = acc[k];
}

__global__ void adopt_reduce_kernel(const float* __restrict__ partial,
                                    float* __restrict__ acc128, int nblk) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= kK * 8) return;
  float a = 0.f;
  for (int b = 0; b < nblk; ++b) a += partial[static_cast<size_t>(b) * kK * 8 + k];
  acc128[k] = a;
}

}  // namespace

extern "C" int bst_adopt(const float* payload, const uint8_t* holes,
                         const float* table, const int* rowlut,
                         uint8_t* adopted, int* row_out, float* partial,
                         float* acc128, int n, float th, float cth, int sgn,
                         void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0) return cudaErrorInvalidValue;
  const int nblk = (n + kAdoptRows - 1) / kAdoptRows;
  adopt_kernel<<<nblk, kAdoptRows, 0, stream>>>(payload, holes, table,
                                                rowlut, adopted, row_out,
                                                partial, n, th, cth, sgn);
  adopt_reduce_kernel<<<(kK * 8 + 255) / 256, 256, 0, stream>>>(
      partial, acc128, nblk);
  return static_cast<int>(cudaGetLastError());
}
