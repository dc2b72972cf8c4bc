// segment_sort: the stable order of the live rows by id that the segment
// sums fold in (segment_sort.cu; segment_sum.cu calls it).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace segsort {

constexpr int kMaxDigitBits = 11;  // a pass ranks at most 2,048 digits
constexpr int kMaxPasses = 3;      // 3 x 11 bits cover every id below 2^31

// Bytes of scratch the sort takes for m rows, ids below size, and this
// digit plan (a header zeroed each call, the passes' buffers, the tiles'
// look-back tables); 0 for a plan that does not cover the ids.
size_t scratch_bytes(int m, int size, int passes, int digit_bits);

// Orders the rows whose id lies in [0, size) stably by id, in `passes`
// LSD passes of `digit_bits` bits.  idx: m ids (int64 where idx64, else
// int32).  runs: i32[2 * size], written: start[id] = runs[id], end[id] =
// runs[size + id], the id's run [start, end) in the order, [-1, -1) for
// an id without rows.  The last pass writes, at each live row's slot
// j < n_live (the count of live rows), either its `cols` floats of rows
// to staged[j * cols, (j + 1) * cols) (rows != null) or its row index to
// perm[j].  *zero (where not null) is set to 0 before the passes run.
// Launches on `stream`; returns cudaGetLastError() after the launches.
int sort(const void* idx, bool idx64, int m, int size, int passes,
         int digit_bits, void* scratch, size_t scratch_size, int* runs,
         const float* rows, int cols, float* staged, int* perm,
         int* zero, cudaStream_t stream);

// Sets the passes' dynamic shared-memory limit on the current device.
int init();

}  // namespace segsort
