// Per-slot mean of slot-sorted value rows, one thread per slot.
//
// Replaces the TPU kernel triton_client_tpu/ops/pallas_voxel.py::
// sorted_segment_mean_pallas (bodies _segment_mean_grid_kernel and
// _segment_mean_manual_kernel), the reduction of SECOND-IoU's fused
// voxelize->scatter stage (fused_mean_volume). It computes what that kernel
// computes, for every slot s < num_slots:
//
//   out[r, s] = sum_{i: slot[i] = s} v[r, i] / max(sum_{i: slot[i] = s} v[7, i], 1)
//
// so row 7 carries each row's weight and empty slots give 0. The TPU's
// 128-aligned slot windows and one-hot matrix product exist for its VMEM
// tiling and are not carried over. Rows at the dump id num_slots (the
// padding, and the points past the voxel cap: about 91k of the 131,072 rows
// of a 120k-point scan) are never read; the TPU kernel reduces that slot too
// and its caller slices it off.
//
// What bounds it on an H100: bytes. It must read the 8 values and the slot
// id of each live row (those below the dump id) and write 8 x num_slots
// means. A 120k-point scan has about 41,700 live rows of its 131,072, so
// at 40,000 slots that is 9 x 41,700 x 4 + 8 x 40,000 x 4 bytes, about
// 2.8 MB, 0.83 us at 3.35 TB/s. Its operations (8 adds a live row, 8
// divisions a slot) take far less. The design: each thread finds its slot's rows by two binary
// searches in the sorted slot ids (17 steps each at N = 131,072, served
// from L2), then walks them in order. The rows of neighbouring slots are
// neighbours, so a warp reads one contiguous span of each value row. No
// atomics and no shared state: the result is the same on every run.
//
// Known worst case, accepted: one thread sums all rows of its slot, so a
// single huge slot runs serially (a scan whose points all fall into one
// voxel takes N dependent adds in one thread). A warp per slot or a
// segmented scan is later work.
//
// Float rules: each row's sum starts at +0.0f and adds the slot's values in
// row order, as the plain PyTorch version does, so the two agree bit for
// bit. No fast-math flag, so the division is IEEE; max(w, 1) keeps a NaN
// weight, as torch.clamp does.
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;
constexpr int kThreads = 256;

// First index in [0, n) whose slot id is >= s, or n.
__device__ __forceinline__ int lower_bound(const int* __restrict__ slots, int n, int s) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (slots[mid] < s) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
segment_mean_kernel(const float* __restrict__ vals,  // (8, n)
                    const int* __restrict__ slots,   // (n,) non-decreasing
                    int n, int num_slots,
                    float* __restrict__ out) {       // (8, num_slots)
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= num_slots) return;
  const int begin = lower_bound(slots, n, s);
  const int end = lower_bound(slots, n, s + 1);
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  for (int i = begin; i < end; ++i) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] += vals[(size_t)r * n + i];
  }
  const float w = acc[kRows - 1] < 1.0f ? 1.0f : acc[kRows - 1];
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[(size_t)r * num_slots + s] = acc[r] / w;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int segment_mean_launch(const void* vals, const void* slots, int n, int num_slots,
                                   void* out, void* stream) {
  const int blocks = (num_slots + kThreads - 1) / kThreads;
  segment_mean_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)vals, (const int*)slots, n, num_slots, (float*)out);
  return (int)cudaGetLastError();
}
