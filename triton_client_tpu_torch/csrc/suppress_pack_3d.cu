// Rotated-BEV greedy suppression + packing over a precomputed IoU matrix
// for the whole batch, as a suppression bitmask and a one-warp scan
// (mask_scan.cuh) in three launches on one stream.
//
// Replaces the TPU kernel triton_client_tpu/ops/pallas_decode.py::
// fused_suppress_pack_3d (body _suppress_pack_3d_kernel). As there, the
// score sort, the gathers and the (K, K) rotated IoU matrix of the sorted
// candidates are computed before the launch (ops/gpu_suppress3d.py); the
// kernel suppresses over them and writes packed rows
// [box7, extras..., score, label] plus a keep mask.
//
// What bounds it on an H100: latency. The bytes it must read (at most the
// 256 KB matrix and 9 KB of rows at K = 256) take about 0.08 us at
// 3.35 TB/s; the greedy loop's max_det dependent block-wide argmax steps
// (~0.9 us each, each reading a 1 KB row of the matrix) were the time. The
// design splits the work by what depends on what:
//   suppress_pack_3d_order  one block per image: the visiting order of
//       the score column (the rows' own when already in order, as the
//       pipelines hand them over, else a bitonic sort) and the live count;
//   suppress_pack_3d_mask   eight rows a block, one warp a row, across the
//       card: iou[chosen][j] > thresh read from the chosen candidate's
//       row (not the column: rotated_iou_bev need not be bitwise
//       symmetric), 32 columns a ballot, only the words the scan reads;
//   suppress_pack_3d_scan   one block per image: the scan
//       (mask_scan.cuh), then 256 threads write the packed rows.
#include <cuda_runtime.h>
#include <cstdint>

#include "mask_scan.cuh"

namespace {

constexpr int kMaskRows = 8;  // one warp a row
constexpr int kUnroll = 4;    // words whose loads are in flight together

__global__ void __launch_bounds__(maskscan::kOrderThreads)
suppress_pack_3d_order(const float* __restrict__ rows,  // (B, K, cols)
                       int k, int cols,
                       int* __restrict__ order,    // (B, K) candidate at each position
                       int* __restrict__ live_n) { // (2B,) live counts, own-order flags
  extern __shared__ unsigned long long keys[];  // sort_slots(k), then k live scores
  float* live = reinterpret_cast<float*>(keys + maskscan::sort_slots(k));
  const int b = blockIdx.x;
  const float* rw = rows + (size_t)b * k * cols;
  for (int j = threadIdx.x; j < k; j += blockDim.x) live[j] = rw[(size_t)j * cols + cols - 2];
  const maskscan::Order o = maskscan::live_order(live, k, keys);
  for (int p = threadIdx.x; p < o.live; p += blockDim.x)
    order[(size_t)b * k + p] = maskscan::candidate_at(o, keys, p);
  if (threadIdx.x == 0) {
    live_n[b] = o.live;
    live_n[gridDim.x + b] = o.sorted;  // read back by chip_smoke.py
  }
}

__global__ void __launch_bounds__(32 * kMaskRows)
suppress_pack_3d_mask(const float* __restrict__ iou,  // (B, K, K)
                      const int* __restrict__ order, const int* __restrict__ live_n, int k,
                      float thresh, uint32_t* __restrict__ mask) {  // (B, K, row_stride(K))
  const int b = blockIdx.y, lane = threadIdx.x & 31;
  const int p = kMaskRows * blockIdx.x + (threadIdx.x >> 5);
  const int n = live_n[b];
  if (p >= n) return;
  const int* ord = order + (size_t)b * k;
  const float* r = iou + ((size_t)b * k + ord[p]) * k;
  const int end = maskscan::words(n);
  uint32_t* out = mask + ((size_t)b * k + p) * maskscan::row_stride(k);
  for (int w0 = p / 32; w0 < end; w0 += kUnroll) {
    int col[kUnroll];
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = 32 * (w0 + u) + lane;
      col[u] = q < n ? ord[q] : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = col[u] >= 0 ? r[col[u]] : 0.0f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (w0 + u >= end) break;  // warp-uniform
      const uint32_t bits = __ballot_sync(maskscan::kFull, col[u] >= 0 && v[u] > thresh);
      if (lane == 0) out[w0 + u] = bits;
    }
  }
}

__global__ void __launch_bounds__(maskscan::kScanThreads)
suppress_pack_3d_scan(const float* __restrict__ rows, int k, int cols,
                      const uint32_t* __restrict__ mask, const int* __restrict__ order,
                      const int* __restrict__ live_n, int max_det,
                      float* __restrict__ dets,  // (B, max_det, cols)
                      bool* __restrict__ keep) { // (B, max_det)
  extern __shared__ uint32_t smem[];  // maskscan::scan_smem_words(k, max_det)
  const int b = blockIdx.x;
  const maskscan::Kept kept =
      maskscan::scan(mask + (size_t)b * k * maskscan::row_stride(k), k, live_n[b], max_det, smem);
  for (int s = threadIdx.x; s < kept.n; s += blockDim.x)
    kept.pos[s] = order[(size_t)b * k + kept.pos[s]];  // position -> candidate
  __syncthreads();
  const float* rw = rows + (size_t)b * k * cols;
  float* out = dets + (size_t)b * max_det * cols;
#pragma unroll 4
  for (int e = threadIdx.x; e < max_det * cols; e += blockDim.x) {
    const int s = e / cols;
    // "+ 0.0f": the TPU kernel picks row values with a masked sum, which
    // turns -0.0 into +0.0
    out[e] = s < kept.n ? rw[(size_t)kept.pos[s] * cols + e % cols] + 0.0f : 0.0f;
  }
  for (int s = threadIdx.x; s < max_det; s += blockDim.x)
    keep[(size_t)b * max_det + s] = s < kept.n;
}

// the dynamic shared memory limits set so far, by device (set_smem)
std::atomic<int> order_smem_set[maskscan::kDevices], scan_smem_set[maskscan::kDevices];

}  // namespace

// The workspace (ops/gpu_suppress3d.workspace): mask (B, K,
// row_stride(K)) words, order (B, K) int32, live counts (B,) then
// own-order flags (B,) int32 (maskscan::Order). order_smem is the
// wrapper's count of the order pass's dynamic shared memory
// (ops/gpu_suppress3d.smem_bytes). Returns the first nonzero
// cudaGetLastError() of the three launches (0 = launched).
extern "C" int suppress_pack_3d_launch(const void* iou, const void* rows, int batch, int k,
                                       int cols, float thresh, int max_det, void* dets,
                                       void* keep, void* mask, void* order, void* live_n,
                                       int order_smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int scan_smem = 4 * maskscan::scan_smem_words(k, max_det);
  int err = maskscan::set_smem((const void*)suppress_pack_3d_order, order_smem_set, order_smem);
  if (err == 0)
    err = maskscan::set_smem((const void*)suppress_pack_3d_scan, scan_smem_set, scan_smem);
  if (err != 0) return err;
  suppress_pack_3d_order<<<batch, maskscan::kOrderThreads, order_smem, st>>>(
      (const float*)rows, k, cols, (int*)order, (int*)live_n);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  if (k > 0) {
    suppress_pack_3d_mask<<<dim3((k + kMaskRows - 1) / kMaskRows, batch), 32 * kMaskRows, 0,
                            st>>>((const float*)iou, (const int*)order, (const int*)live_n, k,
                                  thresh, (uint32_t*)mask);
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  suppress_pack_3d_scan<<<batch, maskscan::kScanThreads, scan_smem, st>>>(
      (const float*)rows, k, cols, (const uint32_t*)mask, (const int*)order,
      (const int*)live_n, max_det, (float*)dets, (bool*)keep);
  return (int)cudaGetLastError();
}
