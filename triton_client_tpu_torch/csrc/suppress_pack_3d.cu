// Rotated-BEV greedy suppression + packing over a precomputed IoU matrix,
// one thread block per image, the whole batch in one launch.
//
// Replaces the TPU kernel triton_client_tpu/ops/pallas_decode.py::
// fused_suppress_pack_3d (body _suppress_pack_3d_kernel). As there, the
// score sort, the gathers and the (K, K) rotated IoU matrix of the sorted
// candidates are computed before the launch (ops/gpu_suppress3d.py); the
// kernel runs the greedy loop over them and writes packed rows
// [box7, extras..., score, label] plus a keep mask.
//
// What bounds it on an H100: latency. max_det dependent steps each end in
// a block-wide argmax; the bytes it must read (the 256 KB matrix and 9 KB
// of rows at K = 256) take about 0.08 us at 3.35 TB/s. The design keeps
// the live scores and the sorted rows in shared memory (4 * K * (cols + 1)
// bytes, 10 KB at K = 256 and 9 columns), reads the chosen candidate's IoU
// row from device memory each step (1 KB, coalesced; the whole matrix does
// not fit a block's 227 KB), shares the loop of greedy.cuh with the 2D
// kernels, and stops at the first step with no live candidate.
#include <cuda_runtime.h>

#include "greedy.cuh"

namespace {

__global__ void __launch_bounds__(greedy::kThreads)
suppress_pack_3d_kernel(const float* __restrict__ iou,   // (B, K, K), score-sorted
                        const float* __restrict__ rows,  // (B, K, cols), score-sorted
                        int k, int cols, float thresh, int max_det,
                        float* __restrict__ dets,   // (B, max_det, cols)
                        bool* __restrict__ keep) {  // (B, max_det)
  extern __shared__ float smem[];
  __shared__ float red_v[greedy::kWarps + 1];
  __shared__ int red_i[greedy::kWarps + 1];

  const int b = blockIdx.x;
  float* live = smem;       // (K,) the score column, -inf = gated or padding
  float* srows = smem + k;  // (K, cols)
  const float* rw = rows + (size_t)b * k * cols;
  for (int t = threadIdx.x; t < k * cols; t += greedy::kThreads) srows[t] = rw[t];
  for (int j = threadIdx.x; j < k; j += greedy::kThreads) live[j] = rw[(size_t)j * cols + cols - 2];
  __syncthreads();

  float* out = dets + (size_t)b * max_det * cols;
  bool* kp = keep + (size_t)b * max_det;
  greedy::suppress_loop(
      greedy::IouMatrix{iou + (size_t)b * k * k, k}, live, k, thresh, max_det, red_v, red_i,
      [&](int s, int best) {
        // "+ 0.0f": the TPU kernel picks row values with a masked sum,
        // which turns -0.0 into +0.0
        for (int c = 0; c < cols; ++c) out[s * cols + c] = srows[best * cols + c] + 0.0f;
        kp[s] = true;
      },
      [&](int s) {
        for (int c = 0; c < cols; ++c) out[s * cols + c] = 0.0f;
        kp[s] = false;
      });
}

}  // namespace

// smem is the wrapper's count of the dynamic shared memory of one block
// (ops/gpu_suppress3d.smem_bytes). Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int suppress_pack_3d_launch(const void* iou, const void* rows, int batch, int k,
                                       int cols, float thresh, int max_det, void* dets,
                                       void* keep, int smem, void* stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        suppress_pack_3d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  suppress_pack_3d_kernel<<<batch, greedy::kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)iou, (const float*)rows, k, cols, thresh, max_det, (float*)dets,
      (bool*)keep);
  return (int)cudaGetLastError();
}
