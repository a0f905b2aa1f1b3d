// Greedy NMS over xyxy boxes, one thread block per image, the whole batch
// in one launch. Returns each image's kept indices in selection order and
// a valid mask; invalid slots hold the index jnp.argmax gives there in the
// TPU kernel (0 over an all -inf row, the first NaN when a score is NaN),
// so index sequences stay identical.
//
// Replaces the TPU kernel triton_client_tpu/ops/pallas_nms.py::nms_pallas
// (body _nms_kernel).
//
// What bounds it on an H100: latency, as for decode_nms_2d.cu: up to
// max_det dependent block reductions, against some 20 KB of bytes an
// image. Candidates stay in shared memory (24 bytes each); the suppression
// pass computes the next step's per-thread argmax; the loop stops at the
// first step with no live candidate.
#include <cuda_runtime.h>

#include "greedy.cuh"

namespace {

__global__ void __launch_bounds__(greedy::kThreads)
greedy_nms_kernel(const float* __restrict__ boxes,   // (B, N, 4) xyxy
                  const float* __restrict__ scores,  // (B, N), -inf = padding
                  int n, float thresh, int max_det,
                  int* __restrict__ indices,  // (B, max_det)
                  bool* __restrict__ valid) { // (B, max_det)
  extern __shared__ float smem[];
  __shared__ float red_v[greedy::kWarps + 1];
  __shared__ int red_i[greedy::kWarps + 1];

  const int b = blockIdx.x;
  float* x1 = smem;
  float* y1 = x1 + n;
  float* x2 = y1 + n;
  float* y2 = x2 + n;
  float* area = y2 + n;
  float* live = area + n;

  const float* bx = boxes + (size_t)b * n * 4;
  const float* sc = scores + (size_t)b * n;
  for (int j = threadIdx.x; j < n; j += greedy::kThreads) {
    const float a1 = bx[4 * j], b1 = bx[4 * j + 1], a2 = bx[4 * j + 2], b2 = bx[4 * j + 3];
    x1[j] = a1;
    y1[j] = b1;
    x2[j] = a2;
    y2[j] = b2;
    area[j] = (a2 - a1) * (b2 - b1);  // unclipped, as ops/pallas_nms.py:129
    live[j] = sc[j];
  }
  __syncthreads();

  int* idx = indices + (size_t)b * max_det;
  bool* val = valid + (size_t)b * max_det;
  greedy::suppress_loop(
      greedy::Boxes{x1, y1, x2, y2, area}, live, n, thresh, max_det, red_v, red_i,
      [&](int s, int best) {
        idx[s] = best;
        val[s] = true;
      },
      [&](int s, int index) {
        idx[s] = index;
        val[s] = false;
      });
}

}  // namespace

// smem is the wrapper's count of the six float arrays of n candidates the
// kernel carves from dynamic shared memory (ops/gpu_nms.smem_bytes).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int greedy_nms_launch(const void* boxes, const void* scores, int batch, int n,
                                 float thresh, int max_det, void* indices, void* valid,
                                 int smem, void* stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        greedy_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  greedy_nms_kernel<<<batch, greedy::kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)boxes, (const float*)scores, n, thresh, max_det, (int*)indices,
      (bool*)valid);
  return (int)cudaGetLastError();
}
