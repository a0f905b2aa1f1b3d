// Fused 2D detection tail: candidate decode, class offset, greedy NMS and
// packed output rows, one thread block per image, the whole batch in one
// launch.
//
// Replaces the TPU kernel triton_client_tpu/ops/pallas_decode.py::
// fused_decode_nms_2d (body _decode_nms_pack_2d_kernel). It computes what
// that kernel computes; the TPU's (8, K) lane layout and masked-sum picks
// are not carried over.
//
// What bounds it on an H100: latency. max_det dependent steps each end in
// a block-wide argmax, so the time is about (kept boxes + 1) reductions of
// two barriers each; the bytes it must move (some 33 KB an image) take
// well under a microsecond at 3.35 TB/s. The design keeps every candidate
// in shared memory (40 bytes each, 40 KB at K = 1024), fuses the
// suppression pass with the next step's per-thread argmax so a step costs
// one reduction, writes each output row straight from shared memory, and
// stops at the first step whose best live score is -inf.
#include <cuda_runtime.h>

#include "greedy.cuh"

namespace {

__global__ void __launch_bounds__(greedy::kThreads)
decode_nms_2d_kernel(const float* __restrict__ boxes,    // (B, K, 4)
                     const float* __restrict__ scores,   // (B, K), 0 where invalid
                     const float* __restrict__ classes,  // (B, K) class ids as float
                     const bool* __restrict__ valid,     // (B, K)
                     int k, float thresh, int max_det, int xywh, int class_agnostic,
                     float* __restrict__ dets,  // (B, max_det, 6)
                     bool* __restrict__ keep) { // (B, max_det)
  extern __shared__ float smem[];
  __shared__ float red_v[greedy::kWarps + 1];
  __shared__ int red_i[greedy::kWarps + 1];

  const int b = blockIdx.x;
  float* x1 = smem;
  float* y1 = x1 + k;
  float* x2 = y1 + k;
  float* y2 = x2 + k;
  float* ox1 = y2 + k;
  float* oy1 = ox1 + k;
  float* ox2 = oy1 + k;
  float* oy2 = ox2 + k;
  float* area = oy2 + k;
  float* live = area + k;

  const float* bx = boxes + (size_t)b * k * 4;
  const float* sc = scores + (size_t)b * k;
  const float* cl = classes + (size_t)b * k;
  const bool* va = valid + (size_t)b * k;

  // Phase 1: decode (ops/boxes.xywh2xyxy; * 0.5 is exact) and the max
  // |coord| over all K slots, invalid ones included, as the TPU kernel
  // and ops/nms.batched_nms take it.
  float m = 0.0f;
  for (int j = threadIdx.x; j < k; j += greedy::kThreads) {
    const float c0 = bx[4 * j], c1 = bx[4 * j + 1], c2 = bx[4 * j + 2], c3 = bx[4 * j + 3];
    float a1, b1, a2, b2;
    if (xywh) {
      a1 = c0 - c2 * 0.5f;
      b1 = c1 - c3 * 0.5f;
      a2 = c0 + c2 * 0.5f;
      b2 = c1 + c3 * 0.5f;
    } else {
      a1 = c0;
      b1 = c1;
      a2 = c2;
      b2 = c3;
    }
    x1[j] = a1;
    y1[j] = b1;
    x2[j] = a2;
    y2[j] = b2;
    m = fmaxf(m, fmaxf(fmaxf(fabsf(a1), fabsf(b1)), fmaxf(fabsf(a2), fabsf(b2))));
  }
  const float stride = class_agnostic ? 0.0f : greedy::block_max(m, red_v) * 2.0f + 1.0f;
  for (int j = threadIdx.x; j < k; j += greedy::kThreads) {
    float p1 = x1[j], q1 = y1[j], p2 = x2[j], q2 = y2[j];
    if (!class_agnostic) {
      const float off = cl[j] * stride;
      p1 = p1 + off;
      q1 = q1 + off;
      p2 = p2 + off;
      q2 = q2 + off;
    }
    ox1[j] = p1;
    oy1[j] = q1;
    ox2[j] = p2;
    oy2[j] = q2;
    area[j] = (p2 - p1) * (q2 - q1);
    live[j] = va[j] ? sc[j] : -CUDART_INF_F;
  }
  __syncthreads();

  // Phase 2: greedy suppression; thread 0 writes one row a step.
  float* out = dets + (size_t)b * max_det * 6;
  bool* kp = keep + (size_t)b * max_det;
  greedy::suppress_loop(
      greedy::Boxes{ox1, oy1, ox2, oy2, area}, live, k, thresh, max_det, red_v, red_i,
      [&](int s, int best) {
        float* row = out + 6 * s;
        row[0] = x1[best] + 0.0f;
        row[1] = y1[best] + 0.0f;
        row[2] = x2[best] + 0.0f;
        row[3] = y2[best] + 0.0f;
        row[4] = sc[best] + 0.0f;
        row[5] = cl[best] + 0.0f;
        kp[s] = true;
      },
      [&](int s) {
        float* row = out + 6 * s;
        for (int r = 0; r < 6; ++r) row[r] = 0.0f;
        kp[s] = false;
      });
}

}  // namespace

// smem is the wrapper's count of the ten float arrays of k candidates the
// kernel carves from dynamic shared memory (ops/gpu_decode.smem_bytes).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int decode_nms_2d_launch(const void* boxes, const void* scores, const void* classes,
                                    const void* valid, int batch, int k, float thresh,
                                    int max_det, int xywh, int class_agnostic, void* dets,
                                    void* keep, int smem, void* stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_nms_2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  decode_nms_2d_kernel<<<batch, greedy::kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)boxes, (const float*)scores, (const float*)classes, (const bool*)valid, k,
      thresh, max_det, xywh, class_agnostic, (float*)dets, (bool*)keep);
  return (int)cudaGetLastError();
}
