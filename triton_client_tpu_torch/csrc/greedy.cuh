// Greedy suppression loop shared by the decode+NMS and greedy-NMS kernels.
//
// One thread block owns one image. Candidates live in shared memory as
// structure-of-arrays rows (offset coordinates, areas, live scores). Each
// step takes the block argmax over live scores (ties to the lowest index,
// as jnp.argmax), emits it, and kills every live candidate whose IoU with
// it exceeds the threshold. The suppression pass also computes each
// thread's argmax for the next step, so a step costs one pass over the
// thread's candidates plus one block reduction (two __syncthreads).
//
// Arithmetic follows ops/pallas_decode.py:128-131 and ops/pallas_nms.py:
// 96-99 of the JAX package operation for operation. The build passes
// --fmad=false so `area + barea - inter` is two rounded operations, as in
// the plain PyTorch version, and no fast-math flag, so `/` is IEEE.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>

namespace greedy {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void arg_better(float v, int i, float& bv, int& bi) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

// Block-wide argmax; every thread returns the winner. red_v/red_i hold
// kWarps + 1 slots; the last one broadcasts the result.
__device__ __forceinline__ void block_argmax(float v, int i, float* red_v, int* red_i,
                                             float& out_v, int& out_i) {
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_down_sync(0xffffffffu, v, off);
    int oi = __shfl_down_sync(0xffffffffu, i, off);
    arg_better(ov, oi, v, i);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red_v[warp] = v;
    red_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red_v[lane] : -CUDART_INF_F;
    i = lane < kWarps ? red_i[lane] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      float ov = __shfl_down_sync(0xffffffffu, v, off);
      int oi = __shfl_down_sync(0xffffffffu, i, off);
      arg_better(ov, oi, v, i);
    }
    if (lane == 0) {
      red_v[kWarps] = v;
      red_i[kWarps] = i;
    }
  }
  __syncthreads();
  out_v = red_v[kWarps];
  out_i = red_i[kWarps];
}

// Block-wide max of non-negative values (the class-offset stride).
__device__ __forceinline__ float block_max(float v, float* red_v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red_v[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red_v[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, off));
    if (lane == 0) red_v[kWarps] = v;
  }
  __syncthreads();
  float out = red_v[kWarps];
  __syncthreads();  // red_v is reused by the next reduction
  return out;
}

struct Cands {
  const float* x1;
  const float* y1;
  const float* x2;
  const float* y2;
  const float* area;
  float* live;  // -inf once suppressed or invalid
  int n;
};

// Runs max_det steps. emit(step, best) is called by thread 0 for each kept
// candidate; emit_empty(step) by thread 0 for every step after the live
// set ran out (the loop stops there: the remaining steps would all pick an
// invalid candidate and change nothing).
template <typename Emit, typename EmitEmpty>
__device__ void suppress_loop(const Cands& c, float thresh, int max_det, float* red_v,
                              int* red_i, Emit emit, EmitEmpty emit_empty) {
  float bv = -CUDART_INF_F;
  int bi = INT_MAX;
  for (int j = threadIdx.x; j < c.n; j += kThreads) arg_better(c.live[j], j, bv, bi);

  for (int step = 0; step < max_det; ++step) {
    float best_v;
    int best;
    block_argmax(bv, bi, red_v, red_i, best_v, best);
    if (!(best_v > -CUDART_INF_F)) {
      if (threadIdx.x == 0)
        for (int s = step; s < max_det; ++s) emit_empty(s);
      return;
    }
    if (threadIdx.x == 0) emit(step, best);
    // "+ 0.0f": the TPU kernel picks the chosen box with a masked sum,
    // which turns -0.0 into +0.0
    const float bx1 = c.x1[best] + 0.0f, by1 = c.y1[best] + 0.0f;
    const float bx2 = c.x2[best] + 0.0f, by2 = c.y2[best] + 0.0f;
    const float barea = c.area[best] + 0.0f;
    bv = -CUDART_INF_F;
    bi = INT_MAX;
    for (int j = threadIdx.x; j < c.n; j += kThreads) {
      const float lv = c.live[j];
      if (lv == -CUDART_INF_F) continue;
      const float iw = fmaxf(fminf(c.x2[j], bx2) - fmaxf(c.x1[j], bx1), 0.0f);
      const float ih = fmaxf(fminf(c.y2[j], by2) - fmaxf(c.y1[j], by1), 0.0f);
      const float inter = iw * ih;
      const float iou = inter / fmaxf(c.area[j] + barea - inter, 1e-9f);
      if (iou > thresh || j == best) {
        c.live[j] = -CUDART_INF_F;
      } else {
        arg_better(lv, j, bv, bi);
      }
    }
    // live[j] is read and written only by its owning thread, and the
    // coordinates are read-only here, so the reduction's barriers are the
    // only ones a step needs.
  }
}

}  // namespace greedy
