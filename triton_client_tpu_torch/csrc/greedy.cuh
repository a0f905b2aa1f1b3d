// Greedy suppression loop shared by the decode+NMS, greedy-NMS and 3D
// suppress+pack kernels.
//
// One thread block owns one image. Live scores sit in shared memory. Each
// step takes the block argmax over live scores (ties to the lowest index,
// as jnp.argmax), emits it, and kills every live candidate whose IoU with
// it exceeds the threshold. Where the IoU comes from is the caller's: the
// 2D kernels compute it from boxes in shared memory (Boxes), the 3D
// kernel reads a row of a precomputed matrix (IouMatrix). The suppression
// pass also computes each thread's argmax for the next step, so a step
// costs one pass over the thread's candidates plus one block reduction
// (two __syncthreads).
//
// The 2D IoU follows ops/pallas_decode.py:128-131 and ops/pallas_nms.py:
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

// IoU of every candidate with the chosen one, computed from boxes in
// shared memory (the 2D kernels). row(best) reads the chosen box once;
// the returned functor gives the IoU of candidate j.
struct BoxIou {
  const float* x1;
  const float* y1;
  const float* x2;
  const float* y2;
  const float* area;
  float bx1, by1, bx2, by2, barea;
  __device__ __forceinline__ float operator()(int j) const {
    const float iw = fmaxf(fminf(x2[j], bx2) - fmaxf(x1[j], bx1), 0.0f);
    const float ih = fmaxf(fminf(y2[j], by2) - fmaxf(y1[j], by1), 0.0f);
    const float inter = iw * ih;
    return inter / fmaxf(area[j] + barea - inter, 1e-9f);
  }
};

struct Boxes {
  const float* x1;
  const float* y1;
  const float* x2;
  const float* y2;
  const float* area;
  // "+ 0.0f": the TPU kernels pick the chosen box with a masked sum,
  // which turns -0.0 into +0.0
  __device__ __forceinline__ BoxIou row(int best) const {
    return {x1, y1, x2, y2, area, x1[best] + 0.0f, y1[best] + 0.0f,
            x2[best] + 0.0f, y2[best] + 0.0f, area[best] + 0.0f};
  }
};

// IoU rows of a precomputed (n, n) matrix in device memory (the 3D
// kernel): row(best) is the chosen candidate's row, read coalesced.
struct IouRow {
  const float* r;
  __device__ __forceinline__ float operator()(int j) const { return r[j]; }
};

struct IouMatrix {
  const float* iou;
  int n;
  __device__ __forceinline__ IouRow row(int best) const { return {iou + (size_t)best * n}; }
};

// Runs max_det steps over the n candidates whose live scores are in
// `live` (-inf once suppressed or invalid; live[j] belongs to thread
// j % kThreads). Each step kills the chosen candidate and every live one
// whose IoU with it, src.row(best)(j), exceeds thresh. emit(step, best) is
// called by thread 0 for each kept candidate; emit_empty(step) by thread 0
// for every step after the live set ran out (the loop stops there: the
// remaining steps would all pick an invalid candidate and change nothing).
template <typename Src, typename Emit, typename EmitEmpty>
__device__ void suppress_loop(const Src& src, float* live, int n, float thresh, int max_det,
                              float* red_v, int* red_i, Emit emit, EmitEmpty emit_empty) {
  float bv = -CUDART_INF_F;
  int bi = INT_MAX;
  for (int j = threadIdx.x; j < n; j += kThreads) arg_better(live[j], j, bv, bi);

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
    const auto iou = src.row(best);
    bv = -CUDART_INF_F;
    bi = INT_MAX;
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float lv = live[j];
      if (lv == -CUDART_INF_F) continue;
      if (iou(j) > thresh || j == best) {
        live[j] = -CUDART_INF_F;
      } else {
        arg_better(lv, j, bv, bi);
      }
    }
    // live[j] is read and written only by its owning thread, and the
    // IoU sources are read-only here, so the reduction's barriers are the
    // only ones a step needs.
  }
}

}  // namespace greedy
