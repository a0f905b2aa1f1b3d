// Greedy suppression loop of the greedy-NMS kernel (greedy_nms.cu,
// kernel 2). The decode+NMS and 3D suppress+pack kernels run a
// suppression bitmask and a one-warp scan instead (mask_scan.cuh).
//
// One thread block owns one image. Live scores sit in shared memory. Each
// step takes the block argmax over live scores (ties to the lowest index,
// as jnp.argmax), emits it, and kills every live candidate whose IoU with
// it exceeds the threshold. A live NaN empties every step, as jnp.argmax
// and torch.argmax rank a NaN above every number (see suppress_loop). The
// suppression pass also computes each thread's argmax for the next step,
// so a step costs one pass over the thread's candidates plus one block
// reduction (two __syncthreads). The IoU test is box_iou.cuh's.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>

#include "box_iou.cuh"

namespace greedy {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Takes (v, i) into (bv, bi) when it ranks higher: the larger value, then
// the lower index. No NaN reaches it (suppress_loop settles a live NaN
// first).
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

// The lowest index whose live score is NaN, INT_MAX when none; every
// thread gets it. red_i holds kWarps slots.
__device__ __forceinline__ int first_nan(const float* live, int n, int* red_i) {
  int at = INT_MAX;
  for (int j = threadIdx.x; j < n; j += kThreads)
    if (isnan(live[j])) at = min(at, j);
  for (int off = 16; off > 0; off >>= 1) at = min(at, __shfl_down_sync(0xffffffffu, at, off));
  if ((threadIdx.x & 31) == 0) red_i[threadIdx.x >> 5] = at;
  __syncthreads();
  at = INT_MAX;
  for (int w = 0; w < kWarps; ++w) at = min(at, red_i[w]);
  __syncthreads();  // red_i is the loop's reduction scratch next
  return at;
}

// IoU of every candidate with the chosen one, computed from boxes in
// shared memory. Boxes::row(best) reads the chosen box once; the returned
// functor gives the IoU of candidate j.
struct BoxIou {
  const float* x1;
  const float* y1;
  const float* x2;
  const float* y2;
  const float* area;
  float bx1, by1, bx2, by2, barea;
  __device__ __forceinline__ float operator()(int j) const {
    return boxiou::iou(x1[j], y1[j], x2[j], y2[j], area[j], bx1, by1, bx2, by2, barea);
  }
};

struct Boxes {
  const float* x1;
  const float* y1;
  const float* x2;
  const float* y2;
  const float* area;
  __device__ __forceinline__ BoxIou row(int best) const {
    return {x1, y1, x2, y2, area, x1[best] + 0.0f, y1[best] + 0.0f,
            x2[best] + 0.0f, y2[best] + 0.0f, area[best] + 0.0f};
  }
};

// Runs max_det steps over the n candidates whose live scores are in
// `live` (-inf once suppressed or invalid; live[j] belongs to thread
// j % kThreads). Each step kills the chosen candidate and every live one
// whose IoU with it, src.row(best)(j), exceeds thresh. emit(step, best) is
// called by thread 0 for each kept candidate; emit_empty(step, index) by
// thread 0 for every step after the live set ran out, with the index
// jnp.argmax gives there: 0 over an all -inf row. The loop stops there:
// the remaining steps would all pick the same invalid candidate and change
// nothing.
//
// jnp.argmax ranks a NaN above every number and takes the first, so a
// live NaN is the loop's first pick, an invalid one, and so is every pick
// after it: every step is empty, at the first NaN's index. A search for
// that NaN before the loop settles it and leaves the steps' reduction the
// plain compare (ranking NaNs inside the reduction made each step some
// 13% slower on an H100).
template <typename Src, typename Emit, typename EmitEmpty>
__device__ void suppress_loop(const Src& src, float* live, int n, float thresh, int max_det,
                              float* red_v, int* red_i, Emit emit, EmitEmpty emit_empty) {
  const int nan_at = first_nan(live, n, red_i);
  if (nan_at != INT_MAX) {
    if (threadIdx.x == 0)
      for (int s = 0; s < max_det; ++s) emit_empty(s, nan_at);
    return;
  }
  float bv = -CUDART_INF_F;
  int bi = INT_MAX;
  for (int j = threadIdx.x; j < n; j += kThreads) arg_better(live[j], j, bv, bi);

  for (int step = 0; step < max_det; ++step) {
    float best_v;
    int best;
    block_argmax(bv, bi, red_v, red_i, best_v, best);
    if (!(best_v > -CUDART_INF_F)) {
      if (threadIdx.x == 0)
        for (int s = step; s < max_det; ++s) emit_empty(s, 0);
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
    // boxes are read-only here, so the reduction's barriers are the only
    // ones a step needs.
  }
}

}  // namespace greedy
