// The IoU test of the 2D greedy kernels: candidate j's box against the
// chosen box b, shared by the greedy loop (greedy.cuh, kernel 2) and the
// suppression bitmask of the decode+NMS kernel (decode_nms_2d.cu), so the
// two take it with the same operations.
//
// It follows ops/pallas_decode.py:128-131 and ops/pallas_nms.py:96-99 of
// the JAX package operation for operation. The build passes --fmad=false
// so `area + barea - inter` is two rounded operations, as in the plain
// PyTorch versions, and no fast-math flag, so `/` is IEEE. The caller
// adds "+ 0.0f" to the chosen box's values: the TPU kernels pick them
// with a masked sum, which turns -0.0 into +0.0.
#pragma once

#include <cuda_runtime.h>

namespace boxiou {

__device__ __forceinline__ float intersection(float x1, float y1, float x2, float y2, float bx1,
                                              float by1, float bx2, float by2) {
  const float iw = fmaxf(fminf(x2, bx2) - fmaxf(x1, bx1), 0.0f);
  const float ih = fmaxf(fminf(y2, by2) - fmaxf(y1, by1), 0.0f);
  return iw * ih;
}

// IoU from the intersection. With inter == 0 it is +-0 whatever the
// areas (the denominator is at least 1e-9), so iou > t is t < 0 there.
__device__ __forceinline__ float iou_of(float inter, float area, float barea) {
  return inter / fmaxf(area + barea - inter, 1e-9f);
}

__device__ __forceinline__ float iou(float x1, float y1, float x2, float y2, float area,
                                     float bx1, float by1, float bx2, float by2, float barea) {
  return iou_of(intersection(x1, y1, x2, y2, bx1, by1, bx2, by2), area, barea);
}

}  // namespace boxiou
