// The IoU test of the 2D NMS kernels: candidate j's box against the
// chosen box b, and the mask tile that takes it for every pair at once,
// shared by the decode+NMS kernel (decode_nms_2d.cu, kernel 1) and greedy
// NMS (greedy_nms.cu, kernel 2), so the two take it with the same
// operations.
//
// It follows ops/pallas_decode.py:128-131 and ops/pallas_nms.py:96-99 of
// the JAX package operation for operation. The build passes --fmad=false
// so `area + barea - inter` is two rounded operations, as in the plain
// PyTorch versions, and no fast-math flag, so `/` is IEEE. The caller
// adds "+ 0.0f" to the chosen box's values: the TPU kernels pick them
// with a masked sum, which turns -0.0 into +0.0.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#include "mask_scan.cuh"

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

// A mask tile: 64 rows x 64 columns (two words a row); a warp takes eight
// of its rows, a lane one column of each word.
constexpr int kRows = 64, kCols = 64, kWords = kCols / 32;
constexpr int kMaskWarps = 8;
constexpr int kMaskThreads = 32 * kMaskWarps;

// The grid of mask tiles over k candidates of a batch of b images.
inline dim3 mask_tiles(int k, int b) {
  return dim3((k + kCols - 1) / kCols, (k + kRows - 1) / kRows, b);
}

// One tile of the suppression bitmask (mask_scan.cuh), by a block of
// kMaskThreads at blockIdx (column tile, row tile, image): bit q of row p
// is set when the box at position p of the visiting order, as the chosen
// box, suppresses the one at position q: IoU > thresh. obox and oarea
// hold each image's K boxes and areas in visiting order; live_n[b] is the
// image's live count. Tiles left of the diagonal and past the live count
// are skipped (the scan reads none of them). Every test at once, a lane a
// column, a ballot a word; the division only where a lane of the warp has
// an intersection.
__device__ __forceinline__ void mask_tile(const float4* __restrict__ obox,
                                          const float* __restrict__ oarea,
                                          const int* __restrict__ live_n, int k, float thresh,
                                          uint32_t* __restrict__ mask) {
  const int ct = blockIdx.x, rt = blockIdx.y, b = blockIdx.z;
  const int p0 = kRows * rt, q0 = kCols * ct;
  if (q0 + kCols <= p0) return;  // every word left of the rows' diagonal words
  const int n = live_n[b];
  if (p0 >= n || q0 >= n) return;  // past the live ones
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __shared__ float4 rbox[kRows];
  __shared__ float rarea[kRows];
  if ((int)threadIdx.x < kRows && p0 + (int)threadIdx.x < n) {
    // the row candidate is the chosen box: "+ 0.0f" as the loop picks it
    const float4 r = obox[(size_t)b * k + p0 + threadIdx.x];
    rbox[threadIdx.x] = make_float4(r.x + 0.0f, r.y + 0.0f, r.z + 0.0f, r.w + 0.0f);
    rarea[threadIdx.x] = oarea[(size_t)b * k + p0 + threadIdx.x] + 0.0f;
  }
  float4 cbox[kWords];
  float carea[kWords];
#pragma unroll
  for (int h = 0; h < kWords; ++h) {  // lane l: column q0 + 32 h + l
    const int q = q0 + 32 * h + lane;
    cbox[h] = q < n ? obox[(size_t)b * k + q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    carea[h] = q < n ? oarea[(size_t)b * k + q] : 0.0f;
  }
  __syncthreads();
  // every test of this warp's rows first, then one ballot a word. The
  // division runs only where a lane of the warp has an intersection: with
  // none, every IoU of the 32 pairs is +-0 (iou_of).
  const bool zero_hit = 0.0f > thresh;
  constexpr int kWarpRows = kRows / kMaskWarps;
  uint32_t hit[kWarpRows] = {};
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    const int r = warp * kWarpRows + i;
    const float4 rb = rbox[r];
    const float ra = rarea[r];
#pragma unroll
    for (int h = 0; h < kWords; ++h) {
      const float inter =
          intersection(cbox[h].x, cbox[h].y, cbox[h].z, cbox[h].w, rb.x, rb.y, rb.z, rb.w);
      bool gt = zero_hit;
      if (__any_sync(maskscan::kFull, inter != 0.0f)) gt = iou_of(inter, carea[h], ra) > thresh;
      hit[i] |= (uint32_t)(q0 + 32 * h + lane < n && gt) << h;
    }
  }
  const int stride = maskscan::row_stride(k);
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    const int p = p0 + warp * kWarpRows + i;
#pragma unroll
    for (int h = 0; h < kWords; ++h) {
      const uint32_t bits = __ballot_sync(maskscan::kFull, hit[i] >> h & 1u);
      const int w = kWords * ct + h;
      if (lane == kWords * i + h && p < n && q0 + 32 * h < n)
        mask[((size_t)b * k + p) * stride + w] = bits;
    }
  }
}

}  // namespace boxiou
