// Fused 2D detection tail: candidate decode, class offset, greedy NMS and
// packed output rows for the whole batch, as a suppression bitmask and a
// one-warp scan (mask_scan.cuh) in three launches on one stream.
//
// Replaces the TPU kernel triton_client_tpu/ops/pallas_decode.py::
// fused_decode_nms_2d (body _decode_nms_pack_2d_kernel). It computes what
// that kernel computes; the TPU's (8, K) lane layout, masked-sum picks and
// step-by-step argmax loop are not carried over.
//
// What bounds it on an H100: latency. The bytes it must move (some 33 KB
// an image at K = 1024) take well under a microsecond at 3.35 TB/s, and
// the IoU tests the loop needs (up to max_det x K an image) a few at the
// fp32 rate. The greedy loop's max_det dependent block-wide argmax steps
// (~1.7 us each) were the time. The design splits the work by what
// depends on what:
//   decode_nms_2d_order  one block per image: decode, the adaptive
//       class-offset stride (max |coord| over all K slots, invalid ones
//       included), live scores, the visiting order, and the offset boxes
//       and areas written in visiting order;
//   decode_nms_2d_mask   a (K/64, K/64, B) grid of 64 x 64 tiles, the
//       tiles left of the diagonal and past the live count skipped: every
//       IoU test at once, by box_iou.cuh's mask tile with the row
//       candidate as the chosen box, a lane a column, a ballot a word; the
//       division only where a lane of the warp has an intersection;
//   decode_nms_2d_scan   one block per image: the scan (mask_scan.cuh),
//       then 256 threads write the packed rows from the original inputs.
// A scan step covers 32 positions: a few ballots, and nothing more for a
// suppressed box.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

#include "box_iou.cuh"
#include "mask_scan.cuh"

namespace {

// xywh -> xyxy (ops/boxes.xywh2xyxy; * 0.5 is exact) or the box as given.
__device__ __forceinline__ float4 decode(const float* bx, int j, int xywh) {
  const float c0 = bx[4 * j], c1 = bx[4 * j + 1], c2 = bx[4 * j + 2], c3 = bx[4 * j + 3];
  if (!xywh) return make_float4(c0, c1, c2, c3);
  return make_float4(c0 - c2 * 0.5f, c1 - c3 * 0.5f, c0 + c2 * 0.5f, c1 + c3 * 0.5f);
}

// Block-wide max of non-negative values; every thread gets it.
__device__ float block_max(float v) {
  __shared__ float red[maskscan::kOrderThreads / 32];
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = 0.0f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) m = fmaxf(m, red[w]);
  return m;
}

__global__ void __launch_bounds__(maskscan::kOrderThreads)
decode_nms_2d_order(const float* __restrict__ boxes,    // (B, K, 4)
                    const float* __restrict__ scores,   // (B, K), 0 where invalid
                    const float* __restrict__ classes,  // (B, K) class ids as float
                    const bool* __restrict__ valid,     // (B, K)
                    int k, int xywh, int class_agnostic,
                    int* __restrict__ order,     // (B, K) candidate at each position
                    int* __restrict__ live_n,    // (2B,) live counts, own-order flags
                    float4* __restrict__ obox,   // (B, K) offset boxes, visiting order
                    float* __restrict__ oarea) { // (B, K)
  extern __shared__ unsigned long long keys[];  // sort_slots(k), then k live scores
  float* live = reinterpret_cast<float*>(keys + maskscan::sort_slots(k));
  const int b = blockIdx.x;
  const float* bx = boxes + (size_t)b * k * 4;
  const float* sc = scores + (size_t)b * k;
  const float* cl = classes + (size_t)b * k;
  const bool* va = valid + (size_t)b * k;

  float m = 0.0f;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const float4 d = decode(bx, j, xywh);
    m = fmaxf(m, fmaxf(fmaxf(fabsf(d.x), fabsf(d.y)), fmaxf(fabsf(d.z), fabsf(d.w))));
    live[j] = va[j] ? sc[j] : -CUDART_INF_F;
  }
  const float stride = class_agnostic ? 0.0f : block_max(m) * 2.0f + 1.0f;
  const maskscan::Order o = maskscan::live_order(live, k, keys);

  for (int p = threadIdx.x; p < o.live; p += blockDim.x) {
    const int j = maskscan::candidate_at(o, keys, p);
    float4 d = decode(bx, j, xywh);
    if (!class_agnostic) {
      const float off = cl[j] * stride;
      d = make_float4(d.x + off, d.y + off, d.z + off, d.w + off);
    }
    order[(size_t)b * k + p] = j;
    obox[(size_t)b * k + p] = d;
    oarea[(size_t)b * k + p] = (d.z - d.x) * (d.w - d.y);
  }
  if (threadIdx.x == 0) {
    live_n[b] = o.live;
    live_n[gridDim.x + b] = o.sorted;  // read back by chip_smoke.py
  }
}

__global__ void __launch_bounds__(boxiou::kMaskThreads)
decode_nms_2d_mask(const float4* __restrict__ obox, const float* __restrict__ oarea,
                   const int* __restrict__ live_n, int k, float thresh,
                   uint32_t* __restrict__ mask) {  // (B, K, row_stride(K))
  boxiou::mask_tile(obox, oarea, live_n, k, thresh, mask);
}

__global__ void __launch_bounds__(maskscan::kScanThreads)
decode_nms_2d_scan(const float* __restrict__ boxes, const float* __restrict__ scores,
                   const float* __restrict__ classes, int k, int xywh,
                   const uint32_t* __restrict__ mask, const int* __restrict__ order,
                   const int* __restrict__ live_n, int max_det,
                   float* __restrict__ dets,  // (B, max_det, 6)
                   bool* __restrict__ keep) { // (B, max_det)
  extern __shared__ uint32_t smem[];  // maskscan::scan_smem_words(k, max_det)
  const int b = blockIdx.x;
  const maskscan::Kept kept =
      maskscan::scan(mask + (size_t)b * k * maskscan::row_stride(k), k, live_n[b], max_det, smem);
  for (int s = threadIdx.x; s < kept.n; s += blockDim.x)
    kept.pos[s] = order[(size_t)b * k + kept.pos[s]];  // position -> candidate
  __syncthreads();
  const float* bx = boxes + (size_t)b * k * 4;
  for (int s = threadIdx.x; s < max_det; s += blockDim.x) {
    float* row = dets + ((size_t)b * max_det + s) * 6;
    const bool kp = s < kept.n;
    if (kp) {
      // "+ 0.0f": the TPU kernel picks row values with a masked sum,
      // which turns -0.0 into +0.0
      const int j = kept.pos[s];
      const float4 d = decode(bx, j, xywh);
      row[0] = d.x + 0.0f;
      row[1] = d.y + 0.0f;
      row[2] = d.z + 0.0f;
      row[3] = d.w + 0.0f;
      row[4] = scores[(size_t)b * k + j] + 0.0f;
      row[5] = classes[(size_t)b * k + j] + 0.0f;
    } else {
      for (int r = 0; r < 6; ++r) row[r] = 0.0f;
    }
    keep[(size_t)b * max_det + s] = kp;
  }
}

// the dynamic shared memory limits set so far, by device (set_smem)
std::atomic<int> order_smem_set[maskscan::kDevices], scan_smem_set[maskscan::kDevices];

}  // namespace

// The workspace (ops/gpu_decode.workspace): mask (B, K, row_stride(K)) words,
// order (B, K) int32, live counts (B,) then own-order flags (B,) int32
// (maskscan::Order), offset boxes (B, K, 4) and areas (B, K) float32. order_smem is the wrapper's count of the order
// pass's dynamic shared memory (ops/gpu_decode.smem_bytes). Returns the
// first nonzero cudaGetLastError() of the three launches (0 = launched).
extern "C" int decode_nms_2d_launch(const void* boxes, const void* scores, const void* classes,
                                    const void* valid, int batch, int k, float thresh,
                                    int max_det, int xywh, int class_agnostic, void* dets,
                                    void* keep, void* mask, void* order, void* live_n,
                                    void* obox, void* oarea, int order_smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int scan_smem = 4 * maskscan::scan_smem_words(k, max_det);
  int err = maskscan::set_smem((const void*)decode_nms_2d_order, order_smem_set, order_smem);
  if (err == 0)
    err = maskscan::set_smem((const void*)decode_nms_2d_scan, scan_smem_set, scan_smem);
  if (err != 0) return err;
  decode_nms_2d_order<<<batch, maskscan::kOrderThreads, order_smem, st>>>(
      (const float*)boxes, (const float*)scores, (const float*)classes, (const bool*)valid, k,
      xywh, class_agnostic, (int*)order, (int*)live_n, (float4*)obox, (float*)oarea);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  if (k > 0) {
    decode_nms_2d_mask<<<boxiou::mask_tiles(k, batch), boxiou::kMaskThreads, 0, st>>>(
        (const float4*)obox, (const float*)oarea, (const int*)live_n, k, thresh,
        (uint32_t*)mask);
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  decode_nms_2d_scan<<<batch, maskscan::kScanThreads, scan_smem, st>>>(
      (const float*)boxes, (const float*)scores, (const float*)classes, k, xywh,
      (const uint32_t*)mask, (const int*)order, (const int*)live_n, max_det, (float*)dets,
      (bool*)keep);
  return (int)cudaGetLastError();
}
