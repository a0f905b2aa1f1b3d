// Greedy NMS over xyxy boxes for the whole batch, as a suppression bitmask
// and a one-warp scan (mask_scan.cuh) in three launches on one stream.
// Returns each image's kept indices in selection order and a valid mask;
// invalid slots hold the index jnp.argmax gives there in the TPU kernel
// (0 once nothing is live, the first NaN when a score is NaN), so index
// sequences stay identical.
//
// Replaces the TPU kernel triton_client_tpu/ops/pallas_nms.py::nms_pallas
// (body _nms_kernel). It computes what that kernel computes; the TPU's
// step-by-step argmax loop is not carried over.
//
// What bounds it on an H100: latency. The bytes it must move (some 20 KB
// an image at N = 1024) take well under a microsecond at 3.35 TB/s, and
// the IoU tests the loop needs a few at the fp32 rate. The greedy loop's
// max_det dependent block-wide argmax steps (~1.6 us each) were the time,
// and its candidates in shared memory capped N near 9,600. The design
// splits the work by what depends on what, as the decode+NMS kernel
// (decode_nms_2d.cu) does:
//   greedy_nms_order  one block per image: the visiting order of the
//       scores (the input's own when the live scores are already in order,
//       as the unfused 2D route hands them over after its top-k, else a
//       bitonic sort), the live count (0 with a live NaN), the first NaN's
//       index, and the boxes and their unclipped areas in visiting order;
//   greedy_nms_mask   box_iou.cuh's 64 x 64 mask tiles across the card;
//   greedy_nms_scan   one block per image: the scan (mask_scan.cuh), then
//       the kept indices and the valid mask.
// N is bounded by the order pass's sort in one block's shared memory
// (16,384 candidates); the mask in device memory takes N x row_stride(N)
// words an image (32 MB at 16,384).
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "box_iou.cuh"
#include "mask_scan.cuh"

namespace {

__global__ void __launch_bounds__(maskscan::kOrderThreads)
greedy_nms_order(const float4* __restrict__ boxes,  // (B, K) xyxy
                 const float* __restrict__ scores,  // (B, K), -inf = padding
                 int k,
                 int* __restrict__ order,     // (B, K) candidate at each position
                 int* __restrict__ live_n,    // (2B,) live counts, own-order flags
                 float4* __restrict__ obox,   // (B, K) boxes, visiting order
                 float* __restrict__ oarea,   // (B, K)
                 int* __restrict__ fill) {    // (B,) index of the invalid slots
  extern __shared__ unsigned long long keys[];  // sort_slots(k), then k live scores
  float* live = reinterpret_cast<float*>(keys + maskscan::sort_slots(k));
  __shared__ int first_nan;
  const int b = blockIdx.x;
  const float* sc = scores + (size_t)b * k;
  if (threadIdx.x == 0) first_nan = INT_MAX;  // published by live_order's barrier
  int nan_at = INT_MAX;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const float s = sc[j];
    live[j] = s;
    if (isnan(s)) nan_at = min(nan_at, j);
  }
  const maskscan::Order o = maskscan::live_order(live, k, keys);
  if (nan_at != INT_MAX) atomicMin(&first_nan, nan_at);

  for (int p = threadIdx.x; p < o.live; p += blockDim.x) {
    const int j = maskscan::candidate_at(o, keys, p);
    const float4 d = boxes[(size_t)b * k + j];
    order[(size_t)b * k + p] = j;
    obox[(size_t)b * k + p] = d;
    oarea[(size_t)b * k + p] = (d.z - d.x) * (d.w - d.y);  // unclipped, as pallas_nms.py:129
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    live_n[b] = o.live;
    live_n[gridDim.x + b] = o.sorted;  // read back by chip_smoke.py
    // jnp.argmax ranks a NaN above every number: with one live, every
    // step picks the first NaN, an invalid pick; else the empty steps
    // pick index 0 of an all -inf row
    fill[b] = first_nan == INT_MAX ? 0 : first_nan;
  }
}

__global__ void __launch_bounds__(boxiou::kMaskThreads)
greedy_nms_mask(const float4* __restrict__ obox, const float* __restrict__ oarea,
                const int* __restrict__ live_n, int k, float thresh,
                uint32_t* __restrict__ mask) {  // (B, K, row_stride(K))
  boxiou::mask_tile(obox, oarea, live_n, k, thresh, mask);
}

__global__ void __launch_bounds__(maskscan::kScanThreads)
greedy_nms_scan(const uint32_t* __restrict__ mask, const int* __restrict__ order,
                const int* __restrict__ live_n, const int* __restrict__ fill, int k,
                int max_det,
                int* __restrict__ indices,  // (B, max_det)
                bool* __restrict__ valid) { // (B, max_det)
  extern __shared__ uint32_t smem[];  // maskscan::scan_smem_words(k, max_det)
  const int b = blockIdx.x;
  const maskscan::Kept kept =
      maskscan::scan(mask + (size_t)b * k * maskscan::row_stride(k), k, live_n[b], max_det, smem);
  const int empty = fill[b];
  for (int s = threadIdx.x; s < max_det; s += blockDim.x) {
    const bool kp = s < kept.n;
    indices[(size_t)b * max_det + s] = kp ? order[(size_t)b * k + kept.pos[s]] : empty;
    valid[(size_t)b * max_det + s] = kp;
  }
}

// the dynamic shared memory limits set so far, by device (set_smem)
std::atomic<int> order_smem_set[maskscan::kDevices], scan_smem_set[maskscan::kDevices];

}  // namespace

// The workspace (ops/gpu_nms.workspace): mask (B, K, row_stride(K)) words,
// order (B, K) int32, live counts (B,) then own-order flags (B,) int32
// (maskscan::Order), boxes (B, K, 4) and areas (B, K) float32 in visiting
// order, the invalid slots' index (B,) int32. order_smem is the wrapper's
// count of the order pass's dynamic shared memory (ops/gpu_nms.smem_bytes).
// Returns the first nonzero cudaGetLastError() of the three launches
// (0 = launched).
extern "C" int greedy_nms_launch(const void* boxes, const void* scores, int batch, int k,
                                 float thresh, int max_det, void* indices, void* valid,
                                 void* mask, void* order, void* live_n, void* obox, void* oarea,
                                 void* fill, int order_smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int scan_smem = 4 * maskscan::scan_smem_words(k, max_det);
  int err = maskscan::set_smem((const void*)greedy_nms_order, order_smem_set, order_smem);
  if (err == 0) err = maskscan::set_smem((const void*)greedy_nms_scan, scan_smem_set, scan_smem);
  if (err != 0) return err;
  greedy_nms_order<<<batch, maskscan::kOrderThreads, order_smem, st>>>(
      (const float4*)boxes, (const float*)scores, k, (int*)order, (int*)live_n, (float4*)obox,
      (float*)oarea, (int*)fill);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  if (k > 0) {
    greedy_nms_mask<<<boxiou::mask_tiles(k, batch), boxiou::kMaskThreads, 0, st>>>(
        (const float4*)obox, (const float*)oarea, (const int*)live_n, k, thresh,
        (uint32_t*)mask);
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  greedy_nms_scan<<<batch, maskscan::kScanThreads, scan_smem, st>>>(
      (const uint32_t*)mask, (const int*)order, (const int*)live_n, (const int*)fill, k,
      max_det, (int*)indices, (bool*)valid);
  return (int)cudaGetLastError();
}
