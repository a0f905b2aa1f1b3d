// 3D anchor-residual box decode + direction-bin heading rectification,
// one thread per candidate, every candidate of the batch in one launch.
//
// Replaces the TPU kernel triton_client_tpu/ops/pallas_decode.py::
// fused_residual_decode (body _residual_decode_kernel). It computes what
// that kernel computes, operation for operation; the TPU's (8, K) SoA lane
// rows are not carried over. Two forms of one kernel body:
//   residual_decode_3d_kernel<false>  reads (n, 7) deltas and anchors and
//       an (n,) int64 direction bin, as the TPU kernel takes them;
//   residual_decode_3d_kernel<true>   reads the top-k candidates' rows
//       itself: candidate i of image b is row top_idx[b, i] of the (B, N, 7)
//       box head, of the (N, 7) anchors and of the (B, N, nb) direction
//       logits, whose argmax is its bin. On the TPU, XLA fuses those
//       gathers into the program around the Pallas call; here they would
//       be four more launches (two take_along_dim, an index, an argmax)
//       ahead of a kernel that is itself mostly its launch.
//
// What bounds it on an H100: launch latency. Its bytes (92 a candidate,
// 23.5 KB at K = 256; gathered, 28 + 28 + 4 nb + 8 + 28, 25.6 KB) take
// about 7 ns at 3.35 TB/s and its few dozen operations a candidate less;
// one launch of a few microseconds is the floor. The design is one pass,
// one thread per candidate, no shared memory.
//
// Float rules: the build passes --fmad=false, so d * diag + xa is two
// rounded operations as in the plain PyTorch version (XLA's CPU code may
// contract it into an FMA); no fast-math flag, so sqrtf, expf and the
// division are the IEEE-accurate ones PyTorch's CUDA kernels call. period
// and dir_offset arrive as float, rounded from double on the host, as JAX
// rounds its Python floats against a float32 array.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;

// The index of the largest of v[0, nb), as jnp.argmax and torch.argmax
// take it: the first maximum, a NaN ranking above every number.
__device__ __forceinline__ int argmax_bin(const float* __restrict__ v, int nb) {
  int best = 0;
  float bv = v[0];
  for (int j = 1; j < nb; ++j) {
    const float x = v[j];
    if (!isnan(bv) && (isnan(x) || x > bv)) {
      bv = x;
      best = j;
    }
  }
  return best;
}

template <bool kGather>
__global__ void __launch_bounds__(kThreads)
residual_decode_3d_kernel(const float* __restrict__ deltas,       // (n, 7) or (B, N, 7)
                          const float* __restrict__ anchors,      // (n, 7) or (N, 7)
                          const long long* __restrict__ dir_bin,  // (n,) or unused
                          const float* __restrict__ dir_logits,   // unused or (B, N, nb)
                          const long long* __restrict__ top_idx,  // unused or (B, K)
                          int n, int k, int n_rows, int nb, float period, float dir_offset,
                          float* __restrict__ boxes) {            // (n, 7); n = B K gathered
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float* o = boxes + (size_t)i * 7;
  const float* d;
  const float* a;
  float bin;
  if (kGather) {
    const long long row = top_idx[i];
    if (row < 0 || row >= n_rows) {  // outside the head: a NaN row, no read past it
      for (int c = 0; c < 7; ++c) o[c] = CUDART_NAN_F;
      return;
    }
    const size_t head_row = (size_t)(i / k) * n_rows + row;
    d = deltas + head_row * 7;
    a = anchors + (size_t)row * 7;
    bin = (float)argmax_bin(dir_logits + head_row * nb, nb);
  } else {
    d = deltas + (size_t)i * 7;
    a = anchors + (size_t)i * 7;
    bin = (float)dir_bin[i];
  }
  const float xa = a[0], ya = a[1], za = a[2];
  const float dxa = a[3], dya = a[4], dza = a[5], ra = a[6];
  const float diag = sqrtf(dxa * dxa + dya * dya);
  o[0] = d[0] * diag + xa;
  o[1] = d[1] * diag + ya;
  o[2] = d[2] * dza + za;
  // jnp.clip(x, -10, 10) = min(max(x, -10), 10)
  o[3] = expf(fminf(fmaxf(d[3], -10.0f), 10.0f)) * dxa;
  o[4] = expf(fminf(fmaxf(d[4], -10.0f), 10.0f)) * dya;
  o[5] = expf(fminf(fmaxf(d[5], -10.0f), 10.0f)) * dza;
  const float rot = d[6] + ra;
  float r = rot - dir_offset;
  r = (r - floorf(r / period) * period) + dir_offset;
  o[6] = r + period * bin;
}

}  // namespace

// The form of the TPU kernel: n candidates' deltas, anchors and bins.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int residual_decode_3d_launch(const void* deltas, const void* anchors,
                                         const void* dir_bin, int n, float period,
                                         float dir_offset, void* boxes, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  residual_decode_3d_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)deltas, (const float*)anchors, (const long long*)dir_bin, nullptr, nullptr,
      n, 1, 0, 0, period, dir_offset, (float*)boxes);
  return (int)cudaGetLastError();
}

// The gathered form: batch images of n_rows anchors, k candidates each
// (top_idx (batch, k) int64), nb direction bins. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int gather_residual_decode_3d_launch(const void* box_head, const void* anchors,
                                                const void* dir_logits, const void* top_idx,
                                                int batch, int n_rows, int k, int nb,
                                                float period, float dir_offset, void* boxes,
                                                void* stream) {
  const int n = batch * k;
  const int blocks = (n + kThreads - 1) / kThreads;
  residual_decode_3d_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)box_head, (const float*)anchors, nullptr, (const float*)dir_logits,
      (const long long*)top_idx, n, k, n_rows, nb, period, dir_offset, (float*)boxes);
  return (int)cudaGetLastError();
}
