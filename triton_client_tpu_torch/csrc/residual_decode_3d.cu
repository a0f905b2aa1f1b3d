// 3D anchor-residual box decode + direction-bin heading rectification,
// one thread per candidate, every candidate of the batch in one launch.
//
// Replaces the TPU kernel triton_client_tpu/ops/pallas_decode.py::
// fused_residual_decode (body _residual_decode_kernel). It computes what
// that kernel computes, operation for operation; the TPU's (8, K) SoA lane
// rows are not carried over: the kernel reads the (B, K, 7) AoS deltas and
// anchors the top-k gather produces and writes (B, K, 7) boxes.
//
// What bounds it on an H100: launch latency. Its bytes (92 a candidate,
// 23.5 KB at K = 256) take about 7 ns at 3.35 TB/s and its few dozen
// operations a candidate less; one launch of a few microseconds is the
// floor. The design is one pass, one thread per candidate, no shared
// memory.
//
// Float rules: the build passes --fmad=false, so d * diag + xa is two
// rounded operations as in the plain PyTorch version (XLA's CPU code may
// contract it into an FMA); no fast-math flag, so sqrtf, expf and the
// division are the IEEE-accurate ones PyTorch's CUDA kernels call. period
// and dir_offset arrive as float, rounded from double on the host, as JAX
// rounds its Python floats against a float32 array.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
residual_decode_3d_kernel(const float* __restrict__ deltas,       // (n, 7)
                          const float* __restrict__ anchors,      // (n, 7)
                          const long long* __restrict__ dir_bin,  // (n,)
                          int n, float period, float dir_offset,
                          float* __restrict__ boxes) {            // (n, 7)
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float* d = deltas + (size_t)i * 7;
  const float* a = anchors + (size_t)i * 7;
  float* o = boxes + (size_t)i * 7;
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
  o[6] = r + period * (float)dir_bin[i];
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int residual_decode_3d_launch(const void* deltas, const void* anchors,
                                         const void* dir_bin, int n, float period,
                                         float dir_offset, void* boxes, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  residual_decode_3d_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)deltas, (const float*)anchors, (const long long*)dir_bin, n, period,
      dir_offset, (float*)boxes);
  return (int)cudaGetLastError();
}
