// Segment sum of value rows with any segment ids, in two deterministic passes.
//
// Replaces the TPU kernel triton_client_tpu/parallel/ragged_kernels.py::
// segment_sum_pallas (body _segment_sum_kernel), the reduction that every
// ragged model body reaches through segment_reduce. It computes what that
// kernel computes:
//
//   out[s, f] = sum_{r: ids[r] = s} v[r, f]    for 0 <= s < S
//
// for values (R, F) float32 and ids (R,) int32 in any order. Ids outside
// [0, S) are dropped (negative ids, the packing's pad id, anything past S).
// R = 0 gives zeros. The TPU builds an (S, R) one-hot matrix and multiplies
// it into the values on its matrix unit, its way to keep a scatter off a
// machine that has none; on Hopper that would read the rows S times, or run
// on TF32 tensor cores, which do not give float32 sums. It is not carried over.
//
// What bounds it on an H100: bytes. It must read every row's id, the values
// of the rows it keeps, and write S x F sums. On the ragged main path (8
// clouds of 20k-120k points, F = 4, S = 8) that is about R x 5 x 4 bytes at
// R ~ 560k-655k packed rows, 11-13 MB, 3.4-3.9 us at 3.35 TB/s. R is
// 10^5-10^6 while S x F is ~32, so the parallelism comes from the rows.
//
// The design, and its summation order (the plain version
// segment_sum_reference in ops/gpu_segment.py follows it step by step, so
// the two agree bit for bit):
//
//   pass 1  one block of 256 threads per chunk of kChunk = 1024 rows (and
//           per tile of segments and of kFTile features). All 256 threads
//           stage the chunk's ids and values in shared memory; then one
//           thread per (segment, feature) walks the chunk's rows in row
//           order, from +0.0f, adding the value of every row whose id is its
//           segment. It writes partial[c, s, f].
//   pass 2  one thread per (segment, feature) adds partial[0..C-1, s, f] in
//           chunk order, from +0.0f, and writes out[s, f].
//
// No atomics and no shared accumulator: the result is the same on every run.
// A row whose id is not the thread's segment adds +0.0f, which leaves a sum
// that started at +0.0f unchanged bit for bit (such a sum is never -0.0f),
// and a selected zero, not a product, so a non-finite value in another
// segment's row never reaches this one. Each pass is a chain of dependent
// adds: 1024 in pass 1, C = ceil(R / 1024) in pass 2; both read kBatch
// values ahead of their adds, which keeps the order. No fast-math flag and
// --fmad=false (there is no product to contract anyway).
//
// Known slow parts, accepted for now: pass 2 is one warp's chain of C adds
// over loads from L2 at the main path's S x F = 32, and pass 1's compute is
// one warp a block; a fold over groups of chunks, and shorter chains in
// pass 1, need another summation order (and the plain version's with it).
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 1024;   // rows a block sums in pass 1
constexpr int kFTile = 8;      // features a pass-1 block stages
constexpr int kThreads = 256;  // threads a block at most
constexpr int kBatch = 32;     // reads in flight before their adds

__global__ void chunk_sums_kernel(const float* __restrict__ vals,  // (r, f)
                                  const int* __restrict__ ids,     // (r,)
                                  int r, int f, int s, int ft_w, int s_tile,
                                  float* __restrict__ partial) {   // (C, s, f)
  __shared__ int sid[kChunk];
  __shared__ float sv[kChunk * kFTile];
  const int c = blockIdx.x;
  const int f0 = blockIdx.y * ft_w;
  const int ft = min(ft_w, f - f0);
  const int s0 = blockIdx.z * s_tile;
  const int row0 = c * kChunk;
  const int rows = min(kChunk, r - row0);
#pragma unroll 4
  for (int i = threadIdx.x; i < rows; i += blockDim.x) sid[i] = ids[row0 + i];
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * ft; i += blockDim.x) {
    const int rr = i / ft, ff = i - rr * ft;
    sv[rr * kFTile + ff] = vals[(size_t)(row0 + rr) * f + f0 + ff];
  }
  __syncthreads();
  const int fl = threadIdx.x % ft_w;
  const int seg = s0 + threadIdx.x / ft_w;
  if (threadIdx.x >= s_tile * ft_w || fl >= ft || seg >= s) return;
  float acc = 0.0f;
  int i = 0;
  for (; i + kBatch <= rows; i += kBatch) {
    // the batch's shared-memory reads first, then its adds in row order
    float t[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      t[k] = sid[i + k] == seg ? sv[(i + k) * kFTile + fl] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) acc += t[k];
  }
  for (; i < rows; ++i) acc += sid[i] == seg ? sv[i * kFTile + fl] : 0.0f;
  partial[((size_t)c * s + seg) * f + f0 + fl] = acc;
}

__global__ void __launch_bounds__(kThreads)
fold_chunks_kernel(const float* __restrict__ partial,  // (chunks, sf)
                   int chunks, int sf,
                   float* __restrict__ out) {          // (sf,)
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= sf) return;
  float acc = 0.0f;
  int c = 0;
  for (; c + kBatch <= chunks; c += kBatch) {
    // the batch's loads in flight together, then its adds in chunk order
    float t[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) t[k] = partial[(size_t)(c + k) * sf + o];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) acc += t[k];
  }
  for (; c < chunks; ++c) acc += partial[(size_t)c * sf + o];
  out[o] = acc;
}

}  // namespace

// vals (r, f) float32 and ids (r,) int32, both contiguous; partial is
// scratch of (ceil(r / 1024), s, f) float32; out (s, f) float32. Needs
// s >= 1 and f >= 1. Returns cudaGetLastError() after the launches
// (0 = launched).
extern "C" int segment_sum_launch(const void* vals, const void* ids, int r, int f, int s,
                                  void* partial, void* out, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int chunks = (r + kChunk - 1) / kChunk;
  if (chunks > 0) {
    const int ft_w = f < kFTile ? f : kFTile;
    const int s_tile = s < kThreads / ft_w ? s : kThreads / ft_w;
    const dim3 grid(chunks, (f + ft_w - 1) / ft_w, (s + s_tile - 1) / s_tile);
    chunk_sums_kernel<<<grid, kThreads, 0, st>>>(
        (const float*)vals, (const int*)ids, r, f, s, ft_w, s_tile, (float*)partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int sf = s * f;
  const int threads = sf < kThreads ? ((sf + 31) / 32) * 32 : kThreads;
  fold_chunks_kernel<<<(sf + threads - 1) / threads, threads, 0, st>>>(
      (const float*)partial, chunks, sf, (float*)out);
  return (int)cudaGetLastError();
}
