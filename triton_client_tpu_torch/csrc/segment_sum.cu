// Segment sum of value rows with any segment ids, in one deterministic launch.
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
// The design. A tile is 32 (segment, feature) pairs: FT = the power of two
// at or above min(F, 8) features by ST = 32 / FT segments (pairs past F or
// S are masked). The grid's x walks the chunks of kChunk = 1024 rows, its y
// the feature tiles; a block of 8 warps takes one chunk of one feature
// tile, and each warp a sub-chunk of kSub = 128 rows. Lane l loads its 4
// rows l, l + 32, l + 64, l + 96 of the sub-chunk once (ids and FT values
// straight into registers, coalesced, 16 bytes a load where F allows, every
// load in flight before the first add); the block then walks the segment
// tiles. For each, the lane keeps one sum for each of the tile's 32 pairs
// (a warp with no row in the tile skips to zeros), a butterfly of shuffles
// leaves the sub-chunk's sum of pair p in lane p, and the block adds its 8
// sub-chunk sums and writes the chunk's partial. The last block of a tile
// to finish (a ticket counter per tile in device memory, taken with one
// acquire-release atomic after a barrier, and reset to 0 by that block for
// the next call) adds the tile's chunk partials: warp w a contiguous group
// of ceil(C / 8) chunks, 32 loads in flight before their adds, then warp 0
// the 8 group sums, and writes out. One launch, no gap. FT stops at 8 so
// that a lane's values and sums fit its registers: at FT = 32 (one segment
// a tile, every row's 32 values held) they spilled, and a block a (chunk,
// segment tile) read each row's values once for every segment tile; at F =
// 130 and S = 64 that took 27 times as long as the earlier two-pass design.
// Now, at R = 131,072 and S = 64: 0.065 ms at F = 64 and 0.226 ms at F =
// 130, against the two-pass design's 0.141 and 0.285 (kernel_ab.py, H100).
//
// Why not one lane a pair walking the rows in row order (the first design):
// every row then costs each warp two shared-memory reads, and the card's
// shared-memory pipe, one warp read a cycle an SM, caps that at ~5 us for
// the main path's rows before any other cost (measured 16-20 us). Here a row
// costs a lane 8 compares, 32 selects and 32 adds in registers.
//
// The summation order (the plain version segment_sum_reference in
// ops/gpu_segment.py follows it step by step, so the two agree bit for bit),
// each sum from +0.0f:
//
//   1. lane l of sub-chunk k of chunk c: rows c*1024 + k*128 + l + 32j,
//      j = 0..3, in j order;
//   2. sub-chunk k: its 32 lane sums by a fixed tree, lane i with lane
//      i + 16 (i < 16), then i with i + 8 (i < 8), then 4, 2 and 1;
//   3. chunk c: its 8 sub-chunk sums in sub-chunk order;
//   4. group w (chunks w*g ... w*g + g - 1, g = ceil(C / 8)): its chunks'
//      sums in chunk order;
//   5. out: the 8 group sums in group order.
//
// Float addition commutes bit for bit, so only this grouping matters, not
// which lane of a pair adds. Missing rows, sub-chunks, chunks and groups add
// +0.0f. A row whose id is not the pair's segment adds +0.0f, which leaves a
// sum that started at +0.0f unchanged bit for bit (such a sum is never
// -0.0f), and a selected zero, not a product, so a non-finite value in
// another segment's row never reaches this one. No atomics touch a sum (the
// only atomic is the ticket), so the result is the same on every run. No
// fast-math flag and --fmad=false (there is no product to contract anyway).
#include <cuda_runtime.h>

#include <cuda/atomic>

namespace {

constexpr int kChunk = 1024;           // rows a block sums into one partial
constexpr int kWarps = 8;              // sub-chunks a chunk, groups a fold
constexpr int kSub = kChunk / kWarps;  // rows a warp sums
constexpr int kRows = kSub / 32;       // rows a lane sums
constexpr int kThreads = kWarps * 32;
constexpr int kFoldBatch = 32;         // L2 reads in flight in the fold

// x[0..n) of every lane -> x[0] of lane p holds the 32 lanes' sum of pair
// p: at offset o (16, 8, 4, 2, 1) lane i keeps the half of its n values
// whose pair bit o matches its own lane bit o and adds its partner's.
template <int N>
__device__ __forceinline__ void butterfly(float* x, int lane) {
  if constexpr (N > 1) {
    constexpr int h = N / 2;
    const bool upper = lane & h;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float keep = upper ? x[i + h] : x[i];
      const float give = upper ? x[i] : x[i + h];
      x[i] = keep + __shfl_xor_sync(0xffffffffu, give, h);
    }
    butterfly<h>(x, lane);
  }
}

// Whether this block is the last of `blocks` to call it on `ticket`. The
// barrier puts every write the block made before the call ahead of thread
// 0's ticket, a release at device scope, which carries them to every block
// that acquires a later ticket; the last block's acquire, and the barrier
// after it, let all its threads read every other block's writes. (A
// __threadfence() by the writers and thread 0 instead measured 1 us slower
// a call.) The last block resets the ticket to 0 for the next launch. Every
// thread of the block must call it.
__device__ __forceinline__ bool last_to_finish(unsigned int* ticket, int blocks, bool* last) {
  __syncthreads();
  if (threadIdx.x == 0) {
    cuda::atomic_ref<unsigned int, cuda::thread_scope_device> t(*ticket);
    *last = t.fetch_add(1u, cuda::memory_order_acq_rel) == (unsigned int)(blocks - 1);
    if (*last) *ticket = 0u;  // every block of the count has taken its ticket
  }
  __syncthreads();
  return *last;
}

template <int FT>
__global__ void __launch_bounds__(kThreads, 4)
segment_sum_chunks_fold(const float* __restrict__ vals,  // (r, f)
                        const int* __restrict__ ids,     // (r,)
                        int r, int f, int s, int chunks, bool vec4,
                        float* __restrict__ partial,      // (tiles, chunks, 32)
                        unsigned int* __restrict__ tickets,  // (tiles,), 0 between calls
                        float* __restrict__ out) {        // (s, f)
  constexpr int ST = 32 / FT;
  __shared__ float fold[kWarps][32];
  __shared__ float group[kWarps][32];
  __shared__ bool last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x;
  const int f0 = blockIdx.y * FT;
  const int ft = min(FT, f - f0);

  // 1a. this lane's rows of the sub-chunk, every load in flight first; they
  // stay in registers for every segment tile
  const long long row0 = (long long)c * kChunk + warp * kSub + lane;
  int id[kRows];
  float v[kRows][FT];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const long long row = row0 + 32 * j;
    const bool live = row < r;
    id[j] = live ? ids[row] : -1;  // -1 is no pair's segment
    const float* src = vals + (size_t)row * f + f0;
    if constexpr (FT % 4 == 0) {
      if (vec4) {  // f % 4 == 0 and an aligned base: f0 and every row 16-byte aligned
        // ft is a multiple of 4 too, so load q holds 4 of the tile's ft
        // columns or none: a tile past F's last column reads no further
#pragma unroll
        for (int q = 0; q < FT / 4; ++q) {
          const float4 t = live && 4 * q < ft ? reinterpret_cast<const float4*>(src)[q]
                                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          v[j][4 * q] = t.x;
          v[j][4 * q + 1] = t.y;
          v[j][4 * q + 2] = t.z;
          v[j][4 * q + 3] = t.w;
        }
        continue;
      }
    }
#pragma unroll
    for (int k = 0; k < FT; ++k) v[j][k] = live && k < ft ? src[k] : 0.0f;
  }

  const int tiles_s = (s + ST - 1) / ST;
  for (int z = 0; z < tiles_s; ++z) {
    const int s0 = z * ST;
    const size_t tile = (size_t)z * gridDim.y + blockIdx.y;
    // 1b. the lane's sums of the tile's pairs. A warp none of whose rows
    // lies in the tile would add only selected zeros: its sums stay +0.0f
    // without them.
    bool mine = false;
#pragma unroll
    for (int j = 0; j < kRows; ++j) mine |= (unsigned int)id[j] - (unsigned int)s0 < (unsigned int)ST;
    float x[32];
#pragma unroll
    for (int p = 0; p < 32; ++p) x[p] = 0.0f;
    if (__any_sync(0xffffffffu, mine)) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
#pragma unroll
        for (int sl = 0; sl < ST; ++sl) {
          const bool hit = id[j] == s0 + sl;
#pragma unroll
          for (int k = 0; k < FT; ++k) x[sl * FT + k] += hit ? v[j][k] : 0.0f;
        }
      }
      // 2. the sub-chunk: the fixed tree over lanes; lane p holds pair p
      butterfly<32>(x, lane);
    }

    // 3. the chunk: its sub-chunk sums in sub-chunk order
    fold[warp][lane] = x[0];
    __syncthreads();
    if (warp == 0) {
      float q = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) q += fold[w][lane];
      partial[(tile * chunks + c) * 32 + lane] = q;
    }
    // (its barriers also keep the next tile's writes to fold behind these reads)
    if (!last_to_finish(tickets + tile, chunks, &last)) continue;

    // 4. group `warp`: its chunks' sums in chunk order, read from L2
    const int g = (chunks + kWarps - 1) / kWarps;  // chunks a group
    const int c0 = warp * g, c1 = min(chunks, c0 + g);
    const float* col = partial + tile * chunks * 32 + lane;
    float grp = 0.0f;
    for (int cc = c0; cc < c1; cc += kFoldBatch) {
      float u[kFoldBatch];
#pragma unroll
      for (int k = 0; k < kFoldBatch; ++k) {
        u[k] = cc + k < c1 ? __ldcg(col + (size_t)(cc + k) * 32) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kFoldBatch; ++k) grp += u[k];
    }
    group[warp][lane] = grp;
    __syncthreads();

    // 5. out: the group sums in group order; lane p is pair p
    if (warp == 0) {
      float o = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) o += group[w][lane];
      const int seg = s0 + lane / FT, fl = lane % FT;
      if (seg < s && fl < ft) out[(size_t)seg * f + f0 + fl] = o;
    }
    // warp 0 reads group before the next tile's barriers; the next fold
    // writes it only after them
  }
}

template <int FT>
cudaError_t launch(const float* vals, const int* ids, int r, int f, int s, float* partial,
                   unsigned int* tickets, float* out, cudaStream_t stream) {
  const int chunks = r > 0 ? (r + kChunk - 1) / kChunk : 1;
  const bool vec4 = f % 4 == 0 && reinterpret_cast<size_t>(vals) % 16 == 0;
  const dim3 grid(chunks, (f + FT - 1) / FT);
  segment_sum_chunks_fold<FT><<<grid, kThreads, 0, stream>>>(vals, ids, r, f, s, chunks, vec4,
                                                              partial, tickets, out);
  return cudaGetLastError();
}

}  // namespace

// vals (r, f) float32 and ids (r,) int32, both contiguous; partial is
// scratch of (tiles, max(1, ceil(r / 1024)), 32) float32 and tickets
// (tiles,) uint32, all 0, which the launch leaves at 0; out (s, f) float32.
// tiles = ceil(f / ft) x ceil(s / (32 / ft)), ft the power of two at or
// above min(f, 8). Needs s >= 1 and f >= 1. Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int segment_sum_launch(const void* vals, const void* ids, int r, int f, int s,
                                  void* partial, void* tickets, void* out, void* stream) {
  const float* v = (const float*)vals;
  const int* i = (const int*)ids;
  float* p = (float*)partial;
  unsigned int* t = (unsigned int*)tickets;
  float* o = (float*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (f <= 1) {
    err = launch<1>(v, i, r, f, s, p, t, o, st);
  } else if (f <= 2) {
    err = launch<2>(v, i, r, f, s, p, t, o, st);
  } else if (f <= 4) {
    err = launch<4>(v, i, r, f, s, p, t, o, st);
  } else {
    err = launch<8>(v, i, r, f, s, p, t, o, st);
  }
  return (int)err;
}
