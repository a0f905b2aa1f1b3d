// Suppression bitmask and one-warp scan, shared by the decode+NMS kernel
// (decode_nms_2d.cu, kernel 1), greedy NMS (greedy_nms.cu, kernel 2) and
// the 3D suppress+pack kernel (suppress_pack_3d.cu, kernel 4).
//
// The greedy loop -- take the live candidate of highest score, ties to the
// lowest index; kill it and every live candidate whose IoU with it exceeds
// the threshold; repeat -- keeps exactly the candidates found by visiting
// the live ones in (score descending, index ascending) order and keeping
// each that no earlier kept one suppresses, up to max_det. The loop's
// argmax ranks a NaN above every number and takes a NaN pick as invalid,
// so with a live NaN it keeps nothing.
//
// Each kernel runs three passes over a workspace in device memory:
//   order  one block per image: the visiting order (the input's own when
//          its live scores are already in order, else a bitonic sort of
//          (score, index) keys in shared memory), the live count (0 with a
//          live NaN) and which of the two orders it took;
//   mask   blocks across the card: word w of row p (rows row_stride(k)
//          words apart) holds bit q - 32 w set when the candidate at
//          position p suppresses the one at position q, by the loop's own
//          test taken from p's side. The scan reads only rows p < live
//          count and words w >= p / 32, so the mask pass computes nothing
//          else;
//   scan   one block per image: the mask rows staged in shared memory 256
//          positions at a time, and one warp walks the order 32 positions
//          (one removed word) a step, with the removed set in registers
//          (lane l holds word 32 g + l in group g of 1024 positions), and
//          writes the kept positions to shared memory; then the whole
//          block writes the packed rows.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <atomic>
#include <cstdint>

namespace maskscan {

constexpr int kOrderThreads = 512;
constexpr int kScanThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// 32-bit words of a row of the mask over k candidates.
__host__ __device__ inline int words(int k) { return (k + 31) / 32; }

// Words between the starts of two mask rows: words(k) rounded up to four,
// so every row starts on 16 bytes (the scan stages rows 16 bytes a copy).
__host__ __device__ inline int row_stride(int k) { return (words(k) + 3) / 4 * 4; }

// Slots of the bitonic sort: the power of two at or above k.
__host__ __device__ inline int sort_slots(int k) {
  int n = 1;
  while (n < k) n <<= 1;
  return n;
}

// Whether score a comes strictly before score b in the visiting order.
__device__ __forceinline__ bool ranks_above(float a, float b) {
  if (isnan(a) || isnan(b)) return isnan(a) && !isnan(b);
  return a > b;
}

// A key whose ascending order is (score descending, index ascending) over
// scores without NaN. "+ 0.0f" makes -0.0 and +0.0 one key, as the
// loop's comparisons take them.
__device__ __forceinline__ unsigned long long sort_key(float s, int j) {
  uint32_t u = __float_as_uint(s + 0.0f);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // ascending by value
  return ((unsigned long long)~u << 32) | (uint32_t)j;
}

struct Order {
  int live;     // candidates the scan visits; 0 with a live NaN
  bool sorted;  // false: position p holds candidate (int)keys[p]
};

// The visiting order of live[0, k) (shared memory; -inf = dead), by the
// whole block. keys holds sort_slots(k) slots of shared memory; when the
// result is not `sorted`, the candidate at position p is the low word of
// keys[p]. Block-uniform result; ends with a barrier.
__device__ Order live_order(const float* live, int k, unsigned long long* keys) {
  __shared__ int count;
  if (threadIdx.x == 0) count = 0;
  __syncthreads();  // also publishes the caller's live[]
  int n = 0, nan = 0, out_of_order = 0;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const float v = live[j];
    n += v > -CUDART_INF_F;
    nan |= isnan(v);
    out_of_order |= j + 1 < k && ranks_above(live[j + 1], v);
  }
  atomicAdd(&count, n);
  const bool any_nan = __syncthreads_or(nan);
  const bool in_order = !__syncthreads_or(out_of_order);
  const Order o{any_nan ? 0 : count, in_order || any_nan};
  if (o.sorted) return o;

  const int slots = sort_slots(k);
  for (int j = threadIdx.x; j < slots; j += blockDim.x)
    keys[j] = j < k ? sort_key(live[j], j) : ~0ull;
  __syncthreads();
  for (int size = 2; size <= slots; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < slots; i += blockDim.x) {
        const int partner = i ^ stride;
        if (partner > i) {
          const unsigned long long a = keys[i], b = keys[partner];
          if ((a > b) == ((i & size) == 0)) {
            keys[i] = b;
            keys[partner] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  return o;
}

__device__ __forceinline__ int candidate_at(const Order& o, const unsigned long long* keys, int p) {
  return o.sorted ? p : (int)(uint32_t)keys[p];
}

// The scan's positions in one group: the removed words warp 0 holds at
// once (lane l holds word 32 g + l in group g).
constexpr int kGroup = 1024;
// Rows staged in shared memory at a time (eight chunks), two buffers.
constexpr int kSub = 256;

// 32-bit words of the scan block's shared memory: two buffers of staged
// rows (32 words each: one group's), one buffer's chunks' diagonal blocks
// transposed, the kept list.
__host__ __device__ inline int scan_smem_words(int k, int max_det) {
  const int rows = k < kSub ? k : kSub;
  return rows * (2 * 32 + 1) + (max_det < k ? max_det : k);
}

// Asynchronous 16-byte copy from device to shared memory (cp.async): the
// thread goes on issuing without waiting for the load.
__device__ __forceinline__ void copy_async(uint32_t* dst, const uint32_t* src) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Starts the copies of rows [s0, s0 + rows) of the mask into buf (rows x
// 32 words): the words of their group, from each row's diagonal word on,
// four at a time.
__device__ __forceinline__ void stage_rows(uint32_t* buf, const uint32_t* __restrict__ mask,
                                           int stride, int n_words, int s0, int rows) {
  const int w0 = s0 / kGroup * 32;
  for (int e = threadIdx.x; e < rows * 8; e += blockDim.x) {
    const int r = e >> 3, v = 4 * (e & 7);
    if (v + 3 >= (s0 + r) / 32 - w0 && w0 + v < n_words)
      copy_async(buf + r * 32 + v, mask + (size_t)(s0 + r) * stride + w0 + v);
  }
  copy_async_commit();
}

struct Kept {
  int* pos;  // kept[0, n): the kept positions, in shared memory
  int n;
};

// The scan, by the whole block over one image's mask rows (k rows,
// row_stride(k) words apart; smem holds scan_smem_words(k, max_det)
// words). Visits positions [0, live) and keeps each that no earlier kept
// one suppresses, up to max_det. Block-uniform result.
//
// 256 positions at a time: all threads stage their rows in shared memory
// (cp.async, every copy in flight at once; the next 256 rows load while
// these are walked) and transpose each chunk's 32 x 32 diagonal block, so
// lane t of chunk c holds the positions of the chunk that would suppress
// 32 c + t. Then warp 0 walks the chunks: a chunk's open positions are
// those its removed word leaves, and its kept set is the fixpoint of
// "open and not suppressed by a kept one before it" (one ballot an
// iteration, as many iterations as the longest chain of suppressions in
// the chunk, plus one), which the greedy order reaches. The kept rows'
// words are ORed into the removed set, a word a lane. At each new group
// of 1024 positions the lanes rebuild their words from the kept list.
__device__ Kept scan(const uint32_t* __restrict__ mask, int k, int live, int max_det,
                     uint32_t* smem) {
  __shared__ int kept_n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int n_words = words(k), stride = row_stride(k), sub_rows = min(k, kSub);
  uint32_t* cols = smem + 2 * sub_rows * 32;  // after the two row buffers
  int* kept = reinterpret_cast<int*>(cols + sub_rows);
  int n = 0;
  uint32_t removed = 0;
  if (live > 0) stage_rows(smem, mask, stride, n_words, 0, min(kSub, live));
  for (int s0 = 0; s0 < live && n < max_det; s0 += kSub) {
    const int rows = min(kSub, live - s0), chunks = words(rows), w0 = s0 / kGroup * 32;
    const int buf = (s0 / kSub) & 1;
    const uint32_t* stage = smem + buf * sub_rows * 32;
    if (s0 + kSub < live) {
      stage_rows(smem + (buf ^ 1) * sub_rows * 32, mask, stride, n_words, s0 + kSub,
                 min(kSub, live - s0 - kSub));
      copy_async_wait<1>();
    } else {
      copy_async_wait<0>();
    }
    __syncthreads();
    for (int c = warp; c < chunks; c += warps) {
      const int span = min(32, rows - 32 * c), diag = (s0 / 32 + c) % 32;
      uint32_t col = 0;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if (j < span) col |= (stage[(32 * c + j) * 32 + diag] >> lane & 1u) << j;
      cols[32 * c + lane] = col;
    }
    __syncthreads();
    if (warp == 0) {
      if (s0 > 0 && s0 % kGroup == 0) {
        removed = 0;
        if (w0 + lane < n_words) {
          for (int s = 0; s < n; s += 8) {
            uint32_t v[8];
#pragma unroll
            for (int u = 0; u < 8; ++u)
              v[u] = s + u < n ? __ldg(mask + (size_t)kept[s + u] * stride + w0 + lane) : 0u;
#pragma unroll
            for (int u = 0; u < 8; ++u) removed |= v[u];
          }
        }
      }
      const uint32_t below = (1u << lane) - 1u;
      for (int c = 0; c < chunks && n < max_det; ++c) {
        const int span = min(32, rows - 32 * c);
        const uint32_t open = ~__shfl_sync(kFull, removed, (s0 / 32 + c) % 32) &
                              (span == 32 ? kFull : (1u << span) - 1u);
        const uint32_t col = cols[32 * c + lane] & below;
        const bool mine = open >> lane & 1u;
        uint32_t took = open;
        for (;;) {
          const uint32_t next = __ballot_sync(kFull, mine && !(col & took));
          if (next == took) break;
          took = next;
        }
        for (int extra = __popc(took) - (max_det - n); extra > 0; --extra)
          took &= ~(0x80000000u >> __clz(took));  // past max_det: drop the last kept
        if (took >> lane & 1u) kept[n + __popc(took & below)] = s0 + 32 * c + lane;
        n += __popc(took);
#pragma unroll
        for (int t = 0; t < 32; ++t)
          if (took >> t & 1u) removed |= stage[(32 * c + t) * 32 + lane];
      }
      if (lane == 0) kept_n = n;
    }
    __syncthreads();
    n = kept_n;
  }
  copy_async_wait<0>();  // the next rows' copies, when max_det ended the walk
  return {kept, n};
}

constexpr int kDevices = 64;

// Host side: raises a kernel's dynamic shared memory limit on the current
// device past the default 48 KB when a launch needs more than any before
// it there (set holds the limit set so far on each device; a race only
// repeats the call). Returns the CUDA error, 0 when none.
inline int set_smem(const void* kernel, std::atomic<int> (&set)[kDevices], int bytes) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kDevices && bytes <= set[dev].load()) return 0;
  const int err =
      (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == 0 && dev < kDevices) set[dev].store(bytes);
  return err;
}

}  // namespace maskscan
