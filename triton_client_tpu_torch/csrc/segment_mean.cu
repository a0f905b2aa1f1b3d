// Per-slot mean of slot-sorted value rows: slot boundaries found row-parallel,
// no search.
//
// Replaces the TPU kernel triton_client_tpu/ops/pallas_voxel.py::
// sorted_segment_mean_pallas (bodies _segment_mean_grid_kernel and
// _segment_mean_manual_kernel), the reduction of SECOND-IoU's fused
// voxelize->scatter stage (fused_mean_volume). It computes what that kernel
// computes, for every slot s < num_slots:
//
//   out[r, s] = sum_{i: slot[i] = s} v[r, i] / max(sum_{i: slot[i] = s} v[7, i], 1)
//
// so row 7 carries each row's weight and empty slots give 0. The TPU's
// 128-aligned slot windows and one-hot matrix product exist for its VMEM
// tiling and are not carried over. Rows at the dump id num_slots (the
// padding, and the points past the voxel cap: about 91k of the 131,072 rows
// of a 120k-point scan) are never summed; the TPU kernel reduces that slot
// too and its caller slices it off.
//
// What bounds it on an H100: bytes. It must read the 8 values and the slot
// id of each live row (those below the dump id) and write 8 x num_slots
// means. A 120k-point scan has about 41,700 live rows of its 131,072, so
// at 40,000 slots that is 9 x 41,700 x 4 + 8 x 40,000 x 4 bytes, about
// 2.8 MB, 0.83 us at 3.35 TB/s. Its operations (8 adds a live row, 8
// divisions a slot) take far less.
//
// The design, two launches counted as one call:
//
//   segment_mean_zero  writes 0 to all 8 x num_slots outputs, 16 bytes a
//                      store, so every empty slot (the tail past the last
//                      live slot: ~20,150 of 40,000 at a 20k-point scan;
//                      the gaps between live slots) gets its 0 from the
//                      whole card. It costs 8 x num_slots x 4 more bytes
//                      written (1.28 MB at 40,000 slots), about 0.4 us.
//   segment_mean_walk  one thread a row: row i begins slot s = slots[i]
//                      when s is live and i == 0 or slots[i - 1] != s, one
//                      coalesced pass over the ids. That thread walks its
//                      slot's first 32 rows; past them its warp walks the
//                      rest, 32 rows a step (a lane loads a row and stages
//                      it in shared memory, the next step's loads in flight
//                      during this step's adds; lane r adds feature r in
//                      row order). Such slots are real: every point whose
//                      coordinates are all NaN (a lidar's organized cloud
//                      marks each missing return so) falls into cell
//                      (0, 0, 0), one slot, as in the reference. The thread
//                      writes the 8 means. Neighbouring threads begin
//                      neighbouring slots, so a warp reads contiguous spans
//                      of each value row and writes contiguous means.
//
// The walk is launched as a programmatic dependent of the zero launch: its
// blocks start while the zeros are written, find and sum their rows, and
// wait for the zero grid to finish (griddepcontrol.wait) before their first
// store, so no zero write can land after a mean: no race. That hid ~1 us of
// launch gap (measured). No atomics, no search: the result is the same on
// every run, and a slot's rows are found in one step, where the search took
// ~34 dependent L2 reads. A slot of L rows is a chain of min(L, 32) dependent
// loads and then one of (L - 32) / 32 steps: a scan whose points all fall
// into one voxel no longer walks N rows in one thread. Measured with
// kernel_ab.py on an H100 (700 W): 131,072 rows in one slot 1.61 ms, where
// the thread's walk alone took 14.85 ms and the search design 21.6 ms; the
// warp walk costs the main path 0.09 us of its 4.55.
//
// Float rules: each row's sum starts at +0.0f and adds the slot's values in
// row order, as the plain PyTorch version does, so the two agree bit for
// bit. No fast-math flag, so the division is IEEE; max(w, 1) keeps a NaN
// weight, as torch.clamp does.
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;
constexpr int kThreads = 256;
constexpr int kAlone = 32;  // rows a thread adds alone before its warp takes over

__global__ void __launch_bounds__(kThreads)
segment_mean_zero(float4* __restrict__ out4, int n4) {
  // the walk may be scheduled now; it waits for this grid to finish
  // before its first store (griddepcontrol.wait)
  asm volatile("griddepcontrol.launch_dependents;");
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n4; i += stride) {
    out4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

__global__ void __launch_bounds__(kThreads)
segment_mean_walk(const float* __restrict__ vals,  // (8, n)
                  const int* __restrict__ slots,   // (n,) non-decreasing
                  int n, int num_slots,
                  float* __restrict__ out) {       // (8, num_slots), zeros
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int s = i < n ? slots[i] : -1;
  const bool begins = s >= 0 && s < num_slots && (i == 0 || slots[i - 1] != s);
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  // the slot's first kAlone rows, by this thread
  int j = i;
  if (begins) {
    do {
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] += vals[(size_t)r * n + j];
      ++j;
    } while (j < n && j - i < kAlone && slots[j] == s);
  }
  // the rest of a longer slot, by the whole warp, one slot at a time: each
  // step takes the next 32 rows (a lane loads a row and stages its 8
  // values in shared memory), then lane r adds feature r of the slot's rows
  // among them in row order (the slot's rows are a prefix of the 32: the
  // ids do not decrease). The next step's rows are loaded before this
  // step's adds, so that their loads run beside them; a row past the slot
  // is loaded and not added.
  __shared__ float stage[kThreads / 32][32][kRows + 1];  // +1: no bank conflicts
  float (*mine)[kRows + 1] = stage[threadIdx.x >> 5];
  unsigned int longer = __ballot_sync(0xffffffffu, begins && j < n && slots[j] == s);
  while (longer) {
    const int leader = __ffs(longer) - 1;
    longer &= longer - 1;
    const int ls = __shfl_sync(0xffffffffu, s, leader);
    int lj = __shfl_sync(0xffffffffu, j, leader);
    float sum = 0.0f;  // lane r < kRows: feature r of the slot so far
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float t = __shfl_sync(0xffffffffu, acc[r], leader);
      if (lane == r) sum = t;
    }
    int row = lj + lane;
    bool in = row < n && slots[row] == ls;
    float v[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) v[r] = row < n ? vals[(size_t)r * n + row] : 0.0f;
    int rows = __popc(__ballot_sync(0xffffffffu, in));
    for (;;) {
      const bool more = rows == 32 && lj + 32 < n;  // the same in every lane
      const int next = row + 32;
      bool next_in = false;
      float nv[kRows];
      if (more) {
        next_in = next < n && slots[next] == ls;
#pragma unroll
        for (int r = 0; r < kRows; ++r) nv[r] = next < n ? vals[(size_t)r * n + next] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) mine[lane][r] = v[r];
      __syncwarp();
      if (lane < kRows) {
        if (rows == 32) {
#pragma unroll
          for (int k = 0; k < 32; ++k) sum += mine[k][lane];
        } else {
          for (int k = 0; k < rows; ++k) sum += mine[k][lane];
        }
      }
      __syncwarp();  // every add has read the stage before the next step writes it
      lj += rows;
      if (!more) break;
      row = next;
#pragma unroll
      for (int r = 0; r < kRows; ++r) v[r] = nv[r];
      rows = __popc(__ballot_sync(0xffffffffu, next_in));
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float t = __shfl_sync(0xffffffffu, sum, r);
      if (lane == leader) acc[r] = t;
    }
  }
  if (!begins) return;
  const float w = acc[kRows - 1] < 1.0f ? 1.0f : acc[kRows - 1];
  float mean[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) mean[r] = acc[r] / w;
  // the zero grid has finished and its stores are visible: no zero write
  // can land after a mean
  asm volatile("griddepcontrol.wait;" ::: "memory");
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[(size_t)r * num_slots + s] = mean[r];
}

}  // namespace

// vals (8, n) float32 and slots (n,) int32, contiguous; out (8, num_slots)
// float32, 16-byte aligned. Needs 1 <= num_slots < 2^30. Returns
// cudaGetLastError() after the two launches (0 = launched).
extern "C" int segment_mean_launch(const void* vals, const void* slots, int n, int num_slots,
                                   void* out, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int n4 = kRows / 4 * num_slots;  // 8 x num_slots floats, 4 a store
  const int zero_blocks = (n4 + kThreads - 1) / kThreads;
  segment_mean_zero<<<zero_blocks < 1024 ? zero_blocks : 1024, kThreads, 0, st>>>(
      (float4*)out, n4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n == 0) return (int)err;
  // programmatic dependent launch: the walk's blocks start while the zero
  // grid runs and read and sum their rows; each waits for that grid before
  // it writes
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + kThreads - 1) / kThreads);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, segment_mean_walk, (const float*)vals, (const int*)slots, n,
                           num_slots, (float*)out);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
