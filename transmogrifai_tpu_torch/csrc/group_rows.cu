// Live rows grouped by slot, once per tree level, for Hopper (sm_90a).
//
// The port's own helper: no TPU kernel corresponds to it. The grouped
// histogram kernels (grouped_hist.cuh) read the rows of one slot at a
// time, so they need the live row ids sorted by slot.
//
//   order   [n + 15 A] int32: for each slot s in turn, the ids i with
//           node[i] = s in increasing order (a stable sort), then padding
//           up to a multiple of KSTEP = 16 (the MMA K-step, so no K-step
//           straddles two slots); past the last slot, padding to the end.
//           The padding id is n, which the histogram kernels read as a
//           zero row. Idle rows (node outside [0, A)) are left out.
//   seg_off [A + 1] int32: slot s occupies order[seg_off[s] .. seg_off[s+1]).
//
// Method: a stable counting sort in three kernels on the caller's stream.
//   1. count: per tile of 1,024 rows, the rows of each slot (shared-memory
//      integer atomics: the same value in any order).
//   2. scan: one block turns the (slot, tile) counts into padded segment
//      offsets and, slot-major, each tile's first position in its slot.
//   3. scatter: each warp of a tile owns 128 consecutive rows; the rows of
//      one slot in a warp-wide step find each other with __match_any_sync,
//      rank themselves by popc of the lower lanes, and take positions after
//      the tile's earlier warps and steps. The tail past seg_off[A] and
//      each slot's padding are filled with n.
// Positions depend only on the node vector, so the output is exact and
// the same on every run.
//
// What bounds it: bytes. It reads node twice and writes one int a row;
// the counts are A x (n / 1024) ints. Each warp loads all its slots
// before it uses the first, so a block waits for device memory once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KSTEP = 16;
constexpr int TILE = 1024;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WARP_ROWS = TILE / WARPS;      // 128 consecutive rows a warp
constexpr int STEPS = WARP_ROWS / 32;        // warp-wide steps over them
constexpr int MAX_A = 1024;
constexpr int SCAN_THREADS = 1024;

__device__ __forceinline__ int slot_of(const int* node, int r, int n, int A) {
  if (r >= n) return -1;
  const int s = node[r];
  return (s >= 0 && s < A) ? s : -1;
}

__global__ void __launch_bounds__(THREADS)
group_count_kernel(const int* __restrict__ node, int* __restrict__ counts,
                   int n, int A, int n_tiles) {
  __shared__ int cnt[MAX_A];
  for (int s = threadIdx.x; s < A; s += THREADS) cnt[s] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * TILE + warp * WARP_ROWS;
  int sv[STEPS];             // all loads in flight before the first use
#pragma unroll
  for (int k = 0; k < STEPS; ++k)
    sv[k] = slot_of(node, r0 + 32 * k + lane, n, A);
#pragma unroll
  for (int k = 0; k < STEPS; ++k) {
    const int s = sv[k];
    const unsigned peers = __match_any_sync(0xffffffffu, s);
    if (s >= 0 && lane == __ffs(peers) - 1) atomicAdd(&cnt[s], __popc(peers));
  }
  __syncthreads();
  for (int s = threadIdx.x; s < A; s += THREADS)
    counts[(size_t)s * n_tiles + blockIdx.x] = cnt[s];
}

// One block: counts [A, n_tiles] become each tile's first position in its
// slot (in place); seg_off gets the padded segment offsets; each slot's
// padding gets the id n.
__global__ void __launch_bounds__(SCAN_THREADS)
group_scan_kernel(int* __restrict__ counts, int* __restrict__ seg_off,
                  int* __restrict__ order, int n, int A, int n_tiles) {
  __shared__ int tot[MAX_A];
  __shared__ int off[MAX_A + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = SCAN_THREADS / 32;
  for (int s = warp; s < A; s += nwarps) {
    int v = 0;
    for (int t = lane; t < n_tiles; t += 32)
      v += counts[(size_t)s * n_tiles + t];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
    if (lane == 0) tot[s] = v;
  }
  __syncthreads();
  if (warp == 0) {
    int carry = 0;
    for (int s0 = 0; s0 < A; s0 += 32) {
      const int s = s0 + lane;
      const int v = s < A ? (tot[s] + KSTEP - 1) / KSTEP * KSTEP : 0;
      int incl = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += u;
      }
      if (s < A) off[s] = carry + incl - v;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) off[A] = carry;
  }
  __syncthreads();
  for (int s = threadIdx.x; s <= A; s += SCAN_THREADS) seg_off[s] = off[s];
  for (int s = warp; s < A; s += nwarps) {
    int run = off[s];
    for (int t0 = 0; t0 < n_tiles; t0 += 32) {
      const int t = t0 + lane;
      const size_t idx = (size_t)s * n_tiles + t;
      const int v = t < n_tiles ? counts[idx] : 0;
      int incl = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += u;
      }
      if (t < n_tiles) counts[idx] = run + incl - v;
      run += __shfl_sync(0xffffffffu, incl, 31);
    }
    for (int p = off[s] + tot[s] + lane; p < off[s + 1]; p += 32) order[p] = n;
  }
}

__global__ void __launch_bounds__(THREADS)
group_scatter_kernel(const int* __restrict__ node,
                     const int* __restrict__ base,
                     const int* __restrict__ seg_off,
                     int* __restrict__ order, int n, int A, int n_tiles,
                     int cap) {
  __shared__ int wpos[WARPS][MAX_A];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  for (int s = threadIdx.x; s < A; s += THREADS)
#pragma unroll
    for (int w = 0; w < WARPS; ++w) wpos[w][s] = 0;
  __syncthreads();
  const int r0 = blockIdx.x * TILE + warp * WARP_ROWS;
  int sv[STEPS];
#pragma unroll
  for (int k = 0; k < STEPS; ++k)
    sv[k] = slot_of(node, r0 + 32 * k + lane, n, A);
  // this warp's rows of each slot
#pragma unroll
  for (int k = 0; k < STEPS; ++k) {
    const int s = sv[k];
    const unsigned peers = __match_any_sync(0xffffffffu, s);
    if (s >= 0 && lane == __ffs(peers) - 1) wpos[warp][s] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // each warp's first position in each slot: the tile's base, then the
  // tile's earlier warps
  for (int s = threadIdx.x; s < A; s += THREADS) {
    int run = base[(size_t)s * n_tiles + blockIdx.x];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = wpos[w][s];
      wpos[w][s] = run;
      run += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < STEPS; ++k) {
    const int r = r0 + 32 * k + lane;
    const int s = sv[k];
    const unsigned peers = __match_any_sync(0xffffffffu, s);
    int first = 0;
    if (s >= 0) {
      first = wpos[warp][s];
      order[first + __popc(peers & lower)] = r;
    }
    __syncwarp();
    if (s >= 0 && lane == __ffs(peers) - 1)
      wpos[warp][s] = first + __popc(peers);
    __syncwarp();
  }
  // the tail past the last segment
  for (int p = seg_off[A] + blockIdx.x * THREADS + threadIdx.x; p < cap;
       p += n_tiles * THREADS)
    order[p] = n;
}

}  // namespace

// node [n] int32 -> order [n + 15 A] int32, seg_off [A + 1] int32; counts
// is [A, ceil(n / 1024)] int32 scratch.
extern "C" int group_rows_launch(const void* node, void* counts, void* order,
                                 void* seg_off, int n, int A, void* stream) {
  if (n < 1 || A < 1 || A > MAX_A) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = (n + TILE - 1) / TILE;
  const int cap = n + (KSTEP - 1) * A;
  group_count_kernel<<<n_tiles, THREADS, 0, st>>>(
      (const int*)node, (int*)counts, n, A, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  group_scan_kernel<<<1, SCAN_THREADS, 0, st>>>(
      (int*)counts, (int*)seg_off, (int*)order, n, A, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  group_scatter_kernel<<<n_tiles, THREADS, 0, st>>>(
      (const int*)node, (const int*)counts, (const int*)seg_off, (int*)order,
      n, A, n_tiles, cap);
  return (int)cudaGetLastError();
}
