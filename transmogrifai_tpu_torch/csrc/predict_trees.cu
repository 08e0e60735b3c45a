// Routed ensemble prediction, for Hopper (sm_90a).
//
// Replaces the Pallas kernel transmogrifai_tpu/models/_pallas_hist.py:
// predict_trees (_predict_kernel :674, pl.pallas_call :766).
//
// Sends each row of X [n, F] down T complete level-order trees of depth D
// (feature feat[t, node], threshold thr[t, node]; right iff x > thr) and
// sums the pre-weighted leaves leaf[t, node, :K] in tree order, so the sums
// are bitwise the plain version's (models/_hist.py predict_trees_reference).
//
// Design: a persistent grid of one or two blocks an SM (from the device's
// SM count and the occupancy the shared memory allows) that loops over
// tiles of THREADS rows, one row a thread.
// - Each block stages the ensemble in shared memory once: the node
//   features as uint16 and the thresholds as f32 in two arrays (a level's
//   nodes up to 64 features and 32 thresholds wide lie in distinct banks),
//   the leaves beside them. An ensemble past the budget is taken in chunks
//   of trees outside the row loop; a row's partial sum goes to `out` and
//   is read back by the same thread for the next chunk.
// - Where a tile of rows fits (F <= MAX_STAGE_F), the tile, one contiguous
//   span of X, is copied into shared memory with 16-byte cp.async, then
//   transposed to [F, THREADS]: thread r reads feature f at bank r mod 32,
//   whatever feature each thread's path asks for. The node entries hold
//   f * THREADS, the offset of feature f in the transposed tile. The copy
//   of the next tile is in flight while this one descends.
// - At wide F (the text path scores a [n, 451] matrix) the rows stay in
//   device memory and the descent reads x[feat] through the read-only path.
// - A thread descends ILP trees together, with no branch between them and
//   in phases (every chain's node loads, then every x load, then every
//   compare), so the in-order warp has ILP independent loads in flight;
//   their leaves are added in tree order.
//
// What bounds it: bytes in principle (the rows, n * F floats, are the only
// large input). At F = 20 the descent's shared-memory loads (T * D node
// and x loads a row, random past the first levels) set its time, above
// the bytes; at F = 451 its scattered reads of x.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_K = 8;
constexpr int ILP = 4;                // trees a thread descends together
constexpr int MAX_BLOCKS_PER_SM = 2;
constexpr int MAX_STAGE_F = 64;       // widest row staged in shared memory
constexpr int SMEM_MAX = 232448;      // dynamic shared memory a block may use
constexpr int STAGE_BATCH = 8;        // tree-feature loads in flight a thread

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// Rows [tile * THREADS, ...) of X, one contiguous span, into buf (dense,
// row stride F): 16-byte copies where X is 16-byte aligned (a tile starts
// at a multiple of THREADS * F floats, so only the span's tail is ragged).
__device__ __forceinline__ void copy_tile(const float* __restrict__ X,
                                          float* buf, int tile, int n, int F,
                                          bool aligned) {
  const int r0 = tile * THREADS;
  const int count = min(THREADS, n - r0) * F;
  const float* src = X + (size_t)r0 * F;
  int done = 0;
  if (aligned) {
    done = count & ~3;
    for (int e = threadIdx.x * 4; e < done; e += THREADS * 4)
      cp_async16(buf + e, src + e);
  }
  for (int e = done + threadIdx.x; e < count; e += THREADS)
    cp_async4(buf + e, src + e);
  cp_async_commit();
}

// Byte offsets in shared memory of `trees` trees' uint16 features, f32
// thresholds and f32 leaves, and, staged, of the row tile (dense [THREADS,
// F]) and its transpose ([F, THREADS]); each part 16-byte aligned.
struct Layout {
  size_t thr, leaf, stage, xt, total;
};

__host__ __device__ __forceinline__ size_t round16(size_t b) {
  return (b + 15) / 16 * 16;
}

__host__ __device__ __forceinline__ Layout layout(int trees, int D, int K,
                                                  int F, bool staged) {
  const size_t NN = ((size_t)1 << D) - 1, L = (size_t)1 << D;
  const size_t tile = staged ? sizeof(float) * THREADS * F : 0;
  Layout o;
  o.thr = round16(sizeof(uint16_t) * trees * NN);
  o.leaf = o.thr + round16(sizeof(float) * trees * NN);
  o.stage = o.leaf + round16(sizeof(float) * trees * L * K);
  o.xt = o.stage + tile;
  o.total = o.xt + tile;
  return o;
}

template <bool STAGED>
__global__ void __launch_bounds__(THREADS)
predict_trees_kernel(const float* __restrict__ X, const int* __restrict__ feat,
                     const float* __restrict__ thr,
                     const float* __restrict__ leaf, float* __restrict__ out,
                     int n, int F, int T, int D, int K, int chunk,
                     bool aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int NN = (1 << D) - 1, L = 1 << D;
  const Layout o = layout(chunk, D, K, F, STAGED);
  uint16_t* feat_s = reinterpret_cast<uint16_t*>(smem);  // [chunk, NN]
  float* thr_s = reinterpret_cast<float*>(smem + o.thr);  // [chunk, NN]
  float* leaf_s = reinterpret_cast<float*>(smem + o.leaf);  // [chunk, L, K]
  float* stage_s = reinterpret_cast<float*>(smem + o.stage);  // [THREADS, F]
  float* xt_s = reinterpret_cast<float*>(smem + o.xt);  // [F, THREADS]
  const int n_tiles = (n + THREADS - 1) / THREADS;
  for (int t0 = 0; t0 < T; t0 += chunk) {
    const int tc = min(chunk, T - t0);
    __syncthreads();                   // the last chunk's readers are done
    // thresholds and leaves by cp.async; the features through registers
    // (uint16), STAGE_BATCH loads in flight a thread
    for (int e = threadIdx.x; e < tc * NN; e += THREADS)
      cp_async4(thr_s + e, thr + (size_t)t0 * NN + e);
    for (int e = threadIdx.x; e < tc * L * K; e += THREADS)
      cp_async4(leaf_s + e, leaf + (size_t)t0 * L * K + e);
    cp_async_commit();
    for (int e0 = threadIdx.x; e0 < tc * NN; e0 += THREADS * STAGE_BATCH) {
      int v[STAGE_BATCH];
#pragma unroll
      for (int u = 0; u < STAGE_BATCH; ++u) {
        const int e = e0 + u * THREADS;
        v[u] = e < tc * NN ? __ldg(feat + (size_t)t0 * NN + e) : 0;
      }
#pragma unroll
      for (int u = 0; u < STAGE_BATCH; ++u) {
        const int e = e0 + u * THREADS;
        if (e < tc * NN) feat_s[e] = (uint16_t)(STAGED ? v[u] * THREADS : v[u]);
      }
    }
    int tile = blockIdx.x;
    if (STAGED) copy_tile(X, stage_s, tile, n, F, aligned);
    for (; tile < n_tiles; tile += gridDim.x) {
      const int i = tile * THREADS + threadIdx.x;
      if (STAGED) {
        cp_async_wait_all();
        __syncthreads();   // the tile is staged; the last descent is done
        if (i < n) {
          // at even F, lane l starts at feature l mod F, so a warp's
          // reads of the dense tile spread over the banks
          int f = (F & 1) ? 0 : (threadIdx.x & 31) % F;
          for (int k = 0; k < F; ++k) {
            xt_s[f * THREADS + threadIdx.x] = stage_s[threadIdx.x * F + f];
            f = f + 1 == F ? 0 : f + 1;
          }
        }
        __syncthreads();   // transposed; the staging buffer is free
        const int next = tile + gridDim.x;
        if (next < n_tiles) copy_tile(X, stage_s, next, n, F, aligned);
      } else {
        cp_async_wait_all();
        __syncthreads();   // the trees are staged
      }
      if (i >= n) continue;
      // x[f] of this row; staged, the feature entries hold f * THREADS
      const float* x = STAGED ? xt_s + threadIdx.x : X + (size_t)i * F;
      float acc[MAX_K];
#pragma unroll
      for (int k = 0; k < MAX_K; ++k)
        acc[k] = (k < K && t0 > 0) ? out[(size_t)i * K + k] : 0.0f;
      for (int tt = 0; tt < tc; tt += ILP) {
        // ILP trees at once, with no branch between them, so the warp
        // interleaves their chains; a group past the last tree repeats
        // it and adds no leaf. pos walks the level-order positions: the
        // children of pos are 2 pos + 1 and 2 pos + 2.
        const uint16_t* fj[ILP];
        const float* tj[ILP];
        int pos[ILP];
#pragma unroll
        for (int j = 0; j < ILP; ++j) {
          const int t = min(tt + j, tc - 1);
          fj[j] = feat_s + (size_t)t * NN;
          tj[j] = thr_s + (size_t)t * NN;
          pos[j] = 0;
        }
        for (int d = 0; d < D; ++d) {
          // in phases, so every chain's loads are in flight together
          int f[ILP];
          float t[ILP], v[ILP];
#pragma unroll
          for (int j = 0; j < ILP; ++j) {
            f[j] = fj[j][pos[j]];
            t[j] = tj[j][pos[j]];
          }
#pragma unroll
          for (int j = 0; j < ILP; ++j)
            v[j] = STAGED ? x[f[j]] : __ldg(x + f[j]);
#pragma unroll
          for (int j = 0; j < ILP; ++j)
            pos[j] = 2 * pos[j] + (v[j] > t[j] ? 2 : 1);
        }
#pragma unroll
        for (int j = 0; j < ILP; ++j) {
          if (tt + j < tc) {
            const float* lv =
                leaf_s + ((size_t)(tt + j) * L + pos[j] - NN) * K;
#pragma unroll
            for (int k = 0; k < MAX_K; ++k)
              if (k < K) acc[k] = acc[k] + lv[k];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < MAX_K; ++k)
        if (k < K) out[(size_t)i * K + k] = acc[k];
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

template <bool STAGED>
int launch(const float* X, const int* feat, const float* thr,
           const float* leaf, float* out, int n, int F, int T, int D, int K,
           int chunk, bool aligned, size_t smem, cudaStream_t stream) {
  auto kernel = predict_trees_kernel<STAGED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if (per_sm > MAX_BLOCKS_PER_SM) per_sm = MAX_BLOCKS_PER_SM;
  const int n_tiles = (n + THREADS - 1) / THREADS;
  const int cap = per_sm * sm_count();
  const int grid = n_tiles < cap ? n_tiles : cap;
  kernel<<<grid, THREADS, smem, stream>>>(X, feat, thr, leaf, out, n, F, T,
                                          D, K, chunk, aligned);
  return (int)cudaGetLastError();
}

bool stages(int F, int D, int K) {
  return F <= MAX_STAGE_F && layout(1, D, K, F, true).total <= SMEM_MAX;
}

}  // namespace

// Trees a chunk holds at this shape (0: one tree does not fit); the
// launch below takes the ensemble in chunks of this many trees.
extern "C" int predict_trees_chunk(int F, int D, int K) {
  const bool staged = stages(F, D, K);
  int chunk = 0;
  while (layout(chunk + 1, D, K, F, staged).total <= SMEM_MAX) ++chunk;
  return chunk;
}

// X [n, F], feat [T, 2^D - 1] int32, thr [T, 2^D - 1], leaf [T, 2^D, K]
// f32; out [n, K]. Returns a cudaError_t.
extern "C" int predict_trees_launch(const void* X, const void* feat,
                                    const void* thr, const void* leaf,
                                    void* out, int n, int F, int T, int D,
                                    int K, void* stream) {
  if (K < 1 || K > MAX_K || D < 1 || D > 16 || F < 1 || F > 65535)
    return (int)cudaErrorInvalidValue;
  if (n <= 0 || T <= 0) return 0;
  const bool staged = stages(F, D, K);
  int chunk = predict_trees_chunk(F, D, K);
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  if (chunk > T) chunk = T;
  const size_t smem = layout(chunk, D, K, F, staged).total;
  const bool aligned = ((uintptr_t)X & 15) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float* x = (const float*)X;
  if (staged)
    return launch<true>(x, (const int*)feat, (const float*)thr,
                        (const float*)leaf, (float*)out, n, F, T, D, K, chunk,
                        aligned, smem, st);
  return launch<false>(x, (const int*)feat, (const float*)thr,
                       (const float*)leaf, (float*)out, n, F, T, D, K, chunk,
                       aligned, smem, st);
}
