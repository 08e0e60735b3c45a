// Level histogram of the tree engine, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of transmogrifai_tpu/models/_pallas_hist.py:
// cumhist (_kernel :160, _kernel_prebc :193; pl.pallas_call :347 and :368).
//
//   cum[s, c, t, f] = sum_i 1[node_i = s] * 1[bin_fi <= t] * bf16(stats_ic)
//
// cumhist_launch (the fits' call): the slot-grouped product of
// grouped_hist.cuh with M = B*F output rows (m = t*F + f), N = C channels
// padded to 8 and each slot's live rows as K. The "bin <= t" indicator is
// built per K-step from the gathered uint8 bins in shared memory, so each
// live row's bins are read once per call; the lower-triangular indicator
// makes the sums cumulative over bins.
//
// cumhist_bc_launch (bc=, the precomputed uint8 [B*F, n] indicator; no
// fit passes it): the first design, kept as it was. One matrix product
// NS^T @ Bc with M = A*C rows (m = s*C + c), N = B*F columns and all n
// rows as K: per 32 rows a block of 256 threads writes its [128 x 32]
// one-hot*stats tile and [32 x 128] indicator tile into shared memory and
// multiplies them with WMMA bf16 16x16x16 (f32 accumulate); the row axis
// is split over gridDim.z and a second kernel sums the splits in order.
// It multiplies the one-hot's zeros and streams idle rows.
//
// Determinism (both): fixed summation orders, no float atomics, so the
// weighted channels are bitwise reproducible run to run and split ties
// never flip. Counts are sums of exact 1.0 products in f32.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "grouped_hist.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int MAX_C = 8;
constexpr int LDA = BM + 8;   // As is k-major: (m, k) at As[k * LDA + m]
constexpr int LDB = BK + 8;   // Bs is n-major: (k, n) at Bs[n * LDB + k]
constexpr uint32_t BF16_ONE = 0x3F80u;
constexpr int NO_SLOT = -(1 << 30);

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack2(bool lo, bool hi) {
  return (lo ? BF16_ONE : 0u) | ((hi ? BF16_ONE : 0u) << 16);
}

__global__ void __launch_bounds__(THREADS)
cumhist_bc_partial_kernel(const float* __restrict__ stats,
                          const int* __restrict__ node,
                          const uint8_t* __restrict__ bc,
                          float* __restrict__ partial,
                          int n, int C, int A, int N,
                          int rows_per_split, int M_pad, int N_pad) {
  __shared__ __align__(128) __nv_bfloat16 As[BK * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[BN * LDB];
  __shared__ int lo_s[BK];                   // row's first tile row m
  __shared__ uint32_t st_s[BK * MAX_C];      // row's stats as bf16 bits

  const int m0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BN;
  const int r_begin = blockIdx.z * rows_per_split;
  const int r_end = min(n, r_begin + rows_per_split);
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 4) * 64;            // 2 warps along M
  const int wn = (warp % 4) * 32;            // 4 warps along N

  // this thread's column of the B tile and its 16-row half
  const int bn = threadIdx.x >> 1;
  const int bh = (threadIdx.x & 1) * 16;
  const int j = j0 + bn;
  const bool col_ok = j < N;
  const uint8_t* __restrict__ brow = bc + (size_t)(col_ok ? j : 0) * n;
  const bool vec_ok = (n % 16) == 0;         // 16-byte aligned row starts

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 2; ++q) wmma::fill_fragment(acc[i][q], 0.0f);

  for (int k0 = r_begin; k0 < r_end; k0 += BK) {
    if (threadIdx.x < BK) {
      const int r = k0 + threadIdx.x;
      const int s = r < r_end ? node[r] : A;
      lo_s[threadIdx.x] = (s >= 0 && s < A) ? s * C - m0 : NO_SLOT;
    }
    for (int e = threadIdx.x; e < BK * C; e += THREADS) {
      const int kk = e / C, c = e - kk * C;
      const int r = k0 + kk;
      st_s[kk * MAX_C + c] =
          bf16_bits(r < r_end ? stats[(size_t)r * C + c] : 0.0f);
    }
    {  // B tile: rows r .. r+15 of column j
      bool on[16];
      const int r = k0 + bh;
      if (col_ok && vec_ok && r + 16 <= r_end) {
        const uint4 v = *reinterpret_cast<const uint4*>(brow + r);
        const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 16; ++i)
          on[i] = ((w4[i / 4] >> (8 * (i % 4))) & 0xFFu) != 0u;
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int rr = r + i;
          on[i] = col_ok && rr < r_end && brow[rr] != 0;
        }
      }
      uint4* dst = reinterpret_cast<uint4*>(Bs + bn * LDB + bh);
      dst[0] = make_uint4(pack2(on[0], on[1]), pack2(on[2], on[3]),
                          pack2(on[4], on[5]), pack2(on[6], on[7]));
      dst[1] = make_uint4(pack2(on[8], on[9]), pack2(on[10], on[11]),
                          pack2(on[12], on[13]), pack2(on[14], on[15]));
    }
    __syncthreads();
    // A tile, 8 rows m of one k per thread and step: a row's one-hot block
    // is stats[0..C) at m = lo .. lo+C-1, zeros elsewhere
    for (int e = threadIdx.x; e < BK * (BM / 8); e += THREADS) {
      const int kk = e / (BM / 8);
      const int mb = (e % (BM / 8)) * 8;
      const int lo = lo_s[kk];
      const uint32_t* st = st_s + kk * MAX_C;
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned d0 = (unsigned)(mb + 2 * q - lo);
        const unsigned d1 = d0 + 1u;
        w[q] = (d0 < (unsigned)C ? st[d0] : 0u) |
               ((d1 < (unsigned)C ? st[d1] : 0u) << 16);
      }
      *reinterpret_cast<uint4*>(As + kk * LDA + mb) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], As + kk * LDA + wm + i * 16, LDA);
#pragma unroll
      for (int q = 0; q < 2; ++q)
        wmma::load_matrix_sync(b[q], Bs + (wn + q * 16) * LDB + kk, LDB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          wmma::mma_sync(acc[i][q], a[i], b[q], acc[i][q]);
    }
    __syncthreads();
  }
  float* out = partial + (size_t)blockIdx.z * M_pad * N_pad;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      wmma::store_matrix_sync(
          out + (size_t)(m0 + wm + i * 16) * N_pad + (j0 + wn + q * 16),
          acc[i][q], N_pad, wmma::mem_row_major);
}

// Sum the per-split partials in split order: out [M, N] = [A, C, B, F].
__global__ void cumhist_bc_reduce_kernel(const float* __restrict__ partial,
                                         float* __restrict__ out, int S,
                                         int M, int N, int M_pad, int N_pad) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * N) return;
  const int m = idx / N, j = idx % N;
  float s = 0.0f;
  for (int k = 0; k < S; ++k)
    s += partial[((size_t)k * M_pad + m) * N_pad + j];
  out[idx] = s;
}

}  // namespace

// stats [n, C] f32, rows [n, row_bytes] uint8 bins, order/seg_off from
// group_rows; partial [n_chunks + A, C, B*F] f32 scratch; out [A, C, B, F].
extern "C" int cumhist_launch(const void* stats, const void* rows,
                              const void* order, const void* seg_off,
                              void* partial, void* out, int n, int C, int A,
                              int B, int F, int row_bytes, int chunk,
                              int n_chunks, void* stream) {
  return grouped::launch<grouped::CUMULATIVE>(
      stats, rows, order, seg_off, partial, out, n, C, A, B * F, B * F, B,
      row_bytes, chunk, n_chunks, (cudaStream_t)stream);
}

extern "C" int cumhist_bc_launch(const void* stats, const void* node,
                                 const void* bc, void* partial, void* out,
                                 int n, int C, int A, int B, int F, int S,
                                 int rows_per_split, int M_pad, int N_pad,
                                 void* stream) {
  if (C < 1 || C > MAX_C || M_pad % BM != 0 || N_pad % BN != 0 ||
      rows_per_split % BK != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int M = A * C, N = B * F;
  dim3 grid(N_pad / BN, M_pad / BM, S);
  cumhist_bc_partial_kernel<<<grid, THREADS, 0, st>>>(
      (const float*)stats, (const int*)node, (const uint8_t*)bc,
      (float*)partial, n, C, A, N, rows_per_split, M_pad, N_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = M * N;
  cumhist_bc_reduce_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      (const float*)partial, (float*)out, S, M, N, M_pad, N_pad);
  return (int)cudaGetLastError();
}
