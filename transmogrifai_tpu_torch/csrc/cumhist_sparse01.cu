// 2-bin histogram of a 0/1 indicator block (the wide-sparse path), for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel of transmogrifai_tpu/models/_pallas_hist.py:
// cumhist(sparse01=True) (_kernel_sparse01 :220; pl.pallas_call :324).
//
//   tot[s, c]       = sum_i 1[node_i = s] * bf16(stats_ic)
//   nz[s, c, f]     = sum_i 1[node_i = s] * x_fi * bf16(stats_ic)
//   out[s, c, 0, f] = tot - nz          (the zero side: bin <= 0)
//   out[s, c, 1, f] = tot               (bin <= 1: every live row)
//
// For a block whose bins are all 0 or 1 the generic kernel's "bin <= t"
// operand is redundant: its t = 1 half is all ones and its t = 0 half is
// one minus the block itself. So this kernel reads the block as it is,
// uint8 [Fb, n], and computes one product NS^T @ [X | 1] with M = A*C rows
// (m = s*C + c), N = Fb + 1 columns and the n data rows as the contraction
// axis. The extra all-ones column j = Fb gives tot out of the same
// product, in the same summation order as nz; the reduce epilogue forms
// tot - nz. As in cumhist.cu, neither operand exists in device memory:
// per 32 rows a block of 256 threads writes its [128 x 32] one-hot*stats
// tile and its [32 x 128] 0/1 tile into shared memory (each thread turns
// 16 consecutive bytes of one column, one 16-byte load, into 16 bf16
// values), and the tensor cores (WMMA bf16 16x16x16, f32 accumulate)
// multiply them.
//
// What bounds it: at the slice's shapes (n = 1.6e5-2e5 rows, Fb = 420-512
// columns at a few percent density, A*C <= 512) the function's own work
// is the f32 adds of the live ones, ~1e7, against ~1e8 bytes of block:
// bytes-bound.
// This first design pays the dense product (zeros included) on the tensor
// cores and the per-32-row barriers; a later one can skip zero tiles.
//
// Determinism: the row axis is split over gridDim.z; every split writes
// its own f32 partial tile and the reduce kernel sums the partials in
// split order, so the weighted channels are bitwise reproducible run to
// run and split ties never flip. Counts are sums of exact 1.0 products in
// f32 and equal the generic kernel's at B = 2 bit for bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

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
sparse01_partial_kernel(const float* __restrict__ stats,
                        const int* __restrict__ node,
                        const uint8_t* __restrict__ xb,
                        float* __restrict__ partial,
                        int n, int C, int A, int Fb,
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

  // this thread's column of the B tile and its 16-row half: a block
  // column (j < Fb), the all-ones column (j == Fb) or padding
  const int bn = threadIdx.x >> 1;
  const int bh = (threadIdx.x & 1) * 16;
  const int j = j0 + bn;
  const bool is_x = j < Fb;
  const bool is_tot = j == Fb;
  const uint8_t* __restrict__ xrow = xb + (size_t)(is_x ? j : 0) * n;
  // 16-byte aligned row starts (row r of column j at xb + j*n + r)
  const bool vec_ok = (n % 16) == 0 && ((uintptr_t)xb % 16) == 0;

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
      if (is_x && vec_ok && r + 16 <= r_end) {
        const uint4 v = *reinterpret_cast<const uint4*>(xrow + r);
        const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 16; ++i)
          on[i] = ((w4[i / 4] >> (8 * (i % 4))) & 0xFFu) != 0u;
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int rr = r + i;
          on[i] = rr < r_end && (is_tot || (is_x && xrow[rr] != 0));
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

// Sum the per-split partials in split order and form the two bins:
// out [M, 2, Fb] = [A, C, 2, Fb] with t = 0 the zero side tot - nz and
// t = 1 the total (partial column Fb).
__global__ void sparse01_reduce_kernel(const float* __restrict__ partial,
                                       float* __restrict__ out, int S, int M,
                                       int Fb, int M_pad, int N_pad) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * Fb) return;
  const int m = idx / Fb, f = idx % Fb;
  float nz = 0.0f, tot = 0.0f;
  for (int k = 0; k < S; ++k) {
    const float* row = partial + ((size_t)k * M_pad + m) * N_pad;
    nz += row[f];
    tot += row[Fb];
  }
  out[((size_t)m * 2) * Fb + f] = tot - nz;
  out[((size_t)m * 2 + 1) * Fb + f] = tot;
}

}  // namespace

extern "C" int cumhist_sparse01_launch(const void* stats, const void* node,
                                       const void* xb, void* partial,
                                       void* out, int n, int C, int A,
                                       int Fb, int S, int rows_per_split,
                                       int M_pad, int N_pad, void* stream) {
  if (C < 1 || C > MAX_C || Fb < 1 || M_pad % BM != 0 || N_pad % BN != 0 ||
      N_pad <= Fb || rows_per_split % BK != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int M = A * C;
  dim3 grid(N_pad / BN, M_pad / BM, S);
  sparse01_partial_kernel<<<grid, THREADS, 0, st>>>(
      (const float*)stats, (const int*)node, (const uint8_t*)xb,
      (float*)partial, n, C, A, Fb, rows_per_split, M_pad, N_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = M * Fb;
  sparse01_reduce_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      (const float*)partial, (float*)out, S, M, Fb, M_pad, N_pad);
  return (int)cudaGetLastError();
}
