// Slot-grouped level histograms on the tensor cores, for Hopper (sm_90a):
// the shared body of cumhist.cu (bin <= t indicators, built from the bins
// or read precomputed) and cumhist_sparse01.cu (0/1 indicator columns
// plus an all-ones column).
//
// Rows come grouped by slot (group_rows.cu: order, seg_off; each slot's
// segment padded to a multiple of 16 with the id n, a zero row). For slot
// s the histogram is one product
//
//   out_s[m, c] = sum_{i in seg(s)} ind(i, m) * bf16(stats[i, c])
//
// with M = the indicator's rows (sparse01: the Fb columns and the all-ones
// column; cumulative and precomputed: (t, f) pairs, m = t*F + f), N = C
// channels padded to 8 and K = the segment's rows. Each live row costs
// M*8 MACs instead of the one-hot product's (A*C)*M, and idle rows are
// never read. A launch takes at most 8 channels, the tile's N: the
// wrappers (models/_hist.py) take wider stats (a tree of eight or more
// classes) in launches over chunks of 8 channels. A histogram is linear
// in its channels and a channel's sums do not depend on the others', so
// the chunks' outputs are the channels' sums as one wide launch would
// take them.
//
// Operands are row-major uint8 copies made once per fit (sparse01: [n, RB]
// 0/1 bytes with the all-ones column at byte Fb; cumulative: [n, RB] bins,
// B <= 256; precomputed: [n, RB] 0/1 bytes of the bin <= t indicator, byte
// m = t*F + f), so a gathered row is one contiguous 16-byte-aligned read.
// The two byte-indicator kinds (sparse01, precomputed) read byte m as
// output row m's indicator; the cumulative kind compares a bin with t.
// A block takes a fixed chunk of the grouped order
// (a multiple of 32 positions) and one group of up to 1,024 output rows m,
// and copies only the bytes of a row that group reads (row_span below).
// Per pipeline stage (Stages below) its 256 threads start 16-byte
// cp.async copies of the gathered rows and 4-byte copies of their f32
// stats into a ring of shared-memory stages (all but one in flight while
// one is multiplied; one barrier a stage); the row ids of a stage are
// loaded into registers a whole stage ahead. Per 16-row K-step each warp
// builds the bf16 B fragment (the stats) once, and for each of its up to
// 8 m-tiles the A fragment from the row bytes, two rows' bytes packed
// into one register (byte indicators: one multiply makes the bf16 pair;
// cumulative: one subtraction, one prmt and one mask test bin <= t for
// the pair), then runs mma.sync m16n8k16 bf16 with f32 accumulators in
// registers.
//
// A block whose chunk crosses a segment boundary writes its accumulators
// to that segment's partial and starts again at zero. The partial of
// (chunk c, slot s) lives at index c + s: two pieces with equal c + s
// would need slot s - k in a later chunk than slot s, which the grouped
// order rules out, so the index is unique and the buffer has
// n_chunks + A entries of [C, M] f32. A second kernel sums each slot's
// partials in chunk order (an empty slot gets zeros); for sparse01 it
// forms t = 0 as total - nonzero side and t = 1 as the total; the other
// two kinds write the sums as they are.
//
// Determinism: the chunk size is a function of (n, A) only, every sum
// has a fixed order and there are no float atomics, so the weighted
// channels are bitwise repeatable and split ties never flip. Counts are
// sums of exact 1.0 products in f32.
//
// What bounds it: bytes (node once, the live rows' stats and uint8 bytes,
// the output). The products are ~M*8*K MACs on the tensor cores; the
// A-fragment builds from shared memory and the cp.async latency of the
// gathered rows are what this design pays.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

namespace grouped {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NPAD = 8;                                // channels, padded
constexpr int MAX_C = 8;
constexpr int KSTEP = 16;            // group_rows pads segments to it
constexpr int MAX_SLOTS = 1024;      // group_rows' limit
constexpr int REDUCE_RUNS = 8;           // runs of chunks summed apart
constexpr uint32_t BF16_ONE = 0x3F80u;

enum Kind { SPARSE01 = 0, CUMULATIVE = 1, PRECOMPUTED = 2 };

// byte m of a gathered row is output row m's 0/1 indicator
__host__ __device__ constexpr bool byte_indicators(int kind) {
  return kind != CUMULATIVE;
}

// Rows a pipeline stage and stages in the ring. The byte indicators' rows
// are wide (RB = 528 bytes at Fb = 512, 640 at B*F = 640; a group reads
// at most 1,024 of them), so four stages of 32 rows (72-88 KB at those
// widths) leave room for two or three blocks an SM; the bins' rows are
// narrow (32 bytes at F = 20), and six stages of 64 rows (43 KB) keep
// more of them in flight.
template <int KIND> struct Stages {
  static constexpr int ROWS = 32, N = 4;
};
template <> struct Stages<CUMULATIVE> {
  static constexpr int ROWS = 64, N = 6;
};

// shared-memory row stride: >= w and = 16 mod 64 bytes, so the four rows
// 2t (t = 0..3) a fragment load touches fall in four different banks
__host__ __device__ inline int row_stride(int w) {
  return w + ((16 - w % 64) + 64) % 64;
}

template <int KIND>
__host__ __device__ inline int stage_bytes(int w) {
  return Stages<KIND>::ROWS * (row_stride(w) + NPAD * (int)sizeof(float));
}

// The bytes of a row that the group of GM output rows from m_base reads:
// [col0, col0 + W), col0 a multiple of 16. Byte indicators: its GM
// columns. cumulative: the features of its (f, t) pairs, f-major, so
// about GM / B of them; shared memory then depends on GM and B, not on F.
struct Span { int col0, W; };
template <int KIND>
__host__ __device__ inline Span row_span(int m_base, int GM, int M, int B,
                                         int row_bytes) {
  if (byte_indicators(KIND)) {
    const int w = row_bytes - m_base;
    return {m_base, w < GM ? w : GM};
  }
  const int m_end = m_base + GM < M ? m_base + GM : M;
  const int f0 = m_base / B, f1 = (m_end - 1) / B;   // f1 <= F - 1
  const int col0 = f0 & ~15;
  return {col0, (f1 + 1 - col0 + 15) & ~15};
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// two rows' bins b, packed as 16-bit halves, against a threshold t packed
// as halves of 0x8000 + t: each half's bit 15 of the difference says
// b <= t; prmt replicates it over the half (selector nibbles 9 and B
// sign-extend bytes 1 and 3), and the mask leaves bf16 1.0 or 0
__device__ __forceinline__ uint32_t le_pair(uint32_t bins, uint32_t thr) {
  uint32_t m;
  asm("prmt.b32 %0, %1, 0, 0xBB99;\n" : "=r"(m) : "r"(thr - bins));
  return m & (BF16_ONE | (BF16_ONE << 16));
}

__device__ __forceinline__ uint32_t pack_pair(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x5410);
}

__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// grid (n_chunks, groups of WARPS * TPW * 16 output rows); partial
// [n_chunks + A, C, M] f32 in the output's row order. M: output rows
// (sparse01: Fb + 1, the last the all-ones column; cumulative and
// precomputed: B * F, m = t * F + f). B: bins (cumulative only).
// row_bytes: RB. TPW: m-tiles a warp holds accumulators for.
template <int KIND, int TPW>
__global__ void __launch_bounds__(THREADS)
grouped_hist_kernel(const float* __restrict__ stats,
                    const uint8_t* __restrict__ rows,
                    const int* __restrict__ order,
                    const int* __restrict__ seg_off,
                    float* __restrict__ partial, int n, int C, int A, int M,
                    int B, int row_bytes, int chunk) {
  constexpr int GM = WARPS * TPW * 16;
  constexpr int STAGE_ROWS = Stages<KIND>::ROWS, NSTAGE = Stages<KIND>::N;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ids_s[NSTAGE][STAGE_ROWS];  // each stage's row ids
  __shared__ int seg_s[MAX_SLOTS + 1];       // seg_off
  const int pos0 = blockIdx.x * chunk;
  // past seg_off[A] the grouped order holds the zero row's id n
  const int chunk_end = min(pos0 + chunk, n + (KSTEP - 1) * A);

  const int m_base = blockIdx.y * GM;
  const Span span = row_span<KIND>(m_base, GM, M, B, row_bytes);
  const int col0 = span.col0, W = span.W;
  const int LDR = row_stride(W);
  const int SB = stage_bytes<KIND>(W);
  const int n_mt = (min(GM, M - m_base) + 15) / 16;
  const int F = byte_indicators(KIND) ? 1 : M / B;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;

  // this warp's m-tiles: interleaved across warps for byte indicators,
  // consecutive for cumulative (so a warp's tiles share features)
  auto tile = [&](int i) {
    return byte_indicators(KIND) ? warp + WARPS * i : warp * TPW + i;
  };
  // this thread's two rows (g, g + 8) of each of its m-tiles, as byte
  // columns from col0. Byte indicators: the indicator columns.
  // cumulative: the tiles run over (f, t) f-major, m' = f * B + t, so
  // when 16 divides B the two rows and, at B = 32, a pair of consecutive
  // tiles share one feature's bins; col = f - col0, thr = t packed for
  // le_pair.
  int lo_col[TPW], hi_col[TPW];
  uint32_t lo_thr[TPW], hi_thr[TPW];
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    const int ml = tile(i) * 16 + g;
    if (byte_indicators(KIND)) {
      lo_col[i] = ml;
      hi_col[i] = ml + 8;
      lo_thr[i] = hi_thr[i] = 0;
    } else {
      const int m0 = m_base + ml, m1 = m0 + 8;
      lo_col[i] = min(m0 / B, F - 1) - col0;
      lo_thr[i] = (0x8000u + m0 % B) * 0x10001u;
      hi_col[i] = min(m1 / B, F - 1) - col0;
      hi_thr[i] = (0x8000u + m1 % B) * 0x10001u;
    }
  }

  // threads < STAGE_ROWS: the row id of their position in stage st
  auto stage_id = [&](int st) {
    const int p = pos0 + st * STAGE_ROWS + threadIdx.x;
    return p < chunk_end ? order[p] : n;
  };
  // one round trip to device memory for seg_off and the first stages'
  // row ids, which do not depend on each other
  for (int j = threadIdx.x; j <= A; j += THREADS) seg_s[j] = seg_off[j];
  if (threadIdx.x < STAGE_ROWS)
    for (int st = 0; st < NSTAGE; ++st)
      ids_s[st][threadIdx.x] = stage_id(st);
  // channels >= C are never copied: zero them once for every stage
  for (int st = 0; st < NSTAGE; ++st) {
    float* S = reinterpret_cast<float*>(smem + st * SB + STAGE_ROWS * LDR);
    for (int e = threadIdx.x; e < STAGE_ROWS * NPAD; e += THREADS) S[e] = 0.f;
  }
  __syncthreads();
  const int total = seg_s[A];
  if (pos0 >= total) return;                 // uniform: the whole block
  const int pos_end = min(pos0 + chunk, total);
  const int n_stages = (pos_end - pos0 + STAGE_ROWS - 1) / STAGE_ROWS;

  auto fetch = [&](int st) {
    unsigned char* Rb = smem + (st % NSTAGE) * SB;
    float* S = reinterpret_cast<float*>(Rb + STAGE_ROWS * LDR);
    const int* ids = ids_s[st % NSTAGE];
    const int q = W / 16;
    for (int e = threadIdx.x; e < STAGE_ROWS * q; e += THREADS) {
      const int r = e / q, qq = e - r * q;
      const int id = ids[r];
      const bool ok = id < n;
      cp_async16(Rb + r * LDR + qq * 16,
                 ok ? rows + (size_t)id * row_bytes + col0 + qq * 16 : rows,
                 ok);
    }
    for (int e = threadIdx.x; e < STAGE_ROWS * C; e += THREADS) {
      const int r = e / C, c = e - r * C;
      const int id = ids[r];
      const bool ok = id < n;
      cp_async4(S + r * NPAD + c, ok ? stats + (size_t)id * C + c : stats, ok);
    }
  };

  // the segment holding pos0: the last slot whose segment starts there or
  // before (an empty slot before it starts at the same place)
  int s = 0;
  {
    int hi = A - 1;
    while (s < hi) {
      const int mid = (s + hi + 1) >> 1;
      if (seg_s[mid] <= pos0) s = mid; else hi = mid - 1;
    }
  }
  int seg_end = seg_s[s + 1];

  float acc[TPW][4];
#pragma unroll
  for (int i = 0; i < TPW; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  auto put = [&](float* P, int nn, int i, bool hi, float v) {
    const int ml = m_base + tile(i) * 16 + g + (hi ? 8 : 0);
    if (nn >= C || ml >= M) return;
    const int t = (int)((hi ? hi_thr[i] : lo_thr[i]) & 0xFFFFu) - 0x8000;
    const int m = byte_indicators(KIND)
                      ? ml : t * F + col0 + (hi ? hi_col[i] : lo_col[i]);
    P[(size_t)nn * M + m] = v;
  };
  auto flush = [&](int slot) {
    float* P = partial + (size_t)(blockIdx.x + slot) * C * M;
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      if (tile(i) < n_mt) {
        put(P, 2 * tq, i, false, acc[i][0]);
        put(P, 2 * tq + 1, i, false, acc[i][1]);
        put(P, 2 * tq, i, true, acc[i][2]);
        put(P, 2 * tq + 1, i, true, acc[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
  };

#pragma unroll
  for (int st = 0; st < NSTAGE - 1; ++st) {
    if (st < n_stages) fetch(st);
    cp_async_commit();
  }
  for (int st = 0; st < n_stages; ++st) {
    // the ids of stage st + NSTAGE load while this stage is multiplied
    const int next_id =
        threadIdx.x < STAGE_ROWS ? stage_id(st + NSTAGE) : n;
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();
    if (st + NSTAGE - 1 < n_stages) fetch(st + NSTAGE - 1);
    cp_async_commit();

    const unsigned char* Rb = smem + (st % NSTAGE) * SB;
    const float* S = reinterpret_cast<const float*>(Rb + STAGE_ROWS * LDR);
#pragma unroll
    for (int kk = 0; kk < STAGE_ROWS; kk += 16) {
      const int pos = pos0 + st * STAGE_ROWS + kk;
      if (pos >= pos_end) break;
      if (pos >= seg_end) {         // uniform across the block
        flush(s);
        while (seg_s[s + 1] <= pos) ++s;
        seg_end = seg_s[s + 1];
      }
      const float* Sk = S + kk * NPAD;
      const uint32_t b0 = bf16x2(Sk[(2 * tq) * NPAD + g],
                                 Sk[(2 * tq + 1) * NPAD + g]);
      const uint32_t b1 = bf16x2(Sk[(2 * tq + 8) * NPAD + g],
                                 Sk[(2 * tq + 9) * NPAD + g]);
      const unsigned char* R0 = Rb + (kk + 2 * tq) * LDR;
      const unsigned char* R1 = R0 + LDR;
      const unsigned char* R2 = R0 + 8 * LDR;
      const unsigned char* R3 = R2 + LDR;
      int cur = -1;                 // the feature whose bins are packed
      uint32_t p01 = 0, p23 = 0;
#pragma unroll
      for (int i = 0; i < TPW; ++i) {
        if (tile(i) < n_mt) {
          const int cl = lo_col[i], ch = hi_col[i];
          uint32_t a0, a1, a2, a3;
          if (byte_indicators(KIND)) {   // 0/1 bytes: byte * 1.0 in bf16
            a0 = pack_pair(R0[cl], R1[cl]) * BF16_ONE;
            a1 = pack_pair(R0[ch], R1[ch]) * BF16_ONE;
            a2 = pack_pair(R2[cl], R3[cl]) * BF16_ONE;
            a3 = pack_pair(R2[ch], R3[ch]) * BF16_ONE;
          } else {                  // bin <= t, two rows at a time
            if (cl != cur) {
              cur = cl;
              p01 = pack_pair(R0[cl], R1[cl]);
              p23 = pack_pair(R2[cl], R3[cl]);
            }
            uint32_t q01 = p01, q23 = p23;
            if (ch != cl) {
              q01 = pack_pair(R0[ch], R1[ch]);
              q23 = pack_pair(R2[ch], R3[ch]);
            }
            a0 = le_pair(p01, lo_thr[i]);
            a1 = le_pair(q01, hi_thr[i]);
            a2 = le_pair(p23, lo_thr[i]);
            a3 = le_pair(q23, hi_thr[i]);
          }
          mma_bf16(acc[i], a0, a1, a2, a3, b0, b1);
        }
      }
    }
    if (threadIdx.x < STAGE_ROWS) ids_s[st % NSTAGE][threadIdx.x] = next_id;
  }
  cp_async_wait<0>();
  flush(s);
}

// grid (ceil(M_out / 32), C, A), block (32, G): out[s, c, m] = the sum of
// slot s's partials in chunk order, as G consecutive runs of chunks whose
// sums are added in run order. sparse01 (M = M_out + 1, the total at
// m = M_out): out [A, C, 2, M_out] with t = 0 the total minus the nonzero
// side and t = 1 the total. cumulative and precomputed: out [A, C, M_out].
template <int KIND>
__global__ void __launch_bounds__(REDUCE_RUNS * 32)
grouped_reduce_kernel(const float* __restrict__ partial,
                      const int* __restrict__ seg_off,
                      float* __restrict__ out, int C, int M, int M_out,
                      int chunk) {
  __shared__ float run_sum[REDUCE_RUNS][32], run_tot[REDUCE_RUNS][32];
  const int m = blockIdx.x * 32 + threadIdx.x;
  const int c = blockIdx.y, s = blockIdx.z;
  const int G = blockDim.y, gy = threadIdx.y;
  const int lo = seg_off[s], hi = seg_off[s + 1];
  float sum = 0.f, tot = 0.f;
  if (hi > lo && m < M_out) {
    const int c0 = lo / chunk, np = (hi - 1) / chunk - c0 + 1;
    const int p_end = c0 + (gy + 1) * np / G;
#pragma unroll 4
    for (int p = c0 + gy * np / G; p < p_end; ++p) {
      const float* P = partial + ((size_t)(p + s) * C + c) * M;
      sum += P[m];
      if (KIND == SPARSE01) tot += P[M - 1];
    }
  }
  run_sum[gy][threadIdx.x] = sum;
  run_tot[gy][threadIdx.x] = tot;
  __syncthreads();
  if (gy != 0 || m >= M_out) return;
  sum = run_sum[0][threadIdx.x];
  tot = run_tot[0][threadIdx.x];
  for (int r = 1; r < G; ++r) {
    sum += run_sum[r][threadIdx.x];
    tot += run_tot[r][threadIdx.x];
  }
  const size_t o = (size_t)s * C + c;
  if (KIND == SPARSE01) {
    out[(o * 2) * M_out + m] = tot - sum;
    out[(o * 2 + 1) * M_out + m] = tot;
  } else {
    out[o * M_out + m] = sum;
  }
}

// launch_tpw's answer when the ring for TPW m-tiles a warp does not fit in
// an SM's shared memory (few bins, many features): take fewer m-tiles
constexpr int TOO_WIDE = -1;

template <int KIND, int TPW>
int launch_tpw(const void* stats, const void* rows, const void* order,
               const void* seg_off, void* partial, void* out, int n, int C,
               int A, int M, int M_out, int B, int row_bytes, int chunk,
               int n_chunks, cudaStream_t st) {
  constexpr int GM = WARPS * TPW * 16;
  int w_max = 0;
  for (int m_base = 0; m_base < M; m_base += GM) {
    const int w = row_span<KIND>(m_base, GM, M, B, row_bytes).W;
    w_max = w > w_max ? w : w_max;
  }
  const int smem = Stages<KIND>::N * stage_bytes<KIND>(w_max);
  // the dynamic shared memory a block may take: the card's opt-in limit
  // less the kernel's static arrays, asked once
  static std::atomic<int> room{0};
  cudaError_t err = cudaSuccess;
  if (room.load() == 0) {
    int dev = 0, optin = 0;
    cudaFuncAttributes fa;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncGetAttributes(&fa, grouped_hist_kernel<KIND, TPW>);
    if (err != cudaSuccess) return (int)err;
    room.store(optin - (int)fa.sharedSizeBytes);
  }
  if (smem > room.load()) return TOO_WIDE;
  err = cudaFuncSetAttribute(
      grouped_hist_kernel<KIND, TPW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_chunks, (M + GM - 1) / GM);
  grouped_hist_kernel<KIND, TPW><<<grid, THREADS, smem, st>>>(
      (const float*)stats, (const uint8_t*)rows, (const int*)order,
      (const int*)seg_off, (float*)partial, n, C, A, M, B, row_bytes, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // runs per output: about four chunks a slot each on average, at most
  // REDUCE_RUNS (a function of shapes only, like the chunks)
  int runs = n_chunks / (4 * A);
  runs = runs < 1 ? 1 : runs > REDUCE_RUNS ? REDUCE_RUNS : runs;
  dim3 rgrid((M_out + 31) / 32, C, A);
  grouped_reduce_kernel<KIND><<<rgrid, dim3(32, runs), 0, st>>>(
      (const float*)partial, (const int*)seg_off, (float*)out, C, M, M_out,
      chunk);
  return (int)cudaGetLastError();
}

// Both passes on the caller's stream; returns a cudaError_t. Each warp
// holds the accumulators of up to 8 m-tiles: the fewest groups of up to
// 1,024 output rows that cover M, split evenly; fewer m-tiles when a
// group's bytes of a row do not fit the ring (cumulative at B = 1).
template <int KIND>
int launch(const void* stats, const void* rows, const void* order,
           const void* seg_off, void* partial, void* out, int n, int C, int A,
           int M, int M_out, int B, int row_bytes, int chunk, int n_chunks,
           cudaStream_t st) {
  if (C < 1 || C > MAX_C || A < 1 || A > MAX_SLOTS || M < 1 || M_out < 1 ||
      n < 1 ||
      row_bytes % 16 != 0 || chunk % 16 != 0 || n_chunks < 1 ||
      (KIND == CUMULATIVE && (B < 1 || M % B != 0 || row_bytes < M / B)) ||
      (byte_indicators(KIND) && row_bytes < M))
    return (int)cudaErrorInvalidValue;
  // groups of equal size: every group pays the whole gather of its rows
  const int tiles = (M + 15) / 16;
  const int groups = (tiles + WARPS * 8 - 1) / (WARPS * 8);
  int rc = TOO_WIDE;
  for (int tpw = (tiles + groups * WARPS - 1) / (groups * WARPS);
       tpw >= 1 && rc == TOO_WIDE; --tpw) {
#define GROUPED_CASE(T)                                                      \
  case T:                                                                    \
    rc = launch_tpw<KIND, T>(stats, rows, order, seg_off, partial, out, n,   \
                             C, A, M, M_out, B, row_bytes, chunk, n_chunks,  \
                             st);                                            \
    break;
    switch (tpw) {
      GROUPED_CASE(1) GROUPED_CASE(2) GROUPED_CASE(3) GROUPED_CASE(4)
      GROUPED_CASE(5) GROUPED_CASE(6) GROUPED_CASE(7) GROUPED_CASE(8)
    }
#undef GROUPED_CASE
  }
  return rc == TOO_WIDE ? (int)cudaErrorInvalidValue : rc;
}

}  // namespace grouped
