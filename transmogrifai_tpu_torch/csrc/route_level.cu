// The tree level's epilogue and per-row routing, for Hopper (sm_90a).
//
// Replaces the Pallas kernel transmogrifai_tpu/models/_pallas_hist.py:
// route_level (_route_kernel :389, pl.pallas_call :480), together with the
// per-level bookkeeping that the JAX package's level body
// (transmogrifai_tpu/models/_treefit.py:876-960) lets XLA fuse around that
// call. Two entry points share one row body:
//
// level_epilogue_launch: one launch a tree level. Every block builds the
//   level's plan for its A parent slots in shared memory:
//   - the winner across the candidate blocks (score desc, concatenated
//     flat index asc) and its decode: global column, bin threshold, stored
//     threshold (edges[f, t], or 0.5 in a 2-bin indicator block), the
//     winner's [C] left stats and block 0's [C] totals;
//   - the exact gain, in the operation order of the plain version
//     (models/_hist.py split_gain; the file is built with -fmad=false, so
//     the gains are bitwise the plain version's IEEE f32 operations), and
//     do_split;
//   - each slot's position in the stable order of (-gain where it splits,
//     else +inf; slot), found by counting: O(A^2) compares spread over the
//     block, integer atomics in shared memory (exact in any order);
//   - the child slots (2 * position where it splits and the position is
//     under A_next / 2, else the dropped sink A_next).
//   Block 0 alone then writes the per-node records (feature, threshold,
//   gain at flat index 2^d - 1 + gpos), the leaf stats of dying slots and
//   of splits that emit two leaves, the next level's gpos/alive and the
//   parents' order rank[:A_next / 2]; sink entries (total_nodes, n_leaves,
//   A_next) are never written. Every other block routes its rows from the
//   plan, so the records are on no row block's path.
// route_level_launch: the route alone, from five slot tables in device
//   memory (the JAX route_level's signature).
//
// Rows: a thread takes ROWS rows a pass (coalesced over i in every array)
// and loads their slot and g before the plan is built, so those loads are
// in flight while the block plans. A row of slot s < A reads one bin
// (XbT[f, i]) where s splits, and writes its child slot, g' = 2 g + right
// and, for a next level with sibling subtraction, node_even' (its left
// child's parent index, or A_next / 2). The grid covers the rows in one
// pass where a few blocks per SM do (n = 200,000: 196 row blocks), so the
// redundant plans cost one plan's latency, not a block's share. The
// kernel is instantiated per channel count C (3 to 8), so a slot's stats
// stay in registers.
//
// What bounds it: bytes. A row reads 12 bytes and writes 8 or 12; the plan
// reads a few KB (block winners, 2 C stats a slot). The launch and the
// plan's chain of dependent loads (winner -> column -> edge) set its time
// at the main path's sizes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 4;              // rows a thread takes a pass
constexpr int BLOCKS_PER_SM = 2;     // at most, beyond one pass's rows
constexpr int MAX_BLOCKS = 4;        // candidate blocks of the feature axis
constexpr int SMEM_MAX = 232448;     // dynamic shared memory a block may use
constexpr float EPS = 1e-12f;

enum Kind { VARIANCE = 0, XGB = 2 };  // models/_hist.py _KINDS

}  // namespace

// The level's inputs and outputs; filled field by field by the ctypes
// structure of the same layout in models/_hist.py.
struct EpilogueParams {
  const float* cum[MAX_BLOCKS];        // [A, C, n_bins, width] each
  const long long* cols[MAX_BLOCKS];   // [width] global column each
  int n_bins[MAX_BLOCKS];
  int width[MAX_BLOCKS];
  int sparse01[MAX_BLOCKS];            // stored threshold 0.5
  const float* score;                  // [n_blocks, A] split_scan outputs
  const int* idx;
  const unsigned char* valid;
  const float* edges;                  // [F, edge_stride]
  const unsigned char* alive;          // [A]
  const int* gpos;                     // [A]
  const int* xbt;                      // [F, n]
  const int* slot;                     // [n]
  const int* g;
  int* slot2;                          // [n]
  int* g2;
  int* node_even2;                     // [n] or null
  int* gpos2;                          // [A_next]
  unsigned char* alive2;               // [A_next]
  long long* rank;                     // [A_next / 2]
  int* feat;                           // [total_nodes + 1], in place
  float* thr;
  float* gain;
  float* leaf_stats;                   // [n_leaves + 1, C], in place
  int n_blocks, edge_stride, n, A, A_next, C, kind, split, d, D;
  float lam, mig;
};

namespace {

__device__ __forceinline__ float clamp_eps(float w) {
  return w < EPS ? EPS : w;            // torch.clamp(min=): NaN stays NaN
}

__device__ __forceinline__ float impurity(float w, float s1, float s2) {
  w = clamp_eps(w);
  const float q = s1 / w;
  return s2 / w - q * q;               // (s1 / w) ** 2 is q * q
}

__device__ __forceinline__ float xgb_score(float g, float h, float lam) {
  return g * g / (h + lam + EPS);
}

// split_gain of models/_hist.py at one slot's [C] left / total stats
__device__ __forceinline__ float split_gain(int kind, const float* l,
                                            const float* t, float lam) {
  if (kind == VARIANCE) {
    const float W = clamp_eps(t[0]);
    const float wL = l[0], wR = t[0] - l[0];
    return impurity(t[0], t[1], t[2]) - (wL / W) * impurity(wL, l[1], l[2])
        - (wR / W) * impurity(wR, t[1] - l[1], t[2] - l[2]);
  }
  return 0.5f * (xgb_score(l[0], l[1], lam)
                 + xgb_score(t[0] - l[0], t[1] - l[1], lam)
                 - xgb_score(t[0], t[1], lam));
}

struct Rows {
  int s[ROWS];
  int g[ROWS];
};

__device__ __forceinline__ Rows load_rows(const int* __restrict__ slot,
                                          const int* __restrict__ g, int n,
                                          long long base) {
  Rows r;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const long long i = base + k * THREADS + threadIdx.x;
    r.s[k] = i < n ? slot[i] : -1;
    r.g[k] = i < n ? g[i] : 0;
  }
  return r;
}

// Route one pass of rows through the slot table in shared memory: tab
// [4, A] (feature, bin threshold, left child, right child) and ds [A]
// (do_split). Idle rows (slot outside [0, A)) go to A_next with right = 0.
__device__ __forceinline__ void route_rows(
    const int* __restrict__ xbt, int n, long long base, const Rows& r,
    const int* tab, const unsigned char* ds, int A, int A_next,
    int* __restrict__ slot2, int* __restrict__ g2,
    int* __restrict__ node_even2) {
  int x[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {   // every bin load in flight together
    const long long i = base + k * THREADS + threadIdx.x;
    const int s = r.s[k];
    x[k] = (s >= 0 && s < A && ds[s]) ? xbt[(size_t)tab[s] * n + i] : 0;
  }
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const long long i = base + k * THREADS + threadIdx.x;
    if (i >= n) continue;
    const int s = r.s[k];
    int right = 0, child = A_next;
    if (s >= 0 && s < A) {
      right = ds[s] && x[k] > tab[A + s];
      child = right ? tab[3 * A + s] : tab[2 * A + s];
    }
    slot2[i] = child;
    g2[i] = 2 * r.g[k] + right;
    if (node_even2 != nullptr)
      node_even2[i] = (child < A_next && (child & 1) == 0) ? child >> 1
                                                          : A_next >> 1;
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS)
level_epilogue_kernel(const EpilogueParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int A = p.A, A_next = p.A_next, half = A_next / 2;
  int* tab = reinterpret_cast<int*>(smem);     // [4, A]
  float* key = reinterpret_cast<float*>(tab + 4 * A);
  float* thr_v = key + A;                      // stored threshold
  int* inv = reinterpret_cast<int*>(thr_v + A);  // position in gain order
  float* lst = reinterpret_cast<float*>(inv + A);  // [A, C] winner's left
  float* tst = lst + A * C;                        // [A, C] totals
  unsigned char* ds = reinterpret_cast<unsigned char*>(tst + A * C);

  // block 0 writes the records; blocks 1.. route the rows, whose slot and
  // g loads are in flight while the block plans
  const bool records = blockIdx.x == 0;
  const long long stride = (long long)(gridDim.x - 1) * THREADS * ROWS;
  long long base = (long long)(blockIdx.x - 1) * THREADS * ROWS;
  const Rows first = records ? Rows() : load_rows(p.slot, p.g, p.n, base);

  // 1. per slot: the winner, its split, its stats and its gain
  for (int a = threadIdx.x; a < A; a += THREADS) {
    // block 0's totals do not depend on the winner: loaded first
    const int nb0 = p.n_bins[0], fb0 = p.width[0];
    const float* c0 = p.cum[0] + (size_t)a * C * nb0 * fb0
        + (size_t)(nb0 - 1) * fb0;
    float l[C], t[C];
#pragma unroll
    for (int c = 0; c < C; ++c) t[c] = c0[(size_t)c * nb0 * fb0];
    float sc = p.score[a];
    long long best = p.idx[a];
    bool ok = p.valid[a] != 0;
    long long off = (long long)(p.n_bins[0] - 1) * p.width[0];
    for (int b = 1; b < p.n_blocks; ++b) {
      const float s = p.score[b * A + a];
      const long long gi = off + p.idx[b * A + a];
      if (s > sc || (s == sc && gi < best)) {
        sc = s;
        best = gi;
        ok = p.valid[b * A + a] != 0;
      }
      off += (long long)(p.n_bins[b] - 1) * p.width[b];
    }
    int wb = 0;                        // the last block best reaches
    long long loc = best;
    off = 0;
    for (int b = 0; b < p.n_blocks; ++b) {
      if (best >= off) {
        wb = b;
        loc = best - off;
      }
      off += (long long)(p.n_bins[b] - 1) * p.width[b];
    }
    const int fb_n = p.width[wb], nb = p.n_bins[wb];
    const int fb = (int)(loc % fb_n), tb = (int)(loc / fb_n);
    const int fg = (int)p.cols[wb][fb];
    // the stored threshold is a record (block 0's); rows compare bins
    const float thr = !records ? 0.0f
        : p.sparse01[wb] ? 0.5f : p.edges[(size_t)fg * p.edge_stride + tb];
    const float* cw = p.cum[wb] + (size_t)a * C * nb * fb_n
        + (size_t)tb * fb_n + fb;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      l[c] = cw[(size_t)c * nb * fb_n];
      lst[a * C + c] = l[c];
      tst[a * C + c] = t[c];
    }
    const float gain = split_gain(p.kind, l, t, p.lam);
    const bool split = p.split && p.alive[a] && ok && gain >= p.mig;
    tab[a] = split ? fg : 0;
    tab[A + a] = tb;
    ds[a] = split;
    thr_v[a] = thr;
    key[a] = split ? -gain : __int_as_float(0x7f800000);
    inv[a] = 0;
  }
  __syncthreads();

  // 2. positions in the stable order of (key, slot), by counting
  const int parts = A < THREADS ? THREADS / A : 1;
  for (int w = threadIdx.x; w < A * parts; w += THREADS) {
    const int a = w / parts, part = w - a * parts;
    const int lo = part * A / parts, hi = (part + 1) * A / parts;
    const float ka = key[a];
    int cnt = 0;
    for (int b = lo; b < hi; ++b) {
      const float kb = key[b];
      cnt += (kb < ka) || (kb == ka && b < a);
    }
    if (cnt) atomicAdd(&inv[a], cnt);
  }
  __syncthreads();

  // 3. child slots
  for (int a = threadIdx.x; a < A; a += THREADS) {
    const int r = inv[a];
    const bool pok = ds[a] && r < half;
    tab[2 * A + a] = pok ? 2 * r : A_next;
    tab[3 * A + a] = pok ? 2 * r + 1 : A_next;
  }
  __syncthreads();

  // 4. block 0: the records, the leaves and the next level's slot state
  if (records) {
    for (int j = threadIdx.x; j < A_next; j += THREADS) {
      p.gpos2[j] = 0;
      p.alive2[j] = 0;
    }
    __syncthreads();
    const int d = p.d, D = p.D;
    for (int a = threadIdx.x; a < A; a += THREADS) {
      const bool split = ds[a] != 0;
      const int r = inv[a], gp = p.gpos[a];
      const bool pok = split && r < half;
      if (p.alive[a]) {
        const int node = (1 << d) - 1 + gp;
        p.feat[node] = tab[a];
        p.thr[node] = split ? thr_v[a] : __int_as_float(0x7f800000);
        p.gain[node] = split ? -key[a] : 0.0f;
        if (!split) {
          float* out = p.leaf_stats + (size_t)(gp << (D - d)) * C;
          for (int c = 0; c < C; ++c) out[c] = tst[a * C + c];
        }
      }
      if (split && (!pok || d == D - 1)) {
        const int sh = D - d - 1;
        float* lo = p.leaf_stats + (size_t)((2 * gp) << sh) * C;
        float* ro = p.leaf_stats + (size_t)((2 * gp + 1) << sh) * C;
        for (int c = 0; c < C; ++c) {
          lo[c] = lst[a * C + c];
          ro[c] = tst[a * C + c] - lst[a * C + c];
        }
      }
      if (pok) {
        p.gpos2[2 * r] = 2 * gp;
        p.gpos2[2 * r + 1] = 2 * gp + 1;
        p.alive2[2 * r] = 1;
        p.alive2[2 * r + 1] = 1;
      }
      if (r < half) p.rank[r] = a;
    }
    return;
  }

  // 5. rows
  route_rows(p.xbt, p.n, base, first, tab, ds, A, A_next, p.slot2, p.g2,
             p.node_even2);
  for (base += stride; base < p.n; base += stride)
    route_rows(p.xbt, p.n, base, load_rows(p.slot, p.g, p.n, base), tab, ds,
               A, A_next, p.slot2, p.g2, p.node_even2);
}

__global__ void __launch_bounds__(THREADS)
route_level_kernel(const int* __restrict__ xbt, const int* __restrict__ slot,
                   const int* __restrict__ g, const int* __restrict__ f_idx,
                   const int* __restrict__ t_idx,
                   const int* __restrict__ lchild,
                   const int* __restrict__ rchild,
                   const unsigned char* __restrict__ do_split,
                   int* __restrict__ slot2, int* __restrict__ g2, int n,
                   int A, int A_next) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* tab = reinterpret_cast<int*>(smem);
  unsigned char* ds = reinterpret_cast<unsigned char*>(tab + 4 * A);
  const long long stride = (long long)gridDim.x * THREADS * ROWS;
  long long base = (long long)blockIdx.x * THREADS * ROWS;
  const Rows first = load_rows(slot, g, n, base);
  for (int a = threadIdx.x; a < A; a += THREADS) {
    tab[a] = f_idx[a];
    tab[A + a] = t_idx[a];
    tab[2 * A + a] = lchild[a];
    tab[3 * A + a] = rchild[a];
    ds[a] = do_split[a];
  }
  __syncthreads();
  route_rows(xbt, n, base, first, tab, ds, A, A_next, slot2, g2, nullptr);
  for (base += stride; base < n; base += stride)
    route_rows(xbt, n, base, load_rows(slot, g, n, base), tab, ds, A,
               A_next, slot2, g2, nullptr);
}

int row_grid(int n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  const long long passes = ((long long)n + THREADS * ROWS - 1)
      / (THREADS * ROWS);
  const long long cap = (long long)BLOCKS_PER_SM * sms;
  return (int)(passes < 1 ? 1 : (passes < cap ? passes : cap));
}

}  // namespace

// Shared memory of the epilogue's plan at A slots and C channels.
extern "C" int level_epilogue_smem(int A, int C) {
  return A * (7 * 4 + 2 * C * 4 + 1);
}

namespace {

// Block 0 writes the records; one block more for each of row_grid's.
template <int C>
int launch_epilogue(const EpilogueParams& p, void* stream) {
  const int smem = level_epilogue_smem(p.A, C);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        level_epilogue_kernel<C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  level_epilogue_kernel<C><<<1 + row_grid(p.n), THREADS, smem,
                             (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// One tree level's epilogue (see the top of this file). Returns a
// cudaError_t.
extern "C" int level_epilogue_launch(const EpilogueParams* params,
                                     void* stream) {
  const EpilogueParams& p = *params;
  if (p.A < 1 || p.A_next < 1 || p.C < 3 || p.C > 8 || p.n_blocks < 1 ||
      p.n_blocks > MAX_BLOCKS || (p.kind != VARIANCE && p.kind != XGB))
    return (int)cudaErrorInvalidValue;
  switch (p.C) {
    case 3: return launch_epilogue<3>(p, stream);
    case 4: return launch_epilogue<4>(p, stream);
    case 5: return launch_epilogue<5>(p, stream);
    case 6: return launch_epilogue<6>(p, stream);
    case 7: return launch_epilogue<7>(p, stream);
    default: return launch_epilogue<8>(p, stream);
  }
}

// The route alone: xbt [F, n], slot, g [n]; the slot tables f_idx, t_idx,
// lchild, rchild [A] int32 and do_split [A] bool bytes; slot2, g2 [n].
// Returns a cudaError_t.
extern "C" int route_level_launch(const void* xbt, const void* slot,
                                  const void* g, const void* f_idx,
                                  const void* t_idx, const void* lchild,
                                  const void* rchild, const void* do_split,
                                  void* slot2, void* g2, int n, int A,
                                  int A_next, void* stream) {
  if (A < 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const size_t smem = (size_t)A * (4 * sizeof(int) + 1);
  route_level_kernel<<<row_grid(n), THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)xbt, (const int*)slot, (const int*)g, (const int*)f_idx,
      (const int*)t_idx, (const int*)lchild, (const int*)rchild,
      (const unsigned char*)do_split, (int*)slot2, (int*)g2, n, A, A_next);
  return (int)cudaGetLastError();
}
