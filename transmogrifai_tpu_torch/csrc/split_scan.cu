// Fused split scan of the tree engine, for Hopper (sm_90a).
//
// Replaces the Pallas kernel transmogrifai_tpu/models/_pallas_hist.py:
// split_scan (_scan_kernel :504, pl.pallas_call :659).
//
// For every slot a of a cumulative histogram cum [A, C, B, F] it scores
// each (threshold t < B-1, feature f) candidate with the criterion's
// monotone surrogate, masks it (min instances, min child weight, [A, F]
// feature mask; masked score -1e30) and keeps the best one under the
// (score desc, flat index t*F + f asc) rule: jnp.argmax's first-occurrence
// semantics over the t-major flat candidate axis.
//
// Layout, as the TPU kernel lays it out (slots x feature lanes, bins
// unrolled), for warps: a lane owns one feature f, so every (c, t) load
// is coalesced across the warp (f is contiguous in cum). A warp's unit of
// work, an item, is one group of 32 features and one run of up to TCH = 2
// consecutive thresholds: the lane loads the total row (B-1, f) of the
// channels the criterion reads once, then the item's (c, t) values all
// together (TCH loads a channel in flight), then scores them in t order.
// No integer divide is done per candidate; the flat index steps by F.
// Each lane keeps its best under (score desc, index asc); the warp then
// reduces with shuffles, and the warps of one slot merge through one
// shared-memory step (one barrier), not a barriered tree.
//
// Mapping (host side, split_scan_launch): a slot has FG * TS items (FG =
// ceil(F / 32) feature groups, TS = ceil((B-1) / TCH) threshold runs) and
// WPS = min(items, 16) warps that take them in turn; a block holds
// S = max(1, 8 / WPS) slots, so narrow slots share a block (several at
// B <= 9 and F <= 32; eight of the 2-bin block at F <= 32). At the main
// paths' shapes:
//   F = 20 or 32, B = 32: 16 items a slot, 16 warps, one slot a block, so
//     one load round trip a warp; A = 1 gives one block of 16 warps.
//   Fb = 419, B = 2: 14 items (one threshold), 14 warps, one slot a block.
//   F = 600, B = 32: 304 items over 16 warps, 19 round trips a warp.
// Splitting the thresholds of a feature over warps, not walking all B-1
// of them in one lane, keeps every warp to one round trip of loads at
// B = 32: a scan this small is a chain of dependent load latencies, and
// the levels of a tree call it at A = 1, 2, 4, ... slots. TCH = 2 was
// chosen by the main path's device time: the sweep's 2,820 scans took
// 13.7 ms at TCH = 8, 9.7 at TCH = 4 and 8.4 at TCH = 2 (one H100 run,
// chip_smoke.py --timings-only); TCH = 8 is faster only at wide F.
//
// What bounds it: it reads the histogram once (A*C*B*F floats, ~1.3 MB at
// A = 128, C = 4, B = 32, F = 20) and does ~12 f32 operations per
// candidate; the bound is ~0.4 us, so its time is launch latency plus a
// load round trip or two.
//
// Numerics: the score is evaluated in the same operation order as the
// plain version (models/_hist.py split_scan_reference); the file is built
// with -fmad=false so no multiply-add is contracted and the scores are
// bitwise equal to the plain version's IEEE f32 operations. valid is
// written as one 0/1 byte a slot, the storage of a torch.bool tensor.
#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>

namespace {

constexpr int TCH = 2;          // thresholds an item covers
constexpr int MAX_WPS = 16;     // warps a slot
constexpr int BLOCK_WARPS = 8;  // warps a block of several slots
constexpr int MAX_WARPS = MAX_WPS > BLOCK_WARPS ? MAX_WPS : BLOCK_WARPS;
constexpr float NEG = -1e30f;
constexpr float EPS = 1e-12f;
constexpr unsigned FULL = 0xFFFFFFFFu;

enum Kind { VARIANCE = 0, GINI = 1, XGB = 2 };

struct Best {
  float s = NEG;
  int i = INT_MAX;
  int ok = 0;

  __device__ __forceinline__ void take(float s2, int i2, int ok2) {
    if (s2 > s || (s2 == s && i2 < i)) {
      s = s2;
      i = i2;
      ok = ok2;
    }
  }

  __device__ __forceinline__ void warp_reduce() {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float s2 = __shfl_xor_sync(FULL, s, o);
      const int i2 = __shfl_xor_sync(FULL, i, o);
      const int ok2 = __shfl_xor_sync(FULL, ok, o);
      take(s2, i2, ok2);
    }
  }
};

// One item: feature f of slot h (h points at cum[a]), thresholds
// t0 .. t0 + nt - 1, folded into the lane's best.
template <int KIND>
__device__ __forceinline__ void scan_item(const float* __restrict__ h,
                                          int f, int t0, int nt, int C,
                                          int B, int F, bool m_ok,
                                          float pmin, float pmcw, float plam,
                                          Best& best) {
  const int BF = B * F;
  const int tl = (B - 1) * F;               // the total row (B-1, f)
  const float* cn = h + (size_t)(C - 1) * BF + f;
  float sb[TCH], lc[TCH], hl[TCH], ht = 0.0f;
  const float tc = cn[tl];
  if (KIND == GINI) {          // channels (class weights..., count)
    float wL[TCH], wR[TCH], l2[TCH], r2[TCH];
#pragma unroll
    for (int j = 0; j < TCH; ++j) {
      wL[j] = wR[j] = l2[j] = r2[j] = 0.0f;
      if (j < nt) lc[j] = cn[(t0 + j) * F];
    }
    for (int k = 0; k < C - 1; ++k) {
      const float* ck = h + (size_t)k * BF + f;
      const float tk = ck[tl];
      float lk[TCH];
#pragma unroll
      for (int j = 0; j < TCH; ++j)
        if (j < nt) lk[j] = ck[(t0 + j) * F];
#pragma unroll
      for (int j = 0; j < TCH; ++j) {
        if (j < nt) {
          const float rk = tk - lk[j];
          wL[j] = wL[j] + lk[j];
          wR[j] = wR[j] + rk;
          l2[j] = l2[j] + lk[j] * lk[j];
          r2[j] = r2[j] + rk * rk;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < TCH; ++j)
      if (j < nt)
        sb[j] = l2[j] / fmaxf(wL[j], EPS) + r2[j] / fmaxf(wR[j], EPS);
  } else {   // variance (w, w*y, w*y^2, count); xgb (g, h, count)
    const float* c0 = h + f;
    const float* c1 = h + BF + f;
    const float t0v = c0[tl], t1v = c1[tl];
    float v0[TCH], v1[TCH];
#pragma unroll
    for (int j = 0; j < TCH; ++j) {
      if (j < nt) {
        const int o = (t0 + j) * F;
        v0[j] = c0[o];
        v1[j] = c1[o];
        lc[j] = cn[o];
      }
    }
    ht = t1v;
#pragma unroll
    for (int j = 0; j < TCH; ++j) {
      if (j < nt) {
        if (KIND == VARIANCE) {
          const float wL = v0[j], sL = v1[j];
          const float sR = t1v - sL, wR = t0v - wL;
          sb[j] = sL * sL / fmaxf(wL, EPS) + sR * sR / fmaxf(wR, EPS);
        } else {
          const float gL = v0[j], hL = v1[j];
          const float gR = t0v - gL, hR = t1v - hL;
          sb[j] = gL * gL / (hL + plam + EPS) + gR * gR / (hR + plam + EPS);
          hl[j] = hL;
        }
      }
    }
  }
  int idx = t0 * F + f;
#pragma unroll
  for (int j = 0; j < TCH; ++j) {
    if (j < nt) {
      bool ok = m_ok && (lc[j] >= pmin) && (tc - lc[j] >= pmin);
      if (KIND == XGB) ok = ok && (hl[j] >= pmcw) && (ht - hl[j] >= pmcw);
      best.take(ok ? sb[j] : NEG, idx, ok ? 1 : 0);
    }
    idx += F;
  }
}

template <int KIND>
__global__ void __launch_bounds__(MAX_WARPS * 32)
split_scan_kernel(const float* __restrict__ cum,
                  const float* __restrict__ mask, int A, int C, int B, int F,
                  int TS, int items, int WPS, float pmin, float pmcw,
                  float plam, float* __restrict__ out_score,
                  int* __restrict__ out_idx,
                  uint8_t* __restrict__ out_valid) {
  __shared__ float s_score[MAX_WARPS];
  __shared__ int s_idx[MAX_WARPS], s_ok[MAX_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = blockDim.x / (32 * WPS);      // slots of this block
  const int ls = warp / WPS, wi = warp - ls * WPS;
  const int a = blockIdx.x * S + ls;
  Best best;
  if (a < A) {
    const float* h = cum + (size_t)a * C * B * F;
    for (int it = wi; it < items; it += WPS) {
      const int fg = it / TS, ts = it - fg * TS;   // once an item
      const int f = fg * 32 + lane;
      if (f >= F) continue;
      const int t0 = ts * TCH;
      const int nt = min(TCH, B - 1 - t0);
      const bool m_ok = mask == nullptr || mask[(size_t)a * F + f] > 0.5f;
      scan_item<KIND>(h, f, t0, nt, C, B, F, m_ok, pmin, pmcw, plam, best);
    }
  }
  best.warp_reduce();
  if (lane == 0) {
    s_score[warp] = best.s;
    s_idx[warp] = best.i;
    s_ok[warp] = best.ok;
  }
  __syncthreads();
  if (wi != 0 || a >= A) return;
  // the slot's first warp merges its WPS warps' winners
  Best slot;
  if (lane < WPS) {
    slot.s = s_score[warp + lane];
    slot.i = s_idx[warp + lane];
    slot.ok = s_ok[warp + lane];
  }
  slot.warp_reduce();
  if (lane == 0) {
    out_score[a] = slot.s;
    out_idx[a] = slot.i;
    out_valid[a] = (uint8_t)slot.ok;
  }
}

}  // namespace

// cum [A, C, B, F] f32, mask [A, F] f32 or null; out_score [A] f32,
// out_idx [A] int32, out_valid [A] bool (one 0/1 byte each). kind:
// 0 variance, 1 gini, 2 xgb. Returns a cudaError_t.
extern "C" int split_scan_launch(const void* cum, const void* mask, int A,
                                 int C, int B, int F, int kind, float pmin,
                                 float pmcw, float plam, void* out_score,
                                 void* out_idx, void* out_valid,
                                 void* stream) {
  if (A < 1 || B < 2 || F < 1 || C < (kind == GINI ? 2 : 3) || kind < 0 ||
      kind > 2)
    return (int)cudaErrorInvalidValue;
  const int FG = (F + 31) / 32, TS = (B - 1 + TCH - 1) / TCH;
  const int items = FG * TS;
  const int WPS = items < MAX_WPS ? items : MAX_WPS;
  const int S = WPS < BLOCK_WARPS ? BLOCK_WARPS / WPS : 1;
  const dim3 grid((A + S - 1) / S), block(32 * S * WPS);
  cudaStream_t st = (cudaStream_t)stream;
#define SCAN_CASE(K)                                                         \
  case K:                                                                    \
    split_scan_kernel<K><<<grid, block, 0, st>>>(                            \
        (const float*)cum, (const float*)mask, A, C, B, F, TS, items, WPS,   \
        pmin, pmcw, plam, (float*)out_score, (int*)out_idx,                  \
        (uint8_t*)out_valid);                                                \
    break;
  switch (kind) { SCAN_CASE(VARIANCE) SCAN_CASE(GINI) SCAN_CASE(XGB) }
#undef SCAN_CASE
  return (int)cudaGetLastError();
}
