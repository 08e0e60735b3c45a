// Level histogram of the tree engine, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of transmogrifai_tpu/models/_pallas_hist.py:
// cumhist (_kernel :160, _kernel_prebc :193; pl.pallas_call :347 and :368).
//
//   cum[s, c, t, f] = sum_i 1[node_i = s] * 1[bin_fi <= t] * bf16(stats_ic)
//
// One design for both entry points: the slot-grouped product of
// grouped_hist.cuh with M = B*F output rows (m = t*F + f), N = C channels
// padded to 8 and each slot's live rows (grouped by group_rows.cu) as K.
// They differ only in where the "bin <= t" indicator comes from:
//
// cumhist_launch (the fits' call): built per K-step from the gathered
// uint8 bins in shared memory, so each live row's bins are read once per
// call; the lower-triangular indicator makes the sums cumulative over
// bins.
//
// cumhist_bc_launch (bc=, the precomputed 0/1 indicator of make_bc; no fit
// passes it): read as it is from a per-fit row-major uint8 copy of bc,
// [n, B*F rounded up to 16], byte m = t*F + f, the way cumhist_sparse01.cu
// reads its 0/1 block. A live row costs its B*F bytes of indicator
// (640 at F = 20, B = 32) against its F bytes of bins, so this entry
// point is bound by the gathered rows' bytes.
//
// Determinism: fixed summation orders, no float atomics, so the weighted
// channels are bitwise reproducible run to run and split ties never flip.
// Counts are sums of exact 1.0 products in f32.
#include "grouped_hist.cuh"

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

// The same with rows [n, row_bytes] the 0/1 bin <= t bytes (byte t*F + f).
extern "C" int cumhist_bc_launch(const void* stats, const void* rows,
                                 const void* order, const void* seg_off,
                                 void* partial, void* out, int n, int C,
                                 int A, int B, int F, int row_bytes,
                                 int chunk, int n_chunks, void* stream) {
  return grouped::launch<grouped::PRECOMPUTED>(
      stats, rows, order, seg_off, partial, out, n, C, A, B * F, B * F, B,
      row_bytes, chunk, n_chunks, (cudaStream_t)stream);
}
