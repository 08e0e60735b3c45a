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
// in the row-major uint8 copy [n, RB] made once per fit, whose byte Fb is
// an all-ones column: the slot-grouped product of grouped_hist.cuh with
// M = Fb + 1 output rows (the last gives tot, in the same summation order
// as nz), N = C channels padded to 8 and each slot's live rows as K. The
// reduce pass forms tot - nz.
//
// What bounds it: bytes. At the slice's shapes (n = 1.6e5-2e5 rows,
// Fb = 420-512 columns at a few percent density) the function's own work
// is the f32 adds of the live ones, ~1e7, against the live rows' ~1e8
// bytes of block. This design still multiplies the block's zeros on the
// tensor cores (Fb + 1 rows x 8 channels a live row); skipping zero tiles
// is left open.
//
// Counts equal the generic kernel's at B = 2 bit for bit (sums of exact
// 1.0 products in f32).
#include "grouped_hist.cuh"

// stats [n, C] f32, rows [n, row_bytes] uint8 (0/1, byte Fb = 1),
// order/seg_off from group_rows; partial [n_chunks + A, C, Fb + 1] f32
// scratch; out [A, C, 2, Fb].
extern "C" int cumhist_sparse01_launch(const void* stats, const void* rows,
                                       const void* order, const void* seg_off,
                                       void* partial, void* out, int n, int C,
                                       int A, int Fb, int row_bytes, int chunk,
                                       int n_chunks, void* stream) {
  return grouped::launch<grouped::SPARSE01>(
      stats, rows, order, seg_off, partial, out, n, C, A, Fb + 1, Fb, 2,
      row_bytes, chunk, n_chunks, (cudaStream_t)stream);
}
