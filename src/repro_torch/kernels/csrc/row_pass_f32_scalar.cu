// Row-pass kernels (K1) for float32 activations, one element a
// load (odd widths, unaligned rows).
#include "row_pass.cuh"

COACH_ROWS(coach_rows_f32_scalar) {
  return rows_entry<float, 1>(a, bits, st);
}
