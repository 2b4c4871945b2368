// Row-pass kernels (K1) for float16 activations, one element a
// load (odd widths, unaligned rows).
#include "row_pass.cuh"

COACH_ROWS(coach_rows_f16_scalar) {
  return rows_entry<__half, 1>(a, bits, st);
}
