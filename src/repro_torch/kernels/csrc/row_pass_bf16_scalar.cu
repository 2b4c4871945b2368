// Row-pass kernels (K1) for bfloat16 activations, one element a
// load (odd widths, unaligned rows).
#include "row_pass.cuh"

COACH_ROWS(coach_rows_bf16_scalar) {
  return rows_entry<__nv_bfloat16, 1>(a, bits, st);
}
