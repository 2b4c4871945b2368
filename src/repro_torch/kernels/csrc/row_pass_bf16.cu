// Row-pass kernels (K1) for bfloat16 activations, 16-byte loads.
#include "row_pass.cuh"

COACH_ROWS(coach_rows_bf16) {
  return rows_entry<__nv_bfloat16, Elem<__nv_bfloat16>::kVec>(a, bits, st);
}
