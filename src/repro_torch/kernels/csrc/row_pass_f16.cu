// Row-pass kernels (K1) for float16 activations, 16-byte loads.
#include "row_pass.cuh"

COACH_ROWS(coach_rows_f16) {
  return rows_entry<__half, Elem<__half>::kVec>(a, bits, st);
}
