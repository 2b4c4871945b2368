// Row-pass kernels (K1) for float32 activations, 16-byte loads.
#include "row_pass.cuh"

COACH_ROWS(coach_rows_f32) {
  return rows_entry<float, Elem<float>::kVec>(a, bits, st);
}
