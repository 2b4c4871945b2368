#!/usr/bin/env python3
"""Check the quantize's division against IEEE division on the card.

  python3 tools/check_division.py

The row-pass kernels (``csrc/common.cuh``, ``quant1``) take x / scale as
q0 = RN(x * r) with r = RN(1 / scale), then two FMA corrections
q = RN(q + (x - scale * q) * r), instead of ``__fdiv_rn``.  This script
runs that formula beside ``__fdiv_rn`` for every mantissa of the divisor
(scale in [1, 2); the result scales with powers of two) against 8192
pseudo-random numerators each, signed, with exponents from 2^-24 to 2^3,
and prints how many quotients differ, for one and for two corrections.
It imports nothing of the repository; it needs nvcc and a CUDA device.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void check(unsigned long long* bad, unsigned seed, int n) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  const float sc = __uint_as_float(0x3f800000u | (i & 0x7fffffu));
  const float r = __frcp_rn(sc);
  unsigned h = i * 2654435761u ^ seed;
  unsigned one = 0, two = 0;
  for (int k = 0; k < n; ++k) {
    h ^= h << 13;
    h ^= h >> 17;
    h ^= h << 5;
    const unsigned e = 103u + (h >> 27) % 27u;
    const float v = __uint_as_float(((h & 1u) << 31) | (e << 23) |
                                    ((h >> 4) & 0x7fffffu));
    const float q0 = __fmul_rn(v, r);
    const float q1 = __fmaf_rn(__fmaf_rn(-q0, sc, v), r, q0);
    const float q2 = __fmaf_rn(__fmaf_rn(-q1, sc, v), r, q1);
    const unsigned want = __float_as_uint(__fdiv_rn(v, sc));
    one += __float_as_uint(q1) != want;
    two += __float_as_uint(q2) != want;
  }
  atomicAdd(&bad[0], (unsigned long long)one);
  atomicAdd(&bad[1], (unsigned long long)two);
}

// counts[0], counts[1]: quotients differing after one and two corrections
extern "C" int run(unsigned seed, int n, unsigned long long* counts) {
  unsigned long long* d = nullptr;
  cudaError_t e = cudaMalloc(&d, 16);
  if (e == cudaSuccess) e = cudaMemset(d, 0, 16);
  if (e == cudaSuccess) {
    check<<<(1 << 23) / 256, 256>>>(d, seed, n);
    e = cudaMemcpy(counts, d, 16, cudaMemcpyDeviceToHost);
  }
  cudaFree(d);
  return (int)e;
}
"""

N_PER_SEED = 1024
SEEDS = 8


def main() -> int:
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = os.path.join(tmp, "d.cu"), os.path.join(tmp, "d.so")
        with open(cu, "w") as f:
            f.write(SRC)
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", so, cu],
                       check=True)
        lib = ctypes.CDLL(so)
        lib.run.restype = ctypes.c_int
        lib.run.argtypes = [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p]
        one = two = 0
        counts = (ctypes.c_ulonglong * 2)()
        for seed in range(SEEDS):
            err = lib.run(seed * 7919 + 1, N_PER_SEED, counts)
            if err != 0:
                print(f"CUDA error {err}", file=sys.stderr)
                return 2
            one += counts[0]
            two += counts[1]
    pairs = SEEDS * (1 << 23) * N_PER_SEED
    print(f"{pairs:.3e} (x, scale) pairs: quotients differing from "
          f"__fdiv_rn: {one} after one correction, {two} after two")
    return 0 if two == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
