"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs
at first use, from the sources in this package only, into
``kernels/build/`` beside this file (listed in ``.gitignore``).  The
library's name carries a hash of the sources and flags, so an edited
source is rebuilt; the compiler writes to a temporary name that is then
``os.replace``d, so two processes building at once do not race.

``LAUNCHES`` counts kernel launches by wrapper name: each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that the
main path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("coach_kernels.cu",)
# never --use_fast_math: the wire fields must match the plain version
# bit for bit (IEEE division and rounding)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: collections.Counter = collections.Counter()

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: argument types, in order (see csrc/coach_kernels.cu)
_SIGNATURES = {
    "coach_fused_boundary": [_P] * 10 + [_I] * 6 + [_P],
    "coach_uaq_quantize": [_P] * 4 + [_I] * 4 + [_P],
    "coach_semantic_probe": [_P] * 6 + [_I] * 5 + [_P],
    "coach_uaq_dequantize": [_P] * 4 + [_I] * 4 + [_P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            path = str(cand)
    if path is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin or "
                           "/usr/local/cuda/bin): cannot build the CUDA kernels")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libcoach_kernels-{_digest()}.so"


def build(verbose: bool = False) -> Path:
    """Compile the sources unless a library built from them exists.
    Returns its path; the compiler's output (``-Xptxas -v``: registers,
    shared memory and spills per kernel) is kept beside it as ``.log``."""
    lib = library_path()
    log = lib.with_suffix(".log")
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *[str(CSRC / s) for s in SOURCES]]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                    f"{proc.stdout}{proc.stderr}")
            log.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    if verbose:
        print(log.read_text() if log.exists() else f"(no build log for {lib})")
    return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


# row passes: aim for about this many CTAs (4 per SM of an H100); a
# function of the shape only, so the GAP summation order is the same on
# every card
TARGET_CTAS = 528


def rows_per_cta(B: int, S: int) -> int:
    return max(1, -(-B * S // TARGET_CTAS))


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def on_cpu(t: torch.Tensor) -> bool:
    """True when ``t`` lies on the CPU, where a wrapper runs the plain
    version; False on CUDA, where it launches the kernel; raises for any
    other device."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tensor on {t.device}: the kernels run on CUDA "
                         f"and their plain versions on the CPU")
    return t.device.type == "cpu"


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
            device: torch.device) -> None:
    """Raise unless ``t`` is what the kernel takes: a contiguous tensor of
    ``dtype`` with ``ndim`` dims on the CUDA ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                        f"{dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}; the kernel "
                         f"takes {ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def check_bits(bits: int) -> None:
    if bits not in (4, 8):
        raise ValueError(f"bits={bits}: the wire kernels take int4 (packed) "
                         f"and int8")


def require_probe_inputs(x: torch.Tensor, centers: torch.Tensor):
    """Check the (B, S, D) activation and (L, D) centers a probe kernel
    takes; returns (B, S, D, L)."""
    require(x, "x", torch.float32, 3, x.device)
    require(centers, "centers", torch.float32, 2, x.device)
    B, S, D = x.shape
    L = centers.shape[0]
    if centers.shape[1] != D or L == 0 or B * S * D == 0 or B > 65535:
        raise ValueError(f"x {tuple(x.shape)} / centers "
                         f"{tuple(centers.shape)}: the kernel takes "
                         f"non-empty x, 1 <= B <= 65535, L >= 1 centers "
                         f"of width D")
    return B, S, D, L


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")
