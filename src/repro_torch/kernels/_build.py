"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``: one ``nvcc -c``
per source, all started together, then one link.  The build runs at first
use, from the sources in this package only, into ``kernels/build/``
beside this file (listed in ``.gitignore``).  The library's name carries
a hash of the sources, headers and flags, so an edited source is rebuilt;
the linker writes to a temporary name that is then ``os.replace``d, so two
processes building at once do not race.

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
SOURCES = ("coach_kernels.cu", "uaq_quantize.cu", "semantic_probe.cu",
           "row_pass_f32.cu", "row_pass_bf16.cu", "row_pass_f16.cu",
           "row_pass_f32_scalar.cu", "row_pass_bf16_scalar.cu",
           "row_pass_f16_scalar.cu", "ssd_mixer.cu", "ssd_proj.cu")
HEADERS = ("common.cuh", "row_pass.cuh")
# never --use_fast_math: the wire fields must match the plain version
# bit for bit (IEEE division and rounding)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: collections.Counter = collections.Counter()

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: argument types, in order (see csrc/coach_kernels.cu,
# csrc/ssd_mixer.cu and csrc/ssd_proj.cu)
_SIGNATURES = {
    "coach_fused_boundary": [_P] * 11 + [_I] * 8 + [_P],
    "coach_uaq_quantize": [_P] * 4 + [_I] * 5 + [_P],
    "coach_semantic_probe": [_P] * 5 + [_I] * 5 + [_P],
    "coach_uaq_dequantize": [_P] * 4 + [_I] * 5 + [_P],
    "coach_capture_id": [_P, _P],
    "coach_ssd_mixer": [_P] * 25 + [_I] * 7 + [ctypes.c_float, _P],
    "coach_ssd_proj": [_P] * 4 + [_I] * 3 + [_P],
}
# element types the kernels read (activations) and write (dequantized
# values), by the code the entry points take (enum DType in the source)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
ACTIVATION_DTYPES = tuple(DTYPE_CODES)

_lock = threading.Lock()
_lib = None
_counters: dict = {}


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
    for name in SOURCES + HEADERS:
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
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            nvcc = _nvcc()
            objs = [os.path.join(tmp, f"{Path(s).stem}.o") for s in SOURCES]
            cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(CSRC / s)]
                    for s, o in zip(SOURCES, objs)]
            procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for c in cmds]
            outs = [p.communicate()[0] for p in procs]
            link = [nvcc, *NVCC_FLAGS, "-shared", "-o",
                    os.path.join(tmp, "lib.so"), *objs]
            for cmd, proc, out in zip(cmds, procs, outs):
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                       f"{' '.join(cmd)}\n{out}")
            proc = subprocess.run(link, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(link)}\n{proc.stdout}"
                                   f"{proc.stderr}")
            log.write_text("".join(outs))
            os.replace(os.path.join(tmp, "lib.so"), lib)
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


# the fused boundary's row pass: CTAs of ROW_WARPS warps; a lane holds LANE_ELEMS elements of
# a row, so a row takes a group of 1, 2 or 4 warps (MAX_ROW elements at
# most).  Few rows get whole groups of 4 warps each, so the card still
# has about TARGET_WARPS warps of work.  Each batch row's S rows are dealt
# out to at most TARGET_CTAS // B CTAs, at least a row per group: one
# wave of 2 CTAs on each of an H100's 132 SMs when it can (registers allow
# 3, but 2 measured faster at (8, 4096, 2304): fewer partial rows for the
# probe epilogue).  A function of the shape only, so the GAP summation
# order is the same on every card.
ROW_WARPS = 4
LANE_ELEMS = 72
MAX_ROW = ROW_WARPS * 32 * LANE_ELEMS
TARGET_CTAS = 2 * 132
TARGET_WARPS = ROW_WARPS * TARGET_CTAS


def launch_shape(B: int, S: int, D: int):
    """(rows per CTA, warps per row) of a row pass over (B, S, D)."""
    wpr = 1
    while wpr * 32 * LANE_ELEMS < D:
        wpr *= 2
    while wpr < ROW_WARPS and B * S * wpr < TARGET_WARPS:
        wpr *= 2
    chunks = max(1, TARGET_CTAS // B)  # CTAs per batch row
    return max(ROW_WARPS // wpr, -(-S // chunks)), wpr


def check_row_width(n: int) -> None:
    if n > MAX_ROW:
        raise ValueError(f"rows of {n} elements: the boundary kernels take "
                         f"at most {MAX_ROW}")


# the quantize (csrc/uaq_quantize.cu): a CTA a row and the row in its
# registers, at most LANE_CAP elements a thread, so rows of up to 4096
# elements take a warp, 8192 two, MAX_ROW four.  While the grid stays
# within FEW_WARPS warps, a row gets more warps, until a thread holds at
# most LANE_FEW elements: with few rows the chain of one row's steps is
# the time, and more warps shorten its per-thread part (8 rows of 4096:
# 4.05 us at 1 warp a row, 2.11 at 8; 256 rows of 2304: 2.48 us at 4,
# 3.42 at 8; 1024 rows: 4.37 at 1, 5.51 at 2; H100,
# tools/time_boundary_kernels.py --sweep).  Rows
# are independent, so the shape picks the speed only, never the bits.
LANE_CAP = 128
LANE_FEW = 12
SMS = 132  # an H100's SMs
FEW_WARPS = 8 * SMS


def quantize_warps(M: int, N: int) -> int:
    """Warps a row (and a CTA) of a quantize launch over (M, N)."""
    warps = 1
    while 32 * warps * LANE_CAP < N:
        warps *= 2
    while (warps < 8 and 32 * warps * LANE_FEW < N
           and 2 * warps * M <= FEW_WARPS):
        warps *= 2
    return warps


def arrival_counters(t: torch.Tensor, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 arrival counters for a fused boundary
    launch on ``t``'s device and current stream.  The kernel leaves them at 0 when
    it ends, so a buffer serves, without a fill, every launch ordered
    after its first one:
      * outside a CUDA-graph capture, one buffer per (device, stream),
        filled when it is made;
      * inside a capture, one buffer per capture, made inside it, so its
        fill is a node of that graph ahead of the graph's launches: every
        replay starts from zeros, and no other graph shares it (graphs
        captured one after another on one stream may be replayed in any
        order, or at once on different streams).
    Only the newest capture's buffer is kept here per (device, stream);
    an older one stays in its graph's private memory pool, under torch's
    rule for any memory there (graphs that share a pool are not replayed
    at once)."""
    stream = stream_of(t)
    capture = capture_id(stream)
    key = (t.device.index, stream)
    with _lock:
        held = _counters.get(key, {})
        buf = held.get(capture)
        if buf is None or buf.numel() < n:
            buf = torch.zeros(max(n, 64), dtype=torch.int32, device=t.device)
            held = {c: b for c, b in held.items() if c in (0, capture)}
            held[capture] = buf
            _counters[key] = held
    return buf


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def capture_id(stream: int) -> int:
    """The id of the CUDA-graph capture under way on ``stream``, or 0."""
    cid = ctypes.c_ulonglong(0)
    check(lib().coach_capture_id(stream, ctypes.byref(cid)), "capture_id")
    return cid.value


def on_cpu(t: torch.Tensor) -> bool:
    """True when ``t`` lies on the CPU, where a wrapper runs the plain
    version; False on CUDA, where it launches the kernel; raises for any
    other device."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tensor on {t.device}: the kernels run on CUDA "
                         f"and their plain versions on the CPU")
    return t.device.type == "cpu"


def require(t: torch.Tensor, name: str, dtype, ndim: int,
            device: torch.device) -> None:
    """Raise unless ``t`` is what the kernel takes: a contiguous tensor of
    ``dtype`` (one dtype or a tuple of them) with ``ndim`` dims on the
    CUDA ``device``."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                        f"{' or '.join(str(d) for d in dtypes)}")
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
    """Check the (B, S, D) activation (float32, bfloat16 or float16) and
    float32 (L, D) centers a probe kernel takes; returns (B, S, D, L)."""
    require(x, "x", ACTIVATION_DTYPES, 3, x.device)
    require(centers, "centers", torch.float32, 2, x.device)
    B, S, D = x.shape
    L = centers.shape[0]
    if centers.shape[1] != D or L == 0 or B * S * D == 0 or B > 65535:
        raise ValueError(f"x {tuple(x.shape)} / centers "
                         f"{tuple(centers.shape)}: the kernel takes "
                         f"non-empty x, 1 <= B <= 65535, L >= 1 centers "
                         f"of width D")
    check_row_width(D)
    return B, S, D, L


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")
