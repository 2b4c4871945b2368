"""A mamba2 block's projections at few rows on the card (K6): wrapper of
the hand-written kernels in ``csrc/ssd_proj.cu``.  ``ssd_in_proj`` takes
the block's five input projections (``in_z``, ``in_x``, ``in_B``,
``in_C``, ``in_dt``) in one launch, ``ssd_out_proj`` its ``out_proj`` in
another: fp32 products ``x @ w`` of at most ``MAX_ROWS`` rows against
(in, out) weights.

It replaces no Pallas kernel: the JAX package leaves these dots to XLA.
Its bound is the bytes of the weights: at up to 16 rows a weight element
takes part in at most 16 FMAs, so a call is bound by reading its weights
once (10.3 MB and 4.7 MB a mamba2-130m layer, 3.07 and 1.41 us at 3.35
TB/s).  The design: the rows of x sit in shared memory; each CTA streams
a tile of 8 or 16 columns of one weight into shared memory with
16-byte asynchronous copies, its whole tile in flight at once, and each
thread does a row's FMAs as soon as that row lands; the contraction is
split across the CTA's warps and their partial sums added in shared
memory in a fixed order, so a call repeats its bits (no atomics).  FMAs
in fp32, no TF32.

The plain version is the products themselves (``x @ w``), which the
wrapper runs on a CPU tensor; ``models.ssm.mamba_forward`` calls the
wrapper only for calls the kernels take (``models.ssm.proj_plain_reason``)
and runs ``layers.column`` and ``@`` otherwise.  On a CUDA tensor the
wrapper launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
import torch

from repro_torch.kernels import _build as KB

MAX_ROWS = 16  # rows of x (leading dims flattened) at most
MAX_WEIGHTS = 5  # weights a launch
# a CTA's shared memory holds the rows of x, padded to 16 rows at most,
# beside its threads' 48 KB of weight rows: an H100 CTA's 227 KB leave 16
# rows of this many elements
MAX_IN = (232448 - 48 * 1024) // (4 * MAX_ROWS) // 4 * 4


def takes(rows: int, width_in: int, widths) -> bool:
    """Whether the kernels take ``rows`` rows of ``width_in`` elements
    against weights of ``widths`` columns."""
    return (1 <= rows <= MAX_ROWS and 4 <= width_in <= MAX_IN
            and width_in % 4 == 0 and 1 <= len(widths) <= MAX_WEIGHTS
            and all(n >= 4 and n % 4 == 0 for n in widths))


def aligned(t: torch.Tensor) -> bool:
    """Whether ``t``'s data starts on 16 bytes, as the kernels' loads
    need."""
    return t.data_ptr() % 16 == 0


def ssd_in_proj(x: torch.Tensor, w_z: torch.Tensor, w_x: torch.Tensor,
                w_B: torch.Tensor, w_C: torch.Tensor, w_dt: torch.Tensor):
    """A mamba2 block's five input projections of x (..., d): z, xr, Br,
    Cr and dt, each (..., n) for its weight (d, n), in one launch."""
    return _project("ssd_in_proj", x, (w_z, w_x, w_B, w_C, w_dt))


def ssd_out_proj(g: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
    """``g @ w_out``: a mamba2 block's out_proj of the mixer's output g
    (..., di) against w_out (di, d)."""
    return _project("ssd_out_proj", g, (w_out,))[0]


def _project(name: str, x: torch.Tensor, ws):
    """``x @ w`` for each w of ``ws`` in one launch of the kernel, counted
    under ``name``."""
    if KB.on_cpu(x):
        return tuple(x @ w for w in ws)
    dev = x.device
    KB.require(x, "x", torch.float32, x.dim(), dev)
    K = x.shape[-1]
    lead = tuple(x.shape[:-1])
    M = math.prod(lead)
    for i, w in enumerate(ws):
        KB.require(w, f"weight {i}", torch.float32, 2, dev)
        if w.shape[0] != K:
            raise ValueError(f"weight {i} has shape {tuple(w.shape)}; x has "
                             f"{K} columns")
    widths = [w.shape[1] for w in ws]
    if not takes(M, K, widths):
        raise ValueError(f"x {tuple(x.shape)} against widths {widths}: the "
                         f"kernel takes 1 to {MAX_ROWS} rows, 4 to {MAX_IN} "
                         f"inputs and up to {MAX_WEIGHTS} weights, every "
                         f"width a multiple of 4")
    if not all(aligned(t) for t in (x, *ws)):
        raise ValueError("x and the weights must start on 16 bytes")
    outs = [torch.empty(lead + (n,), dtype=torch.float32, device=dev)
            for n in widths]
    nw = len(ws)
    with torch.cuda.device(dev):
        err = KB.lib().coach_ssd_proj(
            x.data_ptr(), (ctypes.c_void_p * nw)(*(w.data_ptr() for w in ws)),
            (ctypes.c_void_p * nw)(*(o.data_ptr() for o in outs)),
            (ctypes.c_int * nw)(*widths), nw, M, K, KB.stream_of(x))
    KB.check(err, name)
    KB.LAUNCHES[name] += 1
    return tuple(outs)
