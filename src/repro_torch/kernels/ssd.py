"""The mamba2 SSD mixer on the card (K5): wrapper of the hand-written
kernels in ``csrc/ssd_mixer.cu``.  They replace the plain chain of
``models/ssm.py`` between a mamba2 block's five input projections and its
``out_proj`` (the causal convs over x, B and C, softplus, the chunked SSD
scan, the D skip and the gated RMS norm): ``ssd_prep``, ``ssd_chunk`` and
``gated_rmsnorm`` a call, and ``ssd_state`` between the last two where a
state is carried between chunks, given or returned.

It replaces no Pallas kernel: the JAX package leaves that chain to XLA,
which fuses it, while the port ran it as one ATen kernel an op.  Its plain
version is the chain itself (``models.ssm.mixer_plain``): ``mamba_forward``
calls this wrapper only for inputs it takes (``models.ssm.plain_reason``)
and runs the chain otherwise.  On a CUDA tensor the wrapper launches the
kernels or raises; it takes no CPU tensor.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build as KB

# what the kernels are built for (csrc/ssd_mixer.cu's kP, kN, kMaxQ, kMaxK)
HEAD_DIM = 64  # P
STATE = 128  # N
MAX_CHUNK = 256  # Q = min(ssm_chunk, S) at most
MAX_CONV = 8  # conv taps at most
# a block's parameters that the kernels read in the activations' type, in
# the entry point's order
TYPED_PARAMS = ("conv_x", "conv_B", "conv_C", "conv_bx", "conv_bB",
                "conv_bC", "norm_scale")
HEAD_PARAMS = ("A_log", "D", "dt_bias")  # float32, one a head


def takes_shape(B: int, S: int, P: int, N: int, K: int, chunk: int) -> bool:
    """Whether the kernels take a call of B rows of S tokens, head dim P,
    state N, K conv taps and chunks of ``chunk`` steps."""
    if B < 1 or S < 1 or chunk < 1:
        return False
    return ((P, N) == (HEAD_DIM, STATE) and 1 <= K <= MAX_CONV
            and min(chunk, S) <= MAX_CHUNK)


def _param_shapes(K: int, di: int, H: int) -> dict:
    return {"conv_x": (K, di), "conv_B": (K, STATE), "conv_C": (K, STATE),
            "conv_bx": (di,), "conv_bB": (STATE,), "conv_bC": (STATE,),
            "norm_scale": (di,), "A_log": (H,), "D": (H,), "dt_bias": (H,)}


def _require_shape(t: torch.Tensor, name: str, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def ssd_mixer(z: torch.Tensor, xr: torch.Tensor, Br: torch.Tensor,
              Cr: torch.Tensor, dt: torch.Tensor, params: dict, *,
              chunk: int, eps: float, h0: Optional[torch.Tensor] = None,
              want_state: bool = False):
    """A mamba2 block's mixer from its projections' outputs: z, xr (B,S,di),
    Br, Cr (B,S,128), the raw dt (B,S,H), di = 64 H, all of one type
    (float32, bfloat16 or float16), and the block's ``params`` (the conv
    weights (K,.) and biases and ``norm_scale`` of that type, ``A_log``,
    ``D``, ``dt_bias`` float32).  Returns the input of ``out_proj``
    (B,S,di) and the final state (B,H,64,128), or None unless there is
    more than one chunk of ``chunk`` steps, ``h0`` (B,H,64,128) is given
    or ``want_state``; both of the activations' type."""
    if KB.on_cpu(xr):
        raise ValueError("the SSD mixer kernels take CUDA tensors; "
                         "models.ssm runs the plain chain on the CPU")
    dev, dtype = xr.device, xr.dtype
    if dtype not in KB.DTYPE_CODES:
        raise TypeError(f"xr has dtype {dtype}; the kernels take float32, "
                        f"bfloat16 or float16")
    KB.require(xr, "xr", dtype, 3, dev)
    B, S, di = xr.shape
    KB.require(dt, "dt", dtype, 3, dev)
    H = dt.shape[2]
    K = params["conv_x"].shape[0]
    if (H < 1 or di != HEAD_DIM * H
            or not takes_shape(B, S, HEAD_DIM, STATE, K, chunk)):
        raise ValueError(f"xr {tuple(xr.shape)}, dt {tuple(dt.shape)}, "
                         f"{K} conv taps, chunk {chunk}: the kernels take "
                         f"head dim {HEAD_DIM}, 1 to {MAX_CONV} taps and "
                         f"chunks of at most {MAX_CHUNK} steps")
    for name, t, shape in (("z", z, (B, S, di)), ("Br", Br, (B, S, STATE)),
                           ("Cr", Cr, (B, S, STATE)), ("dt", dt, (B, S, H))):
        KB.require(t, name, dtype, 3, dev)
        _require_shape(t, name, shape)
    for name, shape in _param_shapes(K, di, H).items():
        t = params[name]
        KB.require(t, name, dtype if name in TYPED_PARAMS else torch.float32,
                   len(shape), dev)
        _require_shape(t, name, shape)
    if h0 is not None:
        KB.require(h0, "h0", dtype, 4, dev)
        _require_shape(h0, "h0", (B, H, HEAD_DIM, STATE))
    Q = min(chunk, S)
    nc = -(-S // Q)
    Sp = nc * Q
    state = nc > 1 or h0 is not None or want_state
    # fp32 workspaces, one allocation: xs, B, C (B,Sp,.), y (B,S,di), C.B^T
    # (B,nc,Q,Q), dt and the cumsum (B,H,Sp)
    sizes = (B * Sp * di, B * Sp * STATE, B * Sp * STATE, B * S * di,
             B * nc * Q * Q, B * H * Sp, B * H * Sp)
    ws = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    ptrs, at = [], ws.data_ptr()
    for n in sizes:
        ptrs.append(at)
        at += 4 * n
    out = torch.empty((B, S, di), dtype=dtype, device=dev)
    hT = torch.empty((B, H, HEAD_DIM, STATE), dtype=dtype,
                     device=dev) if state else None
    xs, bs, cs, y, cb, dts, cum = ptrs
    with torch.cuda.device(dev):
        err = KB.lib().coach_ssd_mixer(
            z.data_ptr(), xr.data_ptr(), Br.data_ptr(), Cr.data_ptr(),
            dt.data_ptr(),
            *(params[n].data_ptr() for n in TYPED_PARAMS + HEAD_PARAMS),
            None if h0 is None else h0.data_ptr(),
            xs, bs, cs, dts, cum, cb, y, out.data_ptr(),
            None if hT is None else hT.data_ptr(),
            B, S, Q, H, K, int(state), KB.DTYPE_CODES[dtype],
            ctypes.c_float(eps), KB.stream_of(xr))
    KB.check(err, "ssd_mixer")
    for name in ("ssd_prep", "ssd_chunk") + (("ssd_state",) if state
                                             else ()) + ("gated_rmsnorm",):
        KB.LAUNCHES[name] += 1
    return out, hT
