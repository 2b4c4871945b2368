"""Uniform Affine Quantization (UAQ) of intermediate tensors [34] and
accuracy oracles for the dichotomous precision search (Eq. 1), in
PyTorch, mirroring ``repro.core.quant``.

``uaq_quantize``/``uaq_dequantize`` are the plain tensor semantics; the
Hopper kernels in ``repro_torch.kernels.uaq`` implement the same math
row-wise (held to ``kernels/ref.py`` in the tests).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def uaq_params(x: torch.Tensor, bits: int,
               axis=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor (axis=None) or per-axis scale/zero-point."""
    qmax = (1 << bits) - 1
    if axis is None:
        lo = torch.amin(x)
        hi = torch.amax(x)
    else:
        red = tuple(i for i in range(x.ndim) if i != axis % x.ndim)
        lo = torch.amin(x, dim=red, keepdim=True)
        hi = torch.amax(x, dim=red, keepdim=True)
    scale = torch.clamp(hi - lo, min=1e-8) / qmax
    zp = torch.round(-lo / scale)
    return scale.to(torch.float32), zp.to(torch.float32)


def uaq_quantize(x: torch.Tensor, bits: int, axis=None):
    scale, zp = uaq_params(x, bits, axis)
    qmax = (1 << bits) - 1
    q = torch.clamp(torch.round(x / scale + zp), 0, qmax)
    return q.to(torch.uint8 if bits <= 8 else torch.uint16), scale, zp


def uaq_dequantize(q, scale, zp):
    return (q.to(torch.float32) - zp) * scale


def uaq_roundtrip(x: torch.Tensor, bits: int, axis=None):
    q, s, z = uaq_quantize(x, bits, axis)
    return uaq_dequantize(q, s, z).to(x.dtype)


def quant_error(x: torch.Tensor, bits: int) -> float:
    """Relative L2 error of the UAQ roundtrip."""
    y = uaq_roundtrip(x, bits)
    return float(torch.linalg.vector_norm((x - y).ravel())
                 / (torch.linalg.vector_norm(x.ravel()) + 1e-12))


# ------------------------------------------------------- measured oracle
def measured_acc_oracle(apply_tail: Callable, calib_inputs, calib_labels,
                        base_acc: float) -> Callable[[int], float]:
    """Accuracy-loss oracle measured on a calibration set: quantize the
    intermediate activation, run the remaining model (``apply_tail``), and
    compare top-1 accuracy against ``base_acc``.  Used with small real
    models in examples/tests; big configs use the analytic proxy."""

    def loss(bits: int) -> float:
        xq = uaq_roundtrip(calib_inputs, bits)
        logits = apply_tail(xq)
        acc = float(torch.mean(
            (torch.argmax(logits, -1) == calib_labels).to(torch.float32)))
        return max(0.0, base_acc - acc)

    return loss


def packed_bytes(n_elems: int, bits: int) -> int:
    """Wire bytes for n_elems UAQ values plus per-tensor scale/zp."""
    return (n_elems * bits + 7) // 8 + 8
