"""Bytes and fp32 operations of one boundary-kernel call, from its
shapes: a frozen copy of ``chip_smoke.work()``, and the card's peaks."""

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_FP32_FLOPS = 67e12      # fp32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12     # bytes/s
# a model's products in the configuration's dtype: fp32 outside the
# tensor cores (TF32 off), bf16 on them
PEAK_FLOPS = {"float32": PEAK_FP32_FLOPS, "bfloat16": 989.4e12}


def work(name, B, S, D, L, bits, act=4):
    """(bytes moved, fp32 operations) of one call: each input read once,
    each output written once, an activation ``act`` bytes an element (4
    in fp32, 2 in bf16); ~7 operations per element for the quantize
    (min, max, divide, add, round, 2 clamps), 1 for the GAP add, 2 for
    dequantize, and 4 per center element for the probe's norms and dots."""
    n = B * S * D
    P = (D + 1) // 2 if bits == 4 else D
    wire = B * S * (P + 8)
    probe_out = B * (4 + 4 + 4 * L)
    probe_ops = 4 * L * D * B
    if name == "fused_boundary":
        return (act * n + 4 * L * D + wire + 4 * B * D + probe_out,
                8 * n + probe_ops)
    if name == "uaq_quantize":
        return act * n + wire, 7 * n
    if name == "uaq_dequantize":
        return wire + act * n, 2 * n
    return act * n + 4 * L * D + probe_out, n + probe_ops  # semantic_probe


def roofline_s(name, B, S, D, L, bits, act=4):
    """The least time one call can take on the card: the larger of its
    bytes over the HBM rate and its operations over the fp32 peak."""
    nbytes, ops = work(name, B, S, D, L, bits, act)
    return max(nbytes / PEAK_HBM_BYTES, ops / PEAK_FP32_FLOPS)
