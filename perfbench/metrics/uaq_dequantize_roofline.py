"""K2 ``uaq_dequantize`` (``dequant_kernel``): the least time of one
call at its shape (the driver's ``rows`` of ``d_model`` channels, its
output ``act_bytes`` an element; ``harness/work.py``) over its device
time a call in the profiled stretch, %."""

from perfbench.harness.trace import kernel_time
from perfbench.harness.work import roofline_s


def read(run):
    if run.trace is None:
        return None
    kt = kernel_time(run.trace, "dequant_kernel")
    if kt is None or kt[1] == 0:
        return None
    seconds, calls = kt
    bound = roofline_s("uaq_dequantize", 1, run.rows, run.d_model, 0,
                       run.wire_bits, run.act_bytes)
    return 100.0 * bound / (seconds / calls)
