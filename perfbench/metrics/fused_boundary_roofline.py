"""K1 ``fused_boundary`` (its ``row_pass_kernel``): the least time of one
call at its shape (the driver's ``rows`` of ``d_model`` channels, read
``act_bytes`` an element; bytes over the HBM rate, or fp32 operations
over the peak, ``harness/work.py``) over its device time a call in the
profiled stretch, %."""

from perfbench.harness.trace import kernel_time
from perfbench.harness.work import roofline_s


def read(run):
    if run.trace is None:
        return None
    kt = kernel_time(run.trace, "row_pass_kernel")
    if kt is None or kt[1] == 0:
        return None
    seconds, calls = kt
    bound = roofline_s("fused_boundary", 1, run.rows, run.d_model,
                       run.traced_centers, run.wire_bits, run.act_bytes)
    return 100.0 * bound / (seconds / calls)
