"""Share of the segment sum's roofline (B8, the backward of the attention
rows' gathers in a training step): the least time of its work
(``harness.work.segment_work``, bound by bytes) over the device time of
the kernels that ``csrc/segment_sum.cu`` declares."""

from harness.trace import seconds_of, source_kernels
from harness.work import bound_s


def read(v):
    t = seconds_of(v.trace["kernel_s"], source_kernels(v.csrc, "segment_sum.cu"))
    if t <= 0 or "segment_sum" not in v.work:
        return None
    return 100.0 * bound_s(*v.work["segment_sum"]) / t
