"""Share of the fused training pair's roofline (B4-B7): the least time its
work needs (``harness.work.train_work`` over the window's epochs, at the
float32-accurate tensor-core rate or the memory rate) over the device time
of the kernels that ``csrc/fused_mp.cu`` and ``csrc/fused_mp_train.cu``
declare (the training forward runs the inference file's kernels)."""

from harness.trace import seconds_of, source_kernels
from harness.work import bound_s


def read(v):
    names = source_kernels(v.csrc, "fused_mp.cu") | source_kernels(v.csrc, "fused_mp_train.cu")
    t = seconds_of(v.trace["kernel_s"], names)
    if t <= 0 or "train_mp" not in v.work:
        return None
    return 100.0 * bound_s(*v.work["train_mp"]) / t
