"""The whole training step's share of the chip: the model's FLOPs over the
window's epochs (everything before the message passing, the message
passing and the classifier, forward and backward, over valid edges and
the nodes they touch; ``harness.work``) over the window's time at the
float32-accurate tensor-core rate."""

from harness.peaks import MATMUL_FLOPS_PER_S


def read(v):
    if "model_flops" not in v.work or v.trace["window_s"] <= 0:
        return None
    return 100.0 * v.work["model_flops"] / (v.trace["window_s"] * MATMUL_FLOPS_PER_S)
