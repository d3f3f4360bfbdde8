"""The card's published peaks, the one place they are written.

NVIDIA H100 SXM data sheet, dense rates, at its 700 W power limit. The
port's products are float32-accurate on the tensor cores by 3xTF32 (three
TF32 products per float32 one), so a model's or a kernel's share of the
chip counts its FLOPs against TF32's rate over three. Every traced run
prints the card's name and power limit before its result.
"""

TF32_FLOPS_PER_S = 495e12
MATMUL_FLOPS_PER_S = TF32_FLOPS_PER_S / 3
HBM_BYTES_PER_S = 3.35e12
