"""batch3dmot_tpu_torch: the PyTorch + CUDA port of batch3dmot_tpu.

Offline 3D multi-object tracking with a time-aware message-passing GNN and
cross-edge modality attention, written for one NVIDIA Hopper GPU. The
module layout mirrors ``batch3dmot_tpu``; the JAX package stays the
reference and the tests hold each part of this one against it.

The inference and training entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; without a GPU they raise instead of running on the
CPU.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the GPU, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def prepare_model(model: torch.nn.Module, device=None):
    """Move ``model`` to ``device`` (None: the GPU) and return it with the
    device. On the GPU, float32 products are held to float32: cuDNN runs
    f32 convolutions in TF32 (about three decimal digits) unless told
    otherwise, and f32 matmuls stay off TF32 (PyTorch's default, kept)."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return model.to(device), device


def upload(a, device: torch.device) -> torch.Tensor:
    """The numpy array ``a`` on ``device``: on the GPU through pinned memory
    without waiting for the card."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
