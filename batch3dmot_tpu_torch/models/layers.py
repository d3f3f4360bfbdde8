"""Shared layers: MLPs, single-token attention, eval-mode batch norm, and
seeded parameter initialisation (counterpart of
``batch3dmot_tpu/models/layers.py``)."""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class MLP(nn.Sequential):
    """Linear stack with ReLU between layers, never after the last.

    An ``nn.Sequential`` so the state-dict keys (``0.weight``, ``2.weight``,
    ...) are those of the upstream ``nn.Sequential(Linear, ReLU, ...)``
    blocks."""

    def __init__(self, in_features: int, features: Sequence[int]):
        layers = []
        for i, f in enumerate(features):
            layers.append(nn.Linear(in_features, f))
            if i < len(features) - 1:
                layers.append(nn.ReLU())
            in_features = f
        super().__init__(*layers)


class SingleTokenAttention(nn.Module):
    """Cross-edge modality attention over one key/value token.

    Softmax over a single key is 1 for every head, so the block reduces to
    the value and output projections: ``(x @ Wv + bv) @ Wo + bo``. The
    parameters keep ``nn.MultiheadAttention``'s names and shapes
    (``in_proj_weight`` stays whole, [3D, D]) so upstream state dicts load
    as they are; only its value slice is read."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, value: torch.Tensor) -> torch.Tensor:
        d = self.dim
        v = F.linear(value, self.in_proj_weight[2 * d:], self.in_proj_bias[2 * d:])
        return self.out_proj(v)


def batch_norm_eval(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """Batch norm with the running statistics, whatever the module's mode
    (the encoders are frozen feature extractors). Channels on dim 1."""
    return F.batch_norm(
        x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
        training=False, eps=bn.eps,
    )


def batch_norm_last(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """:func:`batch_norm_eval` for channels-last [..., C] activations."""
    c = x.shape[-1]
    return batch_norm_eval(bn, x.reshape(-1, c)).reshape(x.shape)


@torch.no_grad()
def init_params_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter with seeded random values: U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) for weights and biases, batch-norm affine (1, 0) and
    running statistics (0, 1). The same seed gives the same weights."""
    for mod in module.modules():
        if isinstance(mod, nn.modules.batchnorm._BatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
            continue
        for name, p in mod.named_parameters(recurse=False):
            if isinstance(mod, SingleTokenAttention):
                fan_in = mod.dim
            elif p.dim() > 1:
                fan_in = p[0].numel()
            else:
                weight = getattr(mod, "weight", None)
                fan_in = weight[0].numel() if weight is not None else p.numel()
            bound = 1.0 / math.sqrt(fan_in)
            u = torch.rand(p.shape, generator=generator, dtype=torch.float32)
            p.copy_((u * 2.0 - 1.0) * bound)
    return module
