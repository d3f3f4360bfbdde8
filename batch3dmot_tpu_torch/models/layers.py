"""Shared layers: MLPs, single-token attention, the kNN graph attention
convolution, batch norm in both modes, and seeded parameter initialisation
(counterpart of ``batch3dmot_tpu/models/layers.py``)."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from batch3dmot_tpu_torch.ops.segment import gather_rows, segment_softmax, segment_sum
from batch3dmot_tpu_torch.parallel.mesh import active_mesh, all_reduce_autograd


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


class GATConv(nn.Module):
    """Single-head graph attention convolution over a masked edge list,
    ``torch_geometric.nn.GATConv(F, F, add_self_loops=False)``:
    e_ij = LeakyReLU(a_src . (W x_j) + a_dst . (W x_i)); alpha = softmax of
    e over the incoming edges of i; out_i = sum_j alpha_ij (W x_j) + bias.
    The parameters carry PyG's names and shapes (``lin.weight`` [F, F],
    ``att_src`` and ``att_dst`` [1, 1, F], ``bias`` [F]). Its gathers go
    through :func:`gather_rows` (a fixed-order backward)."""

    def __init__(self, features: int, negative_slope: float = 0.2):
        super().__init__()
        self.features = features
        self.negative_slope = negative_slope
        self.lin = nn.Linear(features, features, bias=False)
        self.att_src = nn.Parameter(torch.empty(1, 1, features))
        self.att_dst = nn.Parameter(torch.empty(1, 1, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(
        self,
        x: torch.Tensor,  # [B, N, F]
        src: torch.Tensor,  # [B, E]
        dst: torch.Tensor,  # [B, E]
        edge_mask: Optional[torch.Tensor] = None,  # [B, E] bool
    ) -> torch.Tensor:
        n = x.shape[-2]
        wx = self.lin(x)
        s_src = (wx @ self.att_src.reshape(-1, 1))[..., 0]  # [B, N]
        s_dst = (wx @ self.att_dst.reshape(-1, 1))[..., 0]
        # both score vectors in one gather: [s_src | s_dst] at [src | dst + N]
        e = src.shape[-1]
        s = gather_rows(torch.cat([s_src, s_dst], dim=-1)[..., None],
                        torch.cat([src.long(), dst.long() + n], dim=-1))[..., 0]
        alpha = F.leaky_relu(s[..., :e] + s[..., e:], self.negative_slope)
        alpha = segment_softmax(alpha, dst, n, edge_mask)
        msgs = gather_rows(wx, src) * alpha[..., None]
        return segment_sum(msgs, dst, n, edge_mask) + self.bias


def batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
               train: bool = False) -> torch.Tensor:
    """Batch norm over the channels on dim 1 with the JAX package's (flax's)
    semantics, whatever the module's own mode.

    ``train=False``: the running statistics. ``train=True``: the batch's
    mean and biased variance over every other axis normalise x, and the
    running statistics move 0.1 of the way to that mean and that biased
    variance. (A torch ``BatchNorm`` module in training mode would move
    ``running_var`` towards the unbiased variance, as ``nn.SyncBatchNorm``
    does.) Under a mesh (``parallel.mesh.data_parallel``) the statistics
    are the global batch's, in two passes: the sums, then the sums of
    squared deviations from the global mean, each all-reduced inside
    autograd, so the backward is the global one too. (``E[x^2] - E[x]^2``
    from one all-reduce loses the variance of a channel whose mean
    dominates it, as zero-padded points make, to cancellation.) No host
    sync."""
    if not train:
        return F.batch_norm(
            x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
            training=False, eps=bn.eps,
        )
    dims = [d for d in range(x.dim()) if d != 1]
    mesh = active_mesh()
    if mesh is None:
        out = F.batch_norm(x, None, None, bn.weight, bn.bias, training=True, eps=bn.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=dims, correction=0)
    else:
        c = x.shape[1]
        count = x.numel() // c * mesh.size
        shape = (1, c) + (1,) * (x.dim() - 2)
        mean = all_reduce_autograd(x.sum(dims), mesh) / count
        dev = x - mean.reshape(shape)
        var = all_reduce_autograd((dev * dev).sum(dims), mesh) / count
        scale = torch.rsqrt(var + bn.eps) * bn.weight
        out = dev * scale.reshape(shape) + bn.bias.reshape(shape)
        mean, var = mean.detach(), var.detach()
    with torch.no_grad():
        bn.running_mean.mul_(1.0 - bn.momentum).add_(mean, alpha=bn.momentum)
        bn.running_var.mul_(1.0 - bn.momentum).add_(var, alpha=bn.momentum)
    return out


def batch_norm_last(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
                    train: bool = False) -> torch.Tensor:
    """:func:`batch_norm` for channels-last [..., C] activations."""
    c = x.shape[-1]
    return batch_norm(bn, x.reshape(-1, c), train).reshape(x.shape)


@torch.no_grad()
def init_params_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter with seeded random values: U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) for weights and biases, batch-norm affine (1, 0) and
    running statistics (0, 1), and for a GATConv Glorot-uniform ``lin``
    and attention vectors with a zero bias (PyG's and flax's init). The
    same seed gives the same weights."""
    done = set()
    for mod in module.modules():
        if id(mod) in done:
            continue
        if isinstance(mod, GATConv):
            for p in (mod.lin.weight, mod.att_src, mod.att_dst):
                bound = math.sqrt(6.0 / (p.shape[-1] + p.shape[-2]))
                u = torch.rand(p.shape, generator=generator, dtype=torch.float32)
                p.copy_((u * 2.0 - 1.0) * bound)
            mod.bias.zero_()
            done.add(id(mod.lin))
            continue
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
