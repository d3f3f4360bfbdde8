"""Time-aware tracking GNNs with cross-edge modality attention (counterpart
of ``batch3dmot_tpu/models/gnn.py``).

  * :class:`MultimodalGNN`: frozen ResNet/PointNet/RadarNet encoders,
    per-edge modality attention fused into a 64-d edge attribute, and a
    depth-6 causal message-passing stack (one weight set shared over depth)
    classifying edges.
  * :class:`PoseGNN`: the poses-only model at smaller widths; returns
    logits.

Every tensor carries a leading window dimension ``[B, ...]`` (the JAX
package vmaps one window; here the batch is written out). Gathers index the
node rows by ``edge_src``/``edge_dst``; the two scatter-adds of each layer
(past messages by destination, future messages by source) skip padded
edges. Every gather whose input takes a gradient goes through
``ops/segment.py::gather_rows``, whose backward is a segment sum in a fixed
order (no atomics), so training is bit-reproducible on the card in both
kNN-conv modes. Parameter names follow the upstream PyTorch state dict, so
``utils/torch_import.py::import_mm_gnn`` reads the port's state dict.

``knn_conv_mode='noop'`` (the default) skips the frame-wise kNN GATConv,
whose result the upstream model discards (the trained checkpoints embed
that); ``'active'`` applies it before message-passing layers 0, 2, 4, ...
over the k nearest same-time nodes of x, as the code visibly intended.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from batch3dmot_tpu_torch.graph import EDGE_DIM, POSE_DIM, PaddedGraph
from batch3dmot_tpu_torch.models.encoders import (
    PointNetClassifier,
    RadarNetClassifier,
    ResNetAE,
)
from batch3dmot_tpu_torch.models.layers import (
    MLP,
    GATConv,
    SingleTokenAttention,
)
from batch3dmot_tpu_torch.ops.knn import knn_graph_masked
from batch3dmot_tpu_torch.ops.segment import gather_rows, segment_sum


def _check_knn_mode(knn_conv_mode: str) -> None:
    if knn_conv_mode not in ("noop", "active"):
        raise ValueError(f"Unknown knn_conv_mode '{knn_conv_mode}'")


def apply_knn_conv(conv: GATConv, k: int, x: torch.Tensor, g: PaddedGraph) -> torch.Tensor:
    """The active-mode step before a message-passing layer: a GATConv over
    each valid node's k nearest valid same-time nodes of x (the graph
    carries no gradient); padded nodes keep x."""
    same_t = g.node_time[..., None, :] == g.node_time[..., :, None]
    k_src, k_dst, k_mask = knn_graph_masked(
        x.detach(), k, valid=g.node_mask, pair_valid=same_t
    )
    x_conv = conv(x, k_src, k_dst, k_mask)
    return torch.where(g.node_mask[..., None], x_conv, x)


class CausalMessagePassing(nn.Module):
    """One step of time-directed edge/node message passing.

    Per edge (j -> i, j in the past):
      updated_edge = MLP([x_i, x_j, edge_attr(, att_edge_attr)])
      future_msg   = MLP([x_i, updated_edge, initial_x_i])  -> sum into j
      past_msg     = MLP([x_j, updated_edge, initial_x_j])  -> sum into i
      x'           = MLP([sum past, sum future])
    """

    def __init__(
        self,
        node_dim: int,
        edge_dim: int,
        msg_dim: int,
        edge_update_hidden: Tuple[int, int] = (256, 128),
        with_attention: bool = True,
    ):
        super().__init__()
        m = msg_dim
        eu_in = 2 * node_dim + edge_dim * (2 if with_attention else 1)
        self.edge_update = MLP(eu_in, (*edge_update_hidden, edge_dim))
        msg_in = 2 * node_dim + edge_dim
        self.create_past_msgs = MLP(msg_in, (m + m // 2, m))
        self.create_future_msgs = MLP(msg_in, (m + m // 2, m))
        self.combine_future_past = MLP(2 * m, (m + m // 2, m, node_dim))

    def forward(
        self,
        x: torch.Tensor,  # [B, N, node_dim]
        edge_attr: torch.Tensor,  # [B, E, edge_dim]
        initial_x: torch.Tensor,  # [B, N, node_dim]
        src: torch.Tensor,  # [B, E]
        dst: torch.Tensor,  # [B, E]
        edge_mask: torch.Tensor,  # [B, E] bool
        att_edge_attr: Optional[torch.Tensor] = None,  # [B, E, edge_dim]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        n, d, e = x.shape[-2], x.shape[-1], src.shape[-1]
        # one gather of [x | initial_x] at [src | dst]: one fixed-order sum
        # in the backward (gather_rows) instead of four
        rows = gather_rows(torch.cat([x, initial_x], dim=-1), torch.cat([src, dst], dim=-1))
        x_j, init_j = rows[..., :e, :d], rows[..., :e, d:]
        x_i, init_i = rows[..., e:, :d], rows[..., e:, d:]

        edge_in = [x_i, x_j, edge_attr]
        if att_edge_attr is not None:
            edge_in.append(att_edge_attr)
        updated_edge = self.edge_update(torch.cat(edge_in, dim=-1))

        future = self.create_future_msgs(torch.cat([x_i, updated_edge, init_i], dim=-1))
        past = self.create_past_msgs(torch.cat([x_j, updated_edge, init_j], dim=-1))

        # past messages flow into the present node (dst); future messages
        # flow back into the past node (src)
        agg_past = segment_sum(past, dst, n, edge_mask)
        agg_future = segment_sum(future, src, n, edge_mask)
        x_new = self.combine_future_past(torch.cat([agg_past, agg_future], dim=-1))
        return x_new, updated_edge


class MultimodalGNN(nn.Module):
    """Camera+LiDAR+radar tracking GNN with cross-edge modality attention.

    ``modalities`` selects the sensor subset (the model family of
    ``models/registry.py``); ``use_attention=False`` is the concat-fusion
    variant whose attribute encoder takes [img_i, lidar_i, img_j, lidar_j,
    edge] (512 wide for camera+LiDAR).

    ``freeze_encoders`` (default True, as upstream, where the three encoders
    have ``requires_grad=False``): their features carry no gradient and
    ``GNNTrainer`` leaves them out of the optimizer. With False they train
    with the rest; either way they normalise with their running statistics
    (the JAX package's ``encode_frozen``)."""

    def __init__(
        self,
        depth: int = 6,
        node_dim: int = 96,
        edge_dim: int = 64,
        img_dim: int = 96,
        lidar_dim: int = 128,
        radar_dim: int = 64,
        use_attention: bool = True,
        knn_conv_mode: str = "noop",
        knn_conv_k: int = 20,
        num_classes: int = 7,
        modalities: Sequence[str] = ("img", "lidar", "radar"),
        freeze_encoders: bool = True,
    ):
        super().__init__()
        _check_knn_mode(knn_conv_mode)
        self.depth = depth
        self.node_dim = node_dim
        self.edge_dim = edge_dim
        self.img_dim = img_dim
        self.lidar_dim = lidar_dim
        self.radar_dim = radar_dim
        self.use_attention = use_attention
        self.knn_conv_mode = knn_conv_mode
        self.knn_conv_k = knn_conv_k
        self.modalities = tuple(modalities)
        self.freeze_encoders = freeze_encoders
        has = self.has

        # the GNN calls the encoders' feature paths only: no decoder, no fc3
        if has("img"):
            self.resnet = ResNetAE(img_dim, decoder=False)
        if has("lidar"):
            self.pointnet = PointNetClassifier(num_classes, head=False)
            self.fc_lidar_encoder = MLP(256, (192, lidar_dim))
        if has("radar"):
            self.radarnet = RadarNetClassifier(num_classes, head=False)
            self.fc_radar_encoder = MLP(256, (192, 128, radar_dim))

        self.edge_encoder = MLP(EDGE_DIM, (16, 32, edge_dim))
        self.node_encoder = MLP(POSE_DIM, (48, node_dim))
        self.edge_classifier = MLP(edge_dim, (32, 16, 8, 1))

        dims = {"img": img_dim, "lidar": lidar_dim, "radar": radar_dim}
        if use_attention:
            if has("img"):
                self.c2c_att = SingleTokenAttention(img_dim)
            if has("lidar"):
                self.l2l_att = SingleTokenAttention(lidar_dim)
            if has("radar"):
                self.r2r_att = SingleTokenAttention(radar_dim)
            att_in = 2 * sum(dims[m] for m in self.modalities) + edge_dim
        else:
            att_in = 2 * sum(dims[m] for m in ("img", "lidar") if has(m)) + edge_dim
        self.att_edge_encoder = MLP(att_in, (512, 384, 256, 128, edge_dim))
        # the message passing always consumes the attention attribute; the
        # use_attention flag only changes how it is computed
        self.message_passing = CausalMessagePassing(node_dim, edge_dim, 128)
        if knn_conv_mode == "active":
            self.knn_conv = GATConv(node_dim)

    def has(self, modality: str) -> bool:
        return modality in self.modalities

    def encode_frozen(
        self, img: torch.Tensor, lidar: torch.Tensor, radar: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Frozen-encoder features for a flat batch of detections:
        (x_img [M, 96], pointnet_256 [M, 256], radarnet_256 [M, 256]),
        with the running statistics, without gradient when
        ``freeze_encoders``. Disabled modalities return zeros. Presence
        gating and the trainable projection heads happen in
        :meth:`pre_message_passing`."""
        m = img.shape[0]
        dev = img.device
        zeros = lambda d: torch.zeros(m, d, device=dev)  # noqa: E731
        frozen = torch.no_grad() if self.freeze_encoders else contextlib.nullcontext()
        with frozen:
            x_img = self.resnet.encode(img) if self.has("img") else zeros(self.img_dim)
            pn = self.pointnet.feat_256(lidar) if self.has("lidar") else zeros(256)
            rn = self.radarnet.feat_256(radar) if self.has("radar") else zeros(256)
        return x_img, pn, rn

    def forward(self, g: PaddedGraph) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full forward over a window batch: encoders per node, then
        :meth:`forward_from_encodings`."""
        b, n = g.pose.shape[:2]
        flat = lambda t: t.reshape(b * n, *t.shape[2:])  # noqa: E731
        x_img, pn, rn = self.encode_frozen(flat(g.img), flat(g.lidar), flat(g.radar))
        unflat = lambda t: t.reshape(b, n, -1)  # noqa: E731
        lidar_present = g.lidar.sum(dim=(-2, -1)) != 0
        radar_present = g.radar.sum(dim=(-2, -1)) != 0
        return self.forward_from_encodings(
            g, unflat(x_img), unflat(pn), unflat(rn), lidar_present, radar_present
        )

    def pre_message_passing(
        self,
        g: PaddedGraph,
        x_img: torch.Tensor,  # [B, N, 96]
        pn: torch.Tensor,  # [B, N, 256]
        rn: torch.Tensor,  # [B, N, 256]
        lidar_present: torch.Tensor,  # [B, N] bool
        radar_present: torch.Tensor,  # [B, N] bool
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Everything before the message-passing loop: (x0, edge_attr0,
        att_edge_attr, x_sens); the fused kernel takes over from here."""
        src, dst = g.edge_src, g.edge_dst
        has = self.has
        edge_attr = self.edge_encoder(g.edge_attr)

        b, n = x_img.shape[:2]
        dev = x_img.device
        x_lidar = (
            torch.where(lidar_present[..., None], self.fc_lidar_encoder(pn), 0.0)
            if has("lidar") else torch.zeros(b, n, self.lidar_dim, device=dev)
        )
        x_radar = (
            torch.where(radar_present[..., None], self.fc_radar_encoder(rn), 0.0)
            if has("radar") else torch.zeros(b, n, self.radar_dim, device=dev)
        )

        if self.use_attention:
            # the attention block is affine per row, so it runs per node and
            # the edges gather its output; concat order radar, lidar, img
            blocks = []
            if has("radar"):
                blocks.append(self.r2r_att(x_radar))
            if has("lidar"):
                blocks.append(self.l2l_att(x_lidar))
            if has("img"):
                blocks.append(self.c2c_att(x_img))
            sens = torch.cat(blocks, dim=-1)
            att_in = [gather_rows(sens, dst), gather_rows(sens, src), edge_attr]
        else:
            node_i = [t for m, t in (("img", x_img), ("lidar", x_lidar)) if has(m)]
            sens = torch.cat(node_i, dim=-1)
            att_in = [gather_rows(sens, dst), gather_rows(sens, src), edge_attr]
        att_edge_attr = self.att_edge_encoder(torch.cat(att_in, dim=-1))

        x_sens = torch.cat([x_img, x_lidar, x_radar], dim=-1)
        x = self.node_encoder(g.pose)
        return x, edge_attr, att_edge_attr, x_sens

    def forward_from_encodings(
        self,
        g: PaddedGraph,
        x_img: torch.Tensor,
        pn: torch.Tensor,
        rn: torch.Tensor,
        lidar_present: torch.Tensor,
        radar_present: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(edge scores [B, E] in (0, 1), x_sens [B, N, 288]) through the
        module loop: the fused kernel's plain-module twin in ``'noop'``
        mode, the only path in ``'active'`` mode."""
        x, edge_attr, att_edge_attr, x_sens = self.pre_message_passing(
            g, x_img, pn, rn, lidar_present, radar_present
        )
        initial_x = x
        for layer in range(self.depth):
            if layer % 2 == 0 and self.knn_conv_mode == "active":
                x = apply_knn_conv(self.knn_conv, self.knn_conv_k, x, g)
            x, edge_attr = self.message_passing(
                x, edge_attr, initial_x, g.edge_src, g.edge_dst, g.edge_mask,
                att_edge_attr,
            )
        scores = torch.sigmoid(self.edge_classifier(edge_attr)[..., 0])
        return scores, x_sens


class PoseGNN(nn.Module):
    """Poses-only tracking GNN; returns logits and the encoded nodes."""

    def __init__(
        self,
        depth: int = 6,
        node_dim: int = 48,
        edge_dim: int = 32,
        knn_conv_mode: str = "noop",
        knn_conv_k: int = 20,
    ):
        super().__init__()
        _check_knn_mode(knn_conv_mode)
        self.depth = depth
        self.node_dim = node_dim
        self.edge_dim = edge_dim
        self.knn_conv_mode = knn_conv_mode
        self.knn_conv_k = knn_conv_k
        self.edge_encoder = MLP(EDGE_DIM, (8, 16, edge_dim))
        self.node_encoder = MLP(POSE_DIM, (24, 36, node_dim))
        self.edge_classifier = MLP(edge_dim, (16, 8, 4, 1))
        self.message_passing = CausalMessagePassing(
            node_dim, edge_dim, 64, edge_update_hidden=(96, 64), with_attention=False
        )
        if knn_conv_mode == "active":
            self.knn_conv = GATConv(node_dim)

    def pre_message_passing(self, g: PaddedGraph) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x0, edge_attr0): the fused-kernel handoff point."""
        return self.node_encoder(g.pose), self.edge_encoder(g.edge_attr)

    def forward(self, g: PaddedGraph) -> Tuple[torch.Tensor, torch.Tensor]:
        x, edge_attr = self.pre_message_passing(g)
        initial_x = x
        for layer in range(self.depth):
            if layer % 2 == 0 and self.knn_conv_mode == "active":
                x = apply_knn_conv(self.knn_conv, self.knn_conv_k, x, g)
            x, edge_attr = self.message_passing(
                x, edge_attr, initial_x, g.edge_src, g.edge_dst, g.edge_mask
            )
        logits = self.edge_classifier(edge_attr)[..., 0]
        return logits, initial_x
