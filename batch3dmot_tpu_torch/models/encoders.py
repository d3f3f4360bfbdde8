"""Frozen per-detection modality encoders, encode paths only (counterpart of
``batch3dmot_tpu/models/encoders.py``).

ResNet autoencoder encoder (camera crops), PointNet (LiDAR) and RadarNet
feature heads. Public layouts follow the JAX package: images NHWC, point
clouds [batch, points, channels]. Parameters carry the upstream PyTorch
names (``res_block1.downsample.0``, ``feat.stn.conv1`` ...): a point conv
with kernel 1 keeps the upstream ``Conv1d`` weight [out, in, 1] and runs as
a matmul over the channels-last points. Batch norm always uses the running
statistics (eps 1e-5). No decoder and no ``fc3`` classification heads: the
GNN never calls them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from batch3dmot_tpu_torch.models.layers import batch_norm_eval, batch_norm_last


def points_input_f32(x: torch.Tensor) -> torch.Tensor:
    """Point clouds may arrive as float16; compute in float32."""
    if x.dtype in (torch.float16, torch.bfloat16):
        return x.float()
    return x


def image_input_f32(x: torch.Tensor) -> torch.Tensor:
    """uint8 crops (0..255) are divided by 255 on the device; float crops
    are taken as [0, 1]."""
    if x.dtype == torch.uint8:
        return x.float() / 255.0
    return x


class PointwiseConv1d(nn.Module):
    """``nn.Conv1d(cin, cout, 1)`` parameters applied to [B, P, cin]."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 1))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight[:, :, 0], self.bias)


# ---------------------------------------------------------------------------
# ResNet autoencoder (camera crops, 32x32 -> 96-d latent)
# ---------------------------------------------------------------------------


class ResidualBlock(nn.Module):
    """Conv-BN-ReLU-Conv-BN + projected skip; both convs carry the stride."""

    def __init__(self, cin, cout, kernel, stride, down_kernel, down_stride):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, kernel, stride, padding=1)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, kernel, stride, padding=1)
        self.bn2 = nn.BatchNorm2d(cout)
        self.downsample = nn.Sequential(
            nn.Conv2d(cin, cout, down_kernel, down_stride, padding=0),
            nn.BatchNorm2d(cout),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = batch_norm_eval(self.downsample[1], self.downsample[0](x))
        h = F.relu(batch_norm_eval(self.bn1, self.conv1(x)))
        h = batch_norm_eval(self.bn2, self.conv2(h))
        return F.relu(h + skip)


class ResNetAE(nn.Module):
    """Encoder half of the ResNet autoencoder: 32 -> 16 -> 4 -> 4 -> 1
    spatial, 96 channels."""

    def __init__(self, latent_dim: int = 96):
        super().__init__()
        self.conv = nn.Conv2d(3, 12, 4, 2, padding=1)
        self.res_block1 = ResidualBlock(12, 24, 4, 2, 5, 3)
        self.res_block2 = ResidualBlock(24, 48, 3, 1, 1, 1)
        self.res_block3 = ResidualBlock(48, latent_dim, 3, 2, 3, 2)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, 32, 32, 3] (uint8 0..255 or float [0,1]) -> [B, 96]."""
        h = image_input_f32(x).permute(0, 3, 1, 2)
        h = self.conv(h)
        h = self.res_block1(h)
        h = self.res_block2(h)
        h = self.res_block3(h)
        return h.reshape(h.shape[0], -1)


# ---------------------------------------------------------------------------
# PointNet (LiDAR, [B, 128, 3] -> 256-d feature)
# ---------------------------------------------------------------------------


class STN3d(nn.Module):
    """Spatial transformer: a 3 x 3 alignment matrix per cloud."""

    def __init__(self, k: int = 3):
        super().__init__()
        self.k = k
        self.conv1 = PointwiseConv1d(k, 64)
        self.conv2 = PointwiseConv1d(64, 128)
        self.conv3 = PointwiseConv1d(128, 1024)
        self.fc1 = nn.Linear(1024, 512)
        self.fc2 = nn.Linear(512, 256)
        self.fc3 = nn.Linear(256, k * k)
        self.bn1 = nn.BatchNorm1d(64)
        self.bn2 = nn.BatchNorm1d(128)
        self.bn3 = nn.BatchNorm1d(1024)
        self.bn4 = nn.BatchNorm1d(512)
        self.bn5 = nn.BatchNorm1d(256)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(batch_norm_last(self.bn1, self.conv1(x)))
        h = F.relu(batch_norm_last(self.bn2, self.conv2(h)))
        h = F.relu(batch_norm_last(self.bn3, self.conv3(h)))
        h = h.amax(dim=1)
        h = F.relu(batch_norm_eval(self.bn4, self.fc1(h)))
        h = F.relu(batch_norm_eval(self.bn5, self.fc2(h)))
        h = self.fc3(h)
        eye = torch.eye(self.k, dtype=h.dtype, device=h.device).reshape(1, -1)
        return (h + eye).reshape(-1, self.k, self.k)


class PointNetFeat(nn.Module):
    """T-Net, shared point MLPs 3->64->128->1024, global max pool."""

    def __init__(self):
        super().__init__()
        self.stn = STN3d(3)
        self.conv1 = PointwiseConv1d(3, 64)
        self.conv2 = PointwiseConv1d(64, 128)
        self.conv3 = PointwiseConv1d(128, 1024)
        self.bn1 = nn.BatchNorm1d(64)
        self.bn2 = nn.BatchNorm1d(128)
        self.bn3 = nn.BatchNorm1d(1024)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = points_input_f32(x)
        trans = self.stn(x)
        # x @ T per cloud, as the JAX package's einsum("bpc,bcd->bpd")
        h = torch.bmm(x, trans)
        h = F.relu(batch_norm_last(self.bn1, self.conv1(h)))
        h = F.relu(batch_norm_last(self.bn2, self.conv2(h)))
        h = batch_norm_last(self.bn3, self.conv3(h))
        return h.amax(dim=1)


class PointNetClassifier(nn.Module):
    """PointNet feature head; :meth:`feat_256` is what the GNN consumes."""

    def __init__(self):
        super().__init__()
        self.feat = PointNetFeat()
        self.fc1 = nn.Linear(1024, 512)
        self.bn1 = nn.BatchNorm1d(512)
        self.fc2 = nn.Linear(512, 256)
        self.bn2 = nn.BatchNorm1d(256)

    def feat_256(self, x: torch.Tensor) -> torch.Tensor:
        h = self.feat(x)
        h = F.relu(batch_norm_eval(self.bn1, self.fc1(h)))
        # dropout sits here upstream; inference is deterministic
        return F.relu(batch_norm_eval(self.bn2, self.fc2(h)))


# ---------------------------------------------------------------------------
# RadarNet ([B, 64, 4] -> 256-d feature)
# ---------------------------------------------------------------------------


class RadarNetFeat(nn.Module):
    """Point MLPs 4->64->128->1024 without a T-Net, global max pool."""

    def __init__(self):
        super().__init__()
        self.conv1 = PointwiseConv1d(4, 64)
        self.conv2 = PointwiseConv1d(64, 128)
        self.conv3 = PointwiseConv1d(128, 1024)
        self.bn1 = nn.BatchNorm1d(64)
        self.bn2 = nn.BatchNorm1d(128)
        self.bn3 = nn.BatchNorm1d(1024)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(batch_norm_last(self.bn1, self.conv1(points_input_f32(x))))
        h = F.relu(batch_norm_last(self.bn2, self.conv2(h)))
        h = batch_norm_last(self.bn3, self.conv3(h))
        return h.amax(dim=1)


class RadarNetClassifier(nn.Module):
    """RadarNet feature head; :meth:`feat_256` is what the GNN consumes."""

    def __init__(self):
        super().__init__()
        self.feat = RadarNetFeat()
        self.fc1 = nn.Linear(1024, 512)
        self.bn1 = nn.BatchNorm1d(512)
        self.fc2 = nn.Linear(512, 256)
        self.bn2 = nn.BatchNorm1d(256)

    def feat_256(self, x: torch.Tensor) -> torch.Tensor:
        h = self.feat(x)
        h = F.relu(batch_norm_eval(self.bn1, self.fc1(h)))
        return F.relu(batch_norm_eval(self.bn2, self.fc2(h)))
