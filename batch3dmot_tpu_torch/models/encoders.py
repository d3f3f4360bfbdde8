"""Per-detection modality encoders (counterpart of
``batch3dmot_tpu/models/encoders.py``).

ResNet autoencoder (camera crops), PointNet (LiDAR) and RadarNet
classifiers. Public layouts follow the JAX package: images NHWC, point
clouds [batch, points, channels]. Parameters carry the upstream PyTorch
names (``res_block1.downsample.0``, ``feat.stn.conv1``, ``conv_decoder.0``
...): a point conv with kernel 1 keeps the upstream ``Conv1d`` weight
[out, in, 1] and runs as a matmul over the channels-last points.

Every path takes ``train``: False (the default, the GNN's frozen feature
extractors) normalises with the running statistics; True normalises with
the batch's and updates the running statistics as flax does
(``models/layers.py::batch_norm``), and applies the classifiers' dropout
with a mask drawn from the ``generator`` passed in.

Inside a ``MultimodalGNN`` the encoders are built without the parts the GNN
never calls (``decoder=False``, ``head=False``): the ResNet's transposed-conv
decoder and the classifiers' ``fc3``, which the JAX package's GNN tree does
not hold either.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from batch3dmot_tpu_torch.models.layers import batch_norm, batch_norm_last
from batch3dmot_tpu_torch.parallel.mesh import batch_mean, rand_rows


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


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: each element kept with probability 1 - p, the
    kept ones scaled by 1 / (1 - p); the mask comes from ``generator`` (on
    x's device), so the caller owns the random stream; under a mesh
    (``parallel.mesh.data_parallel``) the global batch's mask is drawn and
    this rank's rows kept."""
    if p <= 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    keep = rand_rows(x.shape, generator, x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), 0.0)


class PointwiseConv1d(nn.Module):
    """``nn.Conv1d(cin, cout, 1)`` parameters applied to [B, P, cin]."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 1))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight[:, :, 0], self.bias)


# ---------------------------------------------------------------------------
# ResNet autoencoder (camera crops, 32x32 -> 96-d latent -> 32x32)
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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        skip = batch_norm(self.downsample[1], self.downsample[0](x), train)
        h = F.relu(batch_norm(self.bn1, self.conv1(x), train))
        h = batch_norm(self.bn2, self.conv2(h), train)
        return F.relu(h + skip)


class ResNetAE(nn.Module):
    """32 -> 16 -> 4 -> 4 -> 1 spatial, ``latent_dim`` channels; the decoder
    is five ``ConvTranspose2d(k=4, s=2, p=1)`` layers 96 -> 72 -> 48 -> 24 ->
    12 -> 3 with ReLU between them and a sigmoid at the end (the flax
    decoder's input-dilated convs, whose kernels are these weights flipped
    spatially with in and out channels swapped)."""

    def __init__(self, latent_dim: int = 96, decoder: bool = True):
        super().__init__()
        self.latent_dim = latent_dim
        self.conv = nn.Conv2d(3, 12, 4, 2, padding=1)
        self.res_block1 = ResidualBlock(12, 24, 4, 2, 5, 3)
        self.res_block2 = ResidualBlock(24, 48, 3, 1, 1, 1)
        self.res_block3 = ResidualBlock(48, latent_dim, 3, 2, 3, 2)
        if decoder:
            layers = []
            chans = (latent_dim, 72, 48, 24, 12, 3)
            for i, (cin, cout) in enumerate(zip(chans, chans[1:])):
                layers.append(nn.ConvTranspose2d(cin, cout, 4, stride=2, padding=1))
                layers.append(nn.ReLU() if i < len(chans) - 2 else nn.Sigmoid())
            self.conv_decoder = nn.Sequential(*layers)

    def encode(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x: [B, 32, 32, 3] (uint8 0..255 or float [0,1]) -> [B, latent_dim]."""
        h = image_input_f32(x).permute(0, 3, 1, 2)
        h = self.conv(h)
        h = self.res_block1(h, train)
        h = self.res_block2(h, train)
        h = self.res_block3(h, train)
        return h.reshape(h.shape[0], -1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """[B, latent_dim] -> reconstruction [B, 32, 32, 3] in (0, 1)."""
        h = self.conv_decoder(z.reshape(z.shape[0], self.latent_dim, 1, 1))
        return h.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.decode(self.encode(x, train))


# ---------------------------------------------------------------------------
# PointNet (LiDAR, [B, 128, 3] -> 256-d feature -> class log-probabilities)
# ---------------------------------------------------------------------------


class STNkd(nn.Module):
    """Spatial transformer: a k x k alignment matrix per cloud, the identity
    plus ``fc3``'s output (``fc3`` starts at zero in ``init_params_``, as
    the flax ``fc_out`` does, so each transform starts at the identity)."""

    ZERO_INIT = ("fc3",)

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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = F.relu(batch_norm_last(self.bn1, self.conv1(x), train))
        h = F.relu(batch_norm_last(self.bn2, self.conv2(h), train))
        h = F.relu(batch_norm_last(self.bn3, self.conv3(h), train))
        h = h.amax(dim=1)
        h = F.relu(batch_norm(self.bn4, self.fc1(h), train))
        h = F.relu(batch_norm(self.bn5, self.fc2(h), train))
        h = self.fc3(h)
        eye = torch.eye(self.k, dtype=h.dtype, device=h.device).reshape(1, -1)
        return (h + eye).reshape(-1, self.k, self.k)


class PointNetFeat(nn.Module):
    """Input T-Net, shared point MLPs 3->64->128->1024 (with the 64 x 64
    feature T-Net ``fstn`` after the first when ``feature_transform``),
    global max pool."""

    def __init__(self, feature_transform: bool = False):
        super().__init__()
        self.feature_transform = feature_transform
        self.stn = STNkd(3)
        self.conv1 = PointwiseConv1d(3, 64)
        self.conv2 = PointwiseConv1d(64, 128)
        self.conv3 = PointwiseConv1d(128, 1024)
        self.bn1 = nn.BatchNorm1d(64)
        self.bn2 = nn.BatchNorm1d(128)
        self.bn3 = nn.BatchNorm1d(1024)
        if feature_transform:
            self.fstn = STNkd(64)

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """(feature [B, 1024], trans [B, 3, 3], trans_feat [B, 64, 64] or
        None)."""
        x = points_input_f32(x)
        trans = self.stn(x, train)
        # x @ T per cloud, as the JAX package's einsum("bpc,bcd->bpd")
        h = torch.bmm(x, trans)
        h = F.relu(batch_norm_last(self.bn1, self.conv1(h), train))
        trans_feat = None
        if self.feature_transform:
            trans_feat = self.fstn(h, train)
            h = torch.bmm(h, trans_feat)
        h = F.relu(batch_norm_last(self.bn2, self.conv2(h), train))
        h = batch_norm_last(self.bn3, self.conv3(h), train)
        return h.amax(dim=1), trans, trans_feat


class _Classifier(nn.Module):
    """The head shared by the two classifiers, after their ``feat``:
    fc1-bn1-ReLU, fc2-dropout-bn2-ReLU (the 256-d feature) and ``fc3``."""

    def _add_head(self, num_classes: int, dropout: float, head: bool) -> None:
        self.dropout = dropout
        self.fc1 = nn.Linear(1024, 512)
        self.bn1 = nn.BatchNorm1d(512)
        self.fc2 = nn.Linear(512, 256)
        self.bn2 = nn.BatchNorm1d(256)
        if head:
            self.fc3 = nn.Linear(256, num_classes)

    def _head_256(self, h: torch.Tensor, train: bool,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
        h = F.relu(batch_norm(self.bn1, self.fc1(h), train))
        h = self.fc2(h)
        if train:
            h = dropout(h, self.dropout, generator)
        return F.relu(batch_norm(self.bn2, h, train))


class PointNetClassifier(_Classifier):
    """PointNet classifier; :meth:`feat_256` is what the GNN consumes.
    ``forward`` gives (log-probabilities [B, num_classes], trans,
    trans_feat)."""

    def __init__(self, num_classes: int = 7, feature_transform: bool = False,
                 dropout: float = 0.3, head: bool = True):
        super().__init__()
        self.feature_transform = feature_transform
        self.feat = PointNetFeat(feature_transform)
        self._add_head(num_classes, dropout, head)

    def feat_256(self, x: torch.Tensor, train: bool = False,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self._head_256(self.feat(x, train)[0], train, generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None):
        h, trans, trans_feat = self.feat(x, train)
        h = self._head_256(h, train, generator)
        return F.log_softmax(self.fc3(h), dim=-1), trans, trans_feat


def feature_transform_regularizer(trans: torch.Tensor) -> torch.Tensor:
    """Mean over the (global) batch of ||T T^t - I||_F (the orthogonality
    loss)."""
    eye = torch.eye(trans.shape[-1], dtype=trans.dtype, device=trans.device)
    diff = trans @ trans.transpose(1, 2) - eye
    return batch_mean(torch.linalg.matrix_norm(diff))


# ---------------------------------------------------------------------------
# RadarNet ([B, 64, 4] -> 256-d feature -> class log-probabilities)
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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = F.relu(batch_norm_last(self.bn1, self.conv1(points_input_f32(x)), train))
        h = F.relu(batch_norm_last(self.bn2, self.conv2(h), train))
        h = batch_norm_last(self.bn3, self.conv3(h), train)
        return h.amax(dim=1)


class RadarNetClassifier(_Classifier):
    """RadarNet classifier; :meth:`feat_256` is what the GNN consumes,
    ``forward`` gives log-probabilities [B, num_classes]."""

    def __init__(self, num_classes: int = 7, dropout: float = 0.3, head: bool = True):
        super().__init__()
        self.feat = RadarNetFeat()
        self._add_head(num_classes, dropout, head)

    def feat_256(self, x: torch.Tensor, train: bool = False,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self._head_256(self.feat(x, train), train, generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return F.log_softmax(self.fc3(self.feat_256(x, train, generator)), dim=-1)

