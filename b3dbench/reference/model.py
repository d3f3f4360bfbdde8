"""The plain reference of the two tracking GNNs and their frozen encoders:
plain ``torch`` operations on a dict of named tensors, no kernel, no
padding, no batching, no cache. Written from the Batch3DMOT description
(models/clr_att_gnn.py, models/pose_gnn.py, the ResNet-AE, PointNet and
RadarNet encoders) and the configuration file; it imports nothing of the
program.

``prec`` selects the arithmetic: ``"f64"`` (float64, the reference),
``"f32"`` (float32, TF32 off) or ``"tf32"`` (float32 whose products take
their operands rounded to TF32's 10-bit mantissa: the control). A window
is a dict of ``graphs.build_window``; its encodings are
``(x_img, pn, rn, lidar_present, radar_present)`` per node.

Departures from the upstream module code, which the program shares: the
single-token modality attention is its value and output projections (a
softmax over one key is 1); the frame-wise kNN GATConv whose result the
upstream model discards is left out (``knn_conv_mode`` noop).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
# the loss's clamp of the scores, at the float32 values the configuration's
# float32 scores meet
LOSS_LO = float(np.float32(1e-7))
LOSS_HI = float(np.float32(1.0 - 1e-7))


# --------------------------------------------------------------------------
# parameters: name, shape, kind, fan-in
# --------------------------------------------------------------------------

def _mlp(prefix, cin, widths):
    out = []
    for i, w in enumerate(widths):
        out += [(f"{prefix}.{2 * i}.weight", (w, cin), "w", cin),
                (f"{prefix}.{2 * i}.bias", (w,), "b", cin)]
        cin = w
    return out


def _lin(prefix, cin, cout):
    return [(f"{prefix}.weight", (cout, cin), "w", cin), (f"{prefix}.bias", (cout,), "b", cin)]


def _pconv(prefix, cin, cout):
    return [(f"{prefix}.weight", (cout, cin, 1), "w", cin), (f"{prefix}.bias", (cout,), "b", cin)]


def _conv(prefix, cin, cout, k):
    fan = cin * k * k
    return [(f"{prefix}.weight", (cout, cin, k, k), "w", fan),
            (f"{prefix}.bias", (cout,), "b", fan)]


def _bn_spec(prefix, c):
    return [(f"{prefix}.weight", (c,), "bn_w", c), (f"{prefix}.bias", (c,), "bn_b", c),
            (f"{prefix}.running_mean", (c,), "bn_mean", c),
            (f"{prefix}.running_var", (c,), "bn_var", c),
            (f"{prefix}.num_batches_tracked", (), "count", 1)]


# (cin, cout, kernel, stride, downsample kernel, downsample stride)
RES_BLOCKS = ((12, 24, 4, 2, 5, 3), (24, 48, 3, 1, 1, 1), (48, 96, 3, 2, 3, 2))


def _encoder_spec(cfg) -> list:
    spec = _conv("resnet.conv", 3, 12, 4)
    for b, (cin, cout, k, _, dk, _) in enumerate(RES_BLOCKS, start=1):
        p = f"resnet.res_block{b}"
        spec += (_conv(f"{p}.conv1", cin, cout, k) + _bn_spec(f"{p}.bn1", cout)
                 + _conv(f"{p}.conv2", cout, cout, k) + _bn_spec(f"{p}.bn2", cout)
                 + _conv(f"{p}.downsample.0", cin, cout, dk) + _bn_spec(f"{p}.downsample.1", cout))
    stn = "pointnet.feat.stn"
    spec += (_pconv(f"{stn}.conv1", 3, 64) + _pconv(f"{stn}.conv2", 64, 128)
             + _pconv(f"{stn}.conv3", 128, 1024) + _lin(f"{stn}.fc1", 1024, 512)
             + _lin(f"{stn}.fc2", 512, 256) + _lin(f"{stn}.fc3", 256, 9)
             + _bn_spec(f"{stn}.bn1", 64) + _bn_spec(f"{stn}.bn2", 128)
             + _bn_spec(f"{stn}.bn3", 1024) + _bn_spec(f"{stn}.bn4", 512)
             + _bn_spec(f"{stn}.bn5", 256))
    for net, cin in (("pointnet", 3), ("radarnet", 4)):
        spec += (_pconv(f"{net}.feat.conv1", cin, 64) + _pconv(f"{net}.feat.conv2", 64, 128)
                 + _pconv(f"{net}.feat.conv3", 128, 1024) + _bn_spec(f"{net}.feat.bn1", 64)
                 + _bn_spec(f"{net}.feat.bn2", 128) + _bn_spec(f"{net}.feat.bn3", 1024)
                 + _lin(f"{net}.fc1", 1024, 512) + _bn_spec(f"{net}.bn1", 512)
                 + _lin(f"{net}.fc2", 512, 256) + _bn_spec(f"{net}.bn2", 256))
    return spec


def _mp_spec(cfg, with_att: bool) -> list:
    nd, ed, m = cfg["node_dim"], cfg["edge_dim"], cfg["msg_dim"]
    h1, h2 = cfg["edge_update_hidden"]
    p = "message_passing"
    return (_mlp(f"{p}.edge_update", 2 * nd + ed * (2 if with_att else 1), (h1, h2, ed))
            + _mlp(f"{p}.create_past_msgs", 2 * nd + ed, (m + m // 2, m))
            + _mlp(f"{p}.create_future_msgs", 2 * nd + ed, (m + m // 2, m))
            + _mlp(f"{p}.combine_future_past", 2 * m, (m + m // 2, m, nd)))


def param_spec(cfg: dict) -> list:
    """Every tensor of the model's state: (name, shape, kind, fan-in)."""
    nd, ed = cfg["node_dim"], cfg["edge_dim"]
    if cfg["model"] == "PoseGNN":
        return (_mlp("edge_encoder", 4, cfg["edge_encoder"] + [ed])
                + _mlp("node_encoder", 19, cfg["node_encoder"] + [nd])
                + _mlp("edge_classifier", ed, cfg["edge_classifier"] + [1])
                + _mp_spec(cfg, False))
    di, dl, dr = cfg["img_dim"], cfg["lidar_dim"], cfg["radar_dim"]
    spec = _encoder_spec(cfg)
    spec += _mlp("fc_lidar_encoder", 256, cfg["fc_lidar_encoder"] + [dl])
    spec += _mlp("fc_radar_encoder", 256, cfg["fc_radar_encoder"] + [dr])
    spec += (_mlp("edge_encoder", 4, cfg["edge_encoder"] + [ed])
             + _mlp("node_encoder", 19, cfg["node_encoder"] + [nd])
             + _mlp("edge_classifier", ed, cfg["edge_classifier"] + [1]))
    for name, d in (("c2c_att", di), ("l2l_att", dl), ("r2r_att", dr)):
        spec += [(f"{name}.in_proj_weight", (3 * d, d), "w", d),
                 (f"{name}.in_proj_bias", (3 * d,), "b", d)] + _lin(f"{name}.out_proj", d, d)
    spec += _mlp("att_edge_encoder", 2 * (di + dl + dr) + ed, cfg["att_edge_encoder"] + [ed])
    return spec + _mp_spec(cfg, True)


def is_frozen(name: str) -> bool:
    return name.split(".")[0] in ("resnet", "pointnet", "radarnet")


# --------------------------------------------------------------------------
# arithmetic
# --------------------------------------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits, ties away from zero); the
    gradient passes through unchanged."""
    r = ((x.detach().contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return x + (r - x.detach())


class Arith:
    """Products in one precision."""

    def __init__(self, prec: str):
        if prec not in ("f64", "f32", "tf32"):
            raise ValueError(prec)
        self.prec = prec
        self.dtype = torch.float64 if prec == "f64" else torch.float32
        self._round = tf32 if prec == "tf32" else (lambda t: t)

    def linear(self, x, w, b=None):
        return F.linear(self._round(x), self._round(w), b)

    def conv2d(self, x, w, b, stride, padding):
        return F.conv2d(self._round(x), self._round(w), b, stride=stride, padding=padding)

    def bmm(self, a, b):
        return torch.bmm(self._round(a), self._round(b))


def mlp(P, prefix, x, ar: Arith):
    i = 0
    while f"{prefix}.{2 * i}.weight" in P:
        if i:
            x = torch.relu(x)
        x = ar.linear(x, P[f"{prefix}.{2 * i}.weight"], P[f"{prefix}.{2 * i}.bias"])
        i += 1
    return x


def _bn(P, prefix, x, dim=1):
    shape = [1] * x.dim()
    shape[dim] = -1
    g = lambda k: P[f"{prefix}.{k}"].reshape(shape)  # noqa: E731
    return (x - g("running_mean")) / torch.sqrt(g("running_var") + BN_EPS) * g("weight") + g("bias")


# --------------------------------------------------------------------------
# frozen encoders (running statistics)
# --------------------------------------------------------------------------

def resnet_encode(P, img_u8: torch.Tensor, ar: Arith) -> torch.Tensor:
    h = (img_u8.to(ar.dtype) / 255.0).permute(0, 3, 1, 2)
    h = ar.conv2d(h, P["resnet.conv.weight"], P["resnet.conv.bias"], 2, 1)
    for b, (_, _, _, s, _, ds) in enumerate(RES_BLOCKS, start=1):
        p = f"resnet.res_block{b}"
        skip = _bn(P, f"{p}.downsample.1", ar.conv2d(
            h, P[f"{p}.downsample.0.weight"], P[f"{p}.downsample.0.bias"], ds, 0))
        y = torch.relu(_bn(P, f"{p}.bn1", ar.conv2d(h, P[f"{p}.conv1.weight"],
                                                    P[f"{p}.conv1.bias"], s, 1)))
        y = _bn(P, f"{p}.bn2", ar.conv2d(y, P[f"{p}.conv2.weight"], P[f"{p}.conv2.bias"], s, 1))
        h = torch.relu(y + skip)
    return h.reshape(h.shape[0], -1)


def _pconv_bn(P, conv, bn, x, ar, relu=True):
    y = _bn(P, bn, ar.linear(x, P[f"{conv}.weight"][:, :, 0], P[f"{conv}.bias"]), dim=-1)
    return torch.relu(y) if relu else y


def _head_256(P, net, h, ar):
    h = torch.relu(_bn(P, f"{net}.bn1", ar.linear(h, P[f"{net}.fc1.weight"], P[f"{net}.fc1.bias"])))
    return torch.relu(_bn(P, f"{net}.bn2", ar.linear(h, P[f"{net}.fc2.weight"],
                                                     P[f"{net}.fc2.bias"])))


def pointnet_256(P, pts: torch.Tensor, ar: Arith) -> torch.Tensor:
    x = pts.to(ar.dtype)
    s = "pointnet.feat.stn"
    h = _pconv_bn(P, f"{s}.conv1", f"{s}.bn1", x, ar)
    h = _pconv_bn(P, f"{s}.conv2", f"{s}.bn2", h, ar)
    h = _pconv_bn(P, f"{s}.conv3", f"{s}.bn3", h, ar).amax(dim=1)
    h = torch.relu(_bn(P, f"{s}.bn4", ar.linear(h, P[f"{s}.fc1.weight"], P[f"{s}.fc1.bias"])))
    h = torch.relu(_bn(P, f"{s}.bn5", ar.linear(h, P[f"{s}.fc2.weight"], P[f"{s}.fc2.bias"])))
    trans = (ar.linear(h, P[f"{s}.fc3.weight"], P[f"{s}.fc3.bias"])
             + torch.eye(3, dtype=ar.dtype, device=x.device).reshape(1, 9)).reshape(-1, 3, 3)
    h = ar.bmm(x, trans)
    f = "pointnet.feat"
    h = _pconv_bn(P, f"{f}.conv1", f"{f}.bn1", h, ar)
    h = _pconv_bn(P, f"{f}.conv2", f"{f}.bn2", h, ar)
    h = _pconv_bn(P, f"{f}.conv3", f"{f}.bn3", h, ar, relu=False).amax(dim=1)
    return _head_256(P, "pointnet", h, ar)


def radarnet_256(P, pts: torch.Tensor, ar: Arith) -> torch.Tensor:
    f = "radarnet.feat"
    h = _pconv_bn(P, f"{f}.conv1", f"{f}.bn1", pts.to(ar.dtype), ar)
    h = _pconv_bn(P, f"{f}.conv2", f"{f}.bn2", h, ar)
    h = _pconv_bn(P, f"{f}.conv3", f"{f}.bn3", h, ar, relu=False).amax(dim=1)
    return _head_256(P, "radarnet", h, ar)


def encode_detections(P, img, lidar, radar, ar: Arith, chunk: int = 2048):
    """(x_img, pn, rn, lidar_present, radar_present) of every detection,
    ``chunk`` at a time (numpy inputs, tensors out on P's device)."""
    dev = next(iter(P.values())).device
    outs = ([], [], [])
    for lo in range(0, len(img), chunk):
        t = lambda a: torch.from_numpy(a[lo:lo + chunk]).to(dev)  # noqa: E731
        with torch.no_grad():
            outs[0].append(resnet_encode(P, t(img), ar))
            outs[1].append(pointnet_256(P, t(lidar), ar))
            outs[2].append(radarnet_256(P, t(radar), ar))
    def present(a):
        return torch.from_numpy(a.reshape(len(a), -1).astype(np.float32).sum(1) != 0).to(dev)

    return (*(torch.cat(o) for o in outs), present(lidar), present(radar))


# --------------------------------------------------------------------------
# the GNNs
# --------------------------------------------------------------------------

def window_logits(P, cfg, win: dict, enc, ar: Arith) -> torch.Tensor:
    """Edge logits [e] of one window (unpadded); ``enc`` the node
    encodings (MultimodalGNN) or None (PoseGNN)."""
    dev = next(iter(P.values())).device
    t = lambda a, dt=ar.dtype: torch.as_tensor(a).to(dev, dt)  # noqa: E731
    src, dst = t(win["src"], torch.int64), t(win["dst"], torch.int64)
    n = len(win["pose"])
    ea = mlp(P, "edge_encoder", t(win["edge_attr"]), ar)
    att_ea = None
    if enc is not None:
        x_img, pn, rn, lp, rp = enc
        x_lidar = torch.where(lp[:, None], mlp(P, "fc_lidar_encoder", pn, ar), 0.0)
        x_radar = torch.where(rp[:, None], mlp(P, "fc_radar_encoder", rn, ar), 0.0)

        def att(name, v):
            d = v.shape[-1]
            v = ar.linear(v, P[f"{name}.in_proj_weight"][2 * d:], P[f"{name}.in_proj_bias"][2 * d:])
            return ar.linear(v, P[f"{name}.out_proj.weight"], P[f"{name}.out_proj.bias"])

        sens = torch.cat([att("r2r_att", x_radar), att("l2l_att", x_lidar),
                          att("c2c_att", x_img)], dim=-1)
        att_ea = mlp(P, "att_edge_encoder", torch.cat([sens[dst], sens[src], ea], -1), ar)
    x = mlp(P, "node_encoder", t(win["pose"]), ar)
    x0 = x
    mp = "message_passing"
    for _ in range(cfg["gnn_depth"]):
        x_i, x_j = x[dst], x[src]
        edge_in = [x_i, x_j, ea] + ([att_ea] if att_ea is not None else [])
        ue = mlp(P, f"{mp}.edge_update", torch.cat(edge_in, -1), ar)
        fut = mlp(P, f"{mp}.create_future_msgs", torch.cat([x_i, ue, x0[dst]], -1), ar)
        past = mlp(P, f"{mp}.create_past_msgs", torch.cat([x_j, ue, x0[src]], -1), ar)
        agg_past = torch.zeros(n, past.shape[1], dtype=ar.dtype, device=dev).index_add(0, dst, past)
        agg_fut = torch.zeros(n, fut.shape[1], dtype=ar.dtype, device=dev).index_add(0, src, fut)
        x = mlp(P, f"{mp}.combine_future_past", torch.cat([agg_past, agg_fut], -1), ar)
        ea = ue
    return mlp(P, "edge_classifier", ea, ar)[:, 0]


class _StoredSigmoid(torch.autograd.Function):
    """The sigmoid of a float32 model: its output is a float32 tensor, and
    its gradient s (1 - s) is taken from that stored output. Near 1 the
    float32 grid (steps of 6e-8) decides which scores the loss's clamp
    meets and what log(1 - s) reads, so the reference rounds there too;
    everything before it stays in the reference's precision."""

    @staticmethod
    def forward(ctx, z):
        s = torch.sigmoid(z).to(torch.float32).to(z.dtype)
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * s * (1.0 - s)


def window_scores(P, cfg, win, enc, ar: Arith) -> torch.Tensor:
    z = window_logits(P, cfg, win, enc, ar)
    return z if cfg["model"] == "PoseGNN" else _StoredSigmoid.apply(z)


def batch_loss(P, cfg, wins: List[dict], encs, ar: Arith) -> torch.Tensor:
    """Class-balanced BCE summed over the batch's real edges, over their
    count, over the batch size (the upstream trainer's mean BCE divided by
    ``gnn.batch_size``)."""
    total, count = 0.0, 0
    for win, enc in zip(wins, encs):
        y = torch.as_tensor(win["label"]).to(P["edge_encoder.0.weight"].device, ar.dtype)
        w = torch.as_tensor(win["weight"]).to(y.device, ar.dtype)
        s = window_scores(P, cfg, win, enc, ar)
        if cfg["model"] == "PoseGNN":
            bce = torch.clamp(s, min=0) - s * y + torch.log1p(torch.exp(-s.abs()))
        else:
            s = torch.clamp(s, LOSS_LO, LOSS_HI)
            bce = -(y * torch.log(s) + (1.0 - y) * torch.log(1.0 - s))
        total = total + (bce * w).sum()
        count += len(y)
    return total / max(count, 1) / cfg["batch_size"]


def adam_steps(P: Dict[str, torch.Tensor], cfg, batches, ar: Arith, fault=None):
    """``len(batches)`` steps of torch-style Adam (the weight decay added to
    the gradient before the moments) from ``P``; ``batches`` are lists of
    (window, encodings). Returns (losses, the first step's gradients as the
    optimizer takes them, the parameters after the last step), the trained
    leaves only. The fault a check must catch, ``"half_batch"``: each
    step's loss over the first half of its windows only."""
    b1, b2 = cfg["betas"]
    lr, wd = cfg["lr"], cfg["weight_decay"]
    params = {k: v.detach().clone().requires_grad_(True) for k, v in P.items()
              if not is_frozen(k) and v.is_floating_point() and "running_" not in k}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first = [], None
    for step, batch in enumerate(batches, start=1):
        if fault == "half_batch":
            batch = batch[: max(1, len(batch) // 2)]
        full = {**P, **params}
        wins, encs = [w for w, _ in batch], [e for _, e in batch]
        loss = batch_loss(full, cfg, wins, encs, ar)
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            g = {k: gr + wd * params[k] for k, gr in zip(params, grads)}
            if first is None:
                first = {k: t.clone() for k, t in g.items()}
            c1, c2 = 1 - b1 ** step, 1 - b2 ** step
            for k, p in params.items():
                m[k].mul_(b1).add_(g[k], alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
                p.sub_(lr / c1 * m[k] / (torch.sqrt(v2[k]) / math.sqrt(c2) + 1e-8))
    return losses, first, {k: p.detach() for k, p in params.items()}
