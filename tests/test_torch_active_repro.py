"""Reproducible active training in the PyTorch port: every gather of the
``knn_conv_mode='active'`` module loop whose input takes a gradient goes
through ``ops/segment.py::gather_rows``, whose backward is a segment sum in
a fixed order (B8 on the card), never ``torch.gather``'s scatter-add with
float atomics.

  * the structural guard: the graph of one active training loss (``mm``
    with attention, ``pose``) holds no autograd node of an atomic gather or
    scatter, and exactly the gather_rows and segment-sum nodes whose counts
    are the segment-sum kernel's launches per step on the card;
  * the rerouted sites' gradients equal ``torch.gather``'s (float64, exact
    up to the order of the sums), for D = 1 and D > 1;
  * the merged gathers (``[x | initial_x]`` at ``[src | dst]``, the two
    attention-score vectors) give the separate gathers' forward bit for bit.

Port only: the active paths' parity with the JAX package is held in
``tests/test_torch_train.py``, ``test_torch_models.py`` and
``test_torch_predict.py``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from batch3dmot_tpu_torch.config import GNNConfig, GraphConstructionConfig
from batch3dmot_tpu_torch.data.synthetic import make_synthetic_scene
from batch3dmot_tpu_torch.graphs import build_scene_graphs
from batch3dmot_tpu_torch.models import init_params_, make_model
from batch3dmot_tpu_torch.models.gnn import CausalMessagePassing
from batch3dmot_tpu_torch.models.layers import GATConv
from batch3dmot_tpu_torch.ops.segment import gather_rows, segment_max, segment_softmax, segment_sum
from batch3dmot_tpu_torch.ops.segment_kernel import gather_segments
from batch3dmot_tpu_torch.train.data import GraphBatcher
from batch3dmot_tpu_torch.train.encoded import EncodedGraphBatcher, precompute_scene_encodings
from batch3dmot_tpu_torch.train.trainer import GNNTrainer

torch.set_num_threads(1)

# autograd nodes whose backward adds with float atomics on the card
ATOMIC = {"GatherBackward0", "ScatterAddBackward0", "IndexSelectBackward0", "IndexBackward0"}
BUCKETS = ((32, 128), (64, 256))
DEPTH, CONVS = 6, 3  # the kNN GATConv runs before layers 0, 2, 4


def _graph_nodes(root):
    """Every node of the autograd graph below ``root``, once."""
    seen, stack = {}, [root]
    while stack:
        node = stack.pop()
        if node is None or id(node) in seen:
            continue
        seen[id(node)] = node
        stack.extend(n for n, _ in node.next_functions)
    return list(seen.values())


@pytest.fixture(scope="module")
def windows():
    scene = make_synthetic_scene(seed=5, num_frames=6, num_tracks=5, with_modalities=True)
    ws = list(build_scene_graphs(scene, 3, GraphConstructionConfig(top_knn_nodes=4)))
    return scene, ws


@pytest.mark.parametrize("name", ["mm", "pose"])
def test_active_loss_has_no_atomic_gather(name, windows):
    """One active training loss at depth 6: no node of its graph is an
    atomic gather or scatter; the gathers are gather_rows nodes, one per
    layer ([x | initial_x]), four per GATConv (both scores, the messages,
    the softmax's max and denominator) and, for mm, the two attention
    rows: the segment-sum kernel's launches in a step's backward on the
    card, one per gather_rows node (the forward's are its 2 * 6 + 2 * 3
    segment sums, of which the last layer's two feed no loss)."""
    scene, ws = windows
    model = init_params_(make_model(name, knn_conv_mode="active", knn_conv_k=3),
                         torch.Generator().manual_seed(2))
    trainer = GNNTrainer(model, GNNConfig(batch_size=2, loss="cb"), device="cpu",
                         init_state_dict=model.state_dict())
    if name == "mm":
        enc = precompute_scene_encodings(model, scene, device="cpu")
        batch = next(EncodedGraphBatcher([(w, enc) for w in ws], 2, BUCKETS, seed=0,
                                         uniform=True).epoch())
    else:
        batch = next(GraphBatcher(ws, 2, BUCKETS, seed=0).epoch())
    loss, _ = trainer._loss(trainer._to_device(batch))
    names = [n.name() for n in _graph_nodes(loss.grad_fn)]
    assert not ATOMIC & set(names), sorted(ATOMIC & set(names))
    gathers = names.count("_GatherRowsBackward")
    assert gathers == DEPTH + 4 * CONVS + (2 if name == "mm" else 0), gathers
    assert names.count("_SegmentSumBackward") == 2 * (DEPTH - 1) + 2 * CONVS
    loss.backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    assert all(torch.isfinite(g).all() for g in grads)
    assert {k for k, p in model.named_parameters()
            if k.startswith("knn_conv.") and p.grad is not None} == {
        "knn_conv.lin.weight", "knn_conv.att_src", "knn_conv.att_dst", "knn_conv.bias"}


@pytest.mark.parametrize("lead, d", [((2,), 1), ((2,), 7), ((2, 3), 1), ((2, 3), 5)])
def test_gather_rows_gradient_equals_torch_gather(lead, d):
    """gather_rows against torch.gather on the same clamped ids (repeats
    and ids outside [0, N) included), float64: the forward bit for bit,
    the gradient exact up to the order of its sums."""
    rng = np.random.default_rng(d)
    n, e = 6, 20
    x = torch.from_numpy(rng.standard_normal((*lead, n, d)))
    ids = torch.from_numpy(rng.integers(-2, n + 2, (*lead, e)))
    ct = torch.from_numpy(rng.standard_normal((*lead, e, d)))
    a = x.clone().requires_grad_()
    got = gather_rows(a, ids)
    (g_got,) = torch.autograd.grad(got, a, ct)
    b = x.clone().requires_grad_()
    idx = ids.clamp(0, n - 1)[..., None].expand(*lead, e, d)
    want = torch.gather(b, -2, idx)
    (g_want,) = torch.autograd.grad(want, b, ct)
    assert torch.equal(got, want)
    torch.testing.assert_close(g_got, g_want, rtol=1e-12, atol=0)
    assert torch.equal(gather_rows(x, ids), want)  # no gradient: the plain gather


def _edges(rng, b, n, e):
    src = torch.from_numpy(rng.integers(0, n, (b, e)))
    dst = torch.from_numpy(rng.integers(0, n, (b, e)))
    mask = torch.from_numpy(rng.random((b, e)) < 0.8)
    return src, dst, mask


def _gather(x, idx):
    """The separate gather of the earlier formulation: torch.gather."""
    return torch.gather(x, 1, idx.long().unsqueeze(-1).expand(-1, -1, x.shape[-1]))


def _mp_separate(mp, x, edge_attr, initial_x, src, dst, edge_mask, att):
    """CausalMessagePassing with four separate gathers."""
    n = x.shape[-2]
    x_j, x_i = _gather(x, src), _gather(x, dst)
    init_j, init_i = _gather(initial_x, src), _gather(initial_x, dst)
    ue = mp.edge_update(torch.cat([x_i, x_j, edge_attr, att], dim=-1))
    future = mp.create_future_msgs(torch.cat([x_i, ue, init_i], dim=-1))
    past = mp.create_past_msgs(torch.cat([x_j, ue, init_j], dim=-1))
    agg = torch.cat([segment_sum(past, dst, n, edge_mask),
                     segment_sum(future, src, n, edge_mask)], dim=-1)
    return mp.combine_future_past(agg), ue


def _softmax_separate(scores, ids, n, mask):
    """segment_softmax with torch.gather (gather_segments) for the max and
    the denominator."""
    s = scores[..., None]
    shifted = s - gather_segments(segment_max(s, ids, n, mask, initial=0.0), ids)
    shifted = torch.where(mask[..., None], shifted, float("-inf"))
    expd = torch.exp(shifted)
    expd = torch.where(torch.isfinite(expd), expd, 0.0)
    denom = segment_sum(expd, ids, n, mask)
    return (expd / gather_segments(denom, ids).clamp_min(1e-16))[..., 0]


def _gat_separate(conv, x, src, dst, edge_mask):
    """GATConv with the two score gathers and the message gather separate."""
    n = x.shape[-2]
    wx = conv.lin(x)
    s_src = (wx @ conv.att_src.reshape(-1, 1))[..., 0]
    s_dst = (wx @ conv.att_dst.reshape(-1, 1))[..., 0]
    alpha = torch.gather(s_src, 1, src.long()) + torch.gather(s_dst, 1, dst.long())
    alpha = F.leaky_relu(alpha, conv.negative_slope)
    alpha = _softmax_separate(alpha, dst, n, edge_mask)
    return segment_sum(_gather(wx, src) * alpha[..., None], dst, n, edge_mask) + conv.bias


def _site_inputs(name, dtype):
    rng = np.random.default_rng(11)
    b, n, e, d = 2, 7, 24, 12
    src, dst, mask = _edges(rng, b, n, e)
    gen = torch.Generator().manual_seed(4)
    if name == "mp":
        module = init_params_(CausalMessagePassing(d, 8, 16, edge_update_hidden=(20, 12)), gen)
        args = [torch.from_numpy(rng.standard_normal(s)) for s in
                ((b, n, d), (b, e, 8), (b, n, d), (b, e, 8))]
        x, ea, x0, att = (t.to(dtype) for t in args)
        return (module.to(dtype), (x, ea, x0, att), lambda m, t: m(t[0], t[1], t[2], src, dst,
                                                                     mask, t[3]),
                lambda m, t: _mp_separate(m, t[0], t[1], t[2], src, dst, mask, t[3]))
    module = init_params_(GATConv(d), gen)
    x = torch.from_numpy(rng.standard_normal((b, n, d))).to(dtype)
    return (module.to(dtype), (x,), lambda m, t: (m(t[0], src, dst, mask),),
            lambda m, t: (_gat_separate(m, t[0], src, dst, mask),))


@pytest.mark.parametrize("name", ["mp", "gat"])
def test_merged_gathers_forward_bit_identical(name):
    """float32: the merged gathers give the separate gathers' outputs bit
    for bit, with and without a gradient."""
    module, inputs, merged, separate = _site_inputs(name, torch.float32)
    for grad in (False, True):
        leaves = tuple(t.clone().requires_grad_(grad) for t in inputs)
        for a, b in zip(merged(module, leaves), separate(module, leaves)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["mp", "gat"])
def test_rerouted_sites_gradients_equal_torch_gather(name):
    """float64: the gradients of every input and parameter through the
    rerouted sites (the message-passing layer; the GATConv with its
    segment softmax) equal those of the torch.gather formulation, exact
    up to the order of the sums."""
    module, inputs, merged, separate = _site_inputs(name, torch.float64)
    grads, cts = [], None
    for fn in (merged, separate):
        leaves = tuple(t.clone().requires_grad_() for t in inputs)
        outs = fn(module, leaves)
        if cts is None:
            rng = np.random.default_rng(5)
            cts = [torch.from_numpy(rng.standard_normal(o.shape)) for o in outs]
        wrt = (*leaves, *module.parameters())
        grads.append(torch.autograd.grad(outs, wrt, cts, allow_unused=True))
    for got, want in zip(*grads):
        assert (got is None) == (want is None)
        if got is not None:
            torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-14)


def test_segment_softmax_gradient_equals_torch_gather():
    """segment_softmax (the max and the denominator through gather_rows,
    D = 1) against its torch.gather formulation, float64."""
    rng = np.random.default_rng(3)
    src, dst, mask = _edges(rng, 2, 5, 30)
    scores = torch.from_numpy(rng.standard_normal((2, 30)))
    ct = torch.from_numpy(rng.standard_normal((2, 30)))
    out = []
    for fn in (segment_softmax, _softmax_separate):
        s = scores.clone().requires_grad_()
        y = fn(s, dst, 5, mask)
        out.append((y, *torch.autograd.grad(y, s, ct)))
    assert torch.equal(out[0][0], out[1][0])
    torch.testing.assert_close(out[0][1], out[1][1], rtol=1e-12, atol=1e-15)
