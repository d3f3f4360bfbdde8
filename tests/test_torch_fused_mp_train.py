"""Fused message-passing training in the PyTorch port: on the CPU, the
plain version (autograd through the layer loop) against the JAX package's
Pallas training kernels run in interpret mode, the monolithic B4/B5 pair
and the edge-tiled B6/B7 pair; on a CUDA card, the Hopper kernel pair
against the plain version.

The JAX side is imported inside the fixture, so the CUDA case also runs on
a machine without JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_fused_mp_train.py``.
"""

import numpy as np
import pytest
import torch

from batch3dmot_tpu_torch.graph import batch_graphs, pad_graph
from batch3dmot_tpu_torch.models import init_params_, make_model
from batch3dmot_tpu_torch.ops.fused_mp import extract_mp_params, fused_mp_scores_plain
from batch3dmot_tpu_torch.ops.fused_mp_train import (
    fused_mp_train_scores,
    fused_training_scores,
)

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5  # scores: f32, sums in another order
GRAD_RTOL, GRAD_ATOL = 5e-3, 2e-4  # gradients: atol is relative to max|ref|
FROZEN = ("resnet", "pointnet", "radarnet")


def _windows(rng, n_windows, n, e):
    """Random window graphs (numpy kwargs for pad_graph) with a random
    number of real nodes and edges each."""
    out = []
    for _ in range(n_windows):
        nn_ = int(rng.integers(n // 2, n + 1))
        ne = int(rng.integers(e // 2, e + 1))
        out.append(dict(
            pose=rng.standard_normal((nn_, 19)).astype(np.float32),
            edge_src=rng.integers(0, nn_, ne).astype(np.int32),
            edge_dst=rng.integers(0, nn_, ne).astype(np.int32),
            edge_attr=rng.standard_normal((ne, 4)).astype(np.float32),
            node_time=rng.integers(0, 3, nn_).astype(np.int32),
            node_class=rng.integers(1, 8, nn_).astype(np.int32),
            edge_label=rng.integers(0, 2, ne).astype(np.float32),
            edge_weight=rng.uniform(0.5, 2.0, ne).astype(np.float32),
            max_nodes=n, max_edges=e,
        ))
    return out


def _encodings(rng, b, n):
    return (
        rng.standard_normal((b, n, 96)).astype(np.float32),
        rng.standard_normal((b, n, 256)).astype(np.float32),
        rng.standard_normal((b, n, 256)).astype(np.float32),
        rng.random((b, n)) < 0.7,
        rng.random((b, n)) < 0.7,
    )


@pytest.fixture(scope="module")
def jax_train():
    import jax
    import jax.numpy as jnp

    from batch3dmot_tpu.graph import batch_graphs as jax_batch
    from batch3dmot_tpu.graph import pad_graph as jax_pad
    from batch3dmot_tpu.models import make_model as jax_make_model
    from batch3dmot_tpu.ops.pallas_mp_train import fused_training_scores as jax_fts

    def run(name, depth, windows, enc, weights, force_tiles):
        """Flax variables, the loss sum(scores * weights) and its gradient
        through the Pallas training kernels (interpret mode)."""
        model = jax_make_model(name, depth=depth)
        graph = jax_batch([jax_pad(**w) for w in windows])
        variables = jax.jit(model.init)(
            jax.random.key(2), jax.tree.map(lambda x: x[0], graph)
        )
        variables = jax.tree.map(np.asarray, dict(variables))
        extra = {k: v for k, v in variables.items() if k != "params"}
        enc_j = None if enc is None else tuple(jnp.asarray(a) for a in enc)

        def loss(params):
            s = jax_fts(model, extra, params, graph, encodings=enc_j,
                        interpret=True, force_tiles=force_tiles)
            return jnp.sum(s * weights), s

        (_, scores), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
        return variables, np.asarray(scores), jax.tree.map(np.asarray, grads)

    return run


def _port_grads(model):
    return {k: p.grad.numpy() for k, p in model.named_parameters()
            if p.grad is not None}


def assert_grads_close(got, ref, what, ties=False):
    """Every reference leaf at the gradient tolerance (atol relative to the
    leaf's largest magnitude). ``ties``: a leaf with elements outside it is
    held as a whole to a relative L2 error of 1e-2 instead (at large shapes
    a ReLU whose f32 pre-activation is within rounding of zero takes
    different branches in two summation orders, and the flip spreads
    through the layers below it)."""
    assert set(got) == set(ref), (what, set(got) ^ set(ref))
    for k, r in ref.items():
        scale = max(float(np.abs(r).max()), 1e-6)
        rel_l2 = np.linalg.norm((got[k] - r).ravel()) / max(np.linalg.norm(r.ravel()), 1e-30)
        if ties and rel_l2 <= 1e-2:
            continue
        np.testing.assert_allclose(
            got[k], r, rtol=GRAD_RTOL, atol=GRAD_ATOL * scale,
            err_msg=f"{what}: gradient of {k}",
        )


@pytest.mark.parametrize(
    "name, force_tiles",
    [("pose", None), ("pose", 4), ("mm", None), ("mm", 4)],
    ids=["pose-B4B5", "pose-B6B7", "mm-B4B5", "mm-B6B7"],
)
def test_plain_matches_pallas_training_interpret(jax_train, name, force_tiles):
    """(32, 128) x2, depth 2, full widths (mm from encodings): the port's
    scores and every parameter gradient of sum(scores * w), w non-zero on
    every edge (masked ones too), against the JAX fused_training_scores
    through the monolithic (B4/B5) or the 4-tile (B6/B7) Pallas pair."""
    from batch3dmot_tpu_torch.utils.weights import (
        flax_grads_to_state_dict,
        load_flax_variables,
    )

    rng = np.random.default_rng(11)
    windows = _windows(rng, 2, 32, 128)
    enc = None if name == "pose" else _encodings(rng, 2, 32)
    weights = rng.uniform(-1.0, 1.0, (2, 128)).astype(np.float32)
    variables, ref_scores, ref_grads = jax_train(
        name, 2, windows, enc, weights, force_tiles)

    model = load_flax_variables(make_model(name, depth=2), variables)
    for mod in FROZEN:
        if hasattr(model, mod):
            getattr(model, mod).requires_grad_(False)
    batch = batch_graphs([pad_graph(**w) for w in windows])
    enc_t = None if enc is None else tuple(torch.from_numpy(a) for a in enc)
    scores = fused_training_scores(model, batch, enc_t)
    (scores * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(scores.detach().numpy(), ref_scores, rtol=RTOL, atol=ATOL)
    assert_grads_close(_port_grads(model), flax_grads_to_state_dict(ref_grads),
                       f"{name} tiles={force_tiles}")


def test_mm_without_encodings_runs_the_frozen_encoders():
    """Without precomputed encodings the frozen encoders run inside the
    call, without gradient: the same scores and gradients as passing their
    outputs, and no encoder parameter gets a gradient."""
    rng = np.random.default_rng(3)
    model = init_params_(make_model("mm", depth=1), torch.Generator().manual_seed(0))
    windows = _windows(rng, 2, 16, 64)
    for w in windows:
        n = len(w["pose"])
        w.update(img=rng.integers(0, 256, (n, 32, 32, 3)).astype(np.uint8),
                 lidar=rng.standard_normal((n, 128, 3)).astype(np.float32),
                 radar=rng.standard_normal((n, 64, 4)).astype(np.float32))
    batch = batch_graphs([pad_graph(**w) for w in windows])
    full = fused_training_scores(model, batch)
    full.sum().backward()
    g_full = _port_grads(model)
    assert not any(k.split(".")[0] in FROZEN for k in g_full)

    model.zero_grad(set_to_none=True)
    b, n = batch.pose.shape[:2]
    flat = lambda t: t.reshape(b * n, *t.shape[2:])  # noqa: E731
    with torch.no_grad():
        xi, pn, rn = model.encode_frozen(flat(batch.img), flat(batch.lidar), flat(batch.radar))
    enc = (xi.reshape(b, n, -1), pn.reshape(b, n, -1), rn.reshape(b, n, -1),
           batch.lidar.sum(dim=(-2, -1)) != 0, batch.radar.sum(dim=(-2, -1)) != 0)
    from_enc = fused_training_scores(model, batch, enc)
    from_enc.sum().backward()
    torch.testing.assert_close(full, from_enc, rtol=0, atol=0)
    g_enc = _port_grads(model)
    assert set(g_enc) == set(g_full)
    for k, v in g_full.items():
        np.testing.assert_array_equal(g_enc[k], v, err_msg=k)


def test_cuda_wrapper_never_falls_back():
    """On a non-CPU, non-CUDA tensor the wrapper raises instead of running
    the plain version."""
    model = make_model("pose", depth=1)
    flat, meta = extract_mp_params(model, False, 48, 32, trainable=True)
    x0 = torch.zeros(1, 4, 48, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_mp_train_scores(x0, x0, None, x0, x0, x0, flat, meta, 1)


def _train_inputs(rng, b, n, e, nd, ed, with_att, empty):
    """Kernel-level inputs on the card: features, indices, a mask whose
    last ``empty`` windows are all padding, and a cotangent that is
    non-zero on every edge."""
    x0 = rng.standard_normal((b, n, nd)).astype(np.float32)
    e0 = rng.standard_normal((b, e, ed)).astype(np.float32)
    att = rng.standard_normal((b, e, ed)).astype(np.float32) if with_att else None
    src = rng.integers(0, n, (b, e)).astype(np.int32)
    dst = rng.integers(0, n, (b, e)).astype(np.int32)
    n_valid = rng.integers(e // 2, e + 1, b)
    n_valid[b - empty:] = 0
    mask = np.arange(e)[None, :] < n_valid[:, None]
    src[~mask] = 0
    dst[~mask] = 0
    ct = rng.uniform(-1.0, 1.0, (b, e)).astype(np.float32)
    return x0, e0, att, src, dst, mask, ct


def kernel_and_plain(model, arrays, depth, logits):
    """Scores and gradients (dx0, de0, datt, then every parameter) of the
    kernel pair and of the plain version on the same CUDA inputs."""
    x0, e0, att, src, dst, mask, ct = arrays
    cuda = lambda a: None if a is None else torch.from_numpy(a).cuda()  # noqa: E731
    results = []
    for fn in (fused_mp_train_scores, fused_mp_scores_plain):
        model.zero_grad(set_to_none=True)
        xs = [None if a is None else cuda(a).requires_grad_() for a in (x0, e0, att)]
        flat, meta = extract_mp_params(model, att is not None, model.node_dim,
                                       model.edge_dim, trainable=True)
        s = fn(*xs, cuda(src), cuda(dst), cuda(mask), flat, meta, depth, logits)
        s.backward(cuda(ct))
        grads = {k: t.grad for k, t in zip(("dx0", "de0", "datt"), xs) if t is not None}
        grads.update({k: p.grad.clone() for k, p in model.named_parameters()
                      if p.grad is not None})
        results.append((s.detach(), grads))
    return results


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name, bucket, windows, empty",
    [("mm", (64, 512), 2, 1), ("mm", (256, 4096), 2, 0), ("mm", (512, 4096), 1, 0),
     ("pose", (128, 1024), 3, 1)],
)
def test_cuda_training_kernels_match_plain(name, bucket, windows, empty):
    """The Hopper pair against autograd of the plain version on the card,
    and the backward bit-identical across two runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = init_params_(make_model(name), torch.Generator().manual_seed(0)).cuda()
    pose = name == "pose"
    arrays = _train_inputs(np.random.default_rng(5), windows, *bucket,
                           model.node_dim, model.edge_dim, not pose, empty)
    f0, b0 = fused_mp_train_scores.fwd_launches, fused_mp_train_scores.bwd_launches
    (got, g_k), (ref, g_p) = kernel_and_plain(model, arrays, 6, pose)
    torch.cuda.synchronize()
    assert fused_mp_train_scores.fwd_launches == f0 + 1
    assert fused_mp_train_scores.bwd_launches == b0 + 1
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    assert_grads_close({k: v.cpu().numpy() for k, v in g_k.items()},
                       {k: v.cpu().numpy() for k, v in g_p.items()}, name,
                       ties=True)
    (_, again), _ = kernel_and_plain(model, arrays, 6, pose)
    for k in g_k:
        assert torch.equal(g_k[k], again[k]), f"{k} differs between two backward runs"


@pytest.mark.parametrize("name", ["mm", "pose"])
def test_relu_masks_from_stashes_replay_the_loop(name):
    """The ReLU masks recomputed from the training stashes (x_t, e_t,
    agg_t) of the plain loop itself replay it bit for bit, scores and
    gradients; flipping one replayed mask changes the gradients, so the
    replay is what autograd differentiates."""
    from batch3dmot_tpu_torch.ops.fused_mp import relu_masks_from_stashes

    # seed 1: no ReLU of the classifier is dead everywhere (a dead last
    # hidden layer would zero every gradient, flipped masks or not)
    model = init_params_(make_model(name, depth=2), torch.Generator().manual_seed(1))
    pose = name == "pose"
    x0, e0, att, src, dst, mask, ct = (
        None if a is None else torch.from_numpy(a)
        for a in _train_inputs(np.random.default_rng(9), 2, 16, 48, model.node_dim,
                               model.edge_dim, not pose, 1))

    def run(**kw):
        model.zero_grad(set_to_none=True)
        leaves = [None if t is None else t.clone().requires_grad_() for t in (x0, e0, att)]
        flat, meta = extract_mp_params(model, att is not None, model.node_dim,
                                       model.edge_dim, trainable=True)
        out = fused_mp_scores_plain(*leaves, src, dst, mask, flat, meta, 2, pose, **kw)
        scores = out[0] if kw.get("carries") else out
        scores.backward(ct)
        grads = [t.grad for t in leaves if t is not None]
        grads += [p.grad.clone() for p in model.parameters() if p.grad is not None]
        return out, grads, flat, meta

    (scores, *stashes), grads, flat, meta = run(carries=True)
    assert stashes[2].shape == (2, 2, 16, 2 * (64 if pose else 128))
    masks = relu_masks_from_stashes([s.detach() for s in stashes], att, src, dst, mask,
                                    [w.detach() for w in flat], meta, 2)
    assert len(masks) == 2 * 6 + 3 and all(0 < float(m.float().mean()) < 1 for m in masks)
    replayed, r_grads, _, _ = run(relu_masks=masks)
    assert torch.equal(replayed, scores.detach())
    assert all(torch.equal(a, b) for a, b in zip(r_grads, grads))
    flipped = list(masks)
    flipped[3] = flipped[3].clone()
    flipped[3].view(-1)[: flipped[3].numel() // 2] ^= True
    _, f_grads, _, _ = run(relu_masks=flipped)
    assert any(not torch.equal(a, b) for a, b in zip(f_grads, grads))


@pytest.mark.parametrize("name", ["mm", "pose"])
def test_mask_entry_plain_path_replays_exactly(name):
    """The mask entry's plain path (``fused_mp_train_masks`` on CPU tensors:
    relu_masks_from_stashes in float64 on the plain version's own stashes),
    replayed through the plain version, gives its gradients and scores
    exactly, and the training wrapper's; the masks lie in the layout the
    kernel's mask buffer is read in (``_mask_views``), and every unit's
    pre-activation lies within its scale."""
    from batch3dmot_tpu_torch.ops.fused_mp import relu_preactivations_from_stashes
    from batch3dmot_tpu_torch.ops.fused_mp_train import _mask_views, fused_mp_train_masks

    model = init_params_(make_model(name, depth=2), torch.Generator().manual_seed(1)).double()
    pose = name == "pose"
    x0, e0, att, src, dst, mask, ct = (
        None if a is None else torch.from_numpy(a)
        for a in _train_inputs(np.random.default_rng(4), 2, 16, 48, model.node_dim,
                               model.edge_dim, not pose, 1))
    x0, e0, ct = x0.double(), e0.double(), ct.double()
    att = None if att is None else att.double()
    flat, meta = extract_mp_params(model, not pose, model.node_dim, model.edge_dim)
    scores, stashes, grads, masks = fused_mp_train_masks(
        x0, e0, att, src, dst, mask, flat, meta, 2, ct, logits=pose)
    assert len(masks) == 2 * 6 + 3 and all(m.dtype == torch.bool for m in masks)

    def replay(**kw):
        leaves = [None if t is None else t.clone().requires_grad_() for t in (x0, e0, att)]
        ws = [w.clone().requires_grad_() for w in flat]
        out = fused_mp_scores_plain(*leaves, src, dst, mask, ws, meta, 2, pose, **kw)
        wanted = [t for t in (*leaves, *ws) if t is not None]
        return out, torch.autograd.grad(out, wanted, ct)

    want = [g for g in grads if g is not None]
    for kw in ({"relu_masks": masks}, {}):
        out, got = replay(**kw)
        assert torch.equal(out, scores)
        assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))

    # the kernel's byte buffer, filled in relu_masks_from_stashes' order,
    # reads back as these masks
    widths = dict(H1=masks[0].shape[-1], H2=masks[1].shape[-1], M1=masks[2].shape[-1],
                  C1=masks[4].shape[-1], C2=masks[5].shape[-1], L1=masks[-3].shape[-1],
                  L2=masks[-2].shape[-1], L3=masks[-1].shape[-1])
    buf = torch.cat([m.reshape(-1).to(torch.uint8) for m in masks])
    views = _mask_views(buf, widths, 2, 16, 48, 2)
    assert all(torch.equal(v, m) for v, m in zip(views, masks))
    with pytest.raises(ValueError, match="mask bytes"):
        _mask_views(buf[:-1], widths, 2, 16, 48, 2)

    pre = relu_preactivations_from_stashes(stashes, att, src, dst, mask, flat, meta, 2)
    assert all(torch.equal(z > 0, m) for (z, _), m in zip(pre, masks))
    assert all(bool((z.abs() <= s).all()) for z, s in pre)
