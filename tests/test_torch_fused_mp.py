"""Fused message passing in the PyTorch port: the plain version against the
JAX package's Pallas kernel (interpreted on the CPU), and, on a CUDA card,
the Hopper kernel against the plain version.

The JAX side is imported inside the fixture, so the CUDA case also runs on
a machine without JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_fused_mp.py``.
"""

import numpy as np
import pytest
import torch

from batch3dmot_tpu_torch.graph import DEFAULT_BUCKETS
from batch3dmot_tpu_torch.models import init_params_, make_model
from batch3dmot_tpu_torch.ops.fused_mp import (
    edge_csr,
    extract_mp_params,
    fused_mp_scores,
    fused_mp_scores_plain,
    pack_mp_weights,
)

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5


def _inputs(rng, b, n, e, nd, ed, with_att, empty_windows=0):
    """Random window batch; window k has a random number of valid edges,
    the last ``empty_windows`` windows have none."""
    x0 = rng.standard_normal((b, n, nd)).astype(np.float32)
    e0 = rng.standard_normal((b, e, ed)).astype(np.float32)
    att = rng.standard_normal((b, e, ed)).astype(np.float32) if with_att else None
    src = rng.integers(0, n, (b, e)).astype(np.int32)
    dst = rng.integers(0, n, (b, e)).astype(np.int32)
    n_valid = rng.integers(e // 2, e + 1, b)
    n_valid[b - empty_windows:] = 0
    mask = np.arange(e)[None, :] < n_valid[:, None]
    src[~mask] = 0
    dst[~mask] = 0
    return x0, e0, att, src, dst, mask


@pytest.fixture(scope="module")
def jax_ref():
    import jax

    from batch3dmot_tpu.graph import pad_graph
    from batch3dmot_tpu.models import MultimodalGNN, PoseGNN
    from batch3dmot_tpu.ops import pallas_mp

    def init(name):
        model = PoseGNN() if name == "pose" else MultimodalGNN()
        g = pad_graph(
            pose=np.zeros((32, 19), np.float32),
            edge_src=np.zeros(128, np.int32), edge_dst=np.zeros(128, np.int32),
            edge_attr=np.zeros((128, 4), np.float32),
            node_time=np.zeros(32, np.int32), node_class=np.ones(32, np.int32),
            max_nodes=32, max_edges=128,
        )
        return jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.key(1), g))

    return init, pallas_mp


@pytest.mark.parametrize(
    "name, with_att, logits",
    [("mm", True, False), ("mm", False, False), ("pose", False, True)],
)
def test_plain_matches_pallas_interpret(jax_ref, name, with_att, logits):
    """(32, 128) buckets, 4 windows, depth 6, full widths: the port's plain
    fused_mp_scores against the JAX fused_mp_scores(interpret=True), with
    the same weights carried across by utils/weights.py."""
    import jax.numpy as jnp

    from batch3dmot_tpu_torch.utils.weights import load_flax_variables

    init, pallas_mp = jax_ref
    variables = init(name)
    model = load_flax_variables(make_model(name), variables)
    nd, ed = model.node_dim, model.edge_dim
    x0, e0, att, src, dst, mask = _inputs(
        np.random.default_rng(7), 4, 32, 128, nd, ed, with_att
    )

    jflat, jmeta = pallas_mp.extract_mp_params(variables["params"], with_att, nd, ed)
    ref = np.asarray(pallas_mp.fused_mp_scores(
        jnp.asarray(x0), jnp.asarray(e0), None if att is None else jnp.asarray(att),
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask), jflat, jmeta, 6,
        logits=logits, interpret=True,
    ))
    flat, meta = extract_mp_params(model, with_att, nd, ed)
    assert meta == jmeta
    for a, b in zip(flat, jflat):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = fused_mp_scores(
        torch.from_numpy(x0), torch.from_numpy(e0),
        None if att is None else torch.from_numpy(att),
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(mask),
        flat, meta, 6, logits=logits,
    ).numpy()
    np.testing.assert_allclose(got[mask], ref[mask], rtol=RTOL, atol=ATOL)


def test_all_masked_window(jax_ref):
    """A padding window (no valid edge) next to real ones: the real windows'
    scores are unchanged and the padding window's scores are finite and
    equal the Pallas kernel's (both gather zero rows for masked edges)."""
    import jax.numpy as jnp

    from batch3dmot_tpu_torch.utils.weights import load_flax_variables

    init, pallas_mp = jax_ref
    variables = init("mm")
    model = load_flax_variables(make_model("mm"), variables)
    x0, e0, att, src, dst, mask = _inputs(
        np.random.default_rng(3), 3, 32, 128, 96, 64, True, empty_windows=1
    )
    assert not mask[-1].any()
    flat, meta = extract_mp_params(model, True, 96, 64)
    t = [torch.from_numpy(a) for a in (x0, e0, att, src, dst, mask)]
    got = fused_mp_scores(*t, flat, meta, 6).numpy()
    alone = fused_mp_scores(*(a[:2] for a in t), flat, meta, 6).numpy()
    np.testing.assert_array_equal(got[:2], alone)
    assert np.isfinite(got).all()
    jflat, jmeta = pallas_mp.extract_mp_params(variables["params"], True, 96, 64)
    ref = np.asarray(pallas_mp.fused_mp_scores(
        *(jnp.asarray(a) for a in (x0, e0, att, src, dst, mask)),
        jflat, jmeta, 6, interpret=True,
    ))
    np.testing.assert_allclose(got[-1], ref[-1], rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name, bucket, windows, empty",
    [
        ("mm", (64, 512), 8, 1),
        ("mm", (256, 4096), 2, 0),
        ("cl_gnn_trad", (64, 512), 4, 0),
        ("pose", (128, 1024), 4, 1),
    ],
)
def test_cuda_kernel_matches_plain(name, bucket, windows, empty):
    """The Hopper kernel against its plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    assert bucket in DEFAULT_BUCKETS
    model = init_params_(make_model(name), torch.Generator().manual_seed(0))
    model = model.cuda().eval()
    pose = name == "pose"
    with_att = not pose
    nd, ed = model.node_dim, model.edge_dim
    arrays = _inputs(np.random.default_rng(5), windows, *bucket, nd, ed, with_att, empty)
    t = [None if a is None else torch.from_numpy(a).cuda() for a in arrays]
    flat, meta = extract_mp_params(model, with_att, nd, ed)
    before = fused_mp_scores.launches
    got = fused_mp_scores(*t, flat, meta, 6, logits=pose)
    torch.cuda.synchronize()
    assert fused_mp_scores.launches == before + 1
    ref = fused_mp_scores_plain(*t, flat, meta, 6, logits=pose)
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    assert np.isfinite(got).all()
    mask = arrays[-1]
    np.testing.assert_allclose(got[mask], ref[mask], rtol=RTOL, atol=ATOL)


def test_cuda_wrapper_never_falls_back():
    """On a non-CPU, non-CUDA tensor the wrapper raises instead of running
    the plain version."""
    model = make_model("pose", depth=1)
    flat, meta = extract_mp_params(model, False, 48, 32)
    x0 = torch.zeros(1, 4, 48, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_mp_scores(x0, x0, None, x0, x0, x0, flat, meta, 1)


def test_edge_csr_lists_each_nodes_valid_edges_in_order():
    """The kernel's per-node sums read this CSR: node n of window b owns
    perm[off[k]:off[k+1]] (k = b * (N + 1) + n), its valid edges in edge
    order as global ids b * E + e; masked edges (-1) belong to no node."""
    rng = np.random.default_rng(4)
    b, n, e = 3, 9, 40
    idx = rng.integers(0, n, (b, e)).astype(np.int32)
    idx[rng.random((b, e)) < 0.3] = -1
    off, perm = (t.numpy() for t in edge_csr(torch.from_numpy(idx), n))
    assert off.shape == (b * (n + 1) + 1,) and off[0] == 0
    for w in range(b):
        for node in range(n):
            k = w * (n + 1) + node
            want = [w * e + j for j in range(e) if idx[w, j] == node]
            assert perm[off[k]:off[k + 1]].tolist() == want
        k = w * (n + 1) + n  # the masked edges' sentinel row
        assert off[k + 1] - off[k] == (idx[w] < 0).sum()


@pytest.mark.parametrize("name", ["mm", "pose"])
def test_packed_weight_blob_layout(name):
    """The 29 arrays of the kernel's weight blob start on 16-byte
    boundaries and hold the split first layers in the order the kernel
    reads them (see Params in csrc/fused_mp.cu)."""
    model = init_params_(make_model(name), torch.Generator().manual_seed(3))
    with_att = name == "mm"
    nd, ed = model.node_dim, model.edge_dim
    flat, meta = extract_mp_params(model, with_att, nd, ed)
    blob, woff, w = pack_mp_weights(flat, meta, nd, ed, with_att)
    assert len(woff) == 29 and (woff % 4 == 0).all()
    mp = model.message_passing

    def array(i, shape):
        return blob[woff[i]: woff[i] + int(np.prod(shape))].reshape(shape)

    eu_w0 = mp.edge_update[0].weight.detach().t()  # [in, out]
    fut_w0 = mp.create_future_msgs[0].weight.detach().t()
    past_w0 = mp.create_past_msgs[0].weight.detach().t()
    ea = ed * (2 if with_att else 1)
    torch.testing.assert_close(array(0, (ea, w["H1"])), eu_w0[2 * nd:], rtol=0, atol=0)
    pw = 2 * w["H1"] + 4 * w["M1"]
    proj = torch.cat([eu_w0[:nd], eu_w0[nd:2 * nd], fut_w0[:nd], past_w0[:nd],
                      fut_w0[nd + ed:], past_w0[nd + ed:]], dim=1)
    torch.testing.assert_close(array(20, (nd, pw)), proj, rtol=0, atol=0)
    torch.testing.assert_close(array(6, (ed, w["M1"])), fut_w0[nd:nd + ed], rtol=0, atol=0)
    lb3 = model.edge_classifier[6].bias.detach()
    torch.testing.assert_close(array(28, (1,)), lb3, rtol=0, atol=0)


def test_fused_entries_refuse_active_knn_conv():
    """The kernel has no kNN GATConv: its model-level entries refuse a
    model in knn_conv_mode='active', as the JAX package's do."""
    from batch3dmot_tpu_torch.ops.fused_mp import (
        fused_logits_pose,
        fused_scores_from_encodings,
        fused_scores_full,
    )

    mm = make_model("mm", depth=1, knn_conv_mode="active")
    pose = make_model("pose", depth=1, knn_conv_mode="active")
    for call in (lambda: fused_scores_full(mm, None),
                 lambda: fused_scores_from_encodings(mm, None, *[None] * 5),
                 lambda: fused_logits_pose(pose, None)):
        with pytest.raises(ValueError, match="knn_conv_mode must be 'noop'"):
            call()
