"""Host side of the fused message-passing forward kernels (CPU): the launch
plan (``fused_mp_plan``), the TF32 split of the weights (``split_tf32``)
and the weight streams the tensor-core products read (``tc_weights``).
The kernels themselves run only on the card (``chip_smoke.py``)."""

import functools

import numpy as np
import pytest
import torch

from batch3dmot_tpu_torch.graph import DEFAULT_BUCKETS
from batch3dmot_tpu_torch.models import init_params_, make_model
from batch3dmot_tpu_torch.ops import fused_mp
from batch3dmot_tpu_torch.ops.fused_mp import (
    extract_mp_params,
    fused_mp_plan,
    mp_arrays,
    pack_mp_weights,
    split_tf32,
    stream_slices,
    tc_weights,
)

torch.set_num_threads(1)


@functools.cache
def _packed(name, with_att):
    """(flat weights, meta, blob, offsets, widths) of a seeded model."""
    model = init_params_(make_model(name), torch.Generator().manual_seed(2))
    flat, meta = extract_mp_params(model, with_att, model.node_dim, model.edge_dim)
    blob, woff, widths = pack_mp_weights(flat, meta, model.node_dim, model.edge_dim, with_att)
    return flat, meta, blob, woff, widths


def _passes(n):
    return -(-n // 256)


@pytest.mark.parametrize("with_att", [True, False])
@pytest.mark.parametrize("name", ["mm", "cl_gnn_trad", "pose"])
@pytest.mark.parametrize("bucket", DEFAULT_BUCKETS)
def test_plan_fits_the_kernels(bucket, name, with_att):
    """Every bucket at every model's widths, with and without attention,
    for 1, 2 and 8 windows: each kernel's shared memory within a block's,
    64-row edge tiles (wgmma's M), and column shares of the node
    projections that are whole passes, at least one, and no more than the
    (node tile, window) grid needs to fill the SMs."""
    w = _packed(name, with_att)[4]
    n, e = bucket
    qw, pw = 2 * w["H1"] + 2 * w["M1"], 2 * w["H1"] + 4 * w["M1"]
    px, pp = _passes(qw), _passes(qw) + _passes(pw - qw)
    for b in (1, 2, 8):
        plan = fused_mp_plan(b, n, e, w, with_att)
        assert plan["edge_rows"] == 64
        assert set(plan["smem"]) == {"edge", "node", "proj", "cls"}
        for kernel, nbytes in plan["smem"].items():
            assert 0 < nbytes <= fused_mp.SMEM_LIMIT and nbytes % 16 == 0, kernel
        tiles = b * -(-n // 16)
        for split, most in ((plan["node_split"], px), (plan["proj_split"], pp)):
            assert 1 <= split <= most
            assert split == 1 or tiles * split <= fused_mp.H100_SMS
            assert split == most or tiles * (split + 1) > fused_mp.H100_SMS


# the device pipeline's windows (max_nodes, max_nodes * k): the smoke's
# scenes at kNN 40, larger ones at kNN 40, and the largest: a dense
# nuScenes window (500 boxes a frame, L = 5) at kNN 40
PIPELINE_GRIDS = ((256, 10240), (512, 20480), (1024, 40960), (2560, 102400))


@pytest.mark.parametrize("windows", [1, 16, 64])
@pytest.mark.parametrize("grid", PIPELINE_GRIDS)
def test_plan_fits_the_pipeline_windows(grid, windows):
    """The device pipeline hands the inference kernel whole scenes' window
    grids, single and grouped: within the cover and its shared memory."""
    n, e = grid
    assert n <= fused_mp.COVER[0] and e <= fused_mp.COVER[1]
    plan = fused_mp_plan(windows, n, e, _packed("mm", True)[4], True)
    assert all(0 < v <= fused_mp.SMEM_LIMIT for v in plan["smem"].values())


def test_training_pair_keeps_the_largest_bucket():
    """The training pair is held to the largest bucket: a window of the
    wider inference cover is refused before any launch."""
    from batch3dmot_tpu_torch.ops.fused_mp_train import TRAIN_COVER, train_forward_cuda

    assert TRAIN_COVER == DEFAULT_BUCKETS[-1]
    flat, meta = _packed("mm", True)[:2]
    n, e = fused_mp.COVER
    x0, e0 = torch.zeros(1, n, 96), torch.zeros(1, e, 64)
    idx, mask = torch.zeros(1, e, dtype=torch.int32), torch.ones(1, e, dtype=torch.bool)
    with pytest.raises(ValueError, match="cover"):
        train_forward_cuda(x0, e0, e0, idx, idx, mask, flat, meta, 6)


@pytest.mark.parametrize("case", ["nodes", "edges", "ids", "width", "message lanes"])
def test_plan_refuses_shapes_outside_the_cover(case):
    """Beyond the cover, more windows than the int32 edge ids hold, a width
    that is not a multiple of 4, or a message width that the per-node sums
    cannot lay over a warp's lanes: refused on the host, before any
    launch."""
    w = dict(_packed("mm", True)[4])
    n, e = fused_mp.COVER
    b = 1
    assert fused_mp_plan(fused_mp.INT32_IDS // e, n, e, w, True)
    if case == "ids":
        b = fused_mp.INT32_IDS // e + 1
    elif case == "nodes":
        n *= 2
    elif case == "edges":
        e *= 2
    elif case == "width":
        w["H2"] = 130
    else:
        w["M"] = 96  # 24 float4 columns: no power of two of lanes
    with pytest.raises(ValueError):
        fused_mp_plan(b, n, e, w, True)


def _finite_f32(rng, size):
    """Finite float32 values over the whole exponent range, both signs,
    zeros and subnormals among them."""
    mant = rng.uniform(1.0, 2.0, size)
    expo = rng.integers(-149, 127, size).astype(np.float64)
    x = (np.sign(rng.standard_normal(size)) * mant * 2.0 ** expo).astype(np.float32)
    x[:8] = [0.0, -0.0, 1e-45, -1e-45, 3.4e38, -3.4e38, 1.0, -1.0]
    return x[np.isfinite(x)]


def test_split_tf32_matches_the_integer_rounding():
    """The host split equals the kernels' split_tf32 bit for bit: big =
    (bits + 0x1000) & 0xffffe000 on the uint32 pattern, small the same of
    x - big, here as a numpy uint32 reference."""
    x = _finite_f32(np.random.default_rng(0), 20000)
    got = split_tf32(torch.from_numpy(x)).numpy().view(np.uint32)
    big = (x.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    rest = (x - big.view(np.float32)).astype(np.float32)
    small = (rest.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    np.testing.assert_array_equal(got[: x.size], big)
    np.testing.assert_array_equal(got[x.size:], small)


def test_split_tf32_parts_rebuild_each_weight():
    """big + small rebuilds every weight to 2^-21 of its magnitude (and any
    value whose residual stays a normal float: |x| in [2^-100, 2^100]),
    and both parts carry no more than TF32's 10 mantissa bits (their low 13
    bits are zero): what the tensor cores multiply is exact."""
    _, _, blob, _, _ = _packed("mm", True)
    wide = torch.from_numpy(_finite_f32(np.random.default_rng(1), 4000))
    wide = wide[(wide.abs() >= 2.0 ** -100) & (wide.abs() <= 2.0 ** 100)]
    x = torch.cat([blob, wide])
    parts = split_tf32(x)
    big, small = parts[: x.numel()], parts[x.numel():]
    for part in (big, small):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    err = (x.double() - (big.double() + small.double())).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all())


@pytest.mark.parametrize("name, with_att", [("mm", True), ("mm", False), ("pose", False)])
def test_weight_streams_hold_every_weight(name, with_att):
    """tc_weights lays out the edge kernel's seven products and the node
    kernels' five as streams of slices: reading every slice back (big parts,
    then small parts, in the core-matrix order of stream_slices) rebuilds
    each weight matrix to 2^-21, with zeros past the matrix, and the node
    stream starts where the edge stream ends."""
    flat, meta, blob, woff, w = _packed(name, with_att)
    tc, node_at = tc_weights(blob, woff, w, with_att)
    tc = tc.numpy()
    arrays = [a.detach().double().numpy() for a in mp_arrays(flat, meta)]
    edge, node = fused_mp._streams(w, with_att)
    pos = 0
    for products, kc in ((edge, fused_mp._EDGE_KC), (node, fused_mp._NODE_KC)):
        if products is node:
            assert pos == node_at
        for i, k, n, _, col0 in products:
            want = arrays[i][:, col0:col0 + n]
            got = np.zeros((k, n))
            for row, col in stream_slices(k, n, kc):
                big, small = tc[pos:pos + row.size], tc[pos + row.size:pos + 2 * row.size]
                pos += 2 * row.size
                ok = row >= 0
                assert not big[~ok].any() and not small[~ok].any()
                got[row[ok], col[ok]] = big[ok].astype(np.float64) + small[ok]
            np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -21 * np.abs(want).max())
    assert pos == tc.size
