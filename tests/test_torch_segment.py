"""Segment reductions in the PyTorch port against the JAX package on the CPU:
the segment sum's plain version (through the dispatcher) against the Pallas
segment-sum kernel (interpreted) and the JAX ``segment_sum``, its backward
against ``jax.grad``, and ``segment_max``, ``segment_mean`` and
``segment_softmax``; on a CUDA card, the Hopper kernel against its plain
version.

The JAX side is imported inside the tests, so the CUDA cases also run on a
machine without JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_segment.py``.
"""

import numpy as np
import pytest
import torch

from batch3dmot_tpu_torch.ops import segment_kernel
from batch3dmot_tpu_torch.ops.segment import (
    segment_max,
    segment_mean,
    segment_softmax,
    segment_sum,
)
from batch3dmot_tpu_torch.ops.segment_kernel import segment_sum_plain

torch.set_num_threads(1)

# f32 sums of at most a few hundred terms in another order (one-hot
# products, serial index_add_)
RTOL, ATOL = 1e-5, 1e-5


def _inputs(rng, lead, e, n, d, p_valid=0.7, empty=False):
    """data [*lead, E, D], ids [*lead, E] in [0, N - 2] (segment N - 1 stays
    empty), mask [*lead, E]; masked edges carry id 0 and huge data, which
    must reach no sum. ``empty`` masks every edge of the first window."""
    data = rng.standard_normal((*lead, e, d)).astype(np.float32)
    ids = rng.integers(0, n - 1, (*lead, e)).astype(np.int32)
    mask = rng.random((*lead, e)) < p_valid
    if empty:
        mask.reshape(-1, e)[0] = False
    ids[~mask] = 0
    data[~mask] = 1e30
    return data, ids, mask


def _per_window(fn, data, ids, mask):
    """fn(data [E, D], ids [E], mask [E]) over every window, stacked back
    into the leading shape; masked data zeroed for the JAX side."""
    lead = ids.shape[:-1]
    e, d = data.shape[-2:]
    data = np.where(mask[..., None], data, 0.0).reshape(-1, e, d)
    outs = [np.asarray(fn(a, i, m)) for a, i, m in
            zip(data, ids.reshape(-1, e), mask.reshape(-1, e))]
    return np.stack(outs).reshape(*lead, *outs[0].shape)


@pytest.mark.parametrize("d", [1, 48, 96, 128])
def test_segment_sum_matches_pallas_and_jax(d):
    """Windows [2, 3], N = 77 and E = 300 (not multiples of the Pallas
    tiles 128 and 512), masked edges with id 0, an all-masked window."""
    import jax.numpy as jnp

    from batch3dmot_tpu.ops import segment_sum as jax_segment_sum
    from batch3dmot_tpu.ops.pallas_segment import segment_sum_pallas

    n, e = 77, 300
    data, ids, mask = _inputs(np.random.default_rng(d), (2, 3), e, n, d, empty=True)
    t = [torch.from_numpy(a) for a in (data, ids, mask)]
    got = segment_sum(t[0], t[1], n, t[2]).numpy()
    assert got.shape == (2, 3, n, d)
    assert np.abs(got).max() < 1e3 and not got.reshape(6, n, d)[0].any()
    assert not got[..., n - 1, :].any()  # the empty segment
    pallas = _per_window(lambda a, i, m: segment_sum_pallas(
        jnp.asarray(a), jnp.asarray(i), n, jnp.asarray(m), interpret=True), data, ids, mask)
    ref = _per_window(lambda a, i, m: jax_segment_sum(
        jnp.asarray(a), jnp.asarray(i), n, jnp.asarray(m)), data, ids, mask)
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_segment_sum_backward_matches_jax_grad():
    """The autograd backward (a masked gather) against ``jax.grad`` of the
    JAX segment sum under a random cotangent."""
    import jax
    import jax.numpy as jnp

    from batch3dmot_tpu.ops import segment_sum as jax_segment_sum

    n, e, d = 23, 90, 48
    rng = np.random.default_rng(5)
    data, ids, mask = _inputs(rng, (3,), e, n, d)
    data = np.where(mask[..., None], data, 0.5).astype(np.float32)
    ct = rng.standard_normal((3, n, d)).astype(np.float32)

    def loss(x):
        out = jax.vmap(lambda a, i, m: jax_segment_sum(a, i, n, m))(
            x, jnp.asarray(ids), jnp.asarray(mask))
        return jnp.sum(out * ct)

    want = np.asarray(jax.grad(loss)(jnp.asarray(data)))
    x = torch.from_numpy(data).requires_grad_()
    out = segment_sum(x, torch.from_numpy(ids), n, torch.from_numpy(mask))
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=RTOL, atol=ATOL)
    assert not x.grad.numpy()[~mask].any()


def test_segment_max_and_mean_match_jax():
    """Masked edges, an empty segment (``initial``) and an all-masked
    window."""
    import jax.numpy as jnp

    from batch3dmot_tpu.ops import segment_max as jax_segment_max
    from batch3dmot_tpu.ops import segment_mean as jax_segment_mean

    n, e, d = 11, 60, 3
    data, ids, mask = _inputs(np.random.default_rng(8), (2, 2), e, n, d, empty=True)
    t = [torch.from_numpy(a) for a in (data, ids, mask)]
    for initial in (0.0, -5.0):
        got = segment_max(t[0], t[1], n, t[2], initial=initial).numpy()
        ref = _per_window(lambda a, i, m: jax_segment_max(
            jnp.asarray(a), jnp.asarray(i), n, jnp.asarray(m), initial=initial),
            data, ids, mask)
        np.testing.assert_array_equal(got, ref)
        assert (got[..., n - 1, :] == initial).all()
    got = segment_mean(*t[:2], n, t[2]).numpy()
    ref = _per_window(lambda a, i, m: jax_segment_mean(
        jnp.asarray(a), jnp.asarray(i), n, jnp.asarray(m)), data, ids, mask)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_segment_softmax_and_its_gradient_match_jax():
    """Per-edge scores [..., E] (the GATConv's form): the softmax within
    each destination, zero on masked edges, and the gradient of a weighted
    sum of it."""
    import jax
    import jax.numpy as jnp

    from batch3dmot_tpu.ops import segment_softmax as jax_segment_softmax

    n, e = 17, 80
    rng = np.random.default_rng(9)
    _, ids, mask = _inputs(rng, (3,), e, n, 1)
    scores = (3.0 * rng.standard_normal((3, e))).astype(np.float32)
    w = rng.standard_normal((3, e)).astype(np.float32)

    def jax_sm(s):
        return jax.vmap(lambda a, i, m: jax_segment_softmax(a, i, n, m))(
            s, jnp.asarray(ids), jnp.asarray(mask))

    ref = np.asarray(jax_sm(jnp.asarray(scores)))
    want_grad = np.asarray(jax.grad(lambda s: jnp.sum(jax_sm(s) * w))(jnp.asarray(scores)))
    s = torch.from_numpy(scores).requires_grad_()
    got = segment_softmax(s, torch.from_numpy(ids), n, torch.from_numpy(mask))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=RTOL, atol=ATOL)
    assert not got.detach().numpy()[~mask].any()
    np.testing.assert_allclose(s.grad.numpy(), want_grad, rtol=1e-4, atol=ATOL)


def test_segment_sum_refuses_other_devices():
    """On a non-CPU, non-CUDA tensor the dispatcher raises instead of
    running the plain version."""
    x = torch.zeros(1, 4, 2, device="meta")
    ids = torch.zeros(1, 4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        segment_sum(x, ids, 3)


# the path's shapes: mm message passing (D 128), the GAT messages (D 96,
# 48) and softmax denominators (D 1), pose message passing (D 64), the
# largest bucket and the device pipeline's largest window (several edge
# chunks per block), and windows with no valid edge
CUDA_CASES = [
    ((8,), 256, 4096, 128, False),
    ((8,), 256, 5120, 96, False),
    ((8,), 256, 5120, 1, False),
    ((8,), 128, 1024, 64, True),
    ((8,), 128, 2560, 48, False),
    ((1,), 1024, 32768, 128, False),
    ((1,), 1024, 32768, 1, False),
    ((1,), 1024, 40960, 128, False),  # the device pipeline's largest window
    ((2, 3), 77, 300, 6, True),
]


@pytest.mark.parametrize("lead, n, e, d, empty", CUDA_CASES + [
    ((8,), 256, 4096, 4096, False),  # wide rows: the tile shrinks below 8
    ((1,), 5, 0, 3, False),  # no edges at all
])
def test_segment_plan_fits_the_kernel(lead, n, e, d, empty):
    """The kernel's launch plan: a node tile of 1-32 (one warp scans its
    counts), at least 8 unless the accumulators need fewer, two blocks per
    SM unless the tile is already 8, accumulators within their budget, an
    edge chunk that is a multiple of the block and covers a window up to
    MAX_CHUNK edges, and the shared memory the kernel carves."""
    windows = int(np.prod(lead))
    tile, chunk, smem = segment_kernel.segment_plan(windows, n, e, d)
    assert 1 <= tile <= segment_kernel.MAX_TILE
    assert tile * d * 4 <= segment_kernel.ACC_BYTES or tile == 1
    if tile * 2 * d * 4 <= segment_kernel.ACC_BYTES and tile < segment_kernel.MAX_TILE:
        assert tile == 8 or windows * -(-n // (2 * tile)) < 2 * segment_kernel.H100_SMS
    if tile < 8:
        assert tile * 2 * d * 4 > segment_kernel.ACC_BYTES
    assert chunk % segment_kernel.THREADS == 0 and chunk <= segment_kernel.MAX_CHUNK
    assert chunk >= min(e, segment_kernel.MAX_CHUNK)
    warps = segment_kernel.THREADS // 32
    need = 4 * tile * d + 4 * chunk + 4 * warps * tile + 4 * (tile + 1) + chunk
    assert need <= smem < need + 16 and smem % 16 == 0
    assert smem <= segment_kernel.SMEM_LIMIT


def test_segment_plan_refuses_rows_too_wide_for_shared_memory():
    """A row so wide that one node's accumulator and a chunk exceed a
    block's shared memory is refused on the host, before any launch."""
    with pytest.raises(ValueError, match="shared memory"):
        segment_kernel.segment_plan(1, 4, 4096, 64 * 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("lead, n, e, d, empty", CUDA_CASES)
def test_cuda_kernel_matches_plain(lead, n, e, d, empty):
    """The Hopper kernel against its plain version on the card: forward at
    the stated tolerance, bit-identical across two runs and with int64 ids
    (as the kNN graph gives them), one launch per call, and the backward
    against autograd of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    arrays = _inputs(np.random.default_rng(e + d), lead, e, n, d, empty=empty)
    data, ids, mask = (torch.from_numpy(a).cuda() for a in arrays)
    before = segment_sum.launches
    got = segment_sum(data, ids, n, mask)
    again = segment_sum(data, ids, n, mask)
    torch.cuda.synchronize()
    wide = segment_sum(data, ids.long(), n, mask)
    torch.cuda.synchronize()
    assert segment_sum.launches == before + 3
    assert torch.equal(got, again) and torch.equal(got, wide)
    ref = segment_sum_plain(data, ids, n, mask)
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-5)

    x = torch.where(mask[..., None], data, 0.5).requires_grad_()
    ct = torch.randn(*lead, n, d, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    (g_kernel,) = torch.autograd.grad(segment_sum(x, ids, n, mask), x, ct)
    (g_plain,) = torch.autograd.grad(segment_kernel.segment_sum_plain(x, ids, n, mask), x, ct)
    torch.testing.assert_close(g_kernel, g_plain, rtol=0, atol=0)


@pytest.mark.cuda
def test_traced_launches_counts_every_replay():
    """torch.profiler's count of the kernel in a CUDA graph replayed 4
    times, 40 traces in a row: 4 in each (a trace that lost the records of
    its first milliseconds would count fewer, or raise for a lost marker),
    and the replays' sum equals the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from batch3dmot_tpu_torch.ops.cuda_build import traced_launches

    n = 64
    arrays = _inputs(np.random.default_rng(0), (2,), 512, n, 32)
    data, ids, mask = (torch.from_numpy(a).cuda() for a in arrays)
    segment_sum(data, ids, n, mask)  # builds and loads the library
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = segment_sum(data, ids, n, mask)

    def run():
        for _ in range(4):
            graph.replay()

    counts = [traced_launches(run) for _ in range(40)]
    assert all(c == {"segment_sum_kernel": 4} for c in counts), counts
    torch.testing.assert_close(out, segment_sum_plain(data, ids, n, mask), rtol=2e-4, atol=2e-5)
