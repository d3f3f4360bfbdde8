"""The kNN graph and the graph attention convolution of the PyTorch port
against the JAX package on the CPU: ``knn_graph_masked`` edge for edge
(ties at the k-th boundary, the same-time constraint, rows with fewer than
k allowed neighbours, all-padding windows) and ``GATConv`` against the flax
``GATConv`` with the same weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batch3dmot_tpu.models.layers import GATConv as JaxGATConv
from batch3dmot_tpu.ops import knn_graph_masked as jax_knn
from batch3dmot_tpu.ops import pairwise_sq_dists as jax_sq_dists
from batch3dmot_tpu_torch.models.layers import GATConv, init_params_
from batch3dmot_tpu_torch.ops.knn import knn_graph_masked, pairwise_sq_dists

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5


def _jax_graph(x, k, valid, times):
    """The JAX kNN graph of every window, as numpy [B, N * k] arrays."""
    def one(xw, vw, tw):
        return jax_knn(xw, k, valid=vw, pair_valid=tw[None, :] == tw[:, None])

    return [np.asarray(a) for a in jax.vmap(one)(
        jnp.asarray(x), jnp.asarray(valid), jnp.asarray(times))]


def _port_graph(x, k, valid, times):
    t = torch.from_numpy(times)
    out = knn_graph_masked(torch.from_numpy(x), k, valid=torch.from_numpy(valid),
                           pair_valid=t[..., None, :] == t[..., :, None])
    return [a.numpy() for a in out]


def _windows(rng, b, n, d, n_times, integer=False):
    """x [B, N, D] (small integers, so that distances are exact and tie, or
    Gaussian), a valid prefix per window (the last window all padding) and
    node times in [0, n_times) (-1 on padding); node 0 is alone at time
    n_times, a row with no allowed neighbour."""
    if integer:
        x = rng.integers(-1, 2, (b, n, d)).astype(np.float32)
    else:
        x = rng.standard_normal((b, n, d)).astype(np.float32)
    n_valid = rng.integers(n // 2, n + 1, b)
    n_valid[-1] = 0
    valid = np.arange(n)[None, :] < n_valid[:, None]
    times = rng.integers(0, n_times, (b, n))
    times[:, 0] = n_times
    times = np.where(valid, times, -1).astype(np.int32)
    x[~valid] = 0.0
    return x, valid, times


@pytest.mark.parametrize("integer", [True, False], ids=["ties", "gaussian"])
@pytest.mark.parametrize("k", [3, 6])
def test_knn_graph_matches_jax(integer, k):
    """Edge for edge, in order. Integer coordinates make many distances
    equal (the neighbour set at the k-th boundary then depends on the tie
    order); with 3 time steps among at most 32 valid nodes, some rows have
    fewer than k allowed neighbours; the last window is all padding."""
    rng = np.random.default_rng(10 + k)
    x, valid, times = _windows(rng, 4, 32, 3, 3, integer)
    got = _port_graph(x, k, valid, times)
    ref = _jax_graph(x, k, valid, times)
    for g, r, what in zip(got, ref, ("src", "dst", "mask")):
        np.testing.assert_array_equal(g, r, err_msg=what)
    src, dst, mask = got
    assert not mask[-1].any()
    per_row = mask.reshape(4, 32, k).sum(-1)
    assert (per_row[valid] < k).any() and (per_row[valid] == k).any()
    assert (times[np.arange(4)[:, None], src] == times[np.arange(4)[:, None], dst])[mask].all()
    if integer:
        d = np.asarray(jax.vmap(jax_sq_dists)(jnp.asarray(x)))
        full = mask.reshape(4, 32, k).all(-1)
        kth = np.take_along_axis(d, src.reshape(4, 32, k)[..., -1:], -1)[..., 0]
        # a tie at the boundary: an allowed node left out at the k-th distance
        allowed = (valid[:, None, :] & valid[:, :, None]
                   & (times[:, None, :] == times[:, :, None]) & ~np.eye(32, dtype=bool))
        chosen = np.zeros_like(allowed)
        np.put_along_axis(chosen, src.reshape(4, 32, k), True, -1)
        left_out_tied = allowed & ~chosen & (d == kth[..., None])
        assert (left_out_tied.any(-1) & full).any()


def test_pairwise_sq_dists_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 9, 5)).astype(np.float32)
    got = pairwise_sq_dists(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.vmap(jax_sq_dists)(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert (got >= 0).all()


def test_gat_conv_matches_flax():
    """Flax-initialised weights carried onto PyG's names and shapes; the
    conv over a kNN graph with masked edges, then its gradient with respect
    to x and every parameter."""
    rng = np.random.default_rng(4)
    b, n, f, k = 3, 20, 12, 4
    x, valid, times = _windows(rng, b, n, f, 3)
    src, dst, mask = _port_graph(x, k, valid, times)
    jconv = JaxGATConv(f)
    params = jax.jit(jconv.init)(jax.random.key(1), x[0], src[0], dst[0], mask[0])["params"]
    params = jax.tree.map(np.asarray, params)
    params["bias"] = rng.standard_normal(f).astype(np.float32)  # non-zero

    conv = GATConv(f)
    conv.load_state_dict({
        "lin.weight": torch.from_numpy(params["lin"]["kernel"].T.copy()),
        "att_src": torch.tensor(params["att_src"].reshape(1, 1, f)),
        "att_dst": torch.tensor(params["att_dst"].reshape(1, 1, f)),
        "bias": torch.from_numpy(params["bias"]),
    })
    ct = rng.standard_normal((b, n, f)).astype(np.float32)

    def jax_loss(p, xx):
        out = jax.vmap(lambda a, s, d, m: jconv.apply({"params": p}, a, s, d, m))(
            xx, src, dst, mask)
        return jnp.sum(out * ct), out

    (_, ref), (g_p, g_x) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = conv(xt, *(torch.from_numpy(a) for a in (src, dst, mask)))
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), rtol=RTOL, atol=ATOL)
    grads = {
        "lin.weight": np.asarray(g_p["lin"]["kernel"]).T,
        "att_src": np.asarray(g_p["att_src"]).reshape(1, 1, f),
        "att_dst": np.asarray(g_p["att_dst"]).reshape(1, 1, f),
        "bias": np.asarray(g_p["bias"]),
    }
    for name, p in conv.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name], rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_gat_conv_init_is_glorot_and_seeded():
    """``init_params_`` gives the GATConv what flax gives the JAX GATConv:
    Glorot-uniform attention vectors, a lecun-normal ``lin`` (a normal of
    std 1/sqrt(fan_in) cut at two of its standard deviations) and a zero
    bias; the same seed gives the same weights."""
    a = init_params_(GATConv(48), torch.Generator().manual_seed(3))
    b = init_params_(GATConv(48), torch.Generator().manual_seed(3))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    assert not a.bias.any()
    cut = 2.0 / (0.87962566103423978 * 48 ** 0.5)
    for p, bound in ((a.lin.weight, cut), (a.att_src, (6.0 / 49) ** 0.5),
                     (a.att_dst, (6.0 / 49) ** 0.5)):
        assert p.abs().max() <= bound and p.abs().max() > 0.8 * bound
    assert float(a.lin.weight.std()) == pytest.approx(1.0 / 48 ** 0.5, rel=0.05)
