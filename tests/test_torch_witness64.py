"""The float64 witness that decides ``chip_smoke.py``'s kernel checks
(``chip_smoke.fused_mp_plain64``: the port's plain message passing,
``fused_mp_scores_plain``, in float64) against the JAX package's own
message-passing loop (``batch3dmot_tpu/models/gnn.py``: its
``CausalMessagePassing`` depth times, then the edge classifier) in
float64 under ``jax.enable_x64``, on the same inputs (a numpy seed) and
weights (flax's draw, carried across by ``utils/weights.py``).

The JAX loop's ``segment_sum`` takes its one-hot matmul below 32M
one-hot elements, and that matmul accumulates in float32
(``ops/segment.py``: ``preferred_element_type=jnp.float32``) even on
float64 data. The loop here runs the package's other path, its
``xla_scatter`` segment sum (``jax.ops.segment_sum``, the package's own
choice above the one-hot limit), which keeps float64; nothing else of the
loop changes. Both sides then compute one function in float64 in two
summation orders: logits, the node states entering each layer and every
edge state after it agree at rtol 1e-10 (atol 1e-10 of the tensor's
largest magnitude), on valid edges (a masked edge's own state differs by
design: the flax loop gathers node 0, the port a zero row).
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batch3dmot_tpu_torch.models import make_model
from batch3dmot_tpu_torch.ops.fused_mp import extract_mp_params
from batch3dmot_tpu_torch.utils.weights import load_flax_variables

torch.set_num_threads(1)

RTOL = 1e-10


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flax_variables(name, depth):
    from batch3dmot_tpu.graph import pad_graph
    from batch3dmot_tpu.models import MultimodalGNN, PoseGNN

    model = PoseGNN(depth=depth) if name == "pose" else MultimodalGNN(depth=depth)
    g = pad_graph(
        pose=np.zeros((32, 19), np.float32),
        edge_src=np.zeros(128, np.int32), edge_dst=np.zeros(128, np.int32),
        edge_attr=np.zeros((128, 4), np.float32),
        node_time=np.zeros(32, np.int32), node_class=np.ones(32, np.int32),
        max_nodes=32, max_edges=128,
    )
    return model, jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.key(3), g))


def _jax_loop(module, x0, e0, att, src, dst, mask, depth):
    """The flax message-passing loop of ``forward_from_encodings`` on one
    window, its classifier's logit, and the states it passes."""
    x, e = x0, e0
    xs, es = [], [e0]
    for _ in range(depth):
        xs.append(x)
        x, e = module.message_passing(x, e, x0, src, dst, mask, att)
        es.append(e)
    return module.edge_classifier(e)[:, 0], jnp.stack(xs), jnp.stack(es)


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize("name, with_att, scale", [
    ("mm", True, 1.0),
    ("mm", True, 30.0),  # inputs 30x larger: the states reach the sizes of the card's checks
    ("pose", False, 1.0),
])
def test_witness64_matches_the_jax_loop_in_float64(monkeypatch, name, with_att, scale):
    """3 layers, 2 windows of (24, 96) with padding edges: the float64
    witness against the JAX loop in float64."""
    from batch3dmot_tpu.models import gnn
    from batch3dmot_tpu.ops import segment_sum

    depth, b, n, e = 3, 2, 24, 96
    flax_model, variables = _flax_variables(name, depth)
    model = load_flax_variables(make_model(name, depth=depth), variables)
    nd, ed = model.node_dim, model.edge_dim
    rng = np.random.default_rng(17)
    x0 = (rng.standard_normal((b, n, nd)) * scale).astype(np.float32)
    e0 = (rng.standard_normal((b, e, ed)) * scale).astype(np.float32)
    att = (rng.standard_normal((b, e, ed)) * scale).astype(np.float32) if with_att else None
    src = rng.integers(0, n, (b, e)).astype(np.int32)
    dst = rng.integers(0, n, (b, e)).astype(np.int32)
    mask = np.arange(e)[None, :] < np.array([[e - 17], [e - 40]])
    src[~mask] = 0
    dst[~mask] = 0

    flat, meta = extract_mp_params(model, with_att, nd, ed)
    t = [None if a is None else torch.from_numpy(a) for a in (x0, e0, att, src, dst, mask)]
    logits, xs, es, _ = _chip_smoke().fused_mp_plain64(*t, flat, meta, depth, logits=True,
                                                       carries=True)
    assert logits.dtype == torch.float64

    monkeypatch.setattr(gnn, "segment_sum",
                        functools.partial(segment_sum, method="xla_scatter"))
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        for k in range(b):
            up = lambda a: None if a is None else jnp.asarray(a[k], jnp.float64)  # noqa: E731
            ref = flax_model.apply(v64, up(x0), up(e0), up(att), jnp.asarray(src[k]),
                                   jnp.asarray(dst[k]), jnp.asarray(mask[k]), depth,
                                   method=_jax_loop)
            ref = [np.asarray(r) for r in ref]
            assert all(r.dtype == np.float64 for r in ref)
            m = mask[k]
            _close(logits[k].numpy()[m], ref[0][m], f"window {k} logits")
            _close(xs[k].numpy(), ref[1], f"window {k} node states")
            _close(es[k].numpy()[:, m], ref[2][:, m], f"window {k} edge states")
