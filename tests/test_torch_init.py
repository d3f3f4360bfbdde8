"""The port's fresh weights (``models/layers.py::init_params_``) against the
distributions the JAX package draws from (flax's defaults), leaf by leaf,
for ``mm`` in both kNN-conv modes, ``pose`` and the three standalone
encoders.

Target per leaf (named by the port's state-dict keys, the JAX draw mapped
onto them by ``utils/weights.py``): every bias, batch-norm shift and
running mean zero, batch-norm scales and running variances one, the
T-Nets' ``fc3`` zero, the single-token attention's query and key slices
zero; every kernel lecun-normal (``truncnorm(-2, 2)`` of scale
``1 / (0.8796 sqrt(fan_in))``, fan-in of the flax kernel's layout) and a
GATConv's attention vectors Glorot-uniform. The constant leaves must be
exactly equal, each random leaf must pass a one-sample Kolmogorov-Smirnov
test at 1e-3 over the leaves (Bonferroni), the seeds pooled for leaves
under 65,536 elements. The JAX draw
passes the same test (the target is right); the torch-style draw the port
had before (U(+-1/sqrt(fan_in)) weights and biases) fails it on every leaf
of 4,096 elements or more.
"""

import functools
import math

import jax
import numpy as np
import pytest
import torch
from scipy import stats

from batch3dmot_tpu_torch.models import init_params_, make_model
from batch3dmot_tpu_torch.models.encoders import PointNetClassifier, RadarNetClassifier, ResNetAE
from batch3dmot_tpu_torch.models.layers import GATConv, SingleTokenAttention
from batch3dmot_tpu_torch.utils.weights import flax_to_state_dict, load_encoder_variables

torch.set_num_threads(1)

SEEDS = (0, 1, 2)
ALPHA = 1e-3
LECUN_STD = 0.87962566103423978
BIG = 4096
POOL = 65536  # leaves smaller than this pool every seed's draw
CASES = ("mm", "mm-active", "pose", "resnet", "pointnet", "radarnet")


def _port_model(case):
    if case in ("mm", "mm-active", "pose"):
        name, mode = case.split("-")[0], "active" if case.endswith("active") else "noop"
        return make_model(name, depth=2, knn_conv_mode=mode)
    return {"resnet": ResNetAE, "pointnet": lambda: PointNetClassifier(7),
            "radarnet": lambda: RadarNetClassifier(7)}[case]()


def _state(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


@functools.cache
def _draws(source, case):
    """The draws of ``source`` ("port" or "jax") for every seed."""
    draw = _port_draw if source == "port" else _jax_draw
    return tuple(draw(case, s) for s in SEEDS)


def _port_draw(case, seed):
    return _state(init_params_(_port_model(case), torch.Generator().manual_seed(seed)))


_EXAMPLES = {}


def _jax_draw(case, seed):
    """``model.init`` of the JAX model, mapped onto the port's keys."""
    import jax.numpy as jnp

    if case in ("mm", "mm-active", "pose"):
        from batch3dmot_tpu.config import GraphConstructionConfig
        from batch3dmot_tpu.data.synthetic import make_synthetic_scene
        from batch3dmot_tpu.graphs import build_scene_graphs
        from batch3dmot_tpu.models import make_model as jax_make_model
        from batch3dmot_tpu.train.data import to_padded

        if "graph" not in _EXAMPLES:
            scene = make_synthetic_scene(seed=0, num_frames=4, num_tracks=3,
                                         with_modalities=True)
            w = [w for w in build_scene_graphs(scene, 3, GraphConstructionConfig(top_knn_nodes=3))
                 if w.num_edges][0]
            _EXAMPLES["graph"] = to_padded(w, 16, 64)
        name, mode = case.split("-")[0], "active" if case.endswith("active") else "noop"
        model = jax_make_model(name, depth=2, knn_conv_mode=mode)
        v = jax.jit(model.init)(jax.random.key(seed), _EXAMPLES["graph"])
        return flax_to_state_dict(jax.tree.map(np.asarray, v))
    from batch3dmot_tpu.models.encoders import PointNetClassifier as JPointNet
    from batch3dmot_tpu.models.encoders import RadarNetClassifier as JRadarNet
    from batch3dmot_tpu.models.encoders import ResNetAE as JResNetAE

    jmodel, x = {
        "resnet": (JResNetAE(), np.zeros((2, 32, 32, 3), np.float32)),
        "pointnet": (JPointNet(7), np.zeros((2, 16, 3), np.float32)),
        "radarnet": (JRadarNet(7), np.zeros((2, 16, 4), np.float32)),
    }[case]
    v = jax.jit(jmodel.init)(jax.random.key(seed), jnp.asarray(x))
    return _state(load_encoder_variables(_port_model(case), jax.tree.map(np.asarray, v)))


def _targets(model):
    """{key: (kind, arg)} of every leaf of a port model: ("const", value),
    ("lecun", fan_in), ("glorot", (fan_in, fan_out)) or ("attention", d)
    (zero query and key rows over lecun-normal value rows of fan-in d). The
    fan-in is the flax kernel's: a transposed conv's [in, out, kh, kw]
    weight is the flax decoder conv's in x kh x kw."""
    out = {}
    for mname, mod in model.named_modules():
        pre = f"{mname}." if mname else ""
        zero_children = getattr(mod, "ZERO_INIT", ())
        for child in zero_children:
            for pname, _ in getattr(mod, child).named_parameters():
                out[f"{pre}{child}.{pname}"] = ("const", 0.0)
        if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
            for name, value in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                                ("running_var", 1.0)):
                out[f"{pre}{name}"] = ("const", value)
            continue
        for name, p in mod.named_parameters(recurse=False):
            key = f"{pre}{name}"
            if key in out:
                continue
            if isinstance(mod, SingleTokenAttention):
                out[key] = ("attention", mod.dim) if name == "in_proj_weight" else ("const", 0.0)
            elif isinstance(mod, GATConv):
                out[key] = (("glorot", (mod.features, 1)) if name.startswith("att_")
                            else ("const", 0.0))
            elif name == "bias":
                out[key] = ("const", 0.0)
            elif isinstance(mod, torch.nn.ConvTranspose2d):
                out[key] = ("lecun", p.shape[0] * p.shape[2] * p.shape[3])
            else:
                out[key] = ("lecun", int(np.prod(p.shape[1:])))
    return out


def _dist(kind, arg):
    if kind == "lecun":
        return stats.truncnorm(-2.0, 2.0, scale=1.0 / (LECUN_STD * math.sqrt(arg)))
    lo, hi = arg
    bound = math.sqrt(6.0 / (lo + hi))
    return stats.uniform(-bound, 2 * bound)


def _leaf_checks(target, draws):
    """{key: passed} over the leaves of ``target``: constants exactly
    equal in every draw, random leaves (the seeds' draws pooled) through a
    KS test at ALPHA / (random leaves)."""
    random_leaves = [k for k, (kind, _) in target.items() if kind != "const"]
    level = ALPHA / len(random_leaves)
    out = {}
    for key, (kind, arg) in target.items():
        leaves = [d[key] for d in draws]
        if kind == "const":
            out[key] = all(np.array_equal(a, np.full_like(a, arg)) for a in leaves)
            continue
        if kind == "attention":
            zero_ok = all(not a[: 2 * arg].any() for a in leaves)
            leaves = [a[2 * arg:] for a in leaves]
            kind = "lecun"
        else:
            zero_ok = True
        if leaves[0].size >= POOL:
            leaves = leaves[:1]
        sample = np.concatenate([a.ravel() for a in leaves]).astype(np.float64)
        p = stats.kstest(sample, _dist(kind, arg).cdf).pvalue
        out[key] = zero_ok and p > level
    return out


@torch.no_grad()
def _torch_style_draw(model, gen):
    """The port's draw before it followed flax: U(+-1/sqrt(fan_in)) for
    weights and biases with torch's fan-in (``weight[0].numel()``, out x kh
    x kw for a transposed conv), Glorot-uniform GATConv leaves."""
    for mod in model.modules():
        if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
            mod.reset_parameters()
            continue
        for name, p in mod.named_parameters(recurse=False):
            if isinstance(mod, GATConv) and name != "bias":
                bound = math.sqrt(6.0 / (p.shape[-1] + p.shape[-2]))
            elif isinstance(mod, GATConv):
                p.zero_()
                continue
            elif isinstance(mod, SingleTokenAttention):
                bound = 1.0 / math.sqrt(mod.dim)
            elif p.dim() > 1:
                bound = 1.0 / math.sqrt(p[0].numel())
            else:
                bound = 1.0 / math.sqrt(mod.weight[0].numel())
            p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * bound)
    for mod in model.modules():
        if isinstance(mod, GATConv):
            mod.lin.weight.copy_((torch.rand(mod.lin.weight.shape, generator=gen) * 2 - 1)
                                 * math.sqrt(3.0 / mod.features))
    return model


@pytest.mark.parametrize("case", CASES)
def test_port_draw_fits_flax(case):
    """The port's draw: the JAX draw's keys, its constants exactly, its
    random leaves' distributions; reproducible by seed, new per seed."""
    target = _targets(_port_model(case))
    port = _draws("port", case)
    want = _draws("jax", case)[0]
    assert set(port[0]) == set(want) == set(target)
    for key, (kind, _) in target.items():
        assert port[0][key].shape == want[key].shape, key
        if kind == "const":
            np.testing.assert_array_equal(port[0][key], want[key], err_msg=key)
    failed = [k for k, ok in _leaf_checks(target, port).items() if not ok]
    assert not failed, failed
    again = _port_draw(case, SEEDS[0])
    for key in target:
        np.testing.assert_array_equal(again[key], port[0][key], err_msg=key)
    moved = [k for k, (kind, _) in target.items()
             if kind != "const" and not np.array_equal(port[0][k], port[1][k])]
    assert len(moved) == sum(kind != "const" for kind, _ in target.values())


@pytest.mark.parametrize("case", CASES)
def test_jax_draw_fits_the_target(case):
    """The JAX package's own draw passes the same test: the target is
    flax's."""
    target = _targets(_port_model(case))
    draws = _draws("jax", case)
    failed = [k for k, ok in _leaf_checks(target, draws).items() if not ok]
    assert not failed, failed


@pytest.mark.parametrize("case", CASES)
def test_torch_style_draw_fails(case):
    """The draw the port had before fails every leaf of BIG elements or
    more (so the test can tell the two apart)."""
    model = _port_model(case)
    target = _targets(model)
    draws = [_state(_torch_style_draw(_port_model(case), torch.Generator().manual_seed(s)))
             for s in SEEDS]
    checks = _leaf_checks(target, draws)
    big = [k for k in target if draws[0][k].size >= BIG]
    assert big
    passed = [k for k in big if checks[k]]
    assert not passed, passed
