"""The port's standalone encoders (``batch3dmot_tpu_torch/models/encoders.py``)
against the flax modules with the same weights, in eval and train mode:
the ResNet autoencoder's reconstruction, the classifiers' log-probabilities
and transforms, train-mode batch norm's running statistics, dropout, and
the weight bridges both ways (``utils/weights.py``, the JAX package's
``utils/torch_import.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batch3dmot_tpu.models.encoders import PointNetClassifier as JPointNet
from batch3dmot_tpu.models.encoders import RadarNetClassifier as JRadarNet
from batch3dmot_tpu.models.encoders import ResNetAE as JResNetAE
from batch3dmot_tpu.models.encoders import (
    feature_transform_regularizer as j_regularizer,
)
from batch3dmot_tpu.utils.torch_import import (
    import_pointnet,
    import_radarnet,
    import_resnet_ae,
)
from batch3dmot_tpu_torch.models.encoders import (
    PointNetClassifier,
    RadarNetClassifier,
    ResNetAE,
    dropout,
    feature_transform_regularizer,
)
from batch3dmot_tpu_torch.models.layers import batch_norm, batch_norm_last, init_params_
from batch3dmot_tpu_torch.utils.weights import encoder_variables, load_encoder_variables

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
# running statistics after one train-mode forward: both sides reduce the
# same f32 activations; the unbiased update would be off by N / (N - 1)
STATS_RTOL, STATS_ATOL = 1e-5, 1e-6


def _perturbed(variables, seed):
    """flax variables (numpy) with every batch-norm scale, bias, mean and
    variance randomised, so that the statistics and the affine matter."""
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        key = path[-1].key
        if key == "mean":
            return rng.normal(0, 0.5, x.shape).astype(np.float32)
        if key == "var":
            return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
        return x

    out = jax.tree.map(np.array, variables)  # writable copies
    out["batch_stats"] = jax.tree_util.tree_map_with_path(perturb, out["batch_stats"])
    for path, leaf in jax.tree_util.tree_flatten_with_path(out["params"])[0]:
        names = [p.key for p in path]
        if names[-1] == "scale":
            leaf[...] = rng.uniform(0.5, 1.5, leaf.shape)
        elif names[-1] == "bias" and any(n.startswith(("bn", "down_bn", "fc_bn")) for n in names):
            leaf[...] = rng.normal(0, 0.2, leaf.shape)
    return out


# (name, flax model, port model factory, input maker, flax kwargs)
def _cases(feature_transform=False):
    return {
        "resnet": (JResNetAE(), lambda: ResNetAE(),
                   lambda rng: rng.random((4, 32, 32, 3), dtype=np.float32), {}),
        "pointnet": (JPointNet(7, feature_transform=feature_transform),
                     lambda: PointNetClassifier(7, feature_transform=feature_transform,
                                                dropout=0.0),
                     lambda rng: rng.normal(size=(4, 16 if feature_transform else 32, 3))
                     .astype(np.float32), dict(deterministic=True)),
        "radarnet": (JRadarNet(7), lambda: RadarNetClassifier(7, dropout=0.0),
                     lambda rng: rng.normal(size=(4, 16, 4)).astype(np.float32),
                     dict(deterministic=True)),
    }


_VARS = {}


def _setup(name, feature_transform=False):
    jmodel, make_port, make_x, kw = _cases(feature_transform)[name]
    x = make_x(np.random.default_rng(1))
    key = (name, feature_transform)
    if key not in _VARS:
        v = jax.jit(jmodel.init)(jax.random.key(7), jnp.asarray(x))
        _VARS[key] = _perturbed(v, 3)
    return jmodel, load_encoder_variables(make_port(), _VARS[key]), _VARS[key], x, kw


def _outputs(result):
    """Every array of a model's result (reconstruction, log-probabilities,
    trans, trans_feat), as numpy."""
    items = result if isinstance(result, tuple) else (result,)
    return [np.asarray(r.detach() if isinstance(r, torch.Tensor) else r)
            for r in items if r is not None]


def _assert_tree_close(got, want, rtol, atol, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (where, sorted(got), sorted(want))
        for k in want:
            _assert_tree_close(got[k], want[k], rtol, atol, f"{where}/{k}")
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=where)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", ["resnet", "pointnet", "radarnet"])
def test_forward_matches_flax(name, train):
    """Reconstruction / log-probabilities (and PointNet's trans) against
    flax, with the running statistics (eval) or the batch's (train)."""
    jmodel, port, variables, x, kw = _setup(name)
    if train:
        want, _ = jmodel.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"],
                               **kw)
    else:
        want = jmodel.apply(variables, jnp.asarray(x), train=False, **kw)
    got = port(torch.from_numpy(x), train)
    for g, w in zip(_outputs(got), _outputs(want), strict=True):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["resnet", "pointnet", "radarnet"])
def test_running_statistics_match_flax(name):
    """One train-mode forward moves every running mean and variance as
    flax's BatchNorm does (biased batch variance, momentum 0.1); the eval
    forward leaves them alone."""
    jmodel, port, variables, x, kw = _setup(name)
    _, new = jmodel.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"], **kw)
    before = encoder_variables(port)["batch_stats"]
    port(torch.from_numpy(x), False)
    _assert_tree_close(encoder_variables(port)["batch_stats"], before, 0, 0)
    port(torch.from_numpy(x), True)
    _assert_tree_close(encoder_variables(port)["batch_stats"],
                       jax.tree.map(np.asarray, new["batch_stats"]), STATS_RTOL, STATS_ATOL)


def test_batch_norm_train_uses_biased_variance():
    """On a [4, 3] batch the running variance moves towards the biased
    variance (torch's BatchNorm module in training mode would take the
    unbiased one), in both layouts."""
    bn = torch.nn.BatchNorm1d(3)
    x = torch.tensor([[0.0, 1.0, 2.0], [1.0, 3.0, 2.0], [2.0, 2.0, 5.0], [5.0, 0.0, 1.0]])
    out = batch_norm(bn, x, True)
    var = x.var(dim=0, unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)
    torch.testing.assert_close(bn.running_mean, 0.1 * x.mean(dim=0))
    torch.testing.assert_close(out, (x - x.mean(0)) / torch.sqrt(var + 1e-5))
    ref = torch.nn.BatchNorm1d(3).train()
    ref(x)
    assert not torch.allclose(ref.running_var, bn.running_var)
    last = torch.nn.BatchNorm1d(3)
    torch.testing.assert_close(batch_norm_last(last, x.reshape(2, 2, 3), True),
                               out.reshape(2, 2, 3))
    torch.testing.assert_close(last.running_var, bn.running_var)


def test_dropout_statistics():
    """Inverted dropout at p = 0.3: about 30% zeros, the rest scaled by
    1 / 0.7; the mask follows the generator's stream; p = 0 is the
    identity."""
    x = torch.ones(400, 256)
    a = dropout(x, 0.3, torch.Generator().manual_seed(0))
    b = dropout(x, 0.3, torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    zeros = float((a == 0).float().mean())
    assert abs(zeros - 0.3) < 0.01, zeros
    torch.testing.assert_close(a[a != 0], torch.full_like(a[a != 0], 1 / 0.7))
    assert torch.equal(dropout(x, 0.0, None), x)


def test_classifier_dropout_in_train_mode_only():
    """The classifiers apply dropout (0.3 by default) after fc2 in train mode
    only: two generators give two results, one seed the same, eval mode
    none."""
    port = init_params_(PointNetClassifier(7), torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(8, 32, 3)).astype(np.float32))
    state = {k: v.clone() for k, v in port.state_dict().items()}

    def run(train, seed):
        port.load_state_dict(state)
        return port(x, train, torch.Generator().manual_seed(seed))[0]

    assert torch.equal(run(True, 1), run(True, 1))
    assert not torch.equal(run(True, 1), run(True, 2))
    assert torch.equal(run(False, 1), run(False, 2))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_pointnet_feature_transform_matches_flax(train):
    """feature_transform=True (the 64 x 64 fstn) at 16 points: log-probs,
    trans, trans_feat and the regularizer against flax."""
    jmodel, port, variables, x, kw = _setup("pointnet", feature_transform=True)
    if train:
        want, _ = jmodel.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"],
                               **kw)
    else:
        want = jmodel.apply(variables, jnp.asarray(x), train=False, **kw)
    got = port(torch.from_numpy(x), train)
    assert got[2].shape == (4, 64, 64)
    for g, w in zip(_outputs(got), _outputs(want), strict=True):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(feature_transform_regularizer(got[2].detach())),
                               float(j_regularizer(want[2])), rtol=RTOL)


def test_tnets_start_at_identity():
    """init_params_ zeroes every T-Net's fc3 (flax's fc_out init): trans
    and trans_feat start at the identity."""
    port = init_params_(PointNetClassifier(7, feature_transform=True),
                        torch.Generator().manual_seed(0))
    _, trans, trans_feat = port(torch.randn(2, 16, 3))
    torch.testing.assert_close(trans, torch.eye(3).expand(2, 3, 3))
    torch.testing.assert_close(trans_feat, torch.eye(64).expand(2, 64, 64))


def _standalone(name, feature_transform=False):
    make = {"resnet": lambda: ResNetAE(),
            "pointnet": lambda: PointNetClassifier(7, feature_transform=feature_transform),
            "radarnet": lambda: RadarNetClassifier(7)}[name]
    return make, init_params_(make(), torch.Generator().manual_seed(5))


@pytest.mark.parametrize("name,ft", [("resnet", False), ("pointnet", False),
                                     ("pointnet", True), ("radarnet", False)])
def test_round_trip_port_flax_port(name, ft):
    """port -> the JAX tree -> a fresh port model is the identity, decoder,
    fc3 and fstn included, and the tree has the flax init's structure."""
    make, port = _standalone(name, ft)
    tree = encoder_variables(port)
    back = load_encoder_variables(make(), tree)
    for (k, v), w in zip(port.state_dict().items(), back.state_dict().values(), strict=True):
        assert torch.equal(v, w), k
    if name == "pointnet" and ft:
        jvars = _VARS.get(("pointnet", True)) or _setup("pointnet", True)[2]
    else:
        jvars = _VARS.get((name, False)) or _setup(name)[2]
    assert (jax.tree.structure(jax.tree.map(lambda _: 0, tree))
            == jax.tree.structure(jax.tree.map(lambda _: 0, jvars)))


@pytest.mark.parametrize("name", ["resnet", "pointnet", "radarnet"])
def test_torch_import_reads_the_port_state_dict(name):
    """The JAX package's importers, applied to the port's state dict (the
    upstream names), give the tree the port's bridge gives: the decoder
    (flipped transposed-conv kernels) and fc3 included."""
    _, port = _standalone(name)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    importer = {"resnet": import_resnet_ae, "pointnet": import_pointnet,
                "radarnet": import_radarnet}[name]
    got = importer(sd)
    want = encoder_variables(port)
    _assert_tree_close(got, want, 0, 0)
    if name == "resnet":
        assert set(k for k in got["params"] if k.startswith("dec_")) == {
            f"dec_{j}" for j in range(5)}
    else:
        assert "fc3" in got["params"]
