"""Data-parallel encoder training in the PyTorch port
(``EncoderTrainer(mesh=)``, global batch norm, random draws by global rows)
on two gloo ranks on the CPU: ``fit`` and ``fit_device`` of the ResNet-AE
against the JAX trainer on ``make_mesh(2)`` (the set-ups of the JAX
package's ``test_resnet_dp_sharded`` and
``test_encoder_fit_device_learns_and_shards``); train-mode batch norm's
outputs, gradients and running statistics against flax's on the global
batch; and a PointNet with dropout and the LiDAR augmentation on two ranks
against the port in one process on the same seed; the gradients of one
step of each, summed over the ranks, against one process's.

The two ranks run once, in a module fixture; the JAX package runs in this
process only.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from batch3dmot_tpu_torch.config import EncoderTrainConfig
from batch3dmot_tpu_torch.models.layers import batch_norm
from batch3dmot_tpu_torch.parallel.mesh import data_parallel, spawn
from batch3dmot_tpu_torch.train import encoders as tenc

torch.set_num_threads(1)

RANKS = 2
LOSS_REL = 1e-4
RTOL, ATOL = 2e-4, 2e-5
# batch-norm cases: input shapes [B, C, ...]
BN_SHAPES = {"dense": (8, 6), "conv": (4, 5, 3, 3), "points": (4, 7, 5)}
FIT_CFG = dict(lr=1e-3)  # test_resnet_dp_sharded
DEVICE_CFG = dict(batch_size=4, lr=1e-3)  # test_encoder_fit_device_learns_and_shards


def _data():
    """The host batches and datasets, from numpy seeds."""
    rng = np.random.default_rng(0)
    fit_batches = [rng.random((16, 32, 32, 3), dtype=np.float32) for _ in range(2)]
    imgs = (rng.random((16, 32, 32, 3)) * 255).astype(np.uint8)
    labels = rng.integers(0, 7, (16,), dtype=np.int32)
    bn = {name: (rng.normal(1.0, 2.0, shape).astype(np.float32),
                 rng.normal(size=shape).astype(np.float32),
                 rng.normal(1.0, 0.3, shape[1]).astype(np.float32),
                 rng.normal(size=shape[1]).astype(np.float32))
          for name, shape in BN_SHAPES.items()}
    clouds = _clouds(np.random.default_rng(4), 32, 4, 48, 16)
    return fit_batches, (imgs, labels), bn, clouds


def _clouds(rng, n, ch, kcap, num_points, classes=3):
    """Padded clouds [n, ch, kcap], counts (some above num_points), labels."""
    labels = rng.integers(0, classes, n).astype(np.int32)
    counts = rng.integers(num_points // 2, kcap + 1, n).astype(np.int32)
    clouds = np.zeros((n, ch, kcap), np.float32)
    for i in range(n):
        pts = rng.normal(0, 0.2, (ch, counts[i]))
        pts[0] += 3.0 * labels[i]
        clouds[i, :, :counts[i]] = pts
    return clouds, counts, labels


def _bn_rank(mesh, x, ct, w, b):
    """Train-mode batch norm of this rank's rows of x under the mesh:
    (output rows, their dx, this rank's dw and db terms, running stats)."""
    bn = torch.nn.BatchNorm1d(x.shape[1]) if x.ndim < 4 else torch.nn.BatchNorm2d(x.shape[1])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    rows = slice(None) if mesh is None else mesh.rows(x.shape[0])
    xt = torch.from_numpy(x[rows]).requires_grad_(True)
    with data_parallel(mesh):
        out = batch_norm(bn, xt, train=True)
    out.backward(torch.from_numpy(ct[rows]))
    return dict(out=out.detach().numpy(), dx=xt.grad.numpy(), dw=bn.weight.grad.numpy(),
                db=bn.bias.grad.numpy(), mean=bn.running_mean.numpy().copy(),
                var=bn.running_var.numpy().copy())


# PointNet: Adam turns float32 noise into whole steps of about lr (the
# T-Net's zero-initialised fc3 gets its first gradients at noise level, a
# bias right before a batch norm has none), and those steps move the next
# steps' activations; at lr 2e-3 two epochs of two reduction orders drift
# ~1e-3 apart, so the case runs one epoch (4 steps) at 1e-4, as the
# encoders' parity test does. A wrong mask or yaw moves the loss by ~1e-2.
PN_LR, PN_STEPS = 1e-4, 4


def _pointnet(clouds, mesh=None):
    """A fit_device epoch of a PointNet (dropout 0.3, the yaw augmentation,
    the subsample) on 2 or 1 ranks: (history, variables)."""
    kw = dict(mesh=mesh) if mesh is not None else dict(device="cpu")
    tt = tenc.make_pointnet_trainer(EncoderTrainConfig(batch_size=8, lr=PN_LR), num_classes=3,
                                    **kw)
    hist = tt.fit_device(clouds, transform=tenc.lidar_transform(num_points=16), epochs=1,
                         verbose=False, seed=1)
    return hist, tt.variables


def _grads(trainer):
    """The gradients of the trainer's last step (summed over the ranks)."""
    return {k: p.grad.numpy().copy() for k, p in trainer.model.named_parameters()
            if p.grad is not None}


def _one_step_grads(variables, fit_batches, clouds, mesh=None):
    """The gradients of one ResNet-AE step on the first fit batch and of
    one PointNet fit_device step (dropout, the yaw and the subsample on) on
    the first 8 clouds, before Adam turns them into steps of about lr."""
    kw = dict(mesh=mesh) if mesh is not None else dict(device="cpu")
    resnet = tenc.make_resnet_trainer(EncoderTrainConfig(**FIT_CFG), init_variables=variables,
                                      **kw)
    resnet.train_step(fit_batches[0])
    pointnet = tenc.make_pointnet_trainer(EncoderTrainConfig(batch_size=8, lr=PN_LR),
                                          num_classes=3, **kw)
    pointnet.fit_device(tuple(a[:8] for a in clouds), transform=tenc.lidar_transform(
        num_points=16), epochs=1, verbose=False, seed=1)
    return dict(resnet=_grads(resnet), pointnet=_grads(pointnet))


def _resnet_runs(variables, fit_batches, dataset, mesh=None):
    kw = dict(mesh=mesh) if mesh is not None else dict(device="cpu")
    fit = tenc.make_resnet_trainer(EncoderTrainConfig(**FIT_CFG), steps_per_epoch=2,
                                   init_variables=variables, **kw)
    h_fit = fit.fit(lambda: iter(fit_batches), epochs=1, verbose=False)
    dev = tenc.make_resnet_trainer(EncoderTrainConfig(**DEVICE_CFG), init_variables=variables,
                                   **kw)
    h_dev = dev.fit_device(dataset, transform=tenc.image_transform(), epochs=3, verbose=False)
    return dict(fit=(h_fit, fit.variables), fit_device=(h_dev, dev.variables))


def _rank(mesh, tmp):
    variables = torch.load(f"{tmp}/variables.pt", weights_only=False)
    fit_batches, dataset, bn, clouds = _data()
    out = _resnet_runs(variables, fit_batches, dataset, mesh)
    out["bn"] = {name: _bn_rank(mesh, *arrays) for name, arrays in bn.items()}
    out["pointnet"] = _pointnet(clouds, mesh)
    out["grads"] = _one_step_grads(variables, fit_batches, clouds, mesh)
    torch.save(out, f"{tmp}/rank{mesh.rank}.pt")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from batch3dmot_tpu.config import EncoderTrainConfig as JConfig
    from batch3dmot_tpu.train import encoders as jenc

    tmp = tmp_path_factory.mktemp("dp_enc")
    fit_batches, dataset, bn, clouds = _data()
    # the JAX trainers' seed-0 init, for the port's
    variables = jax.tree.map(np.asarray, jenc.make_resnet_trainer(JConfig()).variables)
    torch.save(variables, tmp / "variables.pt")
    with ThreadPoolExecutor(1) as pool:  # the ranks run while this process works
        spawned = pool.submit(spawn, _rank, RANKS, str(tmp), device="cpu")
        jax_runs = _jax_resnet(fit_batches, dataset)
        single = dict(pointnet=_pointnet(clouds),
                      bn={name: _bn_rank(None, *a) for name, a in bn.items()},
                      grads=_one_step_grads(variables, fit_batches, clouds))
        spawned.result()
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(RANKS)]
    return ranks, jax_runs, single, bn


def _jax_resnet(fit_batches, dataset):
    """The JAX trainer on make_mesh(2): fit (lr 1e-3, 2 host batches of
    16, steps_per_epoch 2) and fit_device (16 uint8 crops, batch 4, 3
    epochs, image_transform); both start from its seed-0 init."""
    import jax

    from batch3dmot_tpu.config import EncoderTrainConfig as JConfig
    from batch3dmot_tpu.parallel import make_mesh
    from batch3dmot_tpu.train import encoders as jenc

    mesh = make_mesh(RANKS)
    out = {}
    for case, cfg, kw in (("fit", FIT_CFG, dict(steps_per_epoch=2)),
                          ("fit_device", DEVICE_CFG, {})):
        jt = jenc.make_resnet_trainer(JConfig(**cfg), mesh=mesh, **kw)
        if case == "fit":
            hist = jt.fit(lambda: iter(fit_batches), epochs=1, verbose=False)
        else:
            hist = jt.fit_device(dataset, transform=jenc.image_transform(), epochs=3,
                                 verbose=False)
        out[case] = (hist, jax.tree.map(np.asarray, jt.variables))
    return out


def _tree_close(got, want, rtol, atol, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _tree_close(got[k], want[k], rtol, atol, f"{where}/{k}")
        return
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=where)


def _tree_equal(a, b, where=""):
    if isinstance(a, dict):
        for k in a:
            _tree_equal(a[k], b[k], f"{where}/{k}")
        return
    np.testing.assert_array_equal(a, b, err_msg=where)


@pytest.mark.parametrize("case", ["fit", "fit_device"])
def test_resnet_matches_jax_mesh(runs, case):
    """Each epoch's losses (rel 1e-4) against the JAX trainer on
    make_mesh(2); the parameters after fit_device's 12 steps at rtol 2e-4,
    atol 2e-5; after fit's 2 steps within one Adam step, lr (the first
    steps move an element by lr * g / (|g| + eps): float32 noise moves
    elements whose gradient is near eps by a fraction of lr, a wrong sign
    by 2 * lr a step); the running variances at rtol 1e-4; the ranks'
    variables bit-identical."""
    ranks, jax_runs, _, _ = runs
    (got_h, got_v), (want_h, want_v) = ranks[0][case], jax_runs[case]
    for g, w in zip(got_h, want_h, strict=True):
        for k in w:
            if k != "epoch_time_s":
                np.testing.assert_allclose(g[k], w[k], rtol=LOSS_REL, err_msg=k)
    if case == "fit":
        _tree_close(got_v["params"], want_v["params"], 0, FIT_CFG["lr"])
    else:
        _tree_close(got_v["params"], want_v["params"], RTOL, ATOL)
    _tree_close({k: v for k, v in _flat(got_v["batch_stats"]).items() if k.endswith("var")},
                {k: v for k, v in _flat(want_v["batch_stats"]).items() if k.endswith("var")},
                1e-4, 1e-6)
    _tree_equal(ranks[0][case][1], ranks[1][case][1])


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}/{k}"))
        else:
            out[f"{pre}/{k}"] = v
    return out


@pytest.mark.parametrize("name", list(BN_SHAPES))
def test_global_batch_norm_matches_flax(runs, name):
    """Train-mode batch norm on two ranks: each rank's outputs and input
    gradients are flax's rows on the global batch, the weight and bias
    gradients (summed over the ranks) flax's, and the running statistics
    move towards the global batch's mean and BIASED variance."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    ranks, _, single, bn = runs
    x, ct, w, b = bn[name]
    xl = np.moveaxis(x, 1, -1)  # flax normalises the last axis
    model = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = model.init(jax.random.key(0), jnp.asarray(xl))
    params = {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}

    def f(p, xi):
        return model.apply({"params": p, "batch_stats": variables["batch_stats"]}, xi,
                           mutable=["batch_stats"])

    out, pull, state = jax.vjp(f, params, jnp.asarray(xl), has_aux=True)
    gp, gx = pull(jnp.asarray(np.moveaxis(ct, 1, -1)))
    want_out, want_dx = np.moveaxis(np.asarray(out), -1, 1), np.moveaxis(np.asarray(gx), -1, 1)
    per = x.shape[0] // RANKS
    for r, rank in enumerate(ranks):
        got = rank["bn"][name]
        np.testing.assert_allclose(got["out"], want_out[r * per:(r + 1) * per], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got["dx"], want_dx[r * per:(r + 1) * per], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(got["mean"], np.asarray(state["batch_stats"]["mean"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["var"], np.asarray(state["batch_stats"]["var"]),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sum(r["bn"][name]["dw"] for r in ranks), np.asarray(gp["scale"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sum(r["bn"][name]["db"] for r in ranks), np.asarray(gp["bias"]),
                               rtol=1e-4, atol=1e-5)
    # one process on the global batch gives the same numbers
    np.testing.assert_allclose(single["bn"][name]["out"], want_out, rtol=1e-5, atol=1e-5)


def test_dropout_and_augmentation_match_one_process(runs):
    """A PointNet (dropout 0.3, the LiDAR yaw and the subsample drawn by
    global rows) for a fit_device epoch on two ranks against one process on
    the same seed: the loss and accuracy at rel 1e-4, the parameters within
    2 * lr per step (see ``PN_LR``), and the two ranks bit-identical."""
    ranks, _, single, _ = runs
    (got_h, got_v), (want_h, want_v) = ranks[0]["pointnet"], single["pointnet"]
    for g, w in zip(got_h, want_h, strict=True):
        for k in w:
            if k != "epoch_time_s":
                np.testing.assert_allclose(g[k], w[k], rtol=LOSS_REL, err_msg=k)
    _tree_close(got_v["params"], want_v["params"], 0, 2 * PN_LR * PN_STEPS + 1e-6)
    _tree_equal(ranks[0]["pointnet"][1], ranks[1]["pointnet"][1])


@pytest.mark.parametrize("model", ["resnet", "pointnet"])
def test_one_step_gradients_match_one_process(runs, model):
    """One step's gradients, summed over the two ranks, against the port's
    in one process on the global batch (the PointNet's with dropout and
    the LiDAR augmentation drawn by global rows) at rtol 2e-4 of each
    element and of the model's largest gradient (the ResNet-AE's are
    ~1e-4, and a bias right before a batch norm has an analytically zero
    one, float32 noise), and bit-identical on both ranks: what the
    parameters after a few Adam steps cannot show (Adam's first steps are
    blind to a gradient's scale)."""
    ranks, _, single, _ = runs
    got, want = ranks[0]["grads"][model], single["grads"][model]
    assert got.keys() == want.keys() and want
    scale = max(float(np.abs(g).max()) for g in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=RTOL * scale, err_msg=k)
        np.testing.assert_array_equal(ranks[1]["grads"][model][k], got[k], err_msg=k)
