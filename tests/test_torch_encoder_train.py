"""The port's encoder trainer (``batch3dmot_tpu_torch/train/encoders.py``)
against the JAX ``EncoderTrainer`` from the same weights and batches:
``fit`` steps (losses, parameters, batch statistics), StepLR and weight
decay, ``fit_device`` with the same permutations; and the classifiers'
``fit_device`` learning on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from batch3dmot_tpu.config import EncoderTrainConfig as JConfig
from batch3dmot_tpu.models.encoders import PointNetClassifier as JPointNet
from batch3dmot_tpu.models.encoders import RadarNetClassifier as JRadarNet
from batch3dmot_tpu.models.encoders import ResNetAE as JResNetAE
from batch3dmot_tpu.train import encoders as jenc
from batch3dmot_tpu_torch.config import EncoderTrainConfig
from batch3dmot_tpu_torch.models.encoders import PointNetClassifier, RadarNetClassifier, ResNetAE
from batch3dmot_tpu_torch.train import encoders as tenc
from batch3dmot_tpu_torch.utils.weights import encoder_variables

torch.set_num_threads(1)

LOSS_RTOL = 1e-4
STATS_RTOL, STATS_ATOL = 1e-4, 1e-6
STEPS = 3


def _batches(name, rng, n, bs=4):
    """n host batches: crops for the autoencoder, separable clouds (class k
    centred at offset k) with labels for the classifiers."""
    out = []
    for _ in range(n):
        if name == "resnet":
            out.append(rng.random((bs, 32, 32, 3), dtype=np.float32))
            continue
        pts, ch = (32, 3) if name == "pointnet" else (16, 4)
        labels = rng.integers(0, 3, bs).astype(np.int32)
        x = (rng.normal(0, 0.2, (bs, pts, ch)) + labels[:, None, None] * 2.0).astype(np.float32)
        out.append((x, labels))
    return out


def _models(name):
    """(flax model, JAX loss, example, port model, port loss); dropout 0:
    the two packages' random streams cannot match."""
    if name == "resnet":
        return (JResNetAE(), jenc.resnet_ae_loss, jnp.zeros((2, 32, 32, 3)),
                ResNetAE(), tenc.resnet_ae_loss)
    if name == "pointnet":
        return (JPointNet(3, dropout=0.0), jenc.pointnet_loss,
                (jnp.zeros((2, 32, 3)), jnp.zeros((2,), jnp.int32)),
                PointNetClassifier(3, dropout=0.0), tenc.pointnet_loss)
    return (JRadarNet(3, dropout=0.0), jenc.radarnet_loss,
            (jnp.zeros((2, 16, 4)), jnp.zeros((2,), jnp.int32)),
            RadarNetClassifier(3, dropout=0.0), tenc.radarnet_loss)


def _trainers(name, cfg_kw, steps_per_epoch=STEPS):
    jmodel, jloss, example, tmodel, tloss = _models(name)
    jt = jenc.EncoderTrainer(jmodel, jloss, example, JConfig(**cfg_kw),
                             steps_per_epoch=steps_per_epoch)
    variables = jax.tree.map(np.asarray, jt.variables)
    tt = tenc.EncoderTrainer(tmodel, tloss, EncoderTrainConfig(**cfg_kw),
                             steps_per_epoch=steps_per_epoch, device="cpu",
                             init_variables=variables)
    return jt, tt, variables


def _assert_tree_close(got, want, rtol, atol, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (where, sorted(got), sorted(want))
        for k in want:
            _assert_tree_close(got[k], want[k], rtol, atol, f"{where}/{k}")
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=where)


def _one_batch_epochs(batches):
    """train_batches for fit: epoch e yields batches[e] alone, so that the
    history holds each step's loss."""
    it = iter(batches)
    return lambda: iter([next(it)])


# (encoder, config): the base case per encoder at its configs/clr.yaml
# learning rate (PointNet's at 1e-4: see below), StepLR (steps_per_epoch 1,
# step size 1, gamma 0.5) and coupled weight decay.
# Adam turns float32 noise into whole steps: a bias right before a batch
# norm has an analytically zero gradient in train mode, so both packages
# step it by about +-lr at random (m / (sqrt(v) + 1e-8) of noise), and a
# gradient element near zero may take either sign. Such steps move the next
# steps' activations; at PointNet's 1e-3 the third loss drifts ~1.1e-4
# apart (the first two agree to 1e-5), so its case runs at 1e-4. The same
# biases enter the running means directly: a mean is held within the
# parameters' bound (2 * lr per step), a variance to rtol 1e-4.
CASES = [
    ("resnet", dict(batch_size=4, lr=2e-3)),
    ("pointnet", dict(batch_size=4, lr=1e-4)),
    ("radarnet", dict(batch_size=4, lr=2e-4)),
    ("radarnet", dict(batch_size=4, lr=2e-4, scheduler_step_size=1, scheduler_gamma=0.5)),
    ("resnet", dict(batch_size=4, lr=2e-3, weight_decay=0.05)),
]


def _assert_stats_close(got, want, bound, where=""):
    """Running statistics: each mean within ``bound`` (and rtol 1e-4), each
    variance at rtol 1e-4."""
    if isinstance(want, dict):
        for k in want:
            _assert_stats_close(got[k], want[k], bound, f"{where}/{k}")
        return
    atol = bound if where.endswith("/mean") else STATS_ATOL
    np.testing.assert_allclose(got, want, rtol=STATS_RTOL, atol=atol, err_msg=where)


@pytest.mark.parametrize("name,cfg_kw", CASES, ids=["resnet", "pointnet", "radarnet",
                                                     "radarnet-steplr", "resnet-wd"])
def test_fit_matches_jax(name, cfg_kw):
    """Three steps of fit from the same weights on the same batches: each
    step's loss (rtol 1e-4) and metrics, the parameters after them (within
    2 * lr per step: Adam may flip a step whose gradient is near zero) and
    the batch statistics (see ``CASES``); the learning rate per step is
    optax's schedule."""
    steplr = "scheduler_step_size" in cfg_kw
    jt, tt, init = _trainers(name, cfg_kw, steps_per_epoch=1 if steplr else STEPS)
    batches = _batches(name, np.random.default_rng(0), STEPS)
    if steplr:
        lrs = []
        step = tt._train_step
        tt._train_step = lambda b: (step(b), lrs.append(tt.optimizer.param_groups[0]["lr"]))[0]
    jh = jt.fit(_one_batch_epochs(batches), epochs=STEPS, verbose=False)
    th = tt.fit(_one_batch_epochs(batches), epochs=STEPS, verbose=False)
    for j, t in zip(jh, th, strict=True):
        assert set(j) == set(t)
        for k in j:
            if k != "epoch_time_s":
                np.testing.assert_allclose(t[k], j[k], rtol=LOSS_RTOL, err_msg=k)
    got, want = tt.variables, jax.tree.map(np.asarray, jt.variables)
    bound = 2 * cfg_kw["lr"] * STEPS + 1e-6
    _assert_tree_close(got["params"], want["params"], 0, bound)
    _assert_stats_close(got["batch_stats"], want["batch_stats"], bound)
    if steplr:
        schedule = optax.exponential_decay(cfg_kw["lr"], 1, 0.5, staircase=True)
        np.testing.assert_allclose(lrs, [float(schedule(s)) for s in range(STEPS)], rtol=1e-6)
        assert lrs == [2e-4, 1e-4, 5e-5]
    if cfg_kw.get("weight_decay"):
        # the decay moved the weights: without it the steps differ
        plain = tenc.EncoderTrainer(_models(name)[3], tenc.resnet_ae_loss,
                                    EncoderTrainConfig(**dict(cfg_kw, weight_decay=0.0)),
                                    steps_per_epoch=STEPS, device="cpu", init_variables=init)
        plain.fit(_one_batch_epochs(batches), epochs=STEPS, verbose=False)
        diff = max(float(np.abs(a - b).max()) for a, b in zip(
            jax.tree.leaves(plain.variables["params"]), jax.tree.leaves(got["params"])))
        assert diff > 1e-5


def test_fit_device_resnet_matches_jax():
    """fit_device with image_transform over a uint8 dataset: the same
    permutations (np.random.default_rng(seed)), so each epoch's train and
    validation losses agree with the JAX trainer's at rtol 1e-4."""
    rng = np.random.default_rng(2)
    imgs = (rng.random((12, 32, 32, 3)) * 255).astype(np.uint8)
    labels = rng.integers(0, 7, 12).astype(np.int32)
    cfg = dict(batch_size=4, lr=2e-3)
    jt, tt, _ = _trainers("resnet", cfg)
    kw = dict(val_dataset=(imgs[:8], labels[:8]), epochs=2, verbose=False, seed=3)
    jh = jt.fit_device((imgs, labels), transform=jenc.image_transform(), **kw)
    th = tt.fit_device((imgs, labels), transform=tenc.image_transform(), **kw)
    for j, t in zip(jh, th, strict=True):
        for k in ("train/loss", "train/mse", "val/loss", "val/mse"):
            np.testing.assert_allclose(t[k], j[k], rtol=LOSS_RTOL, err_msg=k)
    assert th[1]["train/loss"] < th[0]["train/loss"]


def _padded_clouds(rng, n, ch, kcap, num_points, classes=3):
    """A stacked dataset (clouds [n, ch, kcap], counts, labels) of separable
    classes; some clouds longer than num_points."""
    labels = rng.integers(0, classes, n).astype(np.int32)
    counts = rng.integers(num_points // 2, kcap + 1, n).astype(np.int32)
    clouds = np.zeros((n, ch, kcap), np.float32)
    for i in range(n):
        pts = rng.normal(0, 0.2, (ch, counts[i]))
        pts[0] += 3.0 * labels[i]
        pts[1] -= 2.0 * labels[i]
        clouds[i, :, :counts[i]] = pts
    return clouds, counts, labels


@pytest.mark.parametrize("name", ["pointnet", "radarnet"])
def test_classifier_fit_device_learns(name):
    """PointNet (with the yaw augmentation and the all-channel
    normalisation) and RadarNet learn separable classes through fit_device
    on the CPU: the loss falls and the accuracy rises, in training and in
    validation."""
    rng = np.random.default_rng(4)
    ch, num_points = (4, 16) if name == "pointnet" else (4, 8)
    data = _padded_clouds(rng, 48, ch, 4 * num_points, num_points)
    cfg = EncoderTrainConfig(batch_size=8, lr=2e-3)
    if name == "pointnet":
        tt = tenc.make_pointnet_trainer(cfg, num_classes=3, device="cpu")
        transform = tenc.lidar_transform(num_points=num_points)
    else:
        tt = tenc.make_radarnet_trainer(cfg, num_classes=3, device="cpu")
        transform = tenc.radar_transform(num_points=num_points)
    hist = tt.fit_device(data, transform=transform, val_dataset=data, epochs=6,
                         verbose=False)
    assert hist[-1]["train/loss"] < hist[0]["train/loss"]
    assert hist[-1]["train/accuracy"] >= 0.8, hist[-1]
    # validation runs with the running statistics, which lag the weights
    assert hist[-1]["val/accuracy"] > hist[0]["val/accuracy"], hist
    assert tt.step == 6 * (48 // 8)


def test_entry_points_default_to_the_card():
    """Without device="cpu" the trainers refuse to run on a machine without
    a card; the PointNet constructor leaves out fstn whatever the config
    says (as the JAX package's does)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    for make in (tenc.make_resnet_trainer, tenc.make_pointnet_trainer,
                 tenc.make_radarnet_trainer):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(EncoderTrainConfig())
    from batch3dmot_tpu_torch.config import PointNetConfig

    tt = tenc.make_pointnet_trainer(PointNetConfig(feature_transform=True), device="cpu")
    assert not hasattr(tt.model.feat, "fstn")
    assert "fstn" not in encoder_variables(tt.model)["params"]["feat"]
