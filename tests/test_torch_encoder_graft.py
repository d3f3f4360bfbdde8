"""Encoder checkpoints across the two packages and trained encoders in the
GNN: a JAX encoder trainer's epoch msgpack loaded into the port, the port's
own ``.pt`` epoch checkpoints grafted into a ``MultimodalGNN``
(``utils/checkpoint.py::merge_encoder_params``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batch3dmot_tpu.config import EncoderTrainConfig as JConfig
from batch3dmot_tpu.train import encoders as jenc
from batch3dmot_tpu_torch.config import EncoderTrainConfig
from batch3dmot_tpu_torch.models import init_params_, make_model
from batch3dmot_tpu_torch.models.encoders import PointNetClassifier, RadarNetClassifier, ResNetAE
from batch3dmot_tpu_torch.train import encoders as tenc
from batch3dmot_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_flax_encoder_checkpoint,
    merge_encoder_params,
)

torch.set_num_threads(1)

ENCODERS = ("resnet", "pointnet", "radarnet")


def _batch(name, rng, bs=4):
    if name == "resnet":
        return rng.random((bs, 32, 32, 3), dtype=np.float32)
    pts, ch = (32, 3) if name == "pointnet" else (16, 4)
    return (rng.normal(size=(bs, pts, ch)).astype(np.float32),
            rng.integers(0, 7, bs).astype(np.int32))


_JAX = {
    "resnet": lambda: (jenc.make_resnet_trainer, ResNetAE, tenc.resnet_ae_loss, {}),
    "pointnet": lambda: (jenc.make_pointnet_trainer, PointNetClassifier, tenc.pointnet_loss,
                         dict(example=(jnp.zeros((2, 32, 3)), jnp.zeros((2,), jnp.int32)))),
    "radarnet": lambda: (jenc.make_radarnet_trainer, RadarNetClassifier, tenc.radarnet_loss,
                         dict(example=(jnp.zeros((2, 16, 4)), jnp.zeros((2,), jnp.int32)))),
}


@pytest.mark.parametrize("name", ENCODERS)
def test_jax_encoder_checkpoint_loads_into_the_port(name, tmp_path):
    """A ``{prefix}_epoch0_loss*.msgpack`` that the JAX EncoderTrainer wrote
    after a step loads into the port's encoder (decoder or fc3 included),
    whose evaluation loss and metrics equal the JAX ``_eval``'s at rtol
    1e-5."""
    make_jax, cls, loss_fn, kw = _JAX[name]()
    rng = np.random.default_rng(0)
    jt = make_jax(JConfig(batch_size=4, lr=1e-3), steps_per_epoch=1, **kw)
    train, val = _batch(name, rng), _batch(name, rng)
    jt.fit(lambda: iter([train]), epochs=1, log_dir=str(tmp_path), prefix=name, verbose=False)
    (path,) = tmp_path.glob(f"{name}_epoch0_loss*.msgpack")
    jbatch = jax.tree.map(jnp.asarray, val)
    want_loss, want_aux = jt._eval_step(jt.state, jbatch)
    port = load_flax_encoder_checkpoint(str(path), cls())
    batch = tuple(torch.from_numpy(a) for a in (val if isinstance(val, tuple) else (val,)))
    with torch.no_grad():
        loss, aux = loss_fn(port, batch, False)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for k, v in want_aux.items():
        np.testing.assert_allclose(float(aux[k]), float(v), rtol=1e-5, err_msg=k)


def test_port_checkpoints_graft_into_the_gnn(tmp_path):
    """Each trainer's epoch .pt (its state dict) reads back equal, and
    merge_encoder_params grafts the three into a MultimodalGNN whose
    encode_frozen outputs are bit-identical to the trainers' models' eval
    encode / feat_256; the GNN's other parameters stay as they were."""
    rng = np.random.default_rng(1)
    cfg = EncoderTrainConfig(batch_size=4, lr=1e-3)
    trainers = {"resnet": tenc.make_resnet_trainer(cfg, device="cpu"),
                "pointnet": tenc.make_pointnet_trainer(cfg, device="cpu"),
                "radarnet": tenc.make_radarnet_trainer(cfg, device="cpu")}
    paths = {}
    for name, tt in trainers.items():
        batches = [_batch(name, rng), _batch(name, rng)]
        tt.fit(lambda: iter(batches), epochs=1, log_dir=str(tmp_path), prefix=name,
               verbose=False)
        (paths[name],) = tmp_path.glob(f"{name}_epoch0_loss*.pt")
        saved = load_checkpoint(str(paths[name]))
        for (k, v), w in zip(tt.model.state_dict().items(), saved.values(), strict=True):
            assert torch.equal(v, w), k
    gnn = init_params_(make_model("mm", depth=2), torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in gnn.state_dict().items()}
    merge_encoder_params(gnn, **paths)
    for k, v in gnn.state_dict().items():
        if k.split(".")[0] not in ENCODERS:
            assert torch.equal(v, before[k]), k
    img = torch.from_numpy((rng.random((6, 32, 32, 3)) * 255).astype(np.uint8))
    lidar = torch.from_numpy(rng.normal(size=(6, 128, 3)).astype(np.float32))
    radar = torch.from_numpy(rng.normal(size=(6, 64, 4)).astype(np.float32))
    with torch.no_grad():
        got = gnn.encode_frozen(img, lidar, radar)
        want = (trainers["resnet"].model.encode(img),
                trainers["pointnet"].model.feat_256(lidar),
                trainers["radarnet"].model.feat_256(radar))
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
