"""GNN training with trainable encoders (``MultimodalGNN(freeze_encoders=
False)`` through ``GNNTrainer``) against the JAX trainer, and the frozen
default beside it."""

import jax
import numpy as np
import torch

from batch3dmot_tpu.config import GNNConfig as JaxGNNConfig
from batch3dmot_tpu.config import GraphConstructionConfig
from batch3dmot_tpu.data.synthetic import make_synthetic_scene
from batch3dmot_tpu.graphs import build_scene_graphs
from batch3dmot_tpu.models import make_model as jax_make_model
from batch3dmot_tpu.train.data import GraphBatcher as JaxGraphBatcher
from batch3dmot_tpu.train.data import to_padded as jax_to_padded
from batch3dmot_tpu.train.trainer import GNNTrainer as JaxTrainer
from batch3dmot_tpu_torch.config import GNNConfig
from batch3dmot_tpu_torch.models import make_model
from batch3dmot_tpu_torch.train.data import GraphBatcher
from batch3dmot_tpu_torch.train.trainer import GNNTrainer
from batch3dmot_tpu_torch.utils.weights import flax_to_state_dict, load_flax_variables

torch.set_num_threads(1)

ENCODERS = ("resnet", "pointnet", "radarnet")


def test_gnn_training_with_trainable_encoders_matches_jax():
    """freeze_encoders=False: two GNNTrainer steps on raw window batches
    (crops, points, radar; the encoders inside the step, with their running
    statistics) against the JAX trainer from the same weights: the losses
    (rtol 1e-4) and every parameter after them, the encoders' included
    (within 2 * lr per step); the encoders moved, their statistics did
    not. The default (frozen) trainer leaves them bit-identical."""
    scene = make_synthetic_scene(seed=5, num_frames=6, num_tracks=5, with_modalities=True,
                                 modality_dropout=0.3)
    windows = list(build_scene_graphs(scene, 3, GraphConstructionConfig(top_knn_nodes=4)))
    buckets = ((32, 128),)
    lr = 1e-4
    cfg_kw = dict(batch_size=2, lr=lr, weight_decay=1e-4, loss="cb")
    jmodel = jax_make_model("mm", depth=2, freeze_encoders=False)
    example = jax_to_padded(windows[0], *buckets[0])
    variables = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.key(3), example))
    jt = JaxTrainer(jmodel, example, JaxGNNConfig(**cfg_kw), fused=False,
                    init_variables=variables)
    jbatches = list(JaxGraphBatcher(windows, 2, buckets, seed=3).epoch())[:2]
    tbatches = list(GraphBatcher(windows, 2, buckets, seed=3).epoch())[:2]
    assert len(jbatches) == 2 and float(np.abs(tbatches[0].img.numpy()).sum()) > 0

    port = load_flax_variables(make_model("mm", depth=2, freeze_encoders=False), variables)
    tt = GNNTrainer(port, GNNConfig(**cfg_kw), device="cpu", init_state_dict=port.state_dict())
    frozen = GNNTrainer(make_model("mm", depth=2), GNNConfig(**cfg_kw), device="cpu",
                        init_state_dict=port.state_dict())
    start = {k: v.clone() for k, v in port.state_dict().items()}
    jl, tl = [], []
    for jb, tb in zip(jbatches, tbatches):
        jt.state, loss, _ = jt._train_step(jt.state, jb)
        jl.append(float(loss))
        tl.append(float(tt.train_step(tb)[0]))
        frozen.train_step(tb)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    want = flax_to_state_dict(jax.tree.map(np.asarray, jt.variables))
    got = tt.model.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=2 * lr * 2 + 1e-6, err_msg=k)
    for name in ENCODERS:
        moved = [k for k, v in got.items() if k.startswith(name + ".")
                 and not torch.equal(v, start[k])]
        assert moved and not any("running" in k for k in moved), (name, moved)
        assert any(np.abs(w - start[k].numpy()).max() > 0 for k, w in want.items()
                   if k.startswith(name + ".") and "running" not in k), name
        for k, v in frozen.model.state_dict().items():
            if k.startswith(name + "."):
                assert torch.equal(v, start[k]), k
