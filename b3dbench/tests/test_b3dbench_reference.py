"""The benchmark's plain reference against the port's plain path, on the CPU
at a tiny size: the window graphs, the frozen encoders, the GNNs' scores
and one training step's loss and gradients."""

import json
import os

import numpy as np
import pytest
import torch

from harness.port import port_model, port_scene
from harness.scenes import make_scenes
from harness.weights import draw_state
from reference import graphs as G
from reference import model as R

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"frames": 8, "tracks": 6}


def _cfg(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def _mix():
    with open(os.path.join(HERE, "traffic", "train_device.json")) as f:
        return {**json.load(f), **TINY}


def _setup(name, use="train"):
    cfg = _cfg(name)
    mm = cfg["model"] != "PoseGNN"
    scenes = make_scenes(_mix(), range(2), 2 ** 31 + 7,
                         (cfg["lidar_points"], cfg["radar_points"]) if mm else None)
    state = draw_state(R.param_spec(cfg), 5, "cpu", cfg["assumed"]["weight_gains"][use],
                       cfg["assumed"]["bias_scale"])
    model = port_model(cfg)
    model.load_state_dict(state)  # strict: the reference names every tensor
    return cfg, mm, scenes, state, model.eval()


@pytest.mark.parametrize("name", ["clr_att_gnn", "pose_gnn"])
def test_param_spec_is_the_port_state(name):
    cfg = _cfg(name)
    spec = {n: tuple(s) for n, s, _, _ in R.param_spec(cfg)}
    port = {k: tuple(v.shape) for k, v in port_model(cfg).state_dict().items()}
    assert spec == port


@pytest.mark.parametrize("window_len", [2, 5])
def test_window_build_matches_the_port(window_len):
    from batch3dmot_tpu_torch.config import GraphConstructionConfig
    from batch3dmot_tpu_torch.graphs import build_scene_graphs

    cfg, _, scenes, _, _ = _setup("pose_gnn")
    gc = GraphConstructionConfig(top_knn_nodes=4, batch_size_graph=window_len)
    for si, sc in enumerate(scenes):
        ours = G.scene_windows(sc, window_len, 4)
        theirs = [w for w in build_scene_graphs(port_scene(sc, "s"), window_len, gc)
                  if w.num_edges]
        assert [s for s, _ in ours] == [w.window_start for w in theirs]
        for (_, a), b in zip(ours, theirs):
            np.testing.assert_array_equal(a["det_index"], b.det_index)
            np.testing.assert_array_equal(a["pose"], b.pose)
            np.testing.assert_array_equal(a["src"], b.edge_src)
            np.testing.assert_array_equal(a["dst"], b.edge_dst)
            np.testing.assert_array_equal(a["edge_attr"], b.edge_attr)
            np.testing.assert_array_equal(a["label"], b.edge_label)
            np.testing.assert_array_equal(a["weight"], b.edge_weight)


def test_encoders_match_the_port():
    cfg, _, scenes, state, model = _setup("clr_att_gnn")
    sc = scenes[0]
    ours = R.encode_detections(state, sc["img"], sc["lidar"], sc["radar"], R.Arith("f32"))
    with torch.no_grad():
        theirs = model.encode_frozen(torch.from_numpy(sc["img"]), torch.from_numpy(sc["lidar"]),
                                     torch.from_numpy(sc["radar"]))
    for a, b in zip(ours[:3], theirs):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)
    assert ours[3].any() and not ours[3].all()  # some lidar clouds dropped, not all


def _port_batch(cfg, mm, sc, wins, state, model):
    """The port's padded batch of reference windows, with encodings."""
    from batch3dmot_tpu_torch.graph import batch_graphs, pad_graph

    n = max(len(w["pose"]) for w in wins)
    e = max(len(w["src"]) for w in wins)
    g = batch_graphs([pad_graph(pose=w["pose"], edge_src=w["src"], edge_dst=w["dst"],
                                edge_attr=w["edge_attr"],
                                node_time=w["pose"][:, -1].astype(np.int32),
                                node_class=w["node_class"], max_nodes=n, max_edges=e,
                                edge_label=w["label"], edge_weight=w["weight"],
                                include_modalities=False) for w in wins])
    if not mm:
        return g, None
    enc = R.encode_detections(state, sc["img"], sc["lidar"], sc["radar"], R.Arith("f32"))
    rows = []
    for t in enc:
        out = torch.zeros((len(wins), n, *t.shape[1:]), dtype=t.dtype)
        for k, w in enumerate(wins):
            out[k, : len(w["pose"])] = t[torch.as_tensor(w["det_index"])]
        rows.append(out)
    return g, tuple(rows)


@pytest.mark.parametrize("name", ["clr_att_gnn", "pose_gnn"])
def test_scores_and_a_step_match_the_port(name):
    cfg, mm, scenes, state, model = _setup(name)
    sc = scenes[0]
    wins = [w for _, w in G.scene_windows(sc, 5, cfg["top_knn_nodes"])][:2]
    g, enc = _port_batch(cfg, mm, sc, wins, state, model)
    with torch.no_grad():
        port = model.forward_from_encodings(g, *enc)[0] if mm else model(g)[0]
    ar = R.Arith("f64")
    P = {k: v.double() if v.is_floating_point() else v for k, v in state.items()}
    encs = [None] * 2
    if mm:
        full = R.encode_detections(P, sc["img"], sc["lidar"], sc["radar"], ar)
        encs = [tuple(t[torch.as_tensor(w["det_index"])] for t in full) for w in wins]
    for k, (w, e) in enumerate(zip(wins, encs)):
        ref = R.window_scores(P, cfg, w, e, ar)
        torch.testing.assert_close(port[k, : len(w["src"])].double(), ref, rtol=2e-4, atol=2e-5)

    # one step: the loss and every trained leaf's gradient
    from batch3dmot_tpu_torch.config import GNNConfig
    from batch3dmot_tpu_torch.train.trainer import GNNTrainer

    tr = GNNTrainer(port_model(cfg), GNNConfig(lr=cfg["lr"], weight_decay=0.0,
                                               batch_size=cfg["batch_size"], loss="cb"),
                    device="cpu", init_state_dict=state)
    loss, _ = tr._loss((g, enc) if mm else g)
    loss.backward()
    cfg0 = {**cfg, "weight_decay": 0.0}
    losses, grad, _ = R.adam_steps(P, cfg0, [list(zip(wins, encs))], ar)
    assert losses[0] == pytest.approx(float(loss.detach()), rel=1e-5)
    for n, p in tr.model.named_parameters():
        if p.requires_grad:
            torch.testing.assert_close(p.grad.double(), grad[n], rtol=5e-3,
                                       atol=2e-4 * float(grad[n].abs().max()) + 1e-12)
