"""The work counts against hand counts at tiny shapes, and the
pre-message-passing FLOPs against torch's FLOP counter on the reference."""

import json
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from harness import peaks, work
from harness.weights import draw_state
from reference import model as R

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNIT = dict(nd=1, ed=1, H1=1, H2=1, M1=1, M=1, C1=1, C2=1, L1=1, L2=1, L3=1, att=False)


def _cfg(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_mp_work_by_hand():
    # one edge touching two nodes, depth 1, every width 1: node projections
    # 2 nodes x 2 x 1 x (2 + 4) = 24; edge layer 2 x (1 + 1 + 1 + 2 x 2) + 2 = 16;
    # node layer 2 nodes x 2 x (2 + 1 + 1) = 16; classifier 2 x 4 = 8
    assert work.mp_work(1, 2, UNIT, 1) == (24 + 16 + 16 + 8, 2 * 4 + (4 + 8) + 4)
    # a second layer adds the layer terms and the later node projections
    # (2 nodes x 2 x 1 x (2 + 2) = 16)
    assert work.mp_work(1, 2, UNIT, 2)[0] == 64 + 16 + 16 + 16


def test_train_work_by_hand():
    f, b, fb, bb = work.train_work(1, 2, UNIT, 1)
    assert (f, fb) == work.mp_work(1, 2, UNIT, 1)
    # the backward: each product's input and weight cotangents, nothing
    # recomputed; it reads the forward's inputs and writes their cotangents
    # (two nodes of 1 float, one edge of 1 float)
    assert b == 2 * f
    assert bb == fb + 2 * 4 + 4


def test_segment_work_and_bound():
    assert work.segment_work(3, 2, 2) == (6, 3 * (8 + 8) + 2 * 2 * 4)
    assert work.bound_s(peaks.MATMUL_FLOPS_PER_S, 0) == pytest.approx(1.0)
    assert work.bound_s(0, peaks.HBM_BYTES_PER_S) == pytest.approx(1.0)
    assert peaks.MATMUL_FLOPS_PER_S == pytest.approx(165e12)


def _count(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("name", ["clr_att_gnn", "pose_gnn"])
def test_pre_mp_flops_match_the_counter(name):
    cfg = _cfg(name)
    mm = cfg["model"] != "PoseGNN"
    P = draw_state(R.param_spec(cfg), 1, "cpu", cfg["assumed"]["weight_gains"]["train"], 0.05)
    n, e = 5, 7
    win = {"pose": np.zeros((n, 19), np.float32), "edge_attr": np.zeros((e, 4), np.float32),
           "src": np.arange(e) % n, "dst": (np.arange(e) + 1) % n}
    enc = None
    if mm:
        enc = (torch.zeros(n, cfg["img_dim"]), torch.zeros(n, 256), torch.zeros(n, 256),
               torch.ones(n, dtype=torch.bool), torch.ones(n, dtype=torch.bool))
    total = _count(lambda: R.window_logits(P, cfg, win, enc, R.Arith("f32")))
    # the module loop's message passing and classifier, per edge and node
    h1, h2 = cfg["edge_update_hidden"]
    nd, ed, m = cfg["node_dim"], cfg["edge_dim"], cfg["msg_dim"]
    eu = work.mlp_flops(2 * nd + ed * (2 if mm else 1), [h1, h2, ed])
    msgs = 2 * work.mlp_flops(2 * nd + ed, [m + m // 2, m])
    comb = work.mlp_flops(2 * m, [m + m // 2, m, nd])
    loop = cfg["gnn_depth"] * (e * (eu + msgs) + n * comb)
    loop += e * work.mlp_flops(ed, cfg["edge_classifier"] + [1])
    assert work.pre_mp_flops(cfg, e, n) == total - loop
