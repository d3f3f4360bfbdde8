"""Operations and bytes a step needs, counted from the inputs' shapes over
the valid edges and the nodes they touch (frozen copies of the smoke's
``mp_work``, ``train_work``, ``segment_work`` and ``bound``,
``chip_smoke.py:456-592,1244-1252``), and the whole model step's FLOPs.

Counts follow the data, never the program's padding or launches: a window
contributes its valid edges and the nodes those edges touch. The bytes are
what these inputs need: each valid row read once, each output row written
once; a backward is twice its forward's operations (the smoke's versions
counted whole padded tensors, the training pair's stashes and what its
backward recomputes, properties of one design). At every shape of these
cells the operations set the bound (see ``bound_s``).
"""

from __future__ import annotations

from harness.peaks import HBM_BYTES_PER_S, MATMUL_FLOPS_PER_S

F32 = 4


def mp_widths(cfg: dict) -> dict:
    """The message-passing loop's widths from the configuration."""
    h1, h2 = cfg["edge_update_hidden"]
    m = cfg["msg_dim"]
    l1, l2, l3 = cfg["edge_classifier"]
    return dict(nd=cfg["node_dim"], ed=cfg["edge_dim"], H1=h1, H2=h2, M1=m + m // 2, M=m,
                C1=m + m // 2, C2=m, L1=l1, L2=l2, L3=l3,
                att=cfg["model"] != "PoseGNN")


def mp_work(edges: int, touched: int, w: dict, depth: int):
    """(FLOP, bytes) of the fused message passing and classifier forward
    (B1-B3) over ``edges`` valid edges touching ``touched`` nodes."""
    nd, ed = w["nd"], w["ed"]
    ea = ed * (2 if w["att"] else 1)
    pw, qw = 2 * w["H1"] + 4 * w["M1"], 2 * w["H1"] + 2 * w["M1"]
    edge_layer = 2 * (ea * w["H1"] + w["H1"] * w["H2"] + w["H2"] * ed
                      + 2 * (ed * w["M1"] + w["M1"] * w["M"]))
    edge_layer += 2 * w["M"]  # the two message sums
    node_layer = 2 * (2 * w["M"] * w["C1"] + w["C1"] * w["C2"] + w["C2"] * nd)
    cls = 2 * (ed * w["L1"] + w["L1"] * w["L2"] + w["L2"] * w["L3"] + w["L3"])
    flops = (touched * 2 * nd * pw + depth * (edges * edge_layer + touched * node_layer)
             + (depth - 1) * touched * 2 * nd * qw + edges * cls)
    nbytes = touched * nd * F32 + edges * (ea * F32 + 2 * 4) + edges * F32
    return flops, nbytes


def train_work(edges: int, touched: int, w: dict, depth: int):
    """(forward FLOP, backward FLOP, forward bytes, backward bytes) of the
    fused training pair (B4-B7): the forward as ``mp_work``; the backward
    twice the forward's operations, each product's input and weight
    cotangents, without what a design recomputes."""
    fwd_flops, fwd_bytes = mp_work(edges, touched, w, depth)
    ea = w["ed"] * (2 if w["att"] else 1)
    # the backward reads the inputs and the scores' cotangent, writes the
    # inputs' cotangents (weights' are small beside them)
    bwd_bytes = fwd_bytes + touched * w["nd"] * F32 + edges * ea * F32
    return fwd_flops, 2 * fwd_flops, fwd_bytes, bwd_bytes


def segment_work(rows: int, width: int, segments: int, id_bytes: int = 8):
    """(FLOP, bytes) of a segment sum (B8) of ``rows`` valid rows of
    ``width`` floats into ``segments`` output rows: an add per element; ids
    and the rows read once, the output written once."""
    return rows * width, rows * (id_bytes + width * F32) + segments * width * F32


def bound_s(flops: float, nbytes: float) -> float:
    """The least seconds this work takes: the larger of operations at the
    float32-accurate tensor-core rate and bytes at the memory rate."""
    return max(flops / MATMUL_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)


def mlp_flops(cin: int, widths) -> int:
    f = 0
    for w in widths:
        f += 2 * cin * w
        cin = w
    return f


def pre_mp_flops(cfg: dict, edges: int, nodes: int) -> int:
    """Forward FLOPs of everything before the message passing, per window
    batch: the edge and node encoders, and for the multimodal model the
    lidar and radar heads, the three attention blocks and the attribute
    encoder over the edges."""
    ed, nd = cfg["edge_dim"], cfg["node_dim"]
    f = edges * mlp_flops(4, cfg["edge_encoder"] + [ed]) + nodes * mlp_flops(
        19, cfg["node_encoder"] + [nd])
    if cfg["model"] != "PoseGNN":
        di, dl, dr = cfg["img_dim"], cfg["lidar_dim"], cfg["radar_dim"]
        f += nodes * (mlp_flops(256, cfg["fc_lidar_encoder"] + [dl])
                      + mlp_flops(256, cfg["fc_radar_encoder"] + [dr])
                      + sum(4 * d * d for d in (di, dl, dr)))
        f += edges * mlp_flops(2 * (di + dl + dr) + ed, cfg["att_edge_encoder"] + [ed])
    return f
