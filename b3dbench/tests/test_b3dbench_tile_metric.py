"""The reader of the training backward's tile counts
(``metrics/bwd_edge_tile_use_pct.train``) on a hand-made traced view with
the program's ``loop_stats`` stubbed: the share by hand, and no number
where the program counted no tile or keeps no such counter."""

import types

import pytest

from batch3dmot_tpu_torch.utils import profiling
from harness import core

NAME = "bwd_edge_tile_use_pct.train"
STATS = {"calls": 10, "steps": 2880, "edges_valid": 12_729_600, "edge_slots": 23_592_960,
         "step_device_s": 20.5, "wait_device_s": 0.06,
         "bwd_tiles_run": 1_136_640, "bwd_tiles": 2_211_840}


def _read():
    mod = core.load_module(core.HERE / "metrics" / f"{NAME}.py", "tile_metric")
    return mod.read(types.SimpleNamespace(trace={"window_s": 21.0, "busy_s": 20.4,
                                                 "records": 432_000},
                                          work={}, cfg={}, csrc=None))


def test_reader_by_hand(monkeypatch):
    monkeypatch.setattr(profiling, "loop_stats", lambda: dict(STATS))
    assert _read() == pytest.approx(100 * 1_136_640 / 2_211_840, rel=1e-12)


@pytest.mark.parametrize("stats", [
    {},
    {k: v for k, v in STATS.items() if not k.startswith("bwd_")},
    {**STATS, "bwd_tiles_run": 0, "bwd_tiles": 0},
], ids=["nothing", "no_tile_counter", "no_tiles"])
def test_reader_without_tiles(stats, monkeypatch):
    monkeypatch.setattr(profiling, "loop_stats", lambda: dict(stats))
    assert _read() is None


def test_reader_of_a_program_without_counters(monkeypatch):
    monkeypatch.delattr(profiling, "loop_stats")
    assert _read() is None
