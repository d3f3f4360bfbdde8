"""The readers of the training loop's counters (``metrics/loop_wait_pct.train``,
``step_idle_pct.train``, ``edge_slot_use_pct.train``,
``device_ops_per_step.train``) on a hand-made traced view with the
program's ``loop_stats`` stubbed: the numbers by hand, and no number where
the program recorded no step or keeps no such counters."""

import types

import pytest

from batch3dmot_tpu_torch.utils import profiling
from harness import core

STATS = {"calls": 10, "steps": 2880, "edges_valid": 12_729_600, "edge_slots": 23_592_960,
         "step_device_s": 20.5, "wait_device_s": 0.06}
TRACE = {"window_s": 21.0, "busy_s": 20.4, "records": 432_000}
WANT = {"loop_wait_pct.train": 100 * 0.06 / 21.0,
        "step_idle_pct.train": 100 * (20.5 - 20.4) / 21.0,
        "edge_slot_use_pct.train": 100 * 12_729_600 / 23_592_960,
        "device_ops_per_step.train": 432_000 / 2880}


def _reader(name):
    return core.load_module(core.HERE / "metrics" / f"{name}.py", f"loop_metric_{name}")


def _view():
    return types.SimpleNamespace(trace=dict(TRACE), work={}, cfg={}, csrc=None)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_by_hand(name, monkeypatch):
    monkeypatch.setattr(profiling, "loop_stats", lambda: dict(STATS))
    assert _reader(name).read(_view()) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(WANT))
@pytest.mark.parametrize("stats", [{}, {**STATS, "calls": 0, "steps": 0}])
def test_reader_without_steps(name, stats, monkeypatch):
    monkeypatch.setattr(profiling, "loop_stats", lambda: dict(stats))
    assert _reader(name).read(_view()) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_of_a_program_without_counters(name, monkeypatch):
    monkeypatch.delattr(profiling, "loop_stats")
    assert _reader(name).read(_view()) is None


def test_device_keys_absent_off_the_card(monkeypatch):
    """Counters without device events (a CPU run): the two device shares
    give nothing, the two counts their numbers."""
    cpu = {k: v for k, v in STATS.items() if not k.endswith("_device_s")}
    monkeypatch.setattr(profiling, "loop_stats", lambda: dict(cpu))
    got = {n: _reader(n).read(_view()) for n in WANT}
    assert got["loop_wait_pct.train"] is None and got["step_idle_pct.train"] is None
    assert got["edge_slot_use_pct.train"] == pytest.approx(WANT["edge_slot_use_pct.train"])
    assert got["device_ops_per_step.train"] == pytest.approx(WANT["device_ops_per_step.train"])
