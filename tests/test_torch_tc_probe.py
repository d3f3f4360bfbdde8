"""The tensor-core rounding probe's arithmetic (``scripts/probe_tc_rounding.py``)
on the CPU: outputs made by one model of the adder must be fitted by that
model, and the one-addend counts must tell a sum rounded to nearest from
one cut toward zero. The probe itself runs on the card
(``chip_smoke.py``)."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scripts"))

import probe_tc_rounding as probe  # noqa: E402


def _card_of(model, problems=8, m=16, n=8, seed=0):
    """Crafted inputs and the outputs ``model`` gives them, as the probe
    lays them out for mma.sync (16 x 8 outputs per problem)."""
    rng = np.random.default_rng(seed)
    rows, cs = probe.crafted(rng, problems * m)
    a = rows.reshape(problems, m, 8)
    c = np.ascontiguousarray(cs[:, :n]).reshape(problems, m, n)
    b = np.where(rng.random((problems, 8, n)) < 0.25, -1.0, 1.0).astype(np.float32)
    b[:, :, 0] = 1.0
    d = np.zeros_like(c)
    for p in range(problems):
        for i in range(m):
            for j in range(n):
                prods = [probe.exact(np.float64(a[p, i, k]) * b[p, k, j]) for k in range(8)]
                v = probe.emulate(probe.exact(c[p, i, j]), prods, *model)
                d[p, i, j] = v / 2.0 ** probe.SCALE
                assert probe.exact(d[p, i, j]) == v  # a float32
    return a, b, c, d


@pytest.mark.parametrize("model", [
    (0, 8, "zero", "zero"),
    (3, 8, "zero", "zero"),
    (0, 4, "zero", "floor"),
    (2, 8, "nearest", "zero"),
    (None, 8, "nearest", "zero"),
])
def test_fit_recovers_the_model_that_made_the_outputs(model):
    alive, one = probe.fit_models(*_card_of(model))
    assert model in alive
    assert len(alive) <= 2, alive  # the cases tell the models apart
    if model[2] == "nearest" and model[0] is None:
        assert one["toward_zero"] == one["other"] == 0 and one["nearest"] > 0, one
    if model[2] == "zero":
        assert one["toward_zero"] + one["other"] > 0, one


def test_to_f32_rounds_as_the_card_would():
    one = probe.exact(1.0)
    ulp = one >> 23
    assert probe.to_f32(one + ulp * 3 // 4, "zero") == one
    assert probe.to_f32(one + ulp * 3 // 4, "nearest") == one + ulp
    assert probe.to_f32(one + ulp // 2, "nearest") == one  # tie to even
    assert probe.to_f32(-(one + ulp * 3 // 4), "zero") == -one
    assert probe.emulate(one, [ulp * 3 // 4] + [0] * 7, 0, 8, "zero", "zero") == one
