"""The model's weights from the run's seed, made on the device in one draw.

One ``torch.randn`` over every float of the state (a ``torch.Generator`` on
the device), cut into the tensors of ``reference.model.param_spec`` and
scaled by kind: a weight by its gain over sqrt(fan-in) (``gains``, by the
longest matching name prefix, else ``default``), a bias by ``bias_scale``,
a batch norm's scale 1 + 0.1 z, shift and running mean 0.1 z, running
variance exp(0.2 z). The same tensors
go to the program and to the reference.
"""

from __future__ import annotations

import math

import torch


def _gain(name: str, gains: dict) -> float:
    best, value = -1, gains["default"]
    for prefix, g in gains.items():
        if prefix != "default" and name.startswith(prefix) and len(prefix) > best:
            best, value = len(prefix), g
    return value


def draw_state(spec, seed: int, device, gains: dict, bias_scale: float) -> dict:
    """{name: tensor} on ``device``, float32 (counters int64)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2 ** 63))
    floats = [s for s in spec if s[2] != "count"]
    total = sum(math.prod(s[1]) for s in floats)
    z = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, kind, fan in spec:
        if kind == "count":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        n = math.prod(shape)
        t = z[off:off + n].reshape(shape)
        off += n
        if kind == "w":
            t = t * (_gain(name, gains) / math.sqrt(fan))
        elif kind == "b":
            t = t * bias_scale
        elif kind == "bn_w":
            t = 1.0 + 0.1 * t
        elif kind in ("bn_b", "bn_mean"):
            t = 0.1 * t
        elif kind == "bn_var":
            t = torch.exp(0.2 * t)
        out[name] = t.contiguous()
    return out
