"""Device operations (kernels, copies, sets) of the traced window per
training step the program counted in it."""


def _loop() -> dict:
    """The program's loop counters (``utils.profiling.loop_stats``): empty
    where it keeps none."""
    from batch3dmot_tpu_torch.utils import profiling

    return getattr(profiling, "loop_stats", dict)()


def read(v):
    s = _loop()
    if not s.get("steps"):
        return None
    return v.trace["records"] / s["steps"]
