"""Share of the edge slots that the training steps of the traced window
carried that hold a valid edge: the windows' valid edges over steps x
batch x the bucket's edge width, counted by the program from the index
rows it stepped. The rest is padding that the kernels carry."""


def _loop() -> dict:
    """The program's loop counters (``utils.profiling.loop_stats``): empty
    where it keeps none."""
    from batch3dmot_tpu_torch.utils import profiling

    return getattr(profiling, "loop_stats", dict)()


def read(v):
    s = _loop()
    if not s.get("steps"):
        return None
    return 100.0 * s["edges_valid"] / s["edge_slots"]
